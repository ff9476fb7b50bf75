"""Log mining → TPS/BPS/latency metrics.

Reimplements the reference's measurement pipeline
(benchmark/benchmark/logs.py:17-251): client logs give input rate, start
time and per-sample send times; node logs give proposal/commit times per
batch digest, batch sizes, and sample-tx→batch joins. Consensus metrics
count from first proposal to last commit; end-to-end metrics count from
client start. The log grammar is frozen — the C++ node emits exactly these
phrasings (see native/src/*/: "NOTE: ... used to compute performance").
"""

from __future__ import annotations

import re
from datetime import datetime
from glob import glob
from os.path import join
from re import findall, search
from statistics import mean

from .utils import Print

SIGNATURE_LENGTH = 0
PUBLICKEY_LENGTH = 0

# A well-formed line of the frozen log grammar (common/log.hpp):
# "[<RFC3339 ms>Z <LEVEL> <module>] <message>".  Concurrent writers to
# one fd (a chaos-restarted node appending to its old log, the C++
# node's multiple threads under memory pressure) can interleave or tear
# lines; anything that does not match this prefix is dropped and
# counted BEFORE the regex mining, so a torn fragment can neither fake
# a fatal " ERROR " hit nor crash a config search().
_WELL_FORMED_LINE = re.compile(
    r"^\[\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}\.\d{3}Z "
    r"(?:ERROR|WARN|INFO|DEBUG) [\w:.\-]+\] ")


class ParseError(Exception):
    pass


class LogParser:
    def __init__(self, clients, nodes, faults, chaos_events=None,
                 strict_chaos=False, twins=None, wan=None, slos=None,
                 strict_lines=False):
        inputs = [clients, nodes]
        assert all(isinstance(x, list) for x in inputs)
        assert all(isinstance(x, str) for y in inputs for x in y)
        if not clients or not nodes:
            raise ParseError("missing client or node logs")

        # Torn-line tolerance: sanitize every log up front (skip-and-
        # count).  Non-strict mode — the default — NEVER raises on a
        # malformed line; the count is surfaced as a parser note so a
        # torn-log run is visible, not silent.  strict_lines is for
        # tests that want to assert a log grammar regression loudly.
        self.malformed_lines = 0
        clients = [self._sanitize_log(x) for x in clients]
        nodes = [self._sanitize_log(x) for x in nodes]
        twins = [self._sanitize_log(x) for x in (twins or [])]
        if strict_lines and self.malformed_lines:
            raise ParseError(
                f"{self.malformed_lines} malformed log line(s) "
                "(strict_lines mode)")

        self.faults = faults
        # graftwan: the WAN spec snapshot the run was shaped under and
        # the SLO table chaos recovery is judged against (None = default
        # table; both ride in from logs/*.json via process()).
        self.wan = wan
        self.slos = slos
        # graftchaos: executed fault events (PlanRunner.events shape).
        # Scripted faults change what counts as a client failure — a
        # client pinned to a replica the plan killed dies with it, which
        # is the fault model working, not a broken bench.  The tolerance
        # is scoped tightly: only as many client deaths as the plan has
        # DISTINCT killed/paused replicas; any further failure is a real
        # bug and still fatal.
        self.chaos_events = chaos_events
        self.chaos = None
        # Strictness rides with chaos mode: a scripted run (incl. surge
        # overload scenarios) must satisfy the recovery/fairness
        # assertions; a plain bench is merely described.
        self._strict_chaos = bool(strict_chaos)
        from ..chaos.plan import cascade_k

        self._tolerable_client_deaths = len({
            e.get("target") for e in (chaos_events or ())
            if e.get("action") in ("kill", "pause")
            and str(e.get("target", "")).startswith("node:")
        }) + sum(
            # graftview: a leader-cascade kills up to k replicas chosen
            # at runtime — their clients die with them, which is the
            # fault model working (same scoped tolerance as node kills).
            cascade_k(e.get("params")) for e in (chaos_events or ())
            if e.get("target") == "leader-cascade")
        # Free-form annotations appended to the CONFIG section of the
        # summary (e.g. the harness marking a degraded host-crypto run,
        # or the sidecar's verifysched telemetry).  Extra lines are
        # invisible to the frozen result-grammar parsers, which match
        # labelled fields only.
        self.notes = []
        # grafttrace: the critical-path summary (note_trace) and the
        # sampled metrics time series (note_metrics) land here for
        # bench.py's machine-readable round trip.  graftscope adds the
        # per-replica node series accounting (hosts + divergence).
        self.trace = None
        self.metrics = None
        self.node_metrics = None
        # graftcadence: the OP_STATS ``cadence`` section (ring tick
        # rate, occupancy, pad-fill, generation drops, queue waits)
        # lands here machine-readable for bench.py's round trip.
        self.cadence = None
        # graftingress: the OP_STATS ``ingress`` bulk-lane feed mix
        # (ingress-fed vs offchain-fed), machine-readable for bench.py.
        self.sidecar_ingress = None
        # graftfleet: cross-tenant verdict-cache dedup, the per-tenant
        # scheduler section, the node-side failover evidence, and the
        # greedy-flood verdict — all machine-readable for bench.py.
        self.sidecar_dedup = None
        self.sidecar_tenants = None
        self.failover = None
        self.tenant_flood = None
        if self.malformed_lines:
            self.notes.append(
                f"Parser: skipped {self.malformed_lines} torn/malformed "
                "log line(s) (concurrent writers)")
        if isinstance(faults, int):
            self.committee_size = len(nodes) + int(faults)
        else:
            self.committee_size = "?"

        try:
            results = [self._parse_client(x) for x in clients]
        except (ValueError, IndexError, AttributeError) as e:
            raise ParseError(f"Failed to parse client logs: {e}")
        self.size, self.rate, self.start, misses, self.sent_samples, \
            client_ingress = zip(*results)
        self.misses = sum(misses)

        try:
            results = [self._parse_node(x) for x in nodes]
        except (ValueError, IndexError, AttributeError) as e:
            raise ParseError(f"Failed to parse node logs: {e}")
        proposals, commits, sizes, self.received_samples, timeouts, \
            configs, views, viewchanges, node_ingress = zip(*results)
        self.proposals = self._merge_earliest(proposals)
        self.commits = self._merge_earliest(commits)
        self.sizes = {
            k: v for x in sizes for k, v in x.items() if k in self.commits
        }
        self.timeouts = max(timeouts)
        self.configs = configs
        # graftview: aggregated view-change evidence — TCs formed (by
        # round, so every replica completing the same quorum counts
        # once), TC-driven round transitions with the largest jump, and
        # the robustness counters (ejected bad signers, dropped
        # future-round floods).  Machine-readable on self.viewchange;
        # the note makes a storm-surviving run read as exactly that.
        self.viewchange = self._aggregate_viewchange(viewchanges)
        vc = self.viewchange
        if vc["tc_rounds"] or vc["transitions"]:
            rounds = ", ".join(str(r) for r in vc["tc_rounds"][:8])
            if len(vc["tc_rounds"]) > 8:
                rounds += ", ..."
            formed = f"TC formed for {len(vc['tc_rounds'])} round(s)"
            if rounds:
                formed += f" ({rounds})"
            self.notes.append(
                f"View change: {formed}; {vc['transitions']} TC round "
                f"transition(s), max jump {vc['max_jump']} round(s)")
        if vc["ejected"]:
            self.notes.append(
                f"View change: {vc['ejected']} invalid timeout "
                "signer(s) ejected by batched TC verify")
        if vc["dropped_future"]:
            self.notes.append(
                f"View change: {vc['dropped_future']} future-round "
                "timeout(s) dropped beyond the aggregation horizon")

        # Twins: logs of equivocating replicas (same key as an honest
        # node, own ports).  Parsed ONLY for their commit views — an
        # adversarial replica's metrics/errors are its own business —
        # and folded into the safety assertion below: their commits must
        # agree with (or be behind) the honest committee's, never fork
        # it.  Twin commits stay OUT of self.commits: a shadow replica
        # must not move throughput/latency numbers.
        self.twins = list(twins or [])
        self._commit_views = list(views) + \
            [self._parse_commit_view(log) for log in self.twins]
        self._check_safety()
        if self.twins:
            self.notes.append(
                f"Twins: {len(self.twins)} equivocating replica(s) "
                "active; safety held (no conflicting commits)")

        if self.misses != 0:
            Print.warn(
                f"Clients missed their target rate {self.misses:,} time(s)")
        # Nodes are expected to time out once at the beginning at most;
        # scripted faults legitimately add a view change per event, so a
        # chaos plan raises the allowance by its event count rather than
        # silencing the check.
        if self.timeouts > 2 + len(self.chaos_events or ()):
            Print.warn(f"Nodes timed out {self.timeouts:,} time(s)")

        # Sidecar circuit-breaker transitions (native/crypto/sidecar_client
        # logs them at WARN/INFO): surfaced as CONFIG notes so a run that
        # silently spent its window on host verify is visible in the
        # summary.
        opens = sum(len(findall(r"circuit breaker OPEN", log))
                    for log in nodes)
        closes = sum(len(findall(r"circuit breaker CLOSED", log))
                     for log in nodes)
        if opens or closes:
            self.notes.append(
                f"Sidecar circuit breaker: {opens} open / "
                f"{closes} re-attach transition(s)")

        # graftfleet failover evidence (native/crypto/sidecar_client
        # fleet ladder): sticky-endpoint re-homes, in-flight resubmits,
        # and the protocol-v6 HELLO accepts per endpoint.  Surfaced so a
        # run that survived a fleet-member kill reads as exactly that;
        # machine-readable on self.failover for the strict drill check
        # in note_chaos_events and bench.py's round trip.
        rehomes = sum(len(findall(
            r"sidecar failover: endpoint \d+ unhealthy, "
            r"re-homed to endpoint \d+", log)) for log in nodes)
        resubmits = sum(len(findall(
            r"sidecar failover: endpoint \d+ failed in flight, "
            r"resubmitting to endpoint \d+", log)) for log in nodes)
        hellos = [(int(ix), tenant) for log in nodes for ix, tenant in
                  findall(r"HELLO accepted by endpoint (\d+): "
                          r"tenant (\S+) \(protocol v\d+\)", log)]
        if rehomes or resubmits or hellos:
            self.failover = {
                "rehomes": rehomes,
                "resubmits": resubmits,
                "hello_accepts": len(hellos),
                "endpoints": sorted({ix for ix, _ in hellos}),
                "tenants": sorted({t for _, t in hellos}),
            }
            parts = [f"{rehomes} re-home(s)", f"{resubmits} in-flight "
                     "resubmit(s)"]
            if hellos:
                parts.append(
                    f"{len(hellos)} HELLO accept(s) across endpoint(s) "
                    + ", ".join(str(i) for i in self.failover["endpoints"])
                    + " (tenant "
                    + ", ".join(self.failover["tenants"]) + ")")
            self.notes.append("Sidecar fleet: " + "; ".join(parts))

        # graftsurge overload evidence: the node's bounded ingress logs
        # watermark crossings, and clients log (rate-limited) BUSY
        # backoffs.  Surfaced so an overloaded-but-surviving run reads
        # as exactly that, not as a quiet healthy one.
        pauses = sum(len(findall(r"Ingress paused", log)) for log in nodes)
        resumes = sum(len(findall(r"Ingress resumed", log))
                      for log in nodes)
        busy_lines = sum(len(findall(r"Node busy \(retry-after", log))
                         for log in clients)
        if pauses or resumes or busy_lines:
            self.notes.append(
                f"Ingress backpressure: {pauses} receiver pause(s) / "
                f"{resumes} resume(s); clients logged {busy_lines} busy "
                "backoff line(s)")

        # graftingress: signed-ingress accounting + the two assertions
        # that make a forgery-mix run meaningful — ALWAYS strict, chaos
        # plan or not: (a) zero forged txs may reach a sealed batch on a
        # verify-ingress run; (b) multi-process client shards must share
        # the offered load fairly (open-loop shards at equal rates that
        # diverge wildly mean a shard starved or died silently).
        self.ingress = self._aggregate_ingress(client_ingress,
                                               node_ingress)
        ing = self.ingress
        if ing["verify_on"] and ing["forged_committed"]:
            raise ParseError(
                f"{ing['forged_committed']} forged transaction(s) "
                "reached a sealed batch on a verify-ingress run — the "
                "admission-verify stage admitted a forgery")
        if ing["shards"] >= 2:
            sent = ing["shard_sent"]
            if sent and min(sent) < 0.25 * max(sent):
                raise ParseError(
                    "client shard fairness violated: per-shard sent "
                    f"totals {sent} diverge beyond 4x (a shard starved "
                    "or died silently)")
            self.notes.append(
                f"Client shards: {ing['shards']} process(es), sent "
                + ", ".join(f"{s:,}" for s in sent) + " tx")
        if ing["signed"]:
            self.notes.append(
                f"Signed ingress: {ing['verified']:,} tx admission-"
                f"verified; clients sent {ing['forged_sent']:,}+ forged "
                f"({ing['forge_pct']:g}% mix), nodes rejected "
                f"{ing['forged_rejected']:,} at admission, "
                f"{ing['busy_shed']:,} shed busy, "
                f"{ing['forged_committed']} committed")

        if self.wan is not None:
            self.note_wan(self.wan)
        if self.chaos_events is not None:
            self.note_chaos_events(self.chaos_events, strict=strict_chaos,
                                   slos=self.slos)

    # -- parsing -------------------------------------------------------------

    def _sanitize_log(self, log: str) -> str:
        """Drop (and count) lines outside the frozen log grammar.  The
        regex miners below would mostly skip garbage anyway; the fatal
        checks (`` ERROR ``, ``panic``) and the labelled config
        ``search()``es are what a torn fragment could corrupt.  C++
        runtime-abort output (libstdc++'s ``terminate called ...``) is
        printed with NO log prefix, so it is explicitly kept — dropping
        it would let ``_parse_node``'s crash check parse a dead replica
        as a clean run."""
        good = []
        for line in log.splitlines():
            if not line.strip():
                continue
            if _WELL_FORMED_LINE.match(line) or \
                    search(r"terminate called|panic", line) is not None:
                good.append(line)
            else:
                self.malformed_lines += 1
        return "\n".join(good) + ("\n" if good else "")

    @staticmethod
    def _merge_earliest(dicts):
        merged = {}
        for d in dicts:
            for k, v in d.items():
                if k not in merged or merged[k] > v:
                    merged[k] = v
        return merged

    @staticmethod
    def _to_posix(ts):
        return datetime.fromisoformat(ts.replace("Z", "+00:00")).timestamp()

    def _parse_client(self, log):
        # Fatal client conditions in the C++ grammar: any ERROR-level line,
        # or the send-failure WARN that precedes client exit
        # (native/src/node/client.cpp).  Under a chaos plan a client
        # pinned to a murdered/paused replica dies WITH its replica —
        # that is the fault model, not a broken bench — so the failure is
        # tolerated and noted instead (the committee metrics come from
        # the surviving logs).
        if search(r" ERROR ", log) is not None or \
                search(r"Failed to send transaction", log) is not None:
            if self._tolerable_client_deaths <= 0:
                raise ParseError("Client(s) failed")
            self._tolerable_client_deaths -= 1
            self.notes.append(
                "Chaos: a client died with its faulted replica "
                "(send failure tolerated under the fault plan)")

        size = int(search(r"Transactions size: (\d+)", log).group(1))
        rate = int(search(r"Transactions rate: (\d+)", log).group(1))
        start = self._to_posix(search(r"\[(.*Z) .* Start ", log).group(1))
        misses = len(findall(r"rate too high", log))
        samples = {
            int(s): self._to_posix(t)
            for t, s in findall(r"\[(.*Z) .* sample transaction (\d+)", log)
        }
        # graftingress accounting: all OPTIONAL (legacy unsigned logs
        # parse exactly as before).  The forged/sent counters are
        # cumulative in the log lines, so the per-log total is the max.
        m = search(r"Signed ingress enabled \(seed \d+, forge ([0-9.]+)%, "
                   r"user offset (\d+), sample offset (\d+)\)", log)
        ingress = {
            "signed": m is not None,
            "forge_pct": float(m.group(1)) if m else 0.0,
            "user_offset": int(m.group(2)) if m else 0,
            "sample_offset": int(m.group(3)) if m else 0,
            "forged_sent": max(
                (int(n) for n in findall(
                    r"Forged transaction sent \((\d+) total\)", log)),
                default=0),
            "sent": max(
                (int(n) for n in findall(
                    r"Sent (\d+) transactions", log)),
                default=0),
        }
        return size, rate, start, misses, samples, ingress

    def _parse_node(self, log):
        # Fatal node conditions: ERROR-level lines (uncaught exceptions,
        # bind failures, store corruption — native/src/node/main.cpp) or a
        # C++ runtime abort message.
        if search(r" ERROR ", log) is not None or \
                search(r"terminate called|panic", log) is not None:
            raise ParseError("Node(s) failed")

        # Earliest occurrence wins even within one log (a digest can be
        # re-proposed after a fallthrough round).
        proposals = {}
        for t, d in findall(r"\[(.*Z) .* Created B\d+ -> ([^ ]+=)", log):
            ts = self._to_posix(t)
            if d not in proposals or proposals[d] > ts:
                proposals[d] = ts
        commits = {}
        for t, d in findall(r"\[(.*Z) .* Committed B\d+ -> ([^ ]+=)", log):
            ts = self._to_posix(t)
            if d not in commits or commits[d] > ts:
                commits[d] = ts
        sizes = {
            d: int(s)
            for d, s in findall(r"Batch ([^ ]+) contains (\d+) B", log)
        }
        samples = {
            int(s): d
            for d, s in findall(r"Batch ([^ ]+) contains sample tx (\d+)",
                                log)
        }
        timeouts = len(findall(r".* WARN .* Timeout reached", log))

        # graftview evidence in the frozen log grammar (core.cpp
        # finish_tc/handle_tc/resolve_tc_batch/handle_timeout; "change
        # both sides together").  "Dropped N ..." lines carry CUMULATIVE
        # counts, so the per-log total is the max, not the sum.
        viewchange = {
            "tcs": [(int(r), int(n)) for r, n in findall(
                r"Formed TC for round (\d+) \((\d+) timeouts", log)],
            "jumps": [(int(a), int(b)) for a, b in findall(
                r"View change: round (\d+) -> (\d+) via TC", log)],
            "ejected": sum(int(n) for n in findall(
                r"Ejected (\d+) invalid timeout signer", log)),
            "dropped_future": max(
                (int(n) for n in findall(
                    r"Dropped (\d+) future-round timeout", log)),
                default=0),
        }

        configs = {
            "consensus": {
                "timeout_delay": int(
                    search(r"Timeout delay .* (\d+)", log).group(1)),
                "sync_retry_delay": int(
                    search(r"consensus.* Sync retry delay .* (\d+)",
                           log).group(1)),
            },
            "mempool": {
                "gc_depth": int(
                    search(r"Garbage collection .* (\d+)", log).group(1)),
                "sync_retry_delay": int(
                    search(r"mempool.* Sync retry delay .* (\d+)",
                           log).group(1)),
                "sync_retry_nodes": int(
                    search(r"Sync retry nodes .* (\d+)", log).group(1)),
                "batch_size": int(
                    search(r"Batch size .* (\d+)", log).group(1)),
                "max_batch_delay": int(
                    search(r"Max batch delay .* (\d+)", log).group(1)),
            },
        }
        # graftview pacemaker knobs: OPTIONAL (logs predating the
        # backoff pacemaker stay parseable) — present only when the node
        # logged them.
        for key, pattern in (
                ("timeout_backoff_factor_pct",
                 r"Timeout backoff factor set to (\d+)"),
                ("timeout_backoff_cap",
                 r"Timeout backoff cap set to (\d+)"),
                ("timeout_jitter_pct", r"Timeout jitter set to (\d+)"),
                ("timeout_future_horizon",
                 r"Timeout future horizon set to (\d+)")):
            m = search(pattern, log)
            if m:
                configs["consensus"][key] = int(m.group(1))
        # graftingress: admission-verify evidence, all OPTIONAL (logs
        # from unsigned runs parse exactly as before).  Rejection totals
        # are cumulative in the WARN line, so max per log; verified
        # totals ride the METRICS suffix (max per log, trace runs only).
        m = search(r"Ingress signature verification enabled with batch "
                   r"(\d+)", log)
        if m:
            configs["mempool"]["verify_batch"] = int(m.group(1))
        ingress = {
            "verify_on": m is not None,
            "forged_committed": len(findall(r"contains forged tx", log)),
            "forged_rejected": max(
                (int(n) for n in findall(
                    r"forged transaction\(s\) at ingress admission "
                    r"\((\d+) total\)", log)),
                default=0),
            "verified": max(
                (int(n) for n in findall(r"METRICS .* verified=(\d+)",
                                         log)),
                default=0),
            "busy_shed": max(
                (int(n) for n in findall(
                    r"Admission verify busy; shed .* \((\d+) total\)",
                    log)),
                default=0),
        }
        return proposals, commits, sizes, samples, timeouts, configs, \
            self._parse_commit_view(log), viewchange, ingress

    @staticmethod
    def _parse_commit_view(log):
        """``{height: {digests committed at that height}}`` for one log —
        the per-replica commit view the safety assertion compares.
        Lenient by design (no error/config checks): it also parses the
        logs of Twins replicas, whose own health is irrelevant."""
        view = {}
        for h, d in findall(r"Committed B(\d+) -> ([^ ]+=)", log):
            view.setdefault(int(h), set()).add(d)
        return view

    def _check_safety(self):
        """STRICT safety assertion: no two logs may commit conflicting
        blocks at the same height.  Every pair of commit views (honest
        nodes AND twins) is compared per height: the digest sets must be
        equal — or one a subset of the other, which teardown killing a
        node mid-write legitimately produces.  (A digest appearing at
        two DIFFERENT heights is payload duplication from re-proposal,
        not a fork, and stays out of this check.)

        Equivocation (Twins) must be CONTAINED — absorbed into one
        agreed chain — not merely survived; any violation is a hard
        ParseError, chaos plan or not."""
        by_height = {}
        for li, view in enumerate(self._commit_views):
            for h, digests in view.items():
                by_height.setdefault(h, []).append((li, digests))
        violations = []
        for h, entries in sorted(by_height.items()):
            for i in range(len(entries)):
                for j in range(i + 1, len(entries)):
                    a, b = entries[i][1], entries[j][1]
                    if not (a <= b or b <= a):
                        violations.append(
                            f"height {h}: log {entries[i][0]} committed "
                            f"{sorted(x[:12] + '...' for x in a - b)} but "
                            f"log {entries[j][0]} committed "
                            f"{sorted(x[:12] + '...' for x in b - a)}")
        if violations:
            raise ParseError(
                "SAFETY VIOLATION — conflicting commits: "
                + "; ".join(violations[:5]))

    @staticmethod
    def _aggregate_viewchange(viewchanges) -> dict:
        """Committee-wide view-change summary from the per-log mining:
        TC rounds deduped (every replica completing the same quorum
        logs its own "Formed TC"), transitions counted raw (each
        replica pays its own round jump), ejections summed, cumulative
        future-drop counters summed across replicas."""
        tc_rounds = sorted({r for vc in viewchanges for r, _ in vc["tcs"]})
        jumps = [b - a for vc in viewchanges for a, b in vc["jumps"]]
        return {
            "tc_rounds": tc_rounds,
            "tcs_formed": sum(len(vc["tcs"]) for vc in viewchanges),
            "transitions": len(jumps),
            "max_jump": max(jumps, default=0),
            "ejected": sum(vc["ejected"] for vc in viewchanges),
            "dropped_future": sum(
                vc["dropped_future"] for vc in viewchanges),
        }

    @staticmethod
    def _aggregate_ingress(client_ingress, node_ingress) -> dict:
        """Run-wide signed-ingress summary from the per-log mining.
        Client forged/sent counters are cumulative per log (already
        max-reduced), so the run totals are sums; shard mode is
        detected by >= 2 clients carrying disjoint sample-id offsets.
        ``forged_sent`` undercounts by at most one forge-log interval
        per client (the line is rate-limited)."""
        shard_clients = [c for c in client_ingress
                         if c["signed"] or c["sample_offset"]]
        offsets = {c["sample_offset"] for c in shard_clients}
        shards = len(shard_clients) if len(offsets) >= 2 else 0
        return {
            "signed": any(c["signed"] for c in client_ingress),
            "verify_on": any(n["verify_on"] for n in node_ingress),
            "forge_pct": max(
                (c["forge_pct"] for c in client_ingress), default=0.0),
            "forged_sent": sum(c["forged_sent"] for c in client_ingress),
            "sent": sum(c["sent"] for c in client_ingress),
            "shards": shards,
            "shard_sent": [c["sent"] for c in shard_clients]
            if shards else [],
            "verified": sum(n["verified"] for n in node_ingress),
            "forged_rejected": sum(
                n["forged_rejected"] for n in node_ingress),
            "busy_shed": sum(n["busy_shed"] for n in node_ingress),
            "forged_committed": sum(
                n["forged_committed"] for n in node_ingress),
        }

    # -- metrics -------------------------------------------------------------

    def _tx_bytes(self):
        return self.size[0] + PUBLICKEY_LENGTH + SIGNATURE_LENGTH

    def _window_tps(self, t0: float, t1: float) -> float:
        """Committed tx/s over the wall-clock window [t0, t1)."""
        if t1 <= t0:
            return 0.0
        byte_total = sum(self.sizes.get(d, 0)
                         for d, c in self.commits.items()
                         if t0 <= c < t1)
        return byte_total / self._tx_bytes() / (t1 - t0)

    def _consensus_throughput(self):
        if not self.commits:
            return 0, 0, 0
        start = min(self.proposals.values())
        end = max(self.commits.values())
        duration = end - start
        byte_total = sum(self.sizes.values())
        bps = byte_total / duration if duration else 0
        tps = bps / self._tx_bytes()
        return tps, bps, duration

    def _consensus_latency(self):
        latency = [
            c - self.proposals[d]
            for d, c in self.commits.items()
            if d in self.proposals
        ]
        return mean(latency) if latency else 0

    def _end_to_end_throughput(self):
        if not self.commits:
            return 0, 0, 0
        start = min(self.start)
        end = max(self.commits.values())
        duration = end - start
        byte_total = sum(self.sizes.values())
        bps = byte_total / duration if duration else 0
        tps = bps / self._tx_bytes()
        return tps, bps, duration

    def _end_to_end_latency(self):
        latency = []
        for sent, received in zip(self.sent_samples, self.received_samples):
            for tx_id, batch_id in received.items():
                if batch_id in self.commits and tx_id in sent:
                    latency.append(self.commits[batch_id] - sent[tx_id])
        return mean(latency) if latency else 0

    def result(self):
        consensus_latency = self._consensus_latency() * 1000
        consensus_tps, consensus_bps, _ = self._consensus_throughput()
        end_to_end_tps, end_to_end_bps, duration = \
            self._end_to_end_throughput()
        end_to_end_latency = self._end_to_end_latency() * 1000
        cfg = self.configs[0]
        batch_size = cfg["mempool"]["batch_size"]
        tx_bytes = self._tx_bytes()
        mean_block = (
            round(mean(self.sizes.values()) / tx_bytes, 2)
            if self.sizes else 0)
        return (
            "\n"
            "-----------------------------------------\n"
            " SUMMARY:\n"
            "-----------------------------------------\n"
            " + CONFIG:\n"
            f" Faults: {self.faults} nodes\n"
            f" Committee size: {self.committee_size} nodes\n"
            f" Input rate: {sum(self.rate):,} tx/s\n"
            f" Transaction size: {self.size[0]:,} B\n"
            f" Execution time: {round(duration):,} s\n"
            "\n"
            f" Consensus timeout delay: "
            f"{cfg['consensus']['timeout_delay']:,} ms\n"
            f" Consensus sync retry delay: "
            f"{cfg['consensus']['sync_retry_delay']:,} ms\n"
            f" Mempool GC depth: {cfg['mempool']['gc_depth']:,} rounds\n"
            f" Mempool sync retry delay: "
            f"{cfg['mempool']['sync_retry_delay']:,} ms\n"
            f" Mempool sync retry nodes: "
            f"{cfg['mempool']['sync_retry_nodes']:,} nodes\n"
            f" Mempool batch size: {batch_size:,} B\n"
            f" Mempool max batch delay: "
            f"{cfg['mempool']['max_batch_delay']:,} ms\n"
            + "".join(f" {note}\n" for note in self.notes) +
            "\n"
            " + RESULTS:\n"
            f" Consensus TPS: {round(consensus_tps):,} tx/s\n"
            f" Consensus BPS: {round(consensus_bps):,} B/s\n"
            f" Consensus latency: {round(consensus_latency):,} ms\n"
            "\n"
            f" End-to-end TPS: {round(end_to_end_tps):,} tx/s\n"
            f" End-to-end BPS: {round(end_to_end_bps):,} B/s\n"
            f" End-to-end latency: {round(end_to_end_latency):,} ms\n"
            "\n"
            f" Max transactions per block: "
            f"{round(batch_size / tx_bytes)} tx/block\n"
            f" Actual transactions per block: {mean_block} tx/block\n"
            f" Blocks per second: "
            f"{round(len(self.sizes) / duration) if duration > 0 else 0} "
            "blocks/s\n"
            "-----------------------------------------\n"
        )

    def note_sidecar_stats(self, stats: dict):
        """Fold a verifysched OP_STATS snapshot (sidecar/sched/stats.py
        schema) into the summary's CONFIG notes — label-free lines, so
        the frozen result grammar never sees them.  Telemetry is
        best-effort: a snapshot with hostile value types (a
        version-skewed sidecar, a writer cut off mid-dump) adds no
        notes at all rather than raising or leaving a partial block."""
        if not isinstance(stats, dict) or not stats.get("launches"):
            return
        # Strict fairness (graftsurge) FIRST, before any cosmetic note
        # formatting: under a scripted run, shedding a latency-class
        # (consensus) request while bulk slipped past the
        # bulk-before-latency gate is a policy regression, not weather —
        # and the assertion must not depend on sibling telemetry keys
        # formatting cleanly.
        surge = stats.get("surge")
        if self._strict_chaos and isinstance(surge, dict):
            violations = surge.get("fairness_violations")
            if isinstance(violations, (int, float)) and violations:
                raise ParseError(
                    f"surge fairness violated: {violations:g} bulk "
                    "request(s) admitted while the latency class was "
                    "shedding (bulk-before-latency)")
            # graftfleet: the DRR rotation's strict invariant — a
            # backlogged tenant passed over a full quantum rotation is
            # a scheduler bug, never weather.
            starvation = surge.get("tenant_starvation")
            if isinstance(starvation, (int, float)) and starvation:
                raise ParseError(
                    f"tenant fairness violated: {starvation:g} tenant "
                    "starvation event(s) (a backlogged tenant was "
                    "passed over a full DRR rotation)")
        lines = []
        # graftfleet: a per-endpoint snapshot (sidecar-stats-<i>.json)
        # prefixes its lines so a fleet teardown reads per member.
        endpoint = stats.get("_endpoint")
        # grafttrace fallback marker: the harness could not reach the
        # sidecar at teardown (chaos-killed before the final fetch) and
        # substituted the periodic sampler's last good snapshot — say
        # so, instead of letting sampled numbers masquerade as final.
        sampled_at = stats.get("_from_sample_at")
        if isinstance(sampled_at, (int, float)):
            ts = datetime.utcfromtimestamp(sampled_at).strftime(
                "%Y-%m-%dT%H:%M:%SZ")
            lines.append(f"Sidecar stats from last sample @ {ts} "
                         "(sidecar unreachable at teardown)")
        try:
            by_class = stats.get("launches_by_class", {})
            lines.append(
                f"Sidecar launches: {stats['launches']:,} "
                f"(latency {by_class.get('latency', 0):,}, "
                f"bulk {by_class.get('bulk', 0):,})")
            paths = stats.get("paths", {})
            if paths:
                lines.append("Sidecar verify paths: " + ", ".join(
                    f"{k}={v:,}" for k, v in sorted(paths.items())))
            waits = stats.get("queue_wait", {})
            if waits:
                lines.append("Sidecar queue wait: " + ", ".join(
                    f"{cls} p50 {w.get('p50_ms', 0)} ms / "
                    f"p99 {w.get('p99_ms', 0)} ms"
                    for cls, w in sorted(waits.items()) if w.get("n")))
            lines.append(
                f"Sidecar pad fill: {stats.get('bulk_fill_sigs', 0):,} "
                f"sigs (waste {stats.get('pad_waste_sigs', 0):,})")
            mesh = stats.get("mesh", {})
            if mesh.get("sharded_launches"):
                hist = ", ".join(
                    f"{k}x{v:,}" for k, v in
                    sorted(mesh.get("shard_buckets", {}).items(),
                           key=lambda kv: int(kv[0])))
                lines.append(
                    f"Sidecar mesh launches: "
                    f"{mesh['sharded_launches']:,}"
                    + (f" (per-shard buckets {hist})" if hist else ""))
            # graftscale: bulk backlogs drained as ONE chunked
            # whole-backlog mesh scan, with the per-launch_cap ladder
            # dispatches the old path would have paid.
            scan = stats.get("scan", {})
            if scan.get("launches"):
                hist = ", ".join(
                    f"{k}x{v:,}" for k, v in
                    sorted(scan.get("chunk_hist", {}).items(),
                           key=lambda kv: int(kv[0])))
                lines.append(
                    f"Sidecar whole-backlog scans: "
                    f"{scan['launches']:,} "
                    f"({scan.get('sigs', 0):,} sigs"
                    + (f", chunks {hist}" if hist else "")
                    + f"), {scan.get('slices_avoided', 0):,} "
                    "slice(s) avoided")
            pipe = stats.get("pipeline", {})
            if pipe.get("pack_ms"):
                lines.append(
                    f"Sidecar pack overlap: "
                    f"{pipe.get('overlap_ratio', 0.0):.0%} of "
                    f"{pipe['pack_ms']:g} ms packing hidden behind "
                    "device execution")
            comp = stats.get("compile", {})
            if isinstance(comp, dict) and \
                    (comp.get("hits") or comp.get("misses")):
                boot = "warm boot" if comp.get("warm_boot") else "cold boot"
                lines.append(
                    f"Sidecar compile cache: {comp.get('hits', 0)} "
                    f"hit(s), {comp.get('misses', 0)} miss(es) — {boot}, "
                    f"warmup {comp.get('warmup_wall_s', 0):g} s"
                    + (f" (kernel {comp['kernel']})"
                       if comp.get("kernel") else ""))
            # graftguard: wedged launches, crash-only reboots, and the
            # quarantine lane — a run that survived a hung device leg
            # must read as exactly that, never as a quiet healthy one.
            g = stats.get("guard", {})
            if isinstance(g, dict) and (g.get("wedges")
                                        or g.get("reboots")
                                        or g.get("poisoned_records")):
                lines.append(
                    f"Sidecar guard: {g.get('wedges', 0):,} wedge(s), "
                    f"{g.get('reboots', 0):,} crash-only reboot(s) "
                    f"(canary {g.get('canary_passes', 0)} pass(es) / "
                    f"{g.get('canary_failures', 0)} fail(s), last reboot "
                    f"{g.get('last_reboot_wall_s', 0):g} s); "
                    f"{g.get('suspect_records', 0):,} quarantined / "
                    f"{g.get('poisoned_records', 0):,} poisoned "
                    f"record(s); {g.get('host_fallback_records', 0):,} "
                    f"host-fallback verdict(s), "
                    f"{g.get('busy_replies', 0):,} BUSY")
                if not g.get("device_ok", True):
                    lines.append(
                        "Sidecar guard: device leg DOWN at teardown "
                        "(host path serving; canary never passed)")
            full = stats.get("queue_full", {})
            if any(full.values()):
                lines.append("Sidecar queue-full sheds: " + ", ".join(
                    f"{k}={v:,}" for k, v in sorted(full.items())))
            # graftfleet: cross-tenant verdict-cache dedup — a record
            # fanned out by two tenants' replicas is device-verified
            # once; the hit rate is the headline the fleet bench cites.
            dd = stats.get("dedup")
            if isinstance(dd, dict) and (dd.get("cache_hits")
                                         or dd.get("inbatch_hits")
                                         or dd.get("misses")):
                self.sidecar_dedup = dd
                lines.append(
                    f"Sidecar dedup: {dd.get('cache_hits', 0):,} cache "
                    f"hit(s) + {dd.get('inbatch_hits', 0):,} in-batch, "
                    f"{dd.get('misses', 0):,} miss(es) "
                    f"(hit rate {dd.get('hit_rate', 0.0):.0%})")
            # graftfleet: the per-tenant scheduler section — noted only
            # when the run was actually multi-tenant, so single-tenant
            # (default-only) summaries stay byte-stable.
            tns = stats.get("tenants")
            if isinstance(tns, dict) and tns and (
                    len(tns) > 1 or set(tns) != {"default"}):
                self.sidecar_tenants = tns
                parts = []
                for tenant, rec in sorted(tns.items()):
                    admitted = sum((rec.get("admitted") or {}).values())
                    shed = sum((rec.get("shed") or {}).values())
                    parts.append(f"{tenant} admitted {admitted:,}"
                                 + (f" / shed {shed:,}" if shed else ""))
                lines.append(f"Sidecar tenants ({len(tns)}): "
                             + "; ".join(parts))
            surge = stats.get("surge")
            if isinstance(surge, dict):
                lines.extend(self._surge_lines(surge))
            # graftingress: bulk-lane feed mix — how much of the bulk
            # lane the mempool admission-verify stage actually drove.
            ing = stats.get("ingress")
            if isinstance(ing, dict) and (ing.get("bulk_requests")
                                          or ing.get("offchain_requests")):
                self.sidecar_ingress = ing
                total = ing.get("bulk_sigs", 0) + \
                    ing.get("offchain_sigs", 0)
                share = ing.get("bulk_sigs", 0) / total if total else 0.0
                lines.append(
                    f"Sidecar bulk lane: {ing.get('bulk_requests', 0):,} "
                    f"ingress-fed request(s) "
                    f"({ing.get('bulk_sigs', 0):,} sigs, {share:.0%} of "
                    f"bulk), {ing.get('offchain_requests', 0):,} "
                    f"offchain-fed "
                    f"({ing.get('offchain_sigs', 0):,} sigs)")
            # graftcadence: a run served by the resident ring says so —
            # tick rate, pad-fill and generation accounting in the
            # CONFIG notes, the full section machine-readable on
            # self.cadence for bench.py's round trip.
            cad = stats.get("cadence")
            if isinstance(cad, dict) and cad.get("ticks"):
                self.cadence = cad
                gen = cad.get("generation", {})
                wait = cad.get("queue_wait", {})
                pad = cad.get("pad_fill", {})
                lines.append(
                    f"Sidecar cadence ring: depth {cad.get('depth', 0)}"
                    f"{'' if cad.get('enabled') else ' (FELL BACK TO STAGED)'}"
                    f", {cad['ticks']:,} tick(s) @ "
                    f"{cad.get('tick_rate_hz', 0):g} Hz "
                    f"({cad.get('dispatch_ticks', 0):,} dispatching), "
                    f"pad fill {pad.get('ratio', 0.0):.0%}, "
                    f"{gen.get('drops', 0):,} generation drop(s) / "
                    f"{gen.get('expiries', 0):,} expiry(ies), "
                    f"queue wait p50 {wait.get('p50_ms', 0)} ms / "
                    f"p99 {wait.get('p99_ms', 0)} ms")
        except (TypeError, ValueError, AttributeError):
            return
        if isinstance(endpoint, str) and endpoint:
            lines = [f"[{endpoint}] {line}" for line in lines]
        self.notes.extend(lines)

    # graftfleet: the greedy-flood latency bound — the victim tenant's
    # latency-class queue-wait p99 may grow at most this factor across
    # the flood window before strict mode calls it an isolation failure.
    TENANT_FLOOD_WAIT_FACTOR = 2.0

    def note_tenant_flood(self, pre: dict, post: dict, victim: str,
                          strict: bool = False):
        """graftfleet greedy-tenant flood verdict: compare the victim
        tenant's latency-class queue-wait p99 between the pre-flood and
        post-flood OP_STATS snapshots, and hold the starvation
        invariant.  Strict mode (the scripted drill) raises ParseError
        when isolation failed; otherwise the verdict is a note.  The
        machine-readable verdict lands on ``self.tenant_flood``."""
        def _p99(stats):
            rec = (stats.get("tenants") or {}).get(victim) or {}
            wait = (rec.get("queue_wait") or {}).get("latency") or {}
            return wait.get("p99_ms"), wait.get("n", 0)

        try:
            starvation = (post.get("surge") or {}).get(
                "tenant_starvation", 0) or 0
            pre_p99, pre_n = _p99(pre)
            post_p99, post_n = _p99(post)
        except (TypeError, ValueError, AttributeError):
            return
        verdict = {"victim": victim, "starvation": starvation,
                   "pre_p99_ms": pre_p99, "post_p99_ms": post_p99,
                   "judged": bool(pre_n and post_n
                                  and isinstance(pre_p99, (int, float))
                                  and isinstance(post_p99, (int, float))
                                  and pre_p99 > 0),
                   "ok": True}
        if starvation:
            verdict["ok"] = False
            verdict["reason"] = (f"{starvation:g} tenant starvation "
                                 "event(s)")
        elif verdict["judged"] and \
                post_p99 > self.TENANT_FLOOD_WAIT_FACTOR * pre_p99:
            verdict["ok"] = False
            verdict["reason"] = (
                f"victim queue-wait p99 {post_p99:g} ms exceeds "
                f"{self.TENANT_FLOOD_WAIT_FACTOR:g}x pre-flood "
                f"{pre_p99:g} ms")
        self.tenant_flood = verdict
        if verdict["ok"]:
            bound = (f"p99 {post_p99:g} ms vs pre-flood {pre_p99:g} ms"
                     if verdict["judged"] else "not judged (no samples)")
            self.notes.append(
                f"Tenant flood: victim {victim} isolated ({bound}; "
                "0 starvation events)")
        else:
            self.notes.append(
                f"Tenant flood: isolation FAILED ({verdict['reason']})")
            if strict:
                raise ParseError(
                    "tenant isolation violated under greedy flood: "
                    + verdict["reason"])

    @staticmethod
    def _surge_lines(surge: dict) -> list:
        """CONFIG-note lines for the OP_STATS ``surge`` section."""
        lines = []
        shed = surge.get("shed", {})
        admitted = surge.get("admitted", {})
        if any(shed.values()) or any(admitted.values()):
            fair = "bulk-before-latency held" \
                if not surge.get("fairness_violations") else \
                f"{surge['fairness_violations']} fairness VIOLATION(S)"
            lines.append(
                "Sidecar surge: admitted "
                + ", ".join(f"{k}={v:,}"
                            for k, v in sorted(admitted.items()))
                + "; shed "
                + ", ".join(f"{k}={v:,}" for k, v in sorted(shed.items()))
                + f" ({fair})")
        if surge.get("tenant_starvation"):
            # Should never fire (strict mode already raised); the note
            # keeps a non-strict re-parse honest about it.
            lines.append(
                f"Sidecar tenant starvation: "
                f"{surge['tenant_starvation']:,} event(s) — DRR "
                "invariant VIOLATED")
        derate = surge.get("derate", {})
        if derate.get("engagements"):
            lines.append(
                f"Sidecar surge derate: engaged {derate['engagements']} "
                f"time(s), factor {derate.get('factor', 1.0)} "
                f"(recent overlap {derate.get('overlap_recent')})")
        return lines

    def note_trace(self, summary: dict):
        """Fold the grafttrace critical-path summary (obs/trace.py
        critical_path + sidecar_breakdown shape) into the CONFIG notes
        and onto ``self.trace`` for bench.py's headline round trip.
        Best-effort like every telemetry note: a hostile summary adds
        nothing rather than raising."""
        if not isinstance(summary, dict):
            return
        try:
            segs = summary.get("segments") or {}
            from ..obs.trace import DEVICE_SEGMENT, SEGMENTS, TOTAL_SEGMENT

            parts = []
            for name in SEGMENTS + (DEVICE_SEGMENT, TOTAL_SEGMENT):
                entry = segs.get(name)
                if entry and entry.get("n"):
                    parts.append(f"{name} p50 {entry['p50_ms']:g} ms / "
                                 f"p99 {entry['p99_ms']:g} ms")
            if not parts:
                return
            self.trace = summary
            # graftscope join accounting: device time nested inside
            # verify is only as good as the fraction of blocks it
            # covers — say the rate next to the percentiles.
            join = summary.get("join") or {}
            join_part = ""
            if isinstance(join.get("rate"), (int, float)):
                join_part = (f", sidecar join {join['rate']:.0%} of "
                             f"{join.get('with_verify', 0)} verify-traced")
            self.notes.append(
                f"Commit critical path ({summary.get('blocks', 0)} "
                f"block(s), {summary.get('complete', 0)} fully traced"
                f"{join_part}): " + "; ".join(parts))
            sc = summary.get("sidecar") or {}
            sc_parts = [f"{stage} p50 {e['p50_ms']:g} ms / "
                        f"p99 {e['p99_ms']:g} ms"
                        for stage, e in sorted(sc.items())
                        if e.get("n") and stage in ("queue", "pack",
                                                    "device")]
            if sc_parts:
                self.notes.append("Sidecar stage latency: "
                                  + "; ".join(sc_parts))
        except (TypeError, ValueError, AttributeError, KeyError):
            self.trace = None
            return

    def note_metrics(self, samples, malformed: int = 0):
        """Fold the sampled metrics time series (obs/sampler.py JSONL)
        into the summary: the in-window sample count as a CONFIG note,
        and — under a chaos plan — the per-event recovery curve, so an
        SLO verdict cites "telemetry resumed N ms after the fault"
        rather than a single post-fault commit scalar.

        graftscope: the series may mix sidecar OP_STATS samples with the
        C++ node's per-replica METRICS records; everything that reasons
        about the SIDECAR (its sample count, recovery curves, the
        baseline SLO judge) sees only the sidecar sub-series — a node
        tick must never read as sidecar telemetry resuming — while the
        node records feed the replica commit-rate notes."""
        if not samples:
            return
        from ..obs import split_samples

        sidecar, node = split_samples(samples)
        try:
            self.metrics = samples
            self._note_node_metrics(node)
            if not sidecar:
                return
            ok = [s for s in sidecar if s.get("ok")]
            window = max(s["t"] for s in sidecar) - \
                min(s["t"] for s in sidecar)
            note = (f"Sidecar metrics: {len(sidecar)} sample(s) "
                    f"({len(ok)} ok) over {window:g} s")
            if malformed:
                note += f", {malformed} torn line(s) skipped"
            self.notes.append(note)
            if not self.chaos:
                return
            from ..chaos.recovery import event_label
            from ..obs import recovery_curve

            for e in self.chaos.get("events", []):
                wall = e.get("wall")
                if not isinstance(wall, (int, float)):
                    continue
                curve = recovery_curve(sidecar, wall)
                e["telemetry"] = curve
                label = f"Chaos {event_label(e)}"
                if curve["resumed"]:
                    self.notes.append(
                        f"{label}: telemetry resumed "
                        f"{curve['resume_ms']:g} ms after event "
                        f"({curve['failed_ticks']} failed tick(s))")
                else:
                    self.notes.append(
                        f"{label}: telemetry did NOT resume "
                        f"({curve['failed_ticks']} failed tick(s) after "
                        "event)")
        except (TypeError, ValueError, AttributeError, KeyError):
            return
        self._judge_metrics_recovery(sidecar)

    # Straggler threshold: a replica sampling below this fraction of the
    # committee's median commit rate diverges (graftscope; evidence, not
    # failure — strict mode is unaffected).
    COMMIT_RATE_DIVERGENCE = 0.7

    def _note_node_metrics(self, node_samples):
        """Per-replica METRICS notes: series count plus the commit-rate
        divergence (straggler) evidence.  Best-effort like every
        telemetry note."""
        if not node_samples:
            return
        try:
            from ..obs import commit_rate_divergence

            hosts = sorted({s["node"] for s in node_samples})
            self.notes.append(
                f"Node metrics: {len(node_samples)} sample(s) across "
                f"{len(hosts)} replica(s)")
            div = commit_rate_divergence(
                node_samples, threshold=self.COMMIT_RATE_DIVERGENCE)
            self.node_metrics = {"hosts": hosts, "divergence": div}
            for s in div["stragglers"]:
                self.notes.append(
                    f"Replica commit-rate divergence: {s['host']} at "
                    f"{s['ratio']:.0%} of committee median "
                    f"({s['rate']:g} vs {div['median']:g} commits/s)")
        except (TypeError, ValueError, AttributeError, KeyError):
            return

    def _judge_metrics_recovery(self, samples):
        """Metrics-driven recovery-to-baseline verdicts (graftsurge):
        the sampled throughput curve must RETURN to
        its pre-event baseline after every chaos event — the commit
        scalar proves liveness, this proves the system came back at
        strength.  Judged events that miss their class SLO fail the run
        under the strict chaos assertion; events without enough
        telemetry are surfaced as unjudged, never failed."""
        from ..chaos import judge_baseline_recovery

        if not self.chaos:
            return
        try:
            verdict = judge_baseline_recovery(
                samples, self.chaos.get("events", []), self.slos)
        except (TypeError, ValueError, KeyError, AttributeError):
            return
        self.chaos["slo_metrics"] = verdict
        for v in verdict["verdicts"]:
            label = f"Chaos SLO (baseline) {v['class']}"
            if not v["judged"]:
                self.notes.append(
                    f"{label}: not judged ({v.get('reason')})")
            elif v["ok"]:
                self.notes.append(
                    f"{label}: back to baseline in "
                    f"{v['recovered_ms']:g} ms PASS")
            else:
                self.notes.append(f"{label}: FAIL ({v.get('reason')})")
        if self._strict_chaos and not verdict["ok"]:
            raise ParseError(
                "metrics-driven recovery SLO breached: " + "; ".join(
                    f"{v['class']} ({v.get('reason')})"
                    for v in verdict["verdicts"] if not v["ok"]))

    def note_wan(self, wan: dict):
        """Fold the run's graftwan spec snapshot (logs/wan.json, the
        WanSpec.to_json shape) into the CONFIG notes so shaped numbers
        never masquerade as LAN numbers in the result files."""
        if not isinstance(wan, dict):
            return
        links = wan.get("links") or []
        parts = []
        for link in links:
            if not isinstance(link, dict):
                continue
            label = link.get("name") or \
                f"{link.get('src')}>{link.get('dst')}"
            shape = ", ".join(
                f"{k.split('_')[0]} {link[k]:g}"
                for k in ("latency_ms", "jitter_ms", "loss_pct",
                          "rate_mbit") if link.get(k))
            parts.append(f"{label} ({shape})" if shape else label)
        note = f"WAN: {len(links)} shaped link(s)"
        if parts:
            note += ": " + "; ".join(parts)
        if wan.get("default"):
            note += " + default shape"
        self.notes.append(note)

    def note_chaos_events(self, events, strict=False, slos=None):
        """Fold executed graftchaos events into the summary: per-fault
        recovery latency (first merged commit strictly after each event's
        wall stamp — chaos/recovery.py) as CONFIG notes,
        per-fault-class SLO verdicts (chaos/slo.py) as notes plus the
        machine-readable summary on ``self.chaos`` for bench.py's
        headline round trip.

        ``strict`` is the testbed's recovery assertion, now an SLO: a
        failed injection, ANY event with no commit after it, or a
        recovery slower than its fault class's SLO raises ParseError —
        commit progress must resume after every scripted fault *within
        budget* (plans are validated to leave the run-window headroom
        this needs; the table is logs/slo.json, else the defaults)."""
        from ..chaos import judge, summarize_recovery
        from ..chaos.recovery import event_label

        summary = summarize_recovery(events, self.commits.values())
        self.chaos = summary
        if summary["events"]:
            self.notes.append(
                f"Chaos plan: {len(summary['events'])} event(s), "
                f"max recovery {summary['max_recovery_ms']:g} ms")
        # graftsurge: goodput retained under each surge window, from the
        # committed-bytes timeline (the offered surge load itself rides
        # a separate generator whose log is outside the client glob).
        from ..chaos.plan import surge_window_s

        for e in summary["events"]:
            if e.get("action") != "surge" or e.get("wall") is None:
                continue
            dur = surge_window_s(e.get("params"))
            if dur <= 0:
                continue
            wall = float(e["wall"])
            before = self._window_tps(wall - dur, wall)
            during = self._window_tps(wall, wall + dur)
            e["goodput"] = {"before_tps": round(before, 1),
                            "during_tps": round(during, 1)}
            if before > 0:
                retained = during / before
                e["goodput"]["retained"] = round(retained, 3)
                self.notes.append(
                    f"Chaos {event_label(e)}: goodput retained "
                    f"{retained:.0%} under surge ({during:.0f} vs "
                    f"{before:.0f} tx/s)")
        for e in summary["events"]:
            label = f"Chaos {event_label(e)}"
            if not e["ok"]:
                self.notes.append(
                    f"{label}: injection FAILED ({e.get('error')})")
            elif e["recovered"]:
                self.notes.append(
                    f"{label}: recovery {e['recovery_ms']:g} ms")
            else:
                self.notes.append(
                    f"{label}: recovery UNCONFIRMED (no commit after "
                    "event)")
        verdict = judge(summary, slos)
        summary["slo"] = verdict
        for v in verdict["verdicts"]:
            if v["ok"]:
                self.notes.append(
                    f"Chaos SLO {v['class']}: {v['recovery_ms']:g} ms "
                    f"<= {v['slo_ms']:g} ms PASS")
            else:
                self.notes.append(
                    f"Chaos SLO {v['class']}: FAIL ({v['reason']})")
        if strict:
            if not summary["injected_ok"]:
                raise ParseError("chaos injection failed: " + "; ".join(
                    e.get("error", "?") for e in summary["events"]
                    if not e["ok"]))
            if not summary["recovered"]:
                raise ParseError(
                    "consensus did not resume after chaos event(s): "
                    + ", ".join(summary["unrecovered"]))
            if not verdict["ok"]:
                raise ParseError(
                    "chaos recovery SLO breached: " + "; ".join(
                        f"{v['class']} ({v['reason']})"
                        for v in verdict["verdicts"] if not v["ok"]))
            # graftview: a leader cascade that "recovered" without a
            # single TC forming means the drill never actually forced a
            # view change (wrong victims, or the round estimate tracked
            # nothing live) — the scripted scenario did not happen as
            # written, so strict mode fails it rather than passing a
            # drill that drilled nothing.
            cascades = [e for e in summary["events"]
                        if e.get("target") == "leader-cascade"
                        and e.get("ok")]
            if cascades and not (self.viewchange["tc_rounds"]
                                 or self.viewchange["transitions"]):
                raise ParseError(
                    "leader cascade executed but no TC formed and no "
                    "TC round transition was logged: the view-change "
                    "drill produced no view change")
            # graftfleet: a fleet-member kill that no node re-homed
            # away from means the failover ladder never engaged — the
            # drill drilled nothing (same idiom as the cascade check).
            from ..chaos.plan import sidecar_index

            fleet_kills = [
                e for e in summary["events"]
                if e.get("action") == "kill" and e.get("ok")
                and sidecar_index(str(e.get("target", ""))) is not None]
            if fleet_kills and not (self.failover or {}).get("rehomes"):
                raise ParseError(
                    "fleet sidecar kill executed but no node logged a "
                    "failover re-home: the endpoint ladder never "
                    "engaged")

    def print(self, filename):
        assert isinstance(filename, str)
        with open(filename, "a") as f:
            f.write(self.result())

    @classmethod
    def process(cls, directory, faults=0):
        assert isinstance(directory, str)
        import json

        clients = []
        for filename in sorted(glob(join(directory, "client-*.log"))):
            with open(filename, "r") as f:
                clients.append(f.read())
        nodes = []
        for filename in sorted(glob(join(directory, "node-*.log"))):
            with open(filename, "r") as f:
                nodes.append(f.read())
        # Executed fault events, written by the harness after the run
        # window (LocalBench._finish_fault_plan).  Presence switches the
        # parser into chaos mode: client deaths on faulted replicas are
        # tolerated, and the recovery assertion is STRICT — a chaos run
        # that stalled is a failed run.
        chaos_events = None
        try:
            with open(join(directory, "chaos-events.json")) as f:
                loaded = json.load(f)
            if isinstance(loaded, list):
                chaos_events = loaded
        except (OSError, ValueError):
            pass
        # Twins: logs of equivocating replicas (harness names them
        # twin-*.log, OUTSIDE the node glob) feed only the safety
        # assertion.
        twins = []
        for filename in sorted(glob(join(directory, "twin-*.log"))):
            with open(filename, "r") as f:
                twins.append(f.read())

        def _json_or_none(name):
            try:
                with open(join(directory, name)) as f:
                    loaded = json.load(f)
                return loaded if isinstance(loaded, dict) else None
            except (OSError, ValueError):
                return None

        parser = cls(clients, nodes, faults, chaos_events=chaos_events,
                     strict_chaos=chaos_events is not None, twins=twins,
                     wan=_json_or_none("wan.json"),
                     slos=_json_or_none("slo.json"))
        # The harness drops the sidecar's scheduler telemetry here at
        # teardown (LocalBench._fetch_sidecar_stats); a missing or
        # malformed file simply means no sidecar ran.
        try:
            with open(join(directory, "sidecar-stats.json")) as f:
                parser.note_sidecar_stats(json.load(f))
        except (OSError, ValueError):
            pass
        # graftfleet: per-endpoint snapshots (sidecar-stats-<i>.json);
        # each folds independently — the strict fairness/starvation
        # assertions hold for EVERY fleet member, and the _endpoint tag
        # the harness stamped prefixes that member's note lines.
        for filename in sorted(glob(join(directory,
                                         "sidecar-stats-*.json"))):
            try:
                with open(filename) as f:
                    parser.note_sidecar_stats(json.load(f))
            except (OSError, ValueError):
                continue
        # grafttrace: merge the run's spans (node TRACE lines + sidecar
        # JSONL + clock offsets) into the Perfetto-loadable trace.json
        # artifact and the commit critical-path notes, and fold the
        # sampled metrics time series in.  graftscope first folds the
        # C++ node's METRICS lines into metrics.jsonl (idempotent), so
        # the per-replica series rides the same artifact.  All
        # best-effort: a run that traced nothing parses exactly as
        # before.
        try:
            from ..obs import merge_node_series, read_samples, \
                write_run_trace

            summary = write_run_trace(directory)
            if summary is not None:
                parser.note_trace(summary)
            merge_node_series(directory)
            samples, torn = read_samples(join(directory, "metrics.jsonl"))
            parser.note_metrics(samples, malformed=torn)
        except (OSError, ValueError, TypeError, KeyError):
            pass
        return parser
