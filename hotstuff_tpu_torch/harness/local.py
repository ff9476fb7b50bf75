"""Local benchmark: run a full committee + clients (+ optional verify
sidecar) on this machine and mine the logs for TPS/latency.

The port's copy of hotstuff_tpu/harness/local.py.  It departs from the
reference in four places:

* it boots ``python -m hotstuff_tpu_torch.sidecar`` (same flags);
* its stale-process sweep matches that module, and only processes whose
  working directory is the bench's own (the reference's ``pkill -f``
  reaches every matching process on the machine, another checkout's
  too);
* a device sidecar that never answers a PING fails the run with
  :class:`BenchError` instead of degrading to a ``--host-crypto`` sidecar
  (a host-mode result would hide the card);
* teardown stops the replicas and clients before the sidecar.

Its readiness budgets are sized from the port's own boot: nvcc builds of
the kernels on a cold tree, then the warm-ups.

Capability mirror of benchmark/benchmark/local.py:12-120: kill stale
processes, compile, generate keys/committee/parameters, boot nodes minus
`faults` (crash faults = nodes never booted), boot one client per node at
rate/N, run for `duration`, parse logs. Processes are plain subprocesses
with per-process log redirection (the reference used tmux panes for the
same effect).
"""

from __future__ import annotations

import os
import signal
import subprocess
from time import monotonic, sleep

from .commands import CommandMaker
from .config import Key, LocalCommittee, NodeParameters
from .logs import LogParser, ParseError
from .utils import BenchError, PathMaker, Print


def _group_alive(pgid: int) -> bool:
    """Whether a process of group ``pgid`` is alive (a zombie is not)."""
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        state, _, pgrp = stat[stat.rindex(")") + 2:].split()[:3]
        if int(pgrp) == pgid and state != "Z":
            return True
    return False


def _stop_groups(procs, wait_s: float):
    """SIGTERM the process group of each of ``procs`` and wait up to
    ``wait_s`` seconds for the groups to exit."""
    pgids = []
    for proc in procs:
        try:
            pgid = os.getpgid(proc.pid)
            os.killpg(pgid, signal.SIGTERM)
            # A chaos-paused (SIGSTOPped) group only sees the SIGTERM
            # once continued; always chase with SIGCONT so teardown
            # can never leave a stopped orphan holding the ports.
            os.killpg(pgid, signal.SIGCONT)
            pgids.append((proc, pgid))
        except (ProcessLookupError, PermissionError):
            pass
    deadline = monotonic() + wait_s
    for proc, pgid in pgids:
        proc.poll()  # reap the shell wrapper
        while monotonic() < deadline and _group_alive(pgid):
            sleep(0.05)
            proc.poll()


def _sweep_stale(sweeps, root: str):
    """Signal every process whose command line matches the extended regex
    of one of ``sweeps`` (``(pattern, signal)`` pairs, ``pkill -f``'s
    matching) and whose working directory is ``root``.  The harness's
    replicas, clients and sidecar all run in the bench's cwd, so a sweep
    from there reaches this bench's stale processes and no other
    checkout's."""
    import re

    root = os.path.realpath(root)
    own = os.getpid()
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == own:
            continue
        try:
            if os.readlink(f"/proc/{entry}/cwd") != root:
                continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmdline = f.read().rstrip(b"\0").replace(b"\0", b" ")
        except OSError:
            continue
        line = cmdline.decode(errors="replace")
        for pattern, sig in sweeps:
            if re.search(pattern, line):
                try:
                    os.kill(int(entry), sig)
                except OSError:
                    pass
                break


class LocalBench:
    BASE_PORT = 9000
    SIDECAR_PORT = 7100
    # graftwan: the userspace WanProxy for a shaped node->sidecar link
    # binds here; the parameters file points the nodes at it.
    WAN_SIDECAR_PORT = 7101
    # Twins: the equivocating replica binds three consecutive ports from
    # here (clear of the committee's BASE_PORT + 3*n block).
    TWIN_BASE_PORT = 9900
    # grafttrace: OP_STATS sampling cadence during the run window.  1 Hz
    # keeps even a minimum-duration run at a handful of in-window
    # samples while costing the sidecar one connection thread per tick.
    METRICS_INTERVAL_S = 1.0
    # The sidecar module this harness boots, and the pattern (an extended
    # regex) that sweeps its stale processes.
    SIDECAR_MODULE = "hotstuff_tpu_torch.sidecar"
    SIDECAR_SWEEP = r"hotstuff_tpu_torch\.sidecar"
    # The stale-process sweep (_kill_nodes): replicas and clients get
    # SIGTERM, the sidecar SIGKILL.
    SWEEPS = ((r"\./node run", signal.SIGTERM),
              (r"\./client 127", signal.SIGTERM),
              (SIDECAR_SWEEP, signal.SIGKILL))
    # Readiness budgets of a device sidecar, in seconds
    # (_sidecar_deadline_s): by scheme on one card, and on a mesh.  On an
    # H100 an Ed25519 boot took 19 s on a cold tree (nvcc, then the
    # warm-ups) and 8.5-10 s with the kernels built, a BLS boot
    # 9.5-10.5 s built.  A mesh keeps the reference's 300 s.
    DEVICE_READY_S = {"ed25519": 120, "bls": 180}
    MESH_READY_S = 300
    # Seconds teardown waits for the replicas and clients to exit before
    # it stops the sidecar.
    TEARDOWN_WAIT_S = 10.0

    def __init__(self, bench_parameters, node_parameters=None):
        self.nodes = bench_parameters.nodes[0]
        self.rate = bench_parameters.rate[0]
        self.tx_size = bench_parameters.tx_size
        self.faults = bench_parameters.faults
        self.duration = bench_parameters.duration
        self.tpu_sidecar = getattr(bench_parameters, "tpu_sidecar", False)
        # graftfleet: sidecar_fleet k > 1 boots k sidecars on consecutive
        # ports (SIDECAR_PORT + i) and hands every node the ORDERED
        # endpoint list — the C++ TpuVerifier's failover ladder.  0/1 is
        # the legacy single-sidecar run, byte-identical artifacts.
        self.sidecar_fleet = int(getattr(
            bench_parameters, "sidecar_fleet", 0) or 0)
        self.sidecar_host_crypto = getattr(
            bench_parameters, "sidecar_host_crypto", False)
        self.sidecar_warm_rlc = getattr(
            bench_parameters, "sidecar_warm_rlc", False)
        self.sidecar_mesh = int(getattr(
            bench_parameters, "sidecar_mesh", 0) or 0)
        if self.sidecar_host_crypto:
            self.tpu_sidecar = True  # host-crypto still runs the sidecar
        self.scheme = getattr(bench_parameters, "scheme", "ed25519")
        if self.scheme == "bls":
            self.tpu_sidecar = True  # no host pairing in the C++ plane
        # graftingress: signed-transaction ingress knobs (config.py
        # BenchParameters validated the ranges).
        self.verify_ingress = bool(
            getattr(bench_parameters, "verify_ingress", False))
        self.forge_pct = float(
            getattr(bench_parameters, "forge_pct", 0.0) or 0.0)
        self.client_shards = max(1, int(
            getattr(bench_parameters, "client_shards", 1) or 1))
        # graftfleet: a fleet run hands nodes the ordered endpoint list
        # (primary first) plus a tenant id for the protocol-v6 HELLO;
        # the single-sidecar run keeps the legacy one-address string.
        if self.tpu_sidecar and self.sidecar_fleet > 1:
            sidecar_addr = [f"127.0.0.1:{self.SIDECAR_PORT + i}"
                            for i in range(self.sidecar_fleet)]
        elif self.tpu_sidecar:
            sidecar_addr = f"127.0.0.1:{self.SIDECAR_PORT}"
        else:
            sidecar_addr = None
        self.node_parameters = node_parameters or NodeParameters.default(
            tpu_sidecar=sidecar_addr,
            scheme=self.scheme if self.scheme != "ed25519" else None,
            tenant="node" if self.sidecar_fleet > 1 else None)
        if self.verify_ingress:
            # The node-side admission-verify stage rides the mempool
            # parameters straight into the C++ from_json reader;
            # setdefault, so caller-provided parameters win.
            self.node_parameters.json.setdefault(
                "mempool", {}).setdefault("verify_ingress", True)
        # grafttrace: benched runs always trace (the span lines are one
        # relaxed atomic load when the committee config disables them,
        # and the critical-path breakdown is what makes the run's
        # numbers attributable).  setdefault, so an explicit
        # "trace": false in caller-provided parameters wins.
        self.node_parameters.json.setdefault("trace", True)
        self._procs = []
        # graftchaos: per-node boot info + the sidecar boot command are
        # tracked so the fault injector can SIGKILL/SIGSTOP groups and
        # reboot on the same store/log (harness/faults.py).
        self._node_procs = {}
        self._node_cmds = {}
        self._sidecar_proc = None
        self._sidecar_cmd = None
        # graftfleet: per-index boot info ({ix: proc} / {ix: (cmd, log)});
        # index 0 is mirrored into the legacy attributes above so the
        # single-sidecar injector/test surface stays byte-compatible.
        self._sidecar_procs = {}
        self._sidecar_cmds = {}
        # graftsurge: {i: (address, tx_size, rate_share)} for the booted
        # clients, so a plan's client:<i> surge event can boot an extra
        # generator at a multiple of the baseline (harness/faults.py).
        self._client_targets = {}
        # graftview: committee names in BOOT order — the leader-cascade
        # injector maps round-robin leader slots (sorted-key order, the
        # C++ LeaderElector's rule) back to the node index to SIGKILL.
        self._node_names = []
        fp = getattr(bench_parameters, "fault_plan", None)
        if fp:
            from ..chaos import PlanError, parse_plan

            try:
                self.fault_plan = parse_plan(fp)
            except PlanError as e:
                raise BenchError("Invalid fault plan", e)
        else:
            self.fault_plan = None
        # graftwan: WAN spec + SLO table, parsed/validated NOW (same
        # fail-before-compile contract as the fault plan).  Locally the
        # spec is realized by WanProxy instances; _check_wan below
        # rejects links no proxy can stand in for.
        self._wan_proxies = {}
        self._twin_proc = None
        wan = getattr(bench_parameters, "wan", None)
        if wan:
            from ..chaos import WanError, parse_wan

            try:
                self.wan = parse_wan(wan)
            except WanError as e:
                raise BenchError("Invalid WAN spec", e)
        else:
            self.wan = None
        slo = getattr(bench_parameters, "slo", None)
        from ..chaos import SloError, parse_slos

        try:
            self.slos = parse_slos(slo)
        except SloError as e:
            raise BenchError("Invalid SLO table", e)
        self.twins = bool(getattr(bench_parameters, "twins", False))
        if self.wan is not None and any(
                link.dst == "sidecar" for link in self.wan.links):
            if not self.tpu_sidecar:
                raise BenchError(
                    "WAN spec shapes the sidecar link but this run "
                    "boots no sidecar (pass --tpu-sidecar / "
                    "--sidecar-host-crypto)", None)
            if self.sidecar_fleet > 1:
                # The fleet binds consecutive ports from SIDECAR_PORT,
                # so sidecar 1 lands exactly on the shared proxy port
                # (WAN_SIDECAR_PORT = SIDECAR_PORT + 1) — and one proxy
                # cannot front an ordered endpoint LIST anyway.
                raise BenchError(
                    "WAN sidecar links are single-sidecar only: the "
                    "fleet's consecutive ports collide with the shared "
                    "proxy port (shape fleet links on the remote "
                    "harness)", None)
            # Nodes reach the sidecar THROUGH the proxy: the link's
            # shape applies to every verify RPC, and a link:<name>
            # partition event black-holes the accelerator service.
            self.node_parameters.json["tpu_sidecar"] = \
                f"127.0.0.1:{self.WAN_SIDECAR_PORT}"

    def _background_run(self, command, log_file, append=False):
        name = command.split()[0]
        # stdout -> /dev/null: children must not inherit the harness's
        # stdout pipe, or an orphaned node keeps a killed harness's caller
        # blocked on that pipe forever (logs go to stderr).
        cmd = f"{command} > /dev/null 2{'>>' if append else '>'} {log_file}"
        # Python children (the sidecar) must find hotstuff_tpu_torch
        # regardless of the harness cwd — `python -m` in the child does not
        # inherit the parent interpreter's implicit cwd sys.path entry.
        # The sidecar's kernels build into build/kernels/<source hash>/
        # under this root (ops/kern/build.py), so no cache path is passed.
        env = os.environ.copy()
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            ["/bin/sh", "-c", cmd], preexec_fn=os.setsid, env=env)
        self._procs.append((name, proc))
        return proc

    def _wait_sidecar_ready(self, deadline_s=300, index=None):
        """Block until the sidecar answers a PING (it binds post-warmup, so
        the first accepted connection implies the kernels are built and
        warm).
        graftfleet: ``index`` picks fleet member i (port SIDECAR_PORT+i,
        per-index log file); None is the legacy single sidecar."""
        from ..sidecar.client import SidecarClient

        port = self.SIDECAR_PORT + (index or 0)
        who = "Sidecar" if index is None else f"Sidecar {index}"
        start = monotonic()
        while True:
            try:
                with SidecarClient(port=port, timeout=5.0) as client:
                    client.ping()
                Print.info(f"{who} ready after "
                           f"{monotonic() - start:.0f}s (warmup done)")
                return
            except (OSError, ConnectionError):
                if monotonic() - start > deadline_s:
                    raise BenchError(
                        f"Verify sidecar failed to become ready; see "
                        f"{PathMaker.sidecar_log_file(index)}",
                        TimeoutError(f"{deadline_s}s elapsed"))
                sleep(0.5)

    def _kill_nodes(self):
        # Replicas and clients first, the sidecar once their process
        # groups are gone: a replica that outlives its sidecar logs an
        # ERROR for an in-flight OP_BLS_SIGN, which the parser reads as a
        # failed node.  (The reference signals in boot order, the
        # sidecar first.)
        _stop_groups([p for name, p in self._procs if name != "python"],
                     wait_s=self.TEARDOWN_WAIT_S)
        _stop_groups([p for name, p in self._procs if name == "python"],
                     wait_s=0.0)
        self._procs = []
        self._node_procs = {}
        self._sidecar_proc = None
        self._sidecar_procs = {}
        self._twin_proc = None
        # Stale-state discipline (benchmark/local.py:31-37): also sweep by
        # pattern for processes from previous runs this harness no longer
        # tracks — including the sidecar, which a wedged device can leave
        # hung past its process group's SIGTERM.  Only processes running
        # in this bench's cwd are swept: a bench in another checkout on
        # the same machine keeps its committee and sidecar.
        _sweep_stale(self.SWEEPS, os.getcwd())

    def _sidecar_deadline_s(self, host_crypto: bool) -> int:
        """Readiness budget: a device sidecar first builds its kernels
        with nvcc (once per source hash, under build/kernels/), then runs
        its warm-ups; the BLS boot adds the Fq12 kernels, the boot
        self-check and one warm check of each pairing count.  Host-crypto
        warmup builds nothing."""
        if host_crypto:
            return 120
        if self.sidecar_mesh > 1:
            return self.MESH_READY_S
        return self.DEVICE_READY_S[self.scheme]

    def _boot_sidecar(self, host_crypto: bool, index=None):
        """Boot the verify sidecar and wait for readiness.  If the device
        path never comes up, kill it and fail the run with BenchError
        naming the sidecar's log: a host-crypto sidecar in its place would
        report host numbers for a device run.

        graftfleet: ``index=i`` boots fleet member i on SIDECAR_PORT+i
        with a per-index log file and does NOT wait — the fleet wrapper
        (:meth:`_boot_sidecars`) waits on every member."""
        mode = " (HOST crypto)" if host_crypto else ""
        who = "" if index is None else f" {index}"
        Print.info(f"Booting verify sidecar{who}...{mode}")
        warm_bls = ""
        if self.scheme == "bls":
            # Warm both BLS shapes: the 2-pairing QC check and the
            # quorum-size multi-digest TC check (one compiled program per
            # vote count; unwarmed counts verify on host).  The vote count
            # MUST use the node's own quorum formula (2n/3+1 with unit
            # stakes, native/src/consensus/config.hpp — NOT 2f+1 from
            # n=3f+1, which disagrees for n not of that form, e.g. n=20)
            # or every TC verify falls back to host pairing mid-traffic.
            # The certificate-minimality guard (messages.cpp) rejects
            # over-quorum TCs, so this one shape covers every TC a
            # well-formed run can carry.
            quorum = 2 * self.nodes // 3 + 1
            warm_bls = f" --warm-bls --warm-bls-multi {quorum}"
        hc = " --host-crypto" if host_crypto else ""
        # RLC warmup is opt-in (each bucket is another boot-time compile,
        # though cached across restarts) and meaningless in host mode.
        warm_rlc = " --warm-rlc" \
            if getattr(self, "sidecar_warm_rlc", False) and not host_crypto \
            else ""
        # Mesh mode: shard verify launches over an N-device mesh, with
        # the sharded one-MSM warmup so coalesced QC batches route
        # through the rlc_sharded engine path from the first block.
        mesh = ""
        if int(getattr(self, "sidecar_mesh", 0) or 0) > 1 \
                and not host_crypto:
            mesh = f" --mesh {self.sidecar_mesh} --warm-rlc-sharded"
        # The chaos hook binds only when a fault plan can reach it; the
        # committee/rate parameters size the scheduler's admission caps
        # (sidecar/sched/scheduler.size_queue_caps) instead of the static
        # defaults.
        chaos = " --chaos" if getattr(self, "fault_plan", None) else ""
        # grafttrace: sidecar stage spans ride a JSONL file next to the
        # logs (appended across chaos restarts, like the log itself).
        trace = f" --trace {PathMaker.sidecar_spans_file()}"
        port = self.SIDECAR_PORT + (index or 0)
        log = PathMaker.sidecar_log_file(index)
        cmd = (f"python -m {self.SIDECAR_MODULE} "
               f"--port {port}"
               f" --committee {self.nodes} --client-rate {self.rate}"
               f"{warm_bls}{warm_rlc}{mesh}{hc}{chaos}{trace}")
        proc = self._background_run(cmd, log)
        ix = 0 if index is None else index
        if not isinstance(getattr(self, "_sidecar_procs", None), dict):
            self._sidecar_procs = {}
            self._sidecar_cmds = {}
        self._sidecar_cmds[ix] = (cmd, log)
        self._sidecar_procs[ix] = proc
        if ix == 0:
            self._sidecar_cmd = (cmd, log)
            self._sidecar_proc = proc
        if index is not None:
            return  # the fleet wrapper waits on the whole fleet
        try:
            self._wait_sidecar_ready(
                deadline_s=self._sidecar_deadline_s(host_crypto))
        except BenchError:
            self._kill_nodes()
            raise

    def _boot_sidecars(self, host_crypto: bool):
        """Boot the sidecar fleet (sidecar_fleet members on consecutive
        ports) and wait for every member; a member that never becomes
        ready fails the run.  Fleet size <= 1 is the legacy
        single-sidecar boot, unchanged."""
        k = self.sidecar_fleet
        if k <= 1:
            self._boot_sidecar(host_crypto=host_crypto)
            return
        Print.info(f"Booting sidecar fleet ({k} endpoints)...")
        for i in range(k):
            self._boot_sidecar(host_crypto, index=i)
        try:
            # The members boot concurrently (their kernel builds share
            # build/kernels/<source hash>/), so one budget covers each
            # member's wait in turn.
            deadline = self._sidecar_deadline_s(host_crypto)
            for i in range(k):
                self._wait_sidecar_ready(deadline_s=deadline, index=i)
        except BenchError:
            self._kill_nodes()
            raise

    def _start_metrics_sampler(self):
        """Poll OP_STATS at a fixed interval for the whole run window
        (obs/sampler.py), appending the time series to logs/metrics.jsonl
        — so throughput/queue-wait over time is plottable and a
        chaos-killed sidecar's telemetry survives as the last good
        sample.  The connection persists across ticks with reconnect-
        on-failure (obs/sampler.persistent_fetch): the sampler still
        outlives a sidecar kill/restart — a dead socket costs one
        ok-false tick and the next tick re-dials — without paying (and
        measuring) a TCP dial on every healthy 1 Hz sample."""
        if not self.tpu_sidecar:
            return None
        from ..obs import MetricsSampler
        from ..obs.sampler import persistent_fetch
        from ..sidecar.client import SidecarClient

        if self.sidecar_fleet > 1:
            # graftfleet: one persistent connection per endpoint; every
            # sample carries its endpoint tag so a kill of sidecar i
            # shows as ok-false ticks for THAT endpoint while the rest
            # of the fleet's series keeps flowing.
            fetches = []
            for i in range(self.sidecar_fleet):
                port = self.SIDECAR_PORT + i
                fetches.append((
                    f"127.0.0.1:{port}",
                    persistent_fetch(
                        lambda p=port: SidecarClient(port=p, timeout=5.0))))
            fetch = fetches
        else:
            fetch = persistent_fetch(
                lambda: SidecarClient(port=self.SIDECAR_PORT, timeout=5.0))
        self._sampler = MetricsSampler(
            fetch,
            PathMaker.metrics_file(),
            interval_s=self.METRICS_INTERVAL_S)
        return self._sampler.start()

    def _fetch_sidecar_stats(self):
        """Write the sidecar's OP_STATS snapshot next to the logs; best
        effort — but a sidecar that died before teardown (chaos kill)
        no longer loses its telemetry silently: the periodic sampler's
        last good snapshot becomes the fallback, marked so the parser
        says where the numbers came from."""
        import json

        from ..sidecar.client import SidecarClient

        k = max(1, int(getattr(self, "sidecar_fleet", 0) or 0))
        for i in range(k):
            port = self.SIDECAR_PORT + i
            index = None if k == 1 else i
            endpoint = f"127.0.0.1:{port}"
            try:
                with SidecarClient(port=port, timeout=10.0) as client:
                    stats = client.stats()
            except (OSError, ConnectionError, ValueError) as e:
                sampler = getattr(self, "_sampler", None)
                last = None if sampler is None else (
                    sampler.last if k == 1
                    else sampler.last_by_endpoint.get(endpoint))
                if last is None:
                    Print.warn(f"Could not fetch sidecar scheduler stats "
                               f"({endpoint}): {e}")
                    continue
                sampled_at, snap = last
                Print.warn(f"Sidecar stats fetch failed ({endpoint}: {e}); "
                           "falling back to the last periodic sample")
                stats = dict(snap, _from_sample_at=sampled_at)
            if index is not None:
                stats = dict(stats, _endpoint=endpoint)
            with open(PathMaker.sidecar_stats_file(index), "w") as f:
                json.dump(stats, f)

    def _check_fault_plan(self):
        """Reject an unexecutable plan BEFORE anything boots: every input
        (duration, committee, faults, sidecar mode, timeout) is known at
        construction time, and a plan targeting a replica that will never
        exist must not cost a multi-minute compile+warmup first."""
        if self.fault_plan is None or not self.fault_plan.events:
            return
        alive = self.nodes - self.faults
        # graftview: a leader-cascade must leave a quorum of live voters
        # behind (stake is uniform here: quorum = 2n/3+1 over the FULL
        # committee, the node's own formula) — a drill that kills the
        # quorum is a permanent stall, not a view-change storm.
        from ..chaos.plan import LEADER_CASCADE, cascade_k

        cascades = [cascade_k(e.params) for e in self.fault_plan.events
                    if e.target == LEADER_CASCADE]
        quorum = 2 * self.nodes // 3 + 1
        if cascades and alive - sum(cascades) < quorum:
            raise BenchError(
                f"leader-cascade kills {sum(cascades)} leader(s) but "
                f"only {alive - quorum} of the {alive} booted replicas "
                f"are expendable (quorum {quorum} of {self.nodes}); "
                "reduce k or grow the committee")
        # Window headroom: the strict recovery assertion (logs.py) needs
        # commits AFTER every event, and recovery from a kill legitimately
        # costs view changes plus the node-side breaker's failure window —
        # an event too close to teardown would either silently never fire
        # (runner.stop() skips it) or fail a healthy run.  Reject the plan
        # up front instead.  A cascade's recovery is k BACKED-OFF view
        # changes, so its grace follows the pacemaker schedule the run
        # will actually execute (node-parameter overrides win).
        grace = 2 * self.node_parameters.timeout_delay / 1000 + 3
        if cascades:
            cons = self.node_parameters.json.get("consensus", {})
            factor = cons.get("timeout_backoff_factor_pct", 200) / 100.0
            cap = cons.get("timeout_backoff_cap", 60_000) / 1000.0
            jitter = cons.get("timeout_jitter_pct", 10) / 100.0
            base = self.node_parameters.timeout_delay / 1000.0
            # Worst case includes the full jitter draw on every backed-off
            # delay — the core adds up to jitter_pct on top of the
            # schedule, and an unlucky run must not outrun the headroom
            # this check promised it.
            worst = sum(min(max(cap, base), base * factor ** d)
                        for d in range(max(cascades) + 1)) * (1 + jitter)
            grace = max(grace, worst + 3)
        if self.fault_plan.max_time() > self.duration - grace:
            raise BenchError(
                f"fault plan's last event (t={self.fault_plan.max_time():g}s) "
                f"leaves less than {grace:g}s of run-window headroom "
                f"(duration {self.duration}s) for recovery to be "
                "observable; extend --duration or move the event earlier")
        bad = [i for i in self.fault_plan.node_indices() if i >= alive]
        if bad:
            raise BenchError(
                f"fault plan targets node(s) {bad} but only {alive} "
                "replicas will be booted (crash faults are never booted)")
        from ..chaos.plan import client_index

        bad_clients = sorted({
            client_index(e.target) for e in self.fault_plan.events
            if client_index(e.target) is not None
            and client_index(e.target) >= alive})
        if bad_clients:
            raise BenchError(
                f"fault plan surges client(s) {bad_clients} but only "
                f"{alive} clients will be booted (one per alive replica)")
        from ..chaos.plan import sidecar_index

        if any(e.target == "sidecar"
               or sidecar_index(e.target) is not None
               for e in self.fault_plan.events) and not self.tpu_sidecar:
            raise BenchError(
                "fault plan targets the sidecar but this run boots none "
                "(pass --tpu-sidecar / --sidecar-host-crypto)")
        # graftfleet: an indexed sidecar:<i> target must name a fleet
        # member that will actually be booted.
        booted = max(1, self.sidecar_fleet) if self.tpu_sidecar else 0
        bad_sidecars = [i for i in self.fault_plan.sidecar_indices()
                        if i >= booted]
        if bad_sidecars:
            raise BenchError(
                f"fault plan targets sidecar(s) {bad_sidecars} but only "
                f"{booted} sidecar(s) will be booted (raise "
                "sidecar_fleet)")
        missing = [name for name in self.fault_plan.link_names()
                   if self.wan is None or self.wan.by_name(name) is None]
        if missing:
            raise BenchError(
                f"fault plan faults link(s) {missing} the WAN spec does "
                "not name (pass --wan with matching links)")

    def _check_wan(self):
        """Reject WAN links no local proxy can realize, BEFORE boot.
        Locally shapeable: dst 'sidecar' (proxy in front of the verify
        sidecar) and dst 'node:<i>' for an alive replica (proxy in
        front of its client-facing front port).  Inter-replica consensus
        links need real egress shaping — run them on a fleet, where the
        same spec compiles to tc netem."""
        if self.wan is None:
            return
        from ..chaos.plan import node_index

        alive = self.nodes - self.faults
        sidecar_links = [l for l in self.wan.links if l.dst == "sidecar"]
        if len(sidecar_links) > 1:
            # One shared proxy port fronts the sidecar locally; a
            # second link would EADDRINUSE mid-boot.  Per-src sidecar
            # shaping needs per-host egress — the remote harness.
            raise BenchError(
                f"WAN spec names {len(sidecar_links)} sidecar links "
                "but a local run realizes at most one (a single proxy "
                "fronts the shared sidecar; per-src sidecar shaping "
                "needs the remote harness)")
        for link in self.wan.links:
            if link.dst == "sidecar":
                if node_index(link.src) is not None:
                    Print.warn(
                        f"WAN link {link.label()!r}: locally the "
                        "sidecar proxy sits in front of the SHARED "
                        "service, so this shapes every replica's "
                        f"verify path, not just {link.src}'s (per-src "
                        "asymmetry needs the remote harness)")
                continue
            i = node_index(link.dst)
            if i is not None and i < alive:
                # The local proxy fronts the node's CLIENT-facing port:
                # only the client->front hop is actually shaped.  A
                # node/sidecar src would silently measure a different
                # topology than the spec declares.
                if link.src not in ("client", "*"):
                    raise BenchError(
                        f"WAN link {link.label()!r}: src {link.src!r} "
                        "is not locally shapeable (the local proxy "
                        "fronts node fronts, so only client->node:<i> "
                        "links are realizable; inter-replica links "
                        "need the remote harness)")
                continue
            raise BenchError(
                f"WAN link {link.label()!r}: dst {link.dst!r} is not "
                "locally shapeable (local runs proxy the sidecar link "
                "and client->node:<i> fronts; use the remote harness "
                "for inter-replica tc shaping)")

    def _start_wan(self, committee, alive):
        """Boot one WanProxy per realizable link; returns the client
        target addresses with shaped fronts swapped for their proxies.
        The sidecar proxy binds its fixed port (the parameters file
        already points nodes at it)."""
        addresses = list(committee.front_addresses()[:alive])
        if self.wan is None:
            return addresses
        from ..chaos import WanProxy
        from ..chaos.plan import node_index

        for link in self.wan.links:
            if link.dst == "sidecar":
                proxy = WanProxy(("127.0.0.1", self.SIDECAR_PORT),
                                 shape=link.shape,
                                 listen_port=self.WAN_SIDECAR_PORT)
            else:
                i = node_index(link.dst)
                host, port = addresses[i].split(":")
                proxy = WanProxy((host, int(port)), shape=link.shape)
            proxy.start()
            self._wan_proxies[link.label()] = proxy
            if link.dst != "sidecar":
                addresses[node_index(link.dst)] = \
                    f"127.0.0.1:{proxy.port}"
        Print.info(f"WAN: {len(self._wan_proxies)} link prox(ies) up")
        return addresses

    def _stop_wan(self):
        proxies, self._wan_proxies = self._wan_proxies, {}
        for proxy in proxies.values():
            proxy.stop()

    def _boot_twin(self):
        """Boot the Twins equivocating replica: replica 0's keypair, its
        own ports/store/log, and the twin committee view (written by
        run() before the honest half that shares it booted) where its
        identity's addresses point at itself."""
        cmd = CommandMaker.run_node(
            PathMaker.key_file(0),
            PathMaker.twin_committee_file(),
            PathMaker.twin_db_path(),
            PathMaker.parameters_file())
        Print.info("Booting Twins replica (equivocating sibling of "
                   "node 0)...")
        self._twin_proc = self._background_run(
            cmd, PathMaker.twin_log_file(0))

    def _start_fault_plan(self, alive: int):
        """Launch the graftchaos runner for this run window (None when no
        plan).  Event times are offsets from the moment clients start
        being paced — the same origin the plan author reasons in."""
        if self.fault_plan is None or not self.fault_plan.events:
            return None
        # Validation already happened at the top of run() — before the
        # bench paid compile/warmup — off the same construction-time
        # inputs this method sees.
        assert alive == self.nodes - self.faults
        from ..chaos import PlanRunner
        from .faults import LocalFaultInjector

        Print.info(f"Executing fault plan "
                   f"({len(self.fault_plan.events)} event(s))...")
        self._injector = LocalFaultInjector(self)
        runner = PlanRunner(self.fault_plan, self._injector)
        runner.start()
        return runner

    def _finish_fault_plan(self, runner):
        """Stop the runner, un-pause stragglers, and persist the executed
        events next to the logs for the parser's recovery summary.  A
        plan event the window closed on (a stalled injection pushing a
        later event past stop()) is a FAILED chaos run: the acceptance
        criterion is recovery after EVERY event, not every event that
        happened to fire."""
        if runner is None:
            return
        import json

        runner.stop()
        runner.join(timeout=30)
        self._injector.cleanup()
        events = runner.events()
        with open(PathMaker.chaos_events_file(), "w") as f:
            json.dump(events, f)
        if len(events) < len(self.fault_plan.events):
            raise BenchError(
                f"fault plan executed only {len(events)} of "
                f"{len(self.fault_plan.events)} event(s) before the run "
                "window closed (an earlier injection stalled?); the "
                "scripted scenario did not happen as written")

    def run(self, debug=False):
        assert isinstance(debug, bool)
        Print.heading("Starting local benchmark")

        # An unexecutable fault plan or WAN spec must fail HERE, before
        # the bench pays compile + keygen + sidecar warmup for a run
        # that cannot deliver its scripted scenario.
        self._check_fault_plan()
        self._check_wan()

        # Kill any previous testbed and cleanup.
        self._kill_nodes()
        cmd = f"{CommandMaker.cleanup()} ; {CommandMaker.clean_logs()}"
        subprocess.run(["/bin/sh", "-c", cmd], check=True)

        try:
            # Compile the node and create binary aliases.
            Print.info("Compiling the node...")
            subprocess.run(["/bin/sh", "-c", CommandMaker.compile()],
                           check=True, capture_output=True)
            subprocess.run(
                ["/bin/sh", "-c",
                 CommandMaker.alias_binaries(PathMaker.binary_path())],
                check=True)

            # Generate configuration files.
            keys = []
            for i in range(self.nodes):
                filename = PathMaker.key_file(i)
                subprocess.run(
                    ["/bin/sh", "-c", CommandMaker.generate_key(filename)],
                    check=True)
                keys.append(Key.from_file(filename))
            names = [k.name for k in keys]
            self._node_names = names
            bls_pubkeys = None
            if self.scheme == "bls":
                from .config import add_bls_keys

                bls_pubkeys = add_bls_keys(
                    [PathMaker.key_file(i) for i in range(self.nodes)],
                    names)
            committee = LocalCommittee(names, self.BASE_PORT,
                                       bls_pubkeys=bls_pubkeys)
            committee.print(PathMaker.committee_file())
            self.node_parameters.print(PathMaker.parameters_file())

            # Optionally start the TPU verify sidecar first and WAIT until
            # it answers a PING before booting any node. The sidecar only
            # binds its socket after jit warmup, so reachable == ready; a
            # node booted earlier would merely fall back to host verify, but
            # the whole point of this mode is to measure the device path.
            if self.tpu_sidecar:
                self._boot_sidecars(host_crypto=self.sidecar_host_crypto)

            # Do not boot faulty nodes (crash faults, local.py:75-76 in the
            # reference); clients only target alive nodes and split the rate
            # among them.
            alive = self.nodes - self.faults
            # graftwan: proxies come up before any node dials through
            # them; shaped fronts are swapped for their proxy addresses
            # in the clients' target list.
            addresses = self._start_wan(committee, alive)
            rate_share = -(-self.rate // alive)  # ceil
            timeout = self.node_parameters.timeout_delay

            # Twins: the equivocating sibling of node 0 binds its own
            # ports, and the honest committee is SPLIT across the two
            # views — the upper half dials identity 0 at the twin's
            # ports — so both siblings receive votes and either can
            # propose in the shared leader slots.
            twin_view_from = alive if not self.twins else max(1, alive // 2)
            if self.twins:
                from .config import twin_committee, write_committee_json

                write_committee_json(
                    twin_committee(committee, 0, self.TWIN_BASE_PORT),
                    PathMaker.twin_committee_file())

            # Nodes first, then clients with the alive fronts as their
            # --nodes wait list: the client retries those until reachable
            # (its single connect to the target would otherwise race a slow
            # node boot and waste the whole run).
            for i in range(alive):
                cmd = CommandMaker.run_node(
                    PathMaker.key_file(i),
                    PathMaker.committee_file() if i < twin_view_from
                    else PathMaker.twin_committee_file(),
                    PathMaker.db_path(i),
                    PathMaker.parameters_file(),
                    debug=debug)
                self._node_cmds[i] = (cmd, PathMaker.node_log_file(i))
                self._node_procs[i] = self._background_run(
                    cmd, PathMaker.node_log_file(i))
            if self.twins:
                self._boot_twin()

            # graftingress: each node's client optionally fans out over
            # client_shards processes (disjoint user-id and sample-id
            # spaces via the offsets, so shard streams never collide),
            # each signing with per-user keys when verify_ingress is on.
            shards = self.client_shards
            shard_rate = -(-rate_share // shards)  # ceil
            for i, address in enumerate(addresses):
                for j in range(shards):
                    g = i * shards + j  # globally unique shard index
                    cmd = CommandMaker.run_client(
                        address, self.tx_size, shard_rate, timeout,
                        nodes=addresses,
                        sign=self.verify_ingress,
                        forge_pct=(self.forge_pct
                                   if self.verify_ingress else None),
                        seed=(g + 1 if self.verify_ingress or shards > 1
                              else None),
                        user_offset=(g << 24 if self.verify_ingress
                                     else None),
                        sample_offset=(g << 32 if shards > 1 else None))
                    log = PathMaker.client_log_file(i) if shards == 1 \
                        else PathMaker.shard_client_log_file(i, j)
                    self._background_run(cmd, log)
                self._client_targets[i] = (address, self.tx_size,
                                           shard_rate)

            # Wait for all transactions to be processed.
            Print.info(f"Running benchmark ({self.duration} sec)...")
            sleep(2 * timeout / 1000)
            sampler = self._start_metrics_sampler()
            runner = self._start_fault_plan(alive)
            sleep(self.duration)
            self._finish_fault_plan(runner)
            if sampler is not None:
                sampler.stop()
            # Snapshot the scheduler telemetry BEFORE teardown (the
            # OP_STATS counters die with the sidecar process); the parser
            # folds the file into the summary's CONFIG notes.  A sidecar
            # a fault plan killed falls back to the sampler's last
            # in-window snapshot instead of losing the section.
            if self.tpu_sidecar:
                self._fetch_sidecar_stats()
            self._kill_nodes()
            self._stop_wan()

            # Persist the chaos context next to the logs so the parser
            # (and any later re-parse of the directory) judges this run
            # exactly as the bench configured it: the WAN the numbers
            # were shaped under, and the SLO table recovery is held to.
            import json

            if self.wan is not None:
                with open(PathMaker.wan_file(), "w") as f:
                    json.dump(self.wan.to_json(), f)
            if self.fault_plan is not None:
                with open(PathMaker.slo_file(), "w") as f:
                    json.dump(self.slos, f)

            # Parse logs and return the summary.
            Print.info("Parsing logs...")
            return LogParser.process(PathMaker.logs_path(),
                                     faults=self.faults)
        except BenchError:
            # e.g. a sidecar readiness failure: sweep everything (incl. a
            # hung sidecar) before propagating.
            self._stop_sampler()
            self._kill_nodes()
            self._stop_wan()
            raise
        except (subprocess.SubprocessError, ParseError) as e:
            self._stop_sampler()
            self._kill_nodes()
            self._stop_wan()
            raise BenchError("Failed to run benchmark", e)

    def _stop_sampler(self):
        sampler = getattr(self, "_sampler", None)
        if sampler is not None:
            sampler.stop()
