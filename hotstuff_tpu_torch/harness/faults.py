"""Harness fault injectors: turn graftchaos plan events into process
signals, sidecar RPCs, and link faults against a running bench —
locally (``LocalFaultInjector``) or across an ssh fleet
(``RemoteFaultInjector``).

The port's copy of hotstuff_tpu/harness/faults.py.  The remote
injector's sidecar pattern and its OP_CHAOS one-liner name
``hotstuff_tpu_torch.sidecar``, the process the port's harness boots;
nothing else differs.

Separation of concerns: ``hotstuff_tpu_torch/chaos`` owns *what happens when*
(plan model, runner thread, recovery math, link-shape compilation); this
module owns *how* — which pid gets which signal, how a replica reboots
on the same store, how the sidecar's OP_CHAOS hook is reached, and
which host's ``tc`` gets the partition.  The local injector is handed
the LocalBench instance itself, which tracks per-node boot commands,
live processes, and WAN proxies exactly for this purpose; the remote
injector is handed the RemoteRunner transport plus the per-host boot
records the remote Bench keeps.

Design notes:
  * kill is SIGKILL on the whole process group — no clean shutdown, the
    crash-fault model (the restart path must recover from persisted
    state, never from a flushed goodbye).
  * pause/resume is SIGSTOP/SIGCONT on the group: the process keeps its
    sockets but answers nothing — the cheapest faithful proxy for a
    network partition of one replica.  ``cleanup()`` SIGCONTs anything
    still paused so teardown's SIGTERM is actually deliverable.
  * restart re-runs the exact boot command with the log in append mode:
    same keys, same store, same ports — and the pre-fault log survives
    for the parser.
  * sidecar degrade opens a short-lived SidecarClient and posts the
    event's params to the OP_CHAOS hook; a sidecar running without
    ``--chaos`` refuses (reported as an injection failure, because the
    plan demanded a fault the deployment cannot express).
"""

from __future__ import annotations

import json
import os
import signal
import threading

from ..chaos.plan import LEADER_CASCADE, SIDECAR, FaultEvent, cascade_k, \
    client_index, link_name, node_index, sidecar_index


class InjectionError(RuntimeError):
    pass


class LocalFaultInjector:
    def __init__(self, bench):
        self._bench = bench
        self._paused: set[int] = set()
        # graftsurge: live flash-crowd generators ([(proc, timer)]); the
        # timer kills each when its window closes, cleanup() reaps any
        # the run window cut short.
        self._surges: list = []

    def apply(self, event: FaultEvent):
        # graftfleet: the bare "sidecar" target aliases fleet index 0;
        # "sidecar:<i>" picks endpoint i of a --sidecar-fleet run.
        six = 0 if event.target == SIDECAR else sidecar_index(event.target)
        if six is not None:
            fn = getattr(self, f"_sidecar_{event.action}")
            fn(six, **event.params)
            return
        if event.target == LEADER_CASCADE:
            self._cascade_kill(cascade_k(event.params))
            return
        name = link_name(event.target)
        if name is not None:
            getattr(self, f"_link_{event.action}")(name)
            return
        ci = client_index(event.target)
        if ci is not None:
            # ``for`` is a keyword, so surge params route as a dict.
            getattr(self, f"_client_{event.action}")(ci, event.params)
            return
        i = node_index(event.target)
        if i is None:
            raise InjectionError(f"unknown target {event.target!r}")
        getattr(self, f"_node_{event.action}")(i)

    def cleanup(self):
        """SIGCONT any group still paused (teardown's SIGTERM queues
        behind a SIGSTOP forever otherwise), and reap surge generators
        whose window the run outlived."""
        for i in sorted(self._paused):
            try:
                self._signal_node(i, signal.SIGCONT)
            except InjectionError:
                pass
        self._paused.clear()
        surges, self._surges = self._surges, []
        for proc, timer in surges:
            timer.cancel()
            self._kill_surge_proc(proc)

    # -- nodes --------------------------------------------------------------

    def _proc(self, i: int):
        proc = self._bench._node_procs.get(i)
        if proc is None:
            raise InjectionError(f"node {i} was never booted "
                                 "(crash-faulted or out of range)")
        return proc

    def _signal_node(self, i: int, sig):
        proc = self._proc(i)
        try:
            os.killpg(os.getpgid(proc.pid), sig)
        except (ProcessLookupError, PermissionError) as e:
            raise InjectionError(f"node {i} signal {sig!r} failed: {e}")

    def _node_kill(self, i: int):
        self._signal_node(i, signal.SIGKILL)
        self._paused.discard(i)
        try:
            self._proc(i).wait(timeout=10)
        except Exception as e:  # noqa: BLE001
            raise InjectionError(f"node {i} did not die on SIGKILL: {e}")

    def _node_restart(self, i: int):
        cmd, log = self._bench._node_cmds[i]
        self._bench._node_procs[i] = self._bench._background_run(
            cmd, log, append=True)

    def _node_pause(self, i: int):
        self._signal_node(i, signal.SIGSTOP)
        self._paused.add(i)

    def _node_resume(self, i: int):
        self._signal_node(i, signal.SIGCONT)
        self._paused.discard(i)

    # -- graftview leader cascade -------------------------------------------

    # How much log tail the round estimate scans per node.  The highest
    # round is always near the END of an append-only log, and this runs
    # on the INJECTION path: reading a multi-GB log in full would delay
    # the SIGKILLs past the event's recorded wall stamp and skew the
    # recovery measurement the drill exists to take.
    _ROUND_SCAN_TAIL_BYTES = 64 * 1024

    def _estimate_round(self) -> int:
        """Best estimate of the round the committee is working on, from
        the highest proposed/committed block round in the node logs (the
        frozen log grammar's ``Created B<r>`` / ``Committed B<r>``
        lines), scanning only each log's tail.  Proposals run ahead of
        commits, so +1 on the max is a round the committee has NOT
        finished yet."""
        import os
        import re

        from .utils import PathMaker

        best = 0
        for i in self._bench._node_procs:
            try:
                with open(PathMaker.node_log_file(i), "rb") as f:
                    f.seek(0, os.SEEK_END)
                    f.seek(max(0, f.tell() - self._ROUND_SCAN_TAIL_BYTES))
                    tail = f.read().decode("utf-8", errors="replace")
                for m in re.finditer(r"(?:Created|Committed) B(\d+)\b",
                                     tail):
                    best = max(best, int(m.group(1)))
            except OSError:
                continue
        return best + 1

    def _cascade_kill(self, k: int):
        """graftview drill: SIGKILL the leader of each of the next ``k``
        rounds.  Leader election is round-robin over the SORTED
        committee keys (native LeaderElector), and sorted order means
        the base64-decoded public-key bytes — the same ordering
        std::map<PublicKey, ...> iterates.  Round-robin guarantees the
        chosen nodes each lead within the next committee-size rounds,
        so even a stale round estimate still produces k dead leader
        slots (= k forced view changes); killing them all at once is
        what makes the cascade chain instead of interleaving with
        healthy rounds."""
        import base64

        names = getattr(self._bench, "_node_names", None)
        if not names:
            raise InjectionError(
                "bench records no committee names; leader-cascade needs "
                "a LocalBench run (boot order -> leader slots)")
        order = sorted(range(len(names)),
                       key=lambda i: base64.b64decode(names[i]))
        base = self._estimate_round()
        killed, dead = [], []
        for r in range(base + 1, base + 1 + int(k)):
            i = order[r % len(names)]
            if i in killed:
                continue  # k > committee wraps onto an already-dead slot
            proc = self._bench._node_procs.get(i)
            if proc is None or proc.poll() is not None:
                dead.append(i)  # crash fault / earlier event: already out
                continue
            self._signal_node(i, signal.SIGKILL)
            self._paused.discard(i)
            killed.append(i)
        if not killed:
            raise InjectionError(
                f"leader-cascade kill {k}: no live leader among rounds "
                f"{base + 1}..{base + k} (already dead: {dead})")
        from .utils import Print

        Print.info(f"Leader cascade: killed node(s) {killed} (leaders of "
                   f"rounds {base + 1}..{base + k})")

    # -- sidecar ------------------------------------------------------------

    def _sidecar_proc_of(self, ix: int):
        """Fleet-aware lookup: the per-index dict when the bench keeps
        one, else the legacy single-sidecar attribute for index 0."""
        procs = getattr(self._bench, "_sidecar_procs", None)
        if procs is not None and ix in procs:
            return procs[ix]
        if ix == 0:
            return getattr(self._bench, "_sidecar_proc", None)
        return None

    def _sidecar_kill(self, ix: int = 0):
        proc = self._sidecar_proc_of(ix)
        if proc is None:
            raise InjectionError(f"no sidecar process {ix} to kill")
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            proc.wait(timeout=10)
        except (ProcessLookupError, PermissionError) as e:
            raise InjectionError(f"sidecar {ix} SIGKILL failed: {e}")

    def _sidecar_restart(self, ix: int = 0):
        cmds = getattr(self._bench, "_sidecar_cmds", None)
        if cmds is not None and ix in cmds:
            cmd, log = cmds[ix]
            proc = self._bench._background_run(cmd, log, append=True)
            self._bench._sidecar_procs[ix] = proc
            if ix == 0:
                self._bench._sidecar_proc = proc
        else:
            cmd, log = self._bench._sidecar_cmd
            self._bench._sidecar_proc = self._bench._background_run(
                cmd, log, append=True)
        # No readiness wait here: the node-side circuit breaker re-attaches
        # on its next probe once the socket binds, and blocking the runner
        # thread would delay every later plan event by a warmup.

    def _sidecar_degrade(self, ix: int = 0, **params):
        from ..sidecar.client import SidecarClient

        try:
            with SidecarClient(port=self._bench.SIDECAR_PORT + ix,
                               timeout=10.0) as client:
                applied = client.chaos(**params)
        except (OSError, ConnectionError) as e:
            raise InjectionError(f"sidecar {ix} chaos RPC failed: {e}")
        if not applied:
            raise InjectionError(
                "sidecar is running without --chaos; the plan's degrade "
                "event cannot be expressed")

    def _sidecar_wedge(self, ix: int = 0, n: int = 1):
        """graftguard drill: the next ``n`` device launches hang past
        their guard deadline (ChaosState's ``wedge`` knob over the same
        OP_CHAOS RPC as degrade) — the in-sidecar supervisor must answer
        the wedged batch from the host path, quarantine it, and
        crash-only-reboot the engine; same --chaos refusal contract."""
        self._sidecar_degrade(ix, wedge=int(n))

    # -- graftsurge client surges -------------------------------------------

    @staticmethod
    def _kill_surge_proc(proc):
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def _client_surge(self, i: int, params: dict):
        """Flash crowd against replica i: boot an EXTRA load generator
        at (x-1)x the baseline client's rate for ``for`` seconds, then
        kill it.  The surge client logs to surge-client-<i>.log —
        outside the parser's client glob, so offered surge load never
        counts as benchmark input rate (goodput under surge is judged
        from the commit/metrics timelines instead)."""
        from .commands import CommandMaker
        from .utils import PathMaker

        targets = getattr(self._bench, "_client_targets", {})
        info = targets.get(i)
        if info is None:
            raise InjectionError(
                f"client {i} was never booted (crash-faulted replica or "
                "out of range); the surge has no baseline to multiply")
        address, tx_size, rate_share = info
        from ..chaos.plan import SURGE_DEFAULT_X, surge_window_s

        x = float(params.get("x", SURGE_DEFAULT_X))
        duration = surge_window_s(params)
        extra_rate = max(1, int(round((x - 1) * rate_share)))
        # Heavy-tailed by default: a flash crowd IS bursty arrivals, so
        # the surge generator simulates users rather than a constant
        # stream (seeded off the replica index for reproducible runs).
        cmd = CommandMaker.run_client(
            address, tx_size, extra_rate, 0,
            users=max(2, extra_rate // 10), seed=1000 + i)
        proc = self._bench._background_run(
            cmd, PathMaker.surge_client_log_file(i), append=True)

        def _end():
            # Late-bound closure: `timer` is assigned below, before
            # start() can fire this.
            self._kill_surge_proc(proc)
            try:
                self._surges.remove((proc, timer))
            except ValueError:
                pass  # cleanup() already reaped it

        timer = threading.Timer(duration, _end)
        timer.daemon = True
        self._surges.append((proc, timer))
        timer.start()

    # -- graftwan links -----------------------------------------------------

    def _proxy(self, name: str):
        proxy = getattr(self._bench, "_wan_proxies", {}).get(name)
        if proxy is None:
            raise InjectionError(
                f"no WAN proxy realizes link {name!r} on this run "
                "(pass --wan with a spec naming it)")
        return proxy

    def _link_partition(self, name: str):
        self._proxy(name).partition()

    def _link_heal(self, name: str):
        self._proxy(name).heal()


class RemoteFaultInjector:
    """Executes fault plans across an ssh fleet (harness/remote.Bench).

    Same plan schema as the local injector; the mechanisms change:

      * node kill/pause/resume are ``pkill`` signals against the node
        pattern on that replica's host (one node per host, the remote
        bench's layout) — ``pkill`` exiting non-zero means no process
        matched, which is an injection failure, not a transport one;
      * node restart re-runs the recorded boot command via the
        background wrapper in APPEND mode, so the pre-fault log
        survives for the parser (the same same-store contract as the
        local injector);
      * link partition/heal compile to ``tc qdisc change`` on every
        host whose egress carries the link (chaos/netem.py owns the
        band numbering; the commands target the qdiscs ``Bench``
        installed from the same spec);
      * sidecar degrade reaches OP_CHAOS through a python one-liner on
        the sidecar host's checkout (the RPC must originate next to the
        sidecar: its port is not assumed reachable from the
        orchestrator); kill/restart pkill + reboot it there.  All three
        need a configured sidecar host — a plan demanding a fault the
        deployment cannot express fails the injection, same contract as
        a --chaos-less local sidecar.

    Event wall stamps are taken by the PlanRunner on the orchestrator's
    clock, while recovery comes from commit stamps in REMOTE logs —
    per-fault recovery latency on a fleet therefore carries the fleet's
    clock skew, exactly like the reference's measurement pipeline (its
    client/node stamps span hosts too).  NTP-synced fleets keep this in
    the low milliseconds.
    """

    # Bracketed dot: the ssh wrapper shell's own cmdline contains this
    # pattern verbatim, and a regex that matches its own text makes
    # ``pkill -f`` signal the wrapper too (a -KILL turns into rc=137 on
    # a successful injection; a -STOP parks the ssh session until the
    # transport timeout).  ``[.]`` matches the node's literal dot but
    # not the bracketed pattern text itself.
    NODE_PATTERN = r"[.]/node run"
    SIDECAR_PATTERN = r"hotstuff_tpu_torch[.]sidecar"

    # Injections are milliseconds of remote work (pkill, tc change, one
    # RPC); never let one share the transport's install-sized default
    # bound — a wedged host must fail the EVENT fast, not stall the
    # PlanRunner past the run window.
    INJECT_TIMEOUT_S = 60.0

    def __init__(self, runner, hosts, repo, node_boots, wan=None,
                 peers=None, dev="eth0", sidecar_host=None,
                 sidecar_port=7100, sidecar_boot=None):
        self._runner = runner
        self._hosts = list(hosts)
        self._repo = repo
        # {i: (command, log_file)} recorded by Bench._run_single.
        self._node_boots = dict(node_boots)
        self._wan = wan
        self._peers = dict(peers or {})
        self._dev = dev
        self._sidecar_host = sidecar_host
        self._sidecar_port = sidecar_port
        self._sidecar_boot = sidecar_boot
        self._paused: set[int] = set()

    def apply(self, event: FaultEvent):
        if event.target == SIDECAR:
            getattr(self, f"_sidecar_{event.action}")(**event.params)
            return
        if sidecar_index(event.target) is not None:
            # graftfleet is local-harness only for now: the remote bench
            # records one sidecar host/boot, so indexed targets cannot
            # be expressed against a fleet it never booted.
            raise InjectionError(
                "sidecar:<i> fleet targets are local-harness only (the "
                "remote bench tracks a single sidecar host)")
        if event.target == LEADER_CASCADE:
            # Pre-flight (remote._check_fault_plan) rejects cascade plans
            # before boot; this is the belt for hand-driven injectors
            # (the remote bench has no live round estimate to pick
            # leaders from).
            raise InjectionError(
                "leader-cascade events are local-harness only (the "
                "remote bench cannot estimate the live round)")
        name = link_name(event.target)
        if name is not None:
            getattr(self, f"_link_{event.action}")(name)
            return
        if client_index(event.target) is not None:
            # Pre-flight (remote._check_fault_plan) rejects surge plans
            # before boot; this is the belt for hand-driven injectors.
            raise InjectionError(
                "client surge events are local-harness only (the remote "
                "bench tracks no client boot commands)")
        i = node_index(event.target)
        if i is None:
            raise InjectionError(f"unknown target {event.target!r}")
        getattr(self, f"_node_{event.action}")(i)

    def cleanup(self):
        """SIGCONT any host still paused (mirrors the local injector:
        teardown's pkill queues behind a SIGSTOP forever otherwise)."""
        for i in sorted(self._paused):
            try:
                self._pkill(i, "CONT")
            except InjectionError:
                pass
        self._paused.clear()

    # -- nodes --------------------------------------------------------------

    def _host(self, i: int) -> str:
        if not 0 <= i < len(self._hosts):
            raise InjectionError(f"node {i} has no host (fleet of "
                                 f"{len(self._hosts)})")
        return self._hosts[i]

    def _run(self, host, command, what):
        from .remote import ExecutionError

        try:
            self._runner.run(host, command,
                             timeout=self.INJECT_TIMEOUT_S)
        except ExecutionError as e:
            raise InjectionError(f"{what} failed on {host}: {e}")

    def _pkill(self, i: int, sig: str, pattern=None):
        self._run(self._host(i),
                  f"pkill -{sig} -f '{pattern or self.NODE_PATTERN}'",
                  f"node {i} pkill -{sig}")

    def _node_kill(self, i: int):
        self._pkill(i, "KILL")
        self._paused.discard(i)

    def _node_restart(self, i: int):
        from .remote import ExecutionError

        boot = self._node_boots.get(i)
        if boot is None:
            raise InjectionError(f"node {i} has no recorded boot command")
        cmd, log = boot
        try:
            self._runner.run_background(self._host(i), cmd, log,
                                        append=True,
                                        timeout=self.INJECT_TIMEOUT_S)
        except ExecutionError as e:
            raise InjectionError(f"node {i} restart failed: {e}")

    def _node_pause(self, i: int):
        self._pkill(i, "STOP")
        self._paused.add(i)

    def _node_resume(self, i: int):
        self._pkill(i, "CONT")
        self._paused.discard(i)

    # -- graftwan links -----------------------------------------------------

    def _link_tc(self, name: str, compile_fn, what: str):
        from ..chaos.netem import WanError

        if self._wan is None:
            raise InjectionError(
                f"plan faults link {name!r} but this run shapes no WAN "
                "(pass --wan)")
        if self._wan.by_name(name) is None:
            raise InjectionError(f"WAN spec names no link {name!r}")
        ran = 0
        for i, host in enumerate(self._hosts):
            try:
                cmds = compile_fn(self._wan, name, f"node:{i}",
                                  self._peers, self._dev)
            except WanError as e:
                raise InjectionError(f"link {name!r}: {e}")
            for cmd in cmds:
                self._run(host, cmd, f"link {name!r} {what}")
                ran += 1
        if not ran:
            raise InjectionError(
                f"link {name!r} touches no egress on this fleet "
                "(src/dst outside the booted hosts)")

    def _link_partition(self, name: str):
        from ..chaos.netem import tc_partition_commands

        self._link_tc(name, tc_partition_commands, "partition")

    def _link_heal(self, name: str):
        from ..chaos.netem import tc_heal_commands

        self._link_tc(name, tc_heal_commands, "heal")

    # -- sidecar ------------------------------------------------------------

    def _sidecar_host_or_fail(self) -> str:
        if not self._sidecar_host:
            raise InjectionError(
                "plan targets the sidecar but this fleet runs none "
                "(configure a sidecar host)")
        return self._sidecar_host

    def _sidecar_kill(self):
        host = self._sidecar_host_or_fail()
        self._run(host, f"pkill -KILL -f '{self.SIDECAR_PATTERN}'",
                  "sidecar pkill -KILL")

    def _sidecar_restart(self):
        from .remote import ExecutionError

        host = self._sidecar_host_or_fail()
        if self._sidecar_boot is None:
            raise InjectionError("sidecar has no recorded boot command")
        cmd, log = self._sidecar_boot
        try:
            self._runner.run_background(host, cmd, log, append=True,
                                        timeout=self.INJECT_TIMEOUT_S)
        except ExecutionError as e:
            raise InjectionError(f"sidecar restart failed: {e}")

    def _sidecar_degrade(self, **params):
        import shlex

        host = self._sidecar_host_or_fail()
        snippet = (
            "import json, sys; "
            "from hotstuff_tpu_torch.sidecar.client import SidecarClient; "
            f"c = SidecarClient(port={self._sidecar_port}, timeout=10.0); "
            "ok = c.chaos(**json.loads(sys.argv[1])); c.close(); "
            "sys.exit(0 if ok else 3)")
        cmd = (f"cd {self._repo} && python3 -c {shlex.quote(snippet)} "
               f"{shlex.quote(json.dumps(params))}")
        self._run(host, cmd, "sidecar chaos RPC")

    def _sidecar_wedge(self, n: int = 1):
        """graftguard drill over the fleet: same OP_CHAOS RPC as
        degrade, with the wedge knob (see LocalFaultInjector)."""
        self._sidecar_degrade(wedge=int(n))
