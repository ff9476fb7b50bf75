"""Remote (multi-host) benchmark orchestration over plain ssh/scp.

Capability mirror of benchmark/benchmark/remote.py:31-300 — install,
update, configure, run, and collect logs across a fleet of hosts — built
on subprocess ssh instead of fabric/paramiko (neither ships in this
image). Hosts come from a `hosts` list in settings.json or an explicit
list; cloud instance lifecycle (create/start/stop/terminate) lives in
instance.py and is gated on boto3 availability.

graftwan promotes this from a plain matrix driver to the distributed
chaos matrix: ``Bench`` accepts a fault plan (the same declarative
graftchaos schema the local harness runs) executed mid-run by a
``RemoteFaultInjector`` over the ssh transport, and a WAN spec
(chaos/netem.py) compiled to per-host ``tc netem`` shaping installed
before the run and torn down after.  Executed events persist into the
downloaded logs directory as ``chaos-events.json`` — the same contract
``LogParser.process`` already consumes — so per-fault recovery latency
and SLO verdicts come out of a fleet run exactly as they do locally.

Transport discipline: ssh's ConnectTimeout bounds the *dial*, not a
hung remote command, so every ``run``/``put``/``get`` carries a
subprocess timeout (the graftlint ``unbounded-socket-op`` rule enforces
this for ssh/scp argv the same way it does for raw sockets).

The port's copy of hotstuff_tpu/harness/remote.py, unchanged: the remote
bench boots replicas and clients only, so no sidecar module is named.
"""

from __future__ import annotations

import json
import shlex
import subprocess
from os.path import join
from time import sleep

from .commands import CommandMaker
from .config import Committee, Key
from .logs import LogParser, ParseError
from .utils import BenchError, PathMaker, Print, progress_bar


class FabricError(Exception):
    """SSH transport failure (name kept for parity with the reference's
    error taxonomy)."""


class ExecutionError(Exception):
    pass


class RemoteRunner:
    """Thin ssh/scp wrapper used by Bench below.

    ``command_timeout``/``copy_timeout`` bound the whole remote
    execution: a wedged remote host (the exact failure class graftchaos
    scripts) must surface as an error in this process, never park an
    orchestrator thread forever.
    """

    # Generous defaults: install/update legitimately run apt + cmake for
    # minutes; a fault-plan pkill takes milliseconds but shares the
    # bound (callers pass a tighter one where it matters).
    COMMAND_TIMEOUT_S = 900.0
    COPY_TIMEOUT_S = 300.0

    def __init__(self, user, key_path, connect_timeout=10):
        self.user = user
        self.key_path = key_path
        self.connect_timeout = connect_timeout

    def _ssh_base(self, host):
        return [
            "ssh", "-i", self.key_path,
            "-o", "StrictHostKeyChecking=no",
            "-o", f"ConnectTimeout={self.connect_timeout}",
            f"{self.user}@{host}",
        ]

    def run(self, host, command, check=True, hide=True, timeout=None):
        try:
            result = subprocess.run(
                self._ssh_base(host) + [command],
                capture_output=hide, text=True,
                timeout=timeout if timeout is not None
                else self.COMMAND_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise ExecutionError(
                f"[{host}] {command!r} hung past {e.timeout:g}s "
                "(wedged host?)")
        if check and result.returncode != 0:
            raise ExecutionError(
                f"[{host}] {command!r} failed: {result.stderr}")
        return result

    def run_background(self, host, command, log_file, append=False,
                       timeout=None):
        # nohup + setsid so the process survives the ssh session.  The
        # command is shlex-quoted INTO the sh -c argument: boot commands
        # legitimately carry single quotes (pkill patterns, --nodes
        # lists), and naive '{command}' wrapping broke on every one.
        redirect = ">>" if append else ">"
        wrapped = (f"nohup setsid sh -c {shlex.quote(command)} "
                   f"{redirect} {log_file} 2>&1 < /dev/null &")
        return self.run(host, wrapped, timeout=timeout)

    def put(self, host, local, remote, timeout=None):
        try:
            result = subprocess.run(
                ["scp", "-i", self.key_path,
                 "-o", "StrictHostKeyChecking=no",
                 local, f"{self.user}@{host}:{remote}"],
                capture_output=True, text=True,
                timeout=timeout if timeout is not None
                else self.COPY_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise FabricError(
                f"scp to {host} hung past {e.timeout:g}s")
        if result.returncode != 0:
            raise FabricError(f"scp to {host} failed: {result.stderr}")

    def get(self, host, remote, local, timeout=None):
        try:
            result = subprocess.run(
                ["scp", "-i", self.key_path,
                 "-o", "StrictHostKeyChecking=no",
                 f"{self.user}@{host}:{remote}", local],
                capture_output=True, text=True,
                timeout=timeout if timeout is not None
                else self.COPY_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise FabricError(
                f"scp from {host} hung past {e.timeout:g}s")
        if result.returncode != 0:
            raise FabricError(f"scp from {host} failed: {result.stderr}")


class Bench:
    """Multi-host benchmark: one node per host, one client per node."""

    # tc shaping applies to each host's primary interface; override via
    # settings.json "wan_dev" when the fleet uses another name.
    WAN_DEV = "eth0"

    def __init__(self, settings, hosts, user="ubuntu", fault_plan=None,
                 wan=None, slos=None):
        self.settings = settings
        self.hosts = hosts
        self.runner = RemoteRunner(user, settings.key_path)
        self.wan_dev = getattr(settings, "wan_dev", None) or self.WAN_DEV
        # graftwan: parse/validate the chaos inputs NOW — a malformed
        # plan must fail before any host is touched, same contract as
        # LocalBench.
        from ..chaos import PlanError, SloError, WanError, parse_plan, \
            parse_slos, parse_wan

        try:
            self.fault_plan = parse_plan(fault_plan) if fault_plan else None
        except PlanError as e:
            raise BenchError("Invalid fault plan", e)
        try:
            self.wan = parse_wan(wan) if wan else None
        except WanError as e:
            raise BenchError("Invalid WAN spec", e)
        try:
            self.slos = parse_slos(slos)
        except SloError as e:
            raise BenchError("Invalid SLO table", e)

    # Provisioning legitimately outlives the runner's 900 s default: a
    # cold apt + full cmake tree build can take tens of minutes, and
    # before the subprocess timeouts landed these calls were unbounded.
    PROVISION_TIMEOUT_S = 3600.0

    def install(self):
        """Install the toolchain + clone the repo on every host
        (remote.py:52-81 analogue, apt/cmake instead of rustup)."""
        cmd = " && ".join([
            "sudo apt-get update",
            "sudo apt-get -y install build-essential cmake ninja-build "
            "python3 python3-pip",
            f"(git clone {self.settings.repo_url} || true)",
        ])
        for host in progress_bar(self.hosts, prefix="Installing:"):
            self.runner.run(host, cmd, timeout=self.PROVISION_TIMEOUT_S)

    def update(self):
        """Pull + rebuild on every host (remote.py:115-130 analogue)."""
        repo = self.settings.repo_name
        cmd = " && ".join([
            f"cd {repo}",
            f"git fetch -f && git checkout -f {self.settings.branch}",
            "git pull -f",
            CommandMaker.compile(),
        ])
        for host in progress_bar(self.hosts, prefix="Updating:"):
            self.runner.run(host, cmd, timeout=self.PROVISION_TIMEOUT_S)

    def _config(self, hosts, node_parameters):
        """Generate keys locally, build the committee from host IPs, upload
        configs (remote.py:132-177 analogue)."""
        subprocess.run(["/bin/sh", "-c", CommandMaker.cleanup()], check=False)
        keys = []
        key_files = [PathMaker.key_file(i) for i in range(len(hosts))]
        for filename in key_files:
            subprocess.run(
                ["/bin/sh", "-c",
                 join(PathMaker.binary_path(), "node")
                 + f" keys --filename {filename}"],
                check=True)
            keys.append(Key.from_file(filename))
        names = [k.name for k in keys]
        base = self.settings.base_port
        consensus = [f"{h}:{base}" for h in hosts]
        front = [f"{h}:{base - 2000}" for h in hosts]
        mempool = [f"{h}:{base - 1000}" for h in hosts]
        committee = Committee(names, consensus, front, mempool)
        committee.print(PathMaker.committee_file())
        node_parameters.print(PathMaker.parameters_file())
        repo = self.settings.repo_name
        for i, host in enumerate(hosts):
            self.runner.run(host, f"rm -rf {repo}/.db-* {repo}/.*.json",
                            check=False)
            self.runner.put(host, PathMaker.committee_file(),
                            f"{repo}/{PathMaker.committee_file()}")
            self.runner.put(host, PathMaker.parameters_file(),
                            f"{repo}/{PathMaker.parameters_file()}")
            self.runner.put(host, key_files[i],
                            f"{repo}/{PathMaker.key_file(i)}")
        return committee

    def _check_fault_plan(self, hosts, duration, timeout_delay_ms,
                          faults=0):
        """Reject an unexecutable plan/WAN combination BEFORE any host
        boots (the LocalBench._check_fault_plan analogue: a scripted
        scenario the fleet cannot deliver must not cost a matrix run)."""
        if self.fault_plan is None or not self.fault_plan.events:
            return
        grace = 2 * timeout_delay_ms / 1000 + 3
        if self.fault_plan.max_time() > duration - grace:
            raise BenchError(
                f"fault plan's last event "
                f"(t={self.fault_plan.max_time():g}s) leaves less than "
                f"{grace:g}s of run-window headroom (duration "
                f"{duration}s) for recovery to be observable")
        alive = len(hosts) - faults
        bad = [i for i in self.fault_plan.node_indices() if i >= alive]
        if bad:
            raise BenchError(
                f"fault plan targets node(s) {bad} but only {alive} "
                "replicas will be booted (crash-fault hosts run nothing)")
        if any(e.target == "sidecar" for e in self.fault_plan.events):
            raise BenchError(
                "fault plan targets the sidecar but the remote bench "
                "boots none (sidecar faults are local-harness only for "
                "now)")
        if any(e.action == "surge" for e in self.fault_plan.events):
            raise BenchError(
                "fault plan schedules client surge events, which the "
                "remote bench cannot express yet (it does not track "
                "per-host client boot commands); run the surge scenario "
                "on the local harness")
        from ..chaos.plan import LEADER_CASCADE

        if any(e.target == LEADER_CASCADE for e in self.fault_plan.events):
            raise BenchError(
                "fault plan schedules leader-cascade events, which the "
                "remote bench cannot express yet (it has no live round "
                "estimate to pick the upcoming leaders from); run the "
                "cascade drill on the local harness")
        missing = [name for name in self.fault_plan.link_names()
                   if self.wan is None or self.wan.by_name(name) is None]
        if missing:
            raise BenchError(
                f"fault plan faults link(s) {missing} the WAN spec does "
                "not name (pass --wan with matching links)")
        if self.fault_plan.link_names():
            # A named link whose src is client/sidecar (or a dead
            # replica) lands on NO host's egress: the partition would
            # compile to zero tc commands and fail at injection time,
            # violating the validated-before-boot contract.
            from ..chaos.netem import host_links

            peers = self._wan_peers(hosts[:alive])
            carried = {
                link.label()
                for i in range(alive)
                for link, _ip, _band in host_links(
                    self.wan, f"node:{i}", peers)}
            uncarried = [name for name in self.fault_plan.link_names()
                         if name not in carried]
            if uncarried:
                raise BenchError(
                    f"fault plan faults link(s) {uncarried} that no "
                    "alive host's egress carries (src must be a booted "
                    "node:<i> or '*'; client/sidecar egress is not "
                    "shapeable on this fleet)")

    def _wan_peers(self, hosts) -> dict:
        return {f"node:{i}": host for i, host in enumerate(hosts)}

    def _check_wan(self, hosts, faults=0):
        """Reject a WAN spec the fleet cannot realize BEFORE any host
        boots.  tc shapes only ``node:<i>`` egress on this fleet, so a
        link naming sidecar/client (or a replica that will not boot)
        would compile to zero commands — and the run would still be
        recorded as WAN-shaped (wan.json written, parser notes emitted),
        publishing a clean-LAN measurement as a shaped one.  Also
        compiles every alive host's command list so a per-host band
        overflow (prio caps at 16 bands) surfaces here, not mid-fleet."""
        if self.wan is None:
            return
        from ..chaos.netem import WILDCARD, WanError, tc_setup_commands

        alive = len(hosts) - faults
        realizable = {f"node:{i}" for i in range(alive)}
        bad = sorted({
            ep for link in self.wan.links
            for ep in (link.src, link.dst)
            if ep != WILDCARD and ep not in realizable})
        if bad:
            raise BenchError(
                f"WAN spec names endpoint(s) {bad} no alive host's "
                f"egress can realize ({alive} replicas boot as "
                f"node:0..node:{alive - 1}; sidecar/client links are "
                "local-harness only)")
        peers = self._wan_peers(hosts[:alive])
        try:
            for i in range(alive):
                tc_setup_commands(self.wan, f"node:{i}", peers,
                                  dev=self.wan_dev)
        except WanError as e:
            raise BenchError(str(e))

    def _setup_wan(self, hosts):
        """Install each host's egress shaping from the spec (and tear
        down any stale qdisc first — the compiled command list leads
        with the teardown)."""
        if self.wan is None:
            return
        from ..chaos.netem import tc_setup_commands

        peers = self._wan_peers(hosts)
        Print.info(f"Shaping WAN links on {len(hosts)} host(s)...")
        for i, host in enumerate(hosts):
            for cmd in tc_setup_commands(self.wan, f"node:{i}", peers,
                                         dev=self.wan_dev):
                self.runner.run(host, cmd, timeout=60.0)

    def _teardown_wan(self, hosts):
        if self.wan is None:
            return
        from ..chaos.netem import tc_teardown_command

        for host in hosts:
            try:
                self.runner.run(host, tc_teardown_command(self.wan_dev),
                                check=False, timeout=60.0)
            except ExecutionError:
                pass  # teardown is best-effort; the next setup retries

    def _start_fault_plan(self, hosts, boots):
        if self.fault_plan is None or not self.fault_plan.events:
            return None
        from ..chaos import PlanRunner
        from .faults import RemoteFaultInjector

        Print.info(f"Executing fault plan "
                   f"({len(self.fault_plan.events)} event(s)) across "
                   "the fleet...")
        self._injector = RemoteFaultInjector(
            self.runner, hosts, self.settings.repo_name, boots,
            wan=self.wan, peers=self._wan_peers(hosts), dev=self.wan_dev)
        runner = PlanRunner(self.fault_plan, self._injector)
        runner.start()
        return runner

    def _finish_fault_plan(self, runner):
        """Stop the plan, un-pause stragglers, and hand back the
        executed events for the log step to persist.  Under-execution
        (a skipped event is a FAILED chaos run, same contract as
        LocalBench) is judged in ``run`` AFTER the logs download, so a
        stalled injection never costs the run's evidence — the partial
        chaos-events.json and node/client logs are exactly what you
        need to diagnose it."""
        if runner is None:
            return None
        runner.stop()
        runner.join(timeout=60)
        self._injector.cleanup()
        return runner.events()

    def _run_single(self, hosts, committee, rate, tx_size, faults, duration,
                    timeout, debug=False):
        Print.info(f"Running {len(hosts)} nodes (rate {rate:,} tx/s)...")
        repo = self.settings.repo_name

        # Nodes minus faults; clients only on alive hosts, waiting only on
        # alive fronts (a dead front in --nodes would block the client's
        # readiness loop forever).
        alive = len(hosts) - faults
        rate_share = -(-rate // alive) if alive else 0
        front = committee.front_addresses()[:alive]
        events = None
        # Everything from the first tc command on runs under the
        # teardown finally: a boot or shaping failure mid-fleet must
        # not leave earlier hosts' egress netem-shaped (silently
        # corrupting every later run) or their processes running.
        try:
            self._setup_wan(hosts[:alive])
            boots = {}
            for i, host in enumerate(hosts[:alive]):
                # Clean logs in a separate foreground command: the
                # background wrapper's shell opens the redirect target
                # inside logs/ before the command runs, so an
                # in-command rm would unlink it.
                self.runner.run(
                    host, f"cd {repo} && rm -rf {PathMaker.logs_path()} && "
                          f"mkdir -p {PathMaker.logs_path()}")
                cmd = (f"cd {repo} && "
                       + CommandMaker.run_client(
                           front[i], tx_size, rate_share, timeout,
                           nodes=front))
                self.runner.run_background(
                    host, cmd, f"{repo}/{PathMaker.client_log_file(i)}")
            for i, host in enumerate(hosts[:alive]):
                cmd = (f"cd {repo} && "
                       + CommandMaker.run_node(
                           PathMaker.key_file(i), PathMaker.committee_file(),
                           PathMaker.db_path(i), PathMaker.parameters_file(),
                           debug=debug))
                boots[i] = (cmd, f"{repo}/{PathMaker.node_log_file(i)}")
                self.runner.run_background(host, cmd, boots[i][1])

            # Same plan-origin convention as the local harness: event
            # times offset from the moment clients start being paced.
            sleep(2 * timeout / 1000)
            plan_runner = self._start_fault_plan(hosts[:alive], boots)
            sleep(duration)
            events = self._finish_fault_plan(plan_runner)
        finally:
            self._teardown_wan(hosts[:alive])
            self.kill(hosts)
        return events

    def kill(self, hosts=None):
        """Stop every node/client process on the fleet (fabfile kill)."""
        for host in hosts if hosts is not None else self.hosts:
            # Bracketed dot so the pattern never matches the ssh
            # wrapper shell carrying it (see faults.NODE_PATTERN).
            self.runner.run(host, "pkill -f '[.]/node run'", check=False,
                            timeout=60.0)
            self.runner.run(host, "pkill -f '[.]/client '", check=False,
                            timeout=60.0)

    def _clock_offsets(self, hosts):
        """grafttrace: estimate each host's wall-clock offset through
        the ssh transport (RTT-midpoint probes, obs/trace.py) and
        persist logs/clock-offsets.json keyed by log file name, so the
        trace merger aligns per-host TRACE stamps before stitching.
        Best-effort: an unreachable host contributes offset 0."""
        from time import time as wall

        from ..obs.trace import probe_host_offset

        offsets = {}
        for i, host in enumerate(hosts):
            try:
                # A clock probe is a sub-second `date`: a tight timeout
                # bounds what a dead host can cost the log-collection
                # path (probe_host_offset also bails after one failed
                # dial when no probe has succeeded yet).
                off = probe_host_offset(
                    lambda h, c: self.runner.run(
                        h, c, timeout=10.0).stdout,
                    host, clock=wall, samples=3)
            except (ExecutionError, FabricError):
                continue
            if off:
                offsets[f"node-{i}.log"] = round(off, 6)
        if offsets:
            with open(PathMaker.clock_offsets_file(), "w") as f:
                json.dump(offsets, f)

    def _logs(self, hosts, faults, chaos_events=None):
        subprocess.run(["/bin/sh", "-c", CommandMaker.clean_logs()],
                       check=True)
        repo = self.settings.repo_name
        alive = hosts[:len(hosts) - faults]  # faulty hosts ran nothing
        for i, host in enumerate(
                progress_bar(alive, prefix="Downloading logs:")):
            self.runner.get(host, f"{repo}/{PathMaker.node_log_file(i)}",
                            PathMaker.node_log_file(i))
            self.runner.get(host, f"{repo}/{PathMaker.client_log_file(i)}",
                            PathMaker.client_log_file(i))
        self._clock_offsets(alive)
        # The same on-disk contract as the local harness: the parser
        # reads chaos-events.json / wan.json / slo.json from the logs
        # dir and switches into chaos mode (recovery + SLO verdicts,
        # strict assertions) when they exist.
        if chaos_events is not None:
            with open(PathMaker.chaos_events_file(), "w") as f:
                json.dump(chaos_events, f)
        if self.wan is not None:
            with open(PathMaker.wan_file(), "w") as f:
                json.dump(self.wan.to_json(), f)
        with open(PathMaker.slo_file(), "w") as f:
            json.dump(self.slos, f)
        return LogParser.process(PathMaker.logs_path(), faults=faults)

    def run(self, bench_parameters, node_parameters, debug=False):
        """Full matrix: nodes x rate x runs, appending to result files
        (remote.py:245-300 analogue)."""
        Print.heading("Starting remote benchmark")
        # grafttrace: fleet runs trace by default too (same setdefault
        # contract as LocalBench — an explicit "trace": false wins).
        node_parameters.json.setdefault("trace", True)
        for n in bench_parameters.nodes:
            hosts = self.hosts[:n]
            if len(hosts) < n:
                Print.warn(f"only {len(hosts)} hosts for {n}-node run; "
                           "skipping")
                continue
            self._check_fault_plan(
                hosts, bench_parameters.duration,
                node_parameters.timeout_delay,
                faults=bench_parameters.faults)
            self._check_wan(hosts, faults=bench_parameters.faults)
            committee = self._config(hosts, node_parameters)
            for rate in bench_parameters.rate:
                for run in range(bench_parameters.runs):
                    Print.heading(
                        f"Run {run + 1}/{bench_parameters.runs}: "
                        f"{n} nodes, {rate:,} tx/s")
                    try:
                        events = self._run_single(
                            hosts, committee, rate,
                            bench_parameters.tx_size,
                            bench_parameters.faults,
                            bench_parameters.duration,
                            node_parameters.timeout_delay, debug)
                        parser = self._logs(hosts, bench_parameters.faults,
                                            chaos_events=events)
                        # Judge under-execution AFTER the logs download
                        # (the partial chaos-events.json is the
                        # diagnosis evidence) but BEFORE the result file
                        # is published: a run whose scripted scenario
                        # never finished must not aggregate as a
                        # passing chaos cell.
                        if events is not None and \
                                len(events) < len(self.fault_plan.events):
                            raise BenchError(
                                f"fault plan executed only {len(events)} "
                                f"of {len(self.fault_plan.events)} "
                                "event(s) before the run window closed "
                                "(an earlier injection stalled?)")
                        parser.print(PathMaker.result_file(
                            bench_parameters.faults, n, rate,
                            bench_parameters.tx_size,
                            chain=node_parameters.json["consensus"].get(
                                "chain_depth", 2)))
                    except (ExecutionError, FabricError, ParseError,
                            BenchError) as e:
                        # A failed run must not abort the matrix: print,
                        # skip this cell, keep the downloaded evidence.
                        Print.error(e if isinstance(e, BenchError)
                                    else BenchError("Benchmark failed", e))
                        continue
