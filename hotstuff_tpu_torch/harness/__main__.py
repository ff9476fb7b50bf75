"""Benchmark harness CLI — the `fab local/remote/plot/...` surface of the
reference (benchmark/fabfile.py:11-155) as a module entry point, the
port's copy of hotstuff_tpu/harness/__main__.py:

  python -m hotstuff_tpu_torch.harness local [--nodes 4] [--rate 100000] ...
  python -m hotstuff_tpu_torch.harness plot
  python -m hotstuff_tpu_torch.harness aggregate
  python -m hotstuff_tpu_torch.harness logs [DIR]
"""

from __future__ import annotations

import argparse
import sys


def cmd_local(args):
    from .config import BenchParameters, NodeParameters
    from .local import LocalBench
    from .utils import BenchError, Print

    use_sidecar = (args.tpu_sidecar or args.sidecar_host_crypto
                   or args.scheme == "bls")
    bench_params = BenchParameters({
        "faults": args.faults,
        "nodes": [args.nodes],
        "rate": [args.rate],
        "tx_size": args.tx_size,
        "duration": args.duration,
        "tpu_sidecar": use_sidecar,
        "sidecar_host_crypto": args.sidecar_host_crypto,
        "sidecar_warm_rlc": args.warm_rlc,
        "sidecar_mesh": args.sidecar_mesh,
        "scheme": args.scheme,
        "fault_plan": args.fault_plan,
        "wan": args.wan,
        "slo": args.slo,
        "twins": args.twins,
    })
    node_params = NodeParameters.default(
        tpu_sidecar=(f"127.0.0.1:{LocalBench.SIDECAR_PORT}"
                     if use_sidecar else None),
        scheme=args.scheme if args.scheme != "ed25519" else None,
        chain=args.chain, dag=args.dag)
    node_params.json["mempool"]["batch_size"] = args.batch_size
    node_params.json["mempool"]["max_batch_delay"] = args.batch_delay
    node_params.json["consensus"]["timeout_delay"] = args.timeout
    try:
        ret = LocalBench(bench_params, node_params).run(debug=args.debug)
        print(ret.result())
        if args.output:
            ret.print(args.output)
    except BenchError as e:
        Print.error(e)
        sys.exit(1)


def cmd_aggregate(args):
    from .aggregate import LogAggregator

    agg = LogAggregator(max_latencies=args.max_latency)
    agg.print()
    agg.print_matrix()
    agg.print_bands()
    print("aggregated series + matrix written to plots/")


def cmd_plot(args):
    from .aggregate import LogAggregator
    from .plot import Ploter, PlotError

    agg = LogAggregator(max_latencies=args.max_latency)
    agg.print()
    agg.print_matrix()
    try:
        ploter = Ploter()
        ploter.plot_latency()
        ploter.plot_robustness()
        if args.max_latency:
            ploter.plot_tps()
        try:
            ploter.plot_matrix()
        except PlotError:
            pass  # a single-cell matrix has nothing to draw
        # grafttrace artifacts from the LAST run's logs dir (per-stage
        # latency histograms + the sampled metrics time series); absent
        # when the last run predates tracing or booted no sidecar.
        for fn in (ploter.plot_trace, ploter.plot_metrics):
            try:
                fn()
            except PlotError:
                pass
        print("plots written to plots/")
    except PlotError as e:
        print(f"plot failed: {e}")
        sys.exit(1)


def cmd_logs(args):
    from .logs import LogParser, ParseError

    try:
        parser = LogParser.process(args.directory, faults=args.faults)
        print(parser.result())
    except ParseError as e:
        print(f"parse failed: {e}")
        sys.exit(1)


def _load_settings(args):
    from .settings import Settings, SettingsError
    from .utils import BenchError

    try:
        return Settings.load(args.settings)
    except SettingsError as e:
        raise BenchError("Failed to load settings", e)


def _resolve_hosts(args, settings):
    """Explicit --hosts beats settings.json's \"hosts\" list beats the
    cloud inventory (remote.py:31-50 host discovery analogue)."""
    if args.hosts:
        return args.hosts
    if settings.hosts:
        return settings.hosts
    from .instance import InstanceManager

    return InstanceManager(settings).hosts()


def cmd_remote(args):
    from .config import BenchParameters, ConfigError, NodeParameters
    from .remote import Bench
    from .utils import BenchError, Print

    try:
        settings = _load_settings(args)
        hosts = _resolve_hosts(args, settings)
        bench_params = BenchParameters({
            "faults": args.faults,
            "nodes": args.nodes,
            "rate": args.rate,
            "tx_size": args.tx_size,
            "duration": args.duration,
            "runs": args.runs,
        })
        node_params = NodeParameters.default(chain=args.chain)
        bench = Bench(settings, hosts, user=args.user,
                      fault_plan=args.fault_plan, wan=args.wan,
                      slos=args.slo)
        if args.install:
            bench.install()
        if args.update:
            bench.update()
        bench.run(bench_params, node_params, debug=args.debug)
    except ConfigError as e:
        Print.error(BenchError("Invalid benchmark parameters", e))
        sys.exit(1)
    except BenchError as e:
        Print.error(e)
        sys.exit(1)


def cmd_install(args):
    from .remote import Bench
    from .utils import BenchError, Print

    try:
        settings = _load_settings(args)
        hosts = _resolve_hosts(args, settings)
        Bench(settings, hosts, user=args.user).install()
    except BenchError as e:
        Print.error(e)
        sys.exit(1)


def cmd_kill(args):
    """Stop every node/client on the fleet (fabfile.py kill analogue)."""
    from .remote import Bench
    from .utils import BenchError, Print

    try:
        settings = _load_settings(args)
        hosts = _resolve_hosts(args, settings)
        Bench(settings, hosts, user=args.user).kill()
        Print.info(f"killed node/client processes on {len(hosts)} host(s)")
    except BenchError as e:
        Print.error(e)
        sys.exit(1)


def cmd_cloud(args):
    """AWS instance lifecycle (fabfile.py create/destroy/start/stop/info
    analogue); requires boto3 + credentials."""
    from .instance import InstanceManager
    from .utils import BenchError, Print

    try:
        settings = _load_settings(args)
        manager = InstanceManager(settings)
        if args.action == "create":
            manager.create_instances(args.instances)
        elif args.action == "destroy":
            manager.terminate_instances()
        elif args.action == "start":
            manager.start_instances()
        elif args.action == "stop":
            manager.stop_instances()
        elif args.action == "info":
            manager.print_info()
    except BenchError as e:
        Print.error(e)
        sys.exit(1)
    except Exception as e:  # boto3/botocore errors (no credentials, API)
        Print.error(BenchError("Cloud operation failed", e))
        sys.exit(1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hotstuff_tpu_torch.harness")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("local", help="run a local 4-node benchmark")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--rate", type=int, default=100_000)
    p.add_argument("--tx-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=15_000)
    p.add_argument("--batch-delay", type=int, default=100,
                   help="mempool max batch delay (ms)")
    p.add_argument("--timeout", type=int, default=1_000)
    p.add_argument("--duration", type=int, default=30, help="seconds")
    p.add_argument("--sidecar-host-crypto", action="store_true",
                   help="run the sidecar with --host-crypto (no device; "
                        "a device sidecar that never becomes ready fails "
                        "the run instead)")
    p.add_argument("--tpu-sidecar", action="store_true",
                   help="route QC verification through the verify "
                        "sidecar on the card")
    p.add_argument("--sidecar-mesh", type=int, default=0, metavar="N",
                   help="run the sidecar with --mesh N --warm-rlc-sharded "
                        "(shard verify launches over an N-device mesh and "
                        "route coalesced batches through the sharded "
                        "one-MSM path; 0 = single device)")
    p.add_argument("--warm-rlc", action="store_true",
                   help="also pre-compile the sidecar's one-MSM RLC "
                        "shapes so coalesced batches route through the "
                        "combined check (adds boot-time compiles, cached "
                        "across restarts)")
    p.add_argument("--chain", type=int, choices=range(2, 9), default=2,
                   metavar="K",
                   help="commit-rule depth: k-chain in [2, 8] (default 2)")
    p.add_argument("--dag", action="store_true",
                   help="graftdag certified-batch mempool: proposals carry "
                        "availability certificates (2f+1 signed batch "
                        "ACKs) instead of relying on payload sync, and "
                        "the leader pipelines rounds without waiting for "
                        "broadcast ACKs")
    p.add_argument("--scheme", choices=["ed25519", "bls"],
                   default="ed25519",
                   help="signature scheme (bls implies --tpu-sidecar)")
    p.add_argument("--fault-plan", default=None, metavar="PATH|SPEC",
                   help="graftchaos fault plan to execute against the "
                        "running bench: a JSON file, or an inline spec "
                        "like '5 sidecar kill; 10 sidecar restart; "
                        "12 node:1 pause; 15 node:1 resume' (times are "
                        "seconds into the run window; the summary "
                        "reports per-fault recovery latency)")
    p.add_argument("--wan", default=None, metavar="PATH|SPEC",
                   help="graftwan link-shape spec (chaos/netem.py): a "
                        "JSON file or inline DSL like 'node:0>sidecar "
                        "latency_ms=40 loss_pct=0.5 name=sc'; realized "
                        "locally by userspace WanProxy instances, so "
                        "link:<name> fault-plan events can partition/"
                        "heal the named links")
    p.add_argument("--slo", default=None, metavar="PATH|SPEC",
                   help="per-fault-class recovery SLO table overrides "
                        "(chaos/slo.py): a JSON file or inline "
                        "'node-kill=8000; link-heal=3000' (ms); chaos "
                        "recovery is judged pass/fail against the table")
    p.add_argument("--twins", action="store_true",
                   help="boot a Twins-style equivocating sibling of "
                        "replica 0 (same keypair, own ports; the honest "
                        "committee splits across the two views) and "
                        "hold the run to the strict no-conflicting-"
                        "commits safety assertion")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--output", help="append summary to this result file")
    p.set_defaults(func=cmd_local)

    p = sub.add_parser("aggregate", help="aggregate results/ into series")
    p.add_argument("--max-latency", type=int, nargs="*", default=[])
    p.set_defaults(func=cmd_aggregate)

    p = sub.add_parser("plot", help="aggregate + plot")
    p.add_argument("--max-latency", type=int, nargs="*", default=[])
    p.set_defaults(func=cmd_plot)

    p = sub.add_parser("logs", help="parse a logs directory")
    p.add_argument("directory", nargs="?", default="logs")
    p.add_argument("--faults", type=int, default=0)
    p.set_defaults(func=cmd_logs)

    def add_fleet_args(p):
        p.add_argument("--settings", default="settings.json")
        p.add_argument("--hosts", nargs="*", default=[],
                       help="override host list (else settings.json "
                            "'hosts', else the cloud inventory)")
        p.add_argument("--user", default="ubuntu")

    p = sub.add_parser("remote",
                       help="multi-host benchmark matrix over ssh")
    add_fleet_args(p)
    p.add_argument("--nodes", type=int, nargs="+", default=[4])
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--rate", type=int, nargs="+", default=[50_000])
    p.add_argument("--tx-size", type=int, default=512)
    p.add_argument("--duration", type=int, default=30)
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--chain", type=int, choices=range(2, 9), default=2,
                   metavar="K",
                   help="commit-rule depth: k-chain in [2, 8] (default 2)")
    p.add_argument("--install", action="store_true",
                   help="install toolchain on hosts first")
    p.add_argument("--update", action="store_true",
                   help="git pull + rebuild on hosts first")
    p.add_argument("--fault-plan", default=None, metavar="PATH|SPEC",
                   help="graftchaos fault plan executed across the fleet "
                        "mid-run over ssh (same schema as local)")
    p.add_argument("--wan", default=None, metavar="PATH|SPEC",
                   help="graftwan link-shape spec compiled to per-host "
                        "'tc qdisc netem' egress shaping (same schema "
                        "as local; needs sudo tc on the hosts)")
    p.add_argument("--slo", default=None, metavar="PATH|SPEC",
                   help="per-fault-class recovery SLO table overrides "
                        "(same schema as local)")
    p.add_argument("--debug", action="store_true")
    p.set_defaults(func=cmd_remote)

    p = sub.add_parser("install", help="install toolchain on the fleet")
    add_fleet_args(p)
    p.set_defaults(func=cmd_install)

    p = sub.add_parser("kill", help="kill node/client on the fleet")
    add_fleet_args(p)
    p.set_defaults(func=cmd_kill)

    for action, help_text in [
        ("create", "create cloud instances"),
        ("destroy", "terminate cloud instances"),
        ("start", "start stopped cloud instances"),
        ("stop", "stop cloud instances"),
        ("info", "print cloud instance info"),
    ]:
        p = sub.add_parser(action, help=help_text)
        p.add_argument("--settings", default="settings.json")
        if action == "create":
            p.add_argument("--instances", type=int, default=2,
                           help="instances per region")
        p.set_defaults(func=cmd_cloud, action=action)

    args = ap.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
