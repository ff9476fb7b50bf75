"""Benchmark harness CLI — the `fab local/remote/plot/...` surface of the
reference (benchmark/fabfile.py:11-155) as a module entry point, the
port's copy of hotstuff_tpu/harness/__main__.py:

  python -m hotstuff_tpu_torch.harness local [--nodes 4] [--rate 100000] ...
  python -m hotstuff_tpu_torch.harness aggregate
  python -m hotstuff_tpu_torch.harness logs [DIR]

``local --fault-plan``, ``plot``, ``remote``, ``install``, ``kill`` and
the cloud actions need modules the port does not have yet
(harness/faults.py, plot.py, remote.py, instance.py): they exit with an
error that names ROADMAP.md Queue A.
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


def cmd_logs(args):
    from .logs import LogParser, ParseError

    try:
        parser = LogParser.process(args.directory, faults=args.faults)
        print(parser.result())
    except ParseError as e:
        print(f"parse failed: {e}")
        sys.exit(1)


def cmd_not_ported(args):
    from .utils import BenchError, Print

    Print.error(BenchError(
        f"'{args.command}' needs {NOT_PORTED[args.command]}, which the "
        "port does not have yet: see ROADMAP.md Queue A"))
    sys.exit(2)


NOT_PORTED = {
    "plot": "harness/plot.py",
    "remote": "harness/remote.py and instance.py",
    "install": "harness/remote.py",
    "kill": "harness/remote.py",
    **{action: "harness/instance.py"
       for action in ("create", "destroy", "start", "stop", "info")},
}


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
                   help="graftchaos fault plan (a JSON file or an inline "
                        "spec like '5 sidecar kill; 10 sidecar restart'); "
                        "parsed, then refused: the port has no fault "
                        "injector yet (ROADMAP.md Queue A)")
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

    p = sub.add_parser("logs", help="parse a logs directory")
    p.add_argument("directory", nargs="?", default="logs")
    p.add_argument("--faults", type=int, default=0)
    p.set_defaults(func=cmd_logs)

    for name in NOT_PORTED:
        p = sub.add_parser(name, help=f"not ported yet ({NOT_PORTED[name]})")
        p.set_defaults(func=cmd_not_ported)

    # An unported command takes any arguments: it only names what is
    # missing.
    args, rest = ap.parse_known_args(argv)
    if rest and args.func is not cmd_not_ported:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    args.func(args)


if __name__ == "__main__":
    main()
