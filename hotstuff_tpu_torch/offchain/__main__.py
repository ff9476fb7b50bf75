"""CLI for the off-chain signature benchmarks (the reference benchmark's
off-chain-benchmarking/main.py entry point; the port of
hotstuff_tpu/offchain/__main__.py):

  python -m hotstuff_tpu_torch.offchain single [--iters 100]
  python -m hotstuff_tpu_torch.offchain batch [--min 20] [--max 300]
      [--step 20] [--no-device] [--device cuda|cpu] [--csv F] [--plot F]
  python -m hotstuff_tpu_torch.offchain msglen [--iters 20]

``batch`` times the device columns on the card unless ``--no-device``
(host columns only) or ``--device cpu`` (the kernels' plain versions);
without a card it raises.  ``--csv`` needs pandas and ``--plot``
matplotlib, imported only then.
"""

from __future__ import annotations

import argparse

from . import bench


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hotstuff_tpu_torch.offchain")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("single", help="single sign/verify latency")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--schemes", nargs="*",
                   default=["eddsa", "ecdsa", "schnorr", "bls"])
    p.add_argument("--csv")

    p = sub.add_parser("batch", help="batch verify scaling sweep")
    p.add_argument("--min", type=int, default=20)
    p.add_argument("--max", type=int, default=300)
    p.add_argument("--step", type=int, default=20)
    p.add_argument("--no-device", action="store_true",
                   help="host columns only")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the device columns run (default: the "
                        "card; cpu runs the kernels' plain versions)")
    p.add_argument("--csv")
    p.add_argument("--plot")

    p = sub.add_parser("msglen", help="verify cost vs message length")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--csv")

    args = ap.parse_args(argv)
    if args.command == "single":
        rows = bench.measure_single(iters=args.iters,
                                    schemes=tuple(args.schemes))
    elif args.command == "batch":
        sizes = tuple(range(args.min, args.max + 1, args.step))
        rows = bench.measure_batch(sizes=sizes, on_device=not args.no_device,
                                   device=args.device)
        if args.plot:
            bench.plot_batch(rows, args.plot)
    else:
        rows = bench.measure_message_length(iters=args.iters)
    if getattr(args, "csv", None):
        bench.to_csv(rows, args.csv)


if __name__ == "__main__":
    main()
