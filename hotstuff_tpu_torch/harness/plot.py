"""Matplotlib plots over aggregated series
(benchmark/benchmark/plot.py:16-164 capability: latency-vs-throughput,
tps-vs-committee-size, robustness; tps↔bps twin axis).

The port's copy of hotstuff_tpu/harness/plot.py, unchanged.
"""

from __future__ import annotations

from glob import glob
from itertools import cycle
from os.path import join
from re import findall, search

from .utils import PathMaker


class PlotError(Exception):
    pass


class Ploter:
    def __init__(self, width=6.4, height=4.8):
        import matplotlib

        matplotlib.use("Agg")  # headless
        import matplotlib.pyplot as plt

        plt.figure(figsize=(width, height))
        self.plt = plt

    @staticmethod
    def _natural_keys(text):
        def try_cast(t):
            return int(t) if t.isdigit() else t
        return [try_cast(c) for c in findall(r"(\d+|\D+)", text)]

    @staticmethod
    def _tps2bps(x, tx_size):
        return x * tx_size / 1e6

    @staticmethod
    def _bps2tps(x, tx_size):
        return x * 1e6 / tx_size

    def _measurements(self, data):
        values = findall(r"Variable value: X=(\d+)", data)
        tps = findall(r"TPS: (\d+) \+/- (\d+)", data)
        latency = findall(r"Latency: (\d+) \+/- (\d+)", data)
        if not (len(values) == len(tps) == len(latency)):
            raise PlotError("Unequal number of x and y values")
        return (
            [int(x) for x in values],
            [int(x) for x, _ in tps],
            [int(s) for _, s in tps],
            [int(x) for x, _ in latency],
            [int(s) for _, s in latency],
        )

    def _plot(self, x_label, y_label, y_axis, z_axis, type,
              tps_y_axis=False):
        self.plt.clf()
        markers = cycle(["o", "v", "s", "d", "^"])
        files = sorted(glob(join(PathMaker.plot_path(), f"{type}*.txt")),
                       key=self._natural_keys)
        if not files:
            raise PlotError(f"no aggregated data for {type}")
        tx_sizes = set()
        for filename in files:
            with open(filename, "r") as f:
                data = f.read()
            m = search(r"Transaction size: (\d+)", data)
            if m:
                tx_sizes.add(int(m.group(1)))
            values, tps, tps_std, lat, lat_std = self._measurements(data)
            x = values
            y, y_err = y_axis(tps, tps_std, lat, lat_std)
            label = z_axis(data)
            self.plt.errorbar(x, y, yerr=y_err, label=label,
                              marker=next(markers), capsize=3, linestyle="-")
        self.plt.legend(loc="best", fontsize="small")
        self.plt.xlabel(x_label)
        self.plt.ylabel(y_label)
        self.plt.grid(True, alpha=0.3)
        if tps_y_axis and len(tx_sizes) == 1:
            # Twin tps<->MB/s axis (the reference's plot.py:46-54). Only
            # drawn when every series shares one tx size — a mixed plot
            # would mislabel the MB/s scale for all but one series.
            tx_size = tx_sizes.pop()
            self.plt.gca().secondary_yaxis(
                "right",
                functions=(
                    lambda v: self._tps2bps(v, tx_size),
                    lambda v: self._bps2tps(v, tx_size),
                )).set_ylabel("Throughput (MB/s)")
        for ext in ("pdf", "png"):
            self.plt.savefig(PathMaker.plot_file(type, ext),
                             bbox_inches="tight")

    @staticmethod
    def _committee_label(data):
        m = search(r"Committee size: (\d+)", data)
        f = search(r"Faults: (\d+)", data)
        label = f"{m.group(1)} nodes" if m else "?"
        if f and int(f.group(1)):
            label += f" ({f.group(1)} faulty)"
        if search(r"Scripted chaos/WAN: True", data):
            # chaos runs aggregate apart from clean ones (no-masquerade
            # contract); the legend must keep the two series apart too
            label += " [chaos]"
        return label

    def plot_latency(self):
        self._plot(
            "Throughput (tx/s)", "Latency (ms)",
            lambda tps, tps_std, lat, lat_std: (lat, lat_std),
            self._committee_label, "latency")

    def plot_robustness(self):
        self._plot(
            "Input rate (tx/s)", "Throughput (tx/s)",
            lambda tps, tps_std, lat, lat_std: (tps, tps_std),
            self._committee_label, "robustness", tps_y_axis=True)

    def plot_tps(self):
        def label(data):
            m = search(r"Max latency: (\d+)", data)
            return f"max latency {m.group(1)} ms" if m else "tps"
        self._plot("Committee size", "Throughput (tx/s)",
                   lambda tps, tps_std, lat, lat_std: (tps, tps_std),
                   label, "tps-scalability", tps_y_axis=True)

    def plot_trace(self, trace_path=None):
        """grafttrace: per-stage latency histograms from the run's
        ``logs/trace.json`` (Chrome trace events; obs/trace.py).  One
        panel per segment/stage that has samples — the visual form of
        the "Commit critical path" parser note."""
        import json

        path = trace_path or PathMaker.trace_file()
        try:
            with open(path) as f:
                chrome = json.load(f)
        except (OSError, ValueError):
            raise PlotError(f"no trace artifact at {path} (run a traced "
                            "bench first)")
        by_stage = {}
        for ev in chrome.get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            by_stage.setdefault(ev["name"], []).append(
                float(ev.get("dur", 0)) / 1e3)  # us -> ms
        by_stage = {k: v for k, v in by_stage.items() if v}
        if not by_stage:
            raise PlotError("trace.json has no duration events")
        fig, axes = self.plt.subplots(
            1, len(by_stage), squeeze=False,
            figsize=(3.2 * len(by_stage), 3.2))
        for ax, (stage, durs) in zip(axes[0], sorted(by_stage.items())):
            ax.hist(durs, bins=min(30, max(5, len(durs) // 2)))
            ax.set_title(f"{stage} (n={len(durs)})", fontsize=8)
            ax.set_xlabel("Latency (ms)", fontsize=7)
            ax.grid(True, alpha=0.3)
        axes[0][0].set_ylabel("Spans")
        for ext in ("pdf", "png"):
            fig.savefig(PathMaker.plot_file("trace-hist", ext),
                        bbox_inches="tight")
        self.plt.close(fig)

    def plot_metrics(self, metrics_path=None):
        """grafttrace: the sampled OP_STATS time series as throughput /
        queue-wait curves (``logs/metrics.jsonl``), with failed ticks —
        a chaos-killed sidecar's telemetry blackout — marked, so a
        recovery transition is visible as a curve, not a scalar.

        graftscope: when the series carries the C++ node's per-replica
        METRICS records, a second panel overlays every replica's sampled
        commit rate (the straggler-detection curves), with the same
        blackout markers — a replica diverging from the committee is a
        visibly lagging line, not just a parser note."""
        from ..obs import read_samples, split_samples

        path = metrics_path or PathMaker.metrics_file()
        samples, _ = read_samples(path)
        if len(samples) < 2:
            raise PlotError(f"fewer than two metrics samples at {path}")
        sidecar, node = split_samples(samples)
        t0 = min(s["t"] for s in samples)
        xs_ok, sig_rate, wait_p99 = [], [], []
        xs_bad = []
        prev = None
        for s in sorted(sidecar, key=lambda s: s["t"]):
            if not s.get("ok"):
                xs_bad.append(s["t"] - t0)
                prev = None  # a blackout breaks the rate delta chain
                continue
            stats = s.get("stats") or {}
            sigs = stats.get("sigs_launched", 0)
            if prev is not None and s["t"] > prev[0]:
                xs_ok.append(s["t"] - t0)
                sig_rate.append((sigs - prev[1]) / (s["t"] - prev[0]))
                wait = (stats.get("queue_wait") or {}).get("latency") or {}
                wait_p99.append(wait.get("p99_ms", 0))
            prev = (s["t"], sigs)
        by_replica = {}
        for s in sorted(node, key=lambda s: s["t"]):
            rate = (s.get("metrics") or {}).get("commit_rate")
            if isinstance(rate, (int, float)):
                xs, ys = by_replica.setdefault(s["node"], ([], []))
                xs.append(s["t"] - t0)
                ys.append(rate)
        self.plt.clf()
        nrows = 1 + (1 if by_replica else 0)
        fig, axes = self.plt.subplots(
            nrows, 1, squeeze=False, sharex=True,
            figsize=(6.4, 4.8 if nrows == 1 else 7.2))
        ax = axes[0][0]
        ax.plot(xs_ok, sig_rate, marker="o", markersize=3,
                label="verify throughput (sigs/s)")
        ax.set_ylabel("Sigs/s launched")
        ax2 = ax.twinx()
        ax2.plot(xs_ok, wait_p99, color="tab:orange", marker="s",
                 markersize=3, label="latency queue-wait p99 (ms)")
        ax2.set_ylabel("Queue wait p99 (ms)")
        # Blackout markers BEFORE the legends are assembled, so the
        # "failed sample" entry actually appears on chaos runs.
        for r in range(nrows):
            for i, x in enumerate(xs_bad):
                axes[r][0].axvline(
                    x, color="red", alpha=0.4, linestyle="--",
                    label="failed sample (sidecar down)"
                    if i == 0 and r == 0 else None)
        lines, labels = ax.get_legend_handles_labels()
        l2, lb2 = ax2.get_legend_handles_labels()
        ax.legend(lines + l2, labels + lb2, loc="best", fontsize="small")
        ax.grid(True, alpha=0.3)
        if by_replica:
            axr = axes[1][0]
            markers = cycle(["o", "v", "s", "d", "^"])
            for host, (xs, ys) in sorted(by_replica.items()):
                axr.plot(xs, ys, marker=next(markers), markersize=2,
                         linewidth=1, label=host)
            axr.set_ylabel("Commit rate (blocks/s)")
            axr.legend(loc="best", fontsize="x-small")
            axr.grid(True, alpha=0.3)
        axes[-1][0].set_xlabel("Run time (s)")
        for ext in ("pdf", "png"):
            fig.savefig(PathMaker.plot_file("metrics", ext),
                        bbox_inches="tight")
        self.plt.close(fig)

    def plot_matrix(self):
        """graftwan matrix heatmap: one nodes×rate panel of end-to-end
        TPS per (faults, tx_size) group from ``plots/matrix.json``
        (LogAggregator.print_matrix).  Chaos/WAN cells are hatched so a
        faulted or shaped number is visually distinct from a clean-LAN
        one; an SLO breach gets a red edge."""
        import json

        path = join(PathMaker.plot_path(), "matrix.json")
        try:
            with open(path) as f:
                groups = json.load(f)
        except (OSError, ValueError):
            raise PlotError("no matrix.json (run aggregate first)")
        groups = {k: g for k, g in groups.items()
                  if g.get("cells") and len(g["cells"]) >= 2}
        if not groups:
            raise PlotError("matrix has fewer than two cells")
        self.plt.clf()
        fig, axes = self.plt.subplots(
            1, len(groups), squeeze=False,
            figsize=(6.4 * len(groups), 4.8))
        for ax, (key, group) in zip(axes[0], sorted(groups.items())):
            nodes, rates = group["nodes"], group["rates"]
            grid = [[float("nan")] * len(rates) for _ in nodes]
            for (ni, n) in enumerate(nodes):
                for (ri, r) in enumerate(rates):
                    cell = group["cells"].get(f"{n}-{r}")
                    if cell is None:
                        continue
                    grid[ni][ri] = cell["tps"]
                    label = f"{cell['tps']:,}\n{cell['latency_ms']:,} ms"
                    chaos = cell.get("chaos")
                    if chaos:
                        label += "\nC!" if chaos.get("slo_fail") else "\nC"
                    ax.text(ri, ni, label, ha="center", va="center",
                            fontsize=7)
                    if chaos:
                        from matplotlib.patches import Rectangle

                        ax.add_patch(Rectangle(
                            (ri - 0.5, ni - 0.5), 1, 1, fill=False,
                            hatch="//",
                            edgecolor="red" if chaos.get("slo_fail")
                            else "gray", linewidth=1.5))
            im = ax.imshow(grid, aspect="auto", cmap="viridis")
            ax.set_xticks(range(len(rates)),
                          [f"{r:,}" for r in rates], fontsize=7)
            ax.set_yticks(range(len(nodes)), nodes)
            ax.set_xlabel("Input rate (tx/s)")
            ax.set_ylabel("Committee size")
            ax.set_title(f"faults={group['faults']} "
                         f"tx={group['tx_size']}B (TPS; C=chaos/WAN)")
            fig.colorbar(im, ax=ax, shrink=0.8)
        for ext in ("pdf", "png"):
            fig.savefig(PathMaker.plot_file("matrix", ext),
                        bbox_inches="tight")
        self.plt.close(fig)
