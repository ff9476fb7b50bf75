"""Aggregate raw result files (mean ± stdev across runs) into plot series.

Capability mirror of benchmark/benchmark/aggregate.py:80-174: scans
results/bench-*.txt, groups runs of the same configuration, and emits
latency-vs-rate, tps-vs-committee-size, and robustness series under
plots/.

graftwan adds the matrix path: ``print_matrix`` folds every aggregated
cell into one nodes×rate table per (faults, tx size) — the reference's
headline artifact shape (SURVEY.md §3.5/§6) — as ``plots/matrix-*.txt``
(a peak-TPS table in the §6 baseline-table column order, so TPU-build
numbers sit next to the paper's) plus machine-readable
``plots/matrix.json``.  Chaos columns ride along: runs whose result
files carry graftchaos/SLO notes report per-cell SLO pass/fail counts
and the WAN shape they were measured under, so a shaped or faulted
cell never masquerades as a clean-LAN number.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from glob import glob
from os.path import join
from re import findall, search
from statistics import mean, stdev

from .utils import PathMaker


class Setup:
    def __init__(self, faults, nodes, rate, tx_size, chaos=False):
        self.faults = faults
        self.nodes = nodes
        self.rate = rate
        self.tx_size = tx_size
        self.chaos = chaos  # scripted-fault/WAN run: aggregated apart
        self.max_latency = None

    def __str__(self):
        return (
            f" Faults: {self.faults}\n"
            f" Committee size: {self.nodes}\n"
            f" Input rate: {self.rate} tx/s\n"
            f" Transaction size: {self.tx_size} B\n"
            f" Scripted chaos/WAN: {self.chaos}\n"
            f" Max latency: {self.max_latency} ms\n"
        )

    def __eq__(self, other):
        return isinstance(other, Setup) and str(self) == str(other)

    def __hash__(self):
        return hash(str(self))

    @classmethod
    def from_str(cls, raw):
        faults = int(search(r"Faults: (\d+)", raw).group(1))
        nodes = int(search(r"Committee size: (\d+)", raw).group(1))
        rate = int(search(r"Input rate: ([\d,]+)", raw).group(1).replace(",", ""))
        tx_size = int(
            search(r"Transaction size: ([\d,]+)", raw).group(1).replace(",", ""))
        return cls(faults, nodes, rate, tx_size)


class Result:
    def __init__(self, mean_tps, mean_latency, std_tps=0, std_latency=0,
                 runs=1):
        self.mean_tps = mean_tps
        self.mean_latency = mean_latency
        self.std_tps = std_tps
        self.std_latency = std_latency
        # Repeatability (VERDICT r5 "do this" #4): how many same-settings
        # runs this mean±stdev aggregates — a band over one run is a
        # point estimate wearing a costume, and the artifacts must say
        # which one they are quoting.
        self.runs = runs

    def __str__(self):
        # " TPS: m +/- s tx/s" prefix is frozen (plot.py findall); the
        # run count rides after it.
        return (
            f" TPS: {self.mean_tps} +/- {self.std_tps} tx/s "
            f"over {self.runs} run(s)\n"
            f" Latency: {self.mean_latency} +/- {self.std_latency} ms\n"
        )

    @classmethod
    def from_str(cls, raw):
        tps = int(
            search(r"End-to-end TPS: ([\d,]+)", raw).group(1).replace(",", ""))
        latency = int(
            search(r"End-to-end latency: ([\d,]+)", raw).group(1)
            .replace(",", ""))
        return cls(tps, latency)

    @classmethod
    def aggregate(cls, results):
        assert len(results) > 0
        if len(results) == 1:
            return results[0]
        mean_tps = round(mean(r.mean_tps for r in results))
        mean_latency = round(mean(r.mean_latency for r in results))
        std_tps = round(stdev(r.mean_tps for r in results))
        std_latency = round(stdev(r.mean_latency for r in results))
        return cls(mean_tps, mean_latency, std_tps, std_latency,
                   runs=len(results))


class LogAggregator:
    def __init__(self, max_latencies=None):
        self.max_latencies = max_latencies or []
        data = ""
        for filename in glob(join(PathMaker.results_path(), "bench-*.txt")):
            # Chain-tagged files (bench-3chain-...) are a different commit
            # rule with +1 round of latency; the SUMMARY grammar is frozen
            # (no chain field), so keep them out of the default series
            # instead of averaging two protocols into one record.
            if search(r"bench-\d+chain-", os.path.basename(filename)):
                continue
            with open(filename, "r") as f:
                data += f.read()

        records = defaultdict(list)
        chaos = defaultdict(lambda: {"slo_pass": 0, "slo_fail": 0,
                                     "runs_with_chaos": 0, "wan": None})
        for chunk in data.replace(",", "").split("SUMMARY")[1:]:
            if not chunk:
                continue
            # Failed runs (zero execution time / zero TPS) would silently
            # drag every averaged series down; reject them here instead of
            # trusting result files to be hand-curated.
            exec_time = search(r"Execution time: (\d+)", chunk)
            result = Result.from_str(chunk)
            if (exec_time and int(exec_time.group(1)) == 0) or \
                    result.mean_tps == 0:
                continue
            setup = Setup.from_str(chunk)
            # graftwan: mine the chaos/SLO notes the LogParser wrote so
            # the matrix can mark which cells ran faulted/shaped.  The
            # chaos-ness is part of the Setup IDENTITY: a clean and a
            # shaped/faulted run of the same configuration must never
            # be averaged into one mean (the docstring's no-masquerade
            # contract).
            verdicts = findall(r"Chaos SLO [\w-]+: .*?(PASS|FAIL)", chunk)
            wan = search(r"WAN: (\d+ shaped link[^\n]*)", chunk)
            setup.chaos = bool(
                verdicts or wan
                or search(r"Chaos plan: \d+ event", chunk))
            records[setup].append(result)
            if setup.chaos:
                cell = chaos[setup]
                cell["runs_with_chaos"] += 1
                cell["slo_pass"] += sum(1 for v in verdicts if v == "PASS")
                cell["slo_fail"] += sum(1 for v in verdicts if v == "FAIL")
                if wan:
                    cell["wan"] = wan.group(1).strip()

        self.records = {k: Result.aggregate(v) for k, v in records.items()}
        self.chaos = {k: dict(v) for k, v in chaos.items()
                      if v["runs_with_chaos"] or v["wan"]}

    def print(self):
        os.makedirs(PathMaker.plot_path(), exist_ok=True)
        results = [
            self._print_latency(),
            self._print_tps(scalability=False),
            self._print_tps(scalability=True),
            self._print_robustness(),
        ]
        for name, records in results:
            for setup, values in records.items():
                data = "\n".join(f" Variable value: X={x}\n{y}"
                                 for x, y in values)
                string = (
                    "\n"
                    "-----------------------------------------\n"
                    " RESULTS:\n"
                    "-----------------------------------------\n"
                    f"{setup}"
                    "\n"
                    f"{data}"
                    "-----------------------------------------\n"
                )
                max_lat = f"-{setup.max_latency}" if setup.max_latency else ""
                chaos_tag = "-chaos" if setup.chaos else ""
                filename = join(
                    PathMaker.plot_path(),
                    f"{name}-{setup.faults}-{setup.nodes}-{setup.rate}-"
                    f"{setup.tx_size}{max_lat}{chaos_tag}.txt"
                    .replace("[", "").replace("]", "").replace(" ", ""))
                with open(filename, "w") as f:
                    f.write(string)

    def _print_latency(self):
        """Latency as a function of input rate, per committee size."""
        organized = defaultdict(list)
        for setup, result in self.records.items():
            rate = setup.rate
            setup_key = Setup(setup.faults, setup.nodes, "any",
                              setup.tx_size, chaos=setup.chaos)
            organized[setup_key].append((rate, result))
        for setup_key in organized:
            organized[setup_key].sort(key=lambda x: x[0])
        return "latency", organized

    def _print_tps(self, scalability):
        """Peak TPS under a latency cap, vs committee size (scalability) or
        vs rate."""
        organized = defaultdict(list)
        for max_latency in self.max_latencies:
            for setup, result in self.records.items():
                if result.mean_latency <= max_latency:
                    nodes = setup.nodes
                    rate = setup.rate
                    key = Setup(setup.faults, "x" if scalability else nodes,
                                "any", setup.tx_size, chaos=setup.chaos)
                    key.max_latency = max_latency
                    variable = nodes if scalability else rate
                    organized[key].append((variable, result))
        # keep the best TPS per variable value
        for key, values in organized.items():
            values.sort(key=lambda x: (x[0], x[1].mean_tps))
            best = {}
            for variable, result in values:
                best[variable] = result
            organized[key] = sorted(best.items())
        return ("tps-scalability" if scalability else "tps"), organized

    def _print_robustness(self):
        """TPS/latency as input rate grows (stress behavior)."""
        organized = defaultdict(list)
        for setup, result in self.records.items():
            rate = setup.rate
            key = Setup(setup.faults, setup.nodes, "any",
                        setup.tx_size, chaos=setup.chaos)
            organized[key].append((rate, result))
        for key in organized:
            organized[key].sort(key=lambda x: x[0])
        return "robustness", organized

    # -- repeatability bands (VERDICT r5 "do this" #4) -----------------------

    def bands(self, min_runs: int = 2) -> list:
        """Per-setup repeatability bands from multi-run same-settings
        result files: every configuration with >= ``min_runs`` aggregated
        runs, as JSON-safe dicts quoting mean±stdev — the shape
        results/README's committee rows should be quoted in (a band,
        not a point estimate)."""
        out = []
        for setup, result in sorted(
                self.records.items(),
                key=lambda kv: (kv[0].faults, kv[0].nodes, kv[0].rate)):
            if result.runs < min_runs:
                continue
            out.append({
                "faults": setup.faults, "nodes": setup.nodes,
                "rate": setup.rate, "tx_size": setup.tx_size,
                "chaos": setup.chaos, "runs": result.runs,
                "tps": result.mean_tps, "tps_std": result.std_tps,
                "latency_ms": result.mean_latency,
                "latency_std": result.std_latency,
            })
        return out

    def print_bands(self, min_runs: int = 2):
        """Human-readable repeatability table on stdout (the aggregate
        CLI surfaces it so quoting a band is copy-paste, not archaeology
        over result files)."""
        bands = self.bands(min_runs=min_runs)
        if not bands:
            print(f"no setup has >= {min_runs} same-settings runs yet "
                  "(repeatability bands need repeats)")
            return
        print("Repeatability bands (mean +/- stdev over same-settings "
              "runs):")
        for b in bands:
            chaos = " [chaos]" if b["chaos"] else ""
            print(f"  N={b['nodes']} f={b['faults']} rate={b['rate']:,}"
                  f"{chaos}: {b['tps']:,} +/- {b['tps_std']:,} tx/s, "
                  f"{b['latency_ms']:,} +/- {b['latency_std']:,} ms "
                  f"over {b['runs']} runs")

    # -- graftwan matrix ----------------------------------------------------

    def matrix(self) -> dict:
        """Every aggregated cell as one nodes×rate matrix per
        (faults, tx_size) — the reference's headline artifact shape::

            {(faults, tx_size): {"nodes": [...], "rates": [...],
                                 "cells": {(nodes, rate): {...}}}}

        Cell dicts are JSON-safe (tps/latency ± stdev, plus the chaos
        summary mined from the result files when the run was faulted or
        WAN-shaped).
        """
        out = {}
        for setup, result in self.records.items():
            key = (setup.faults, setup.tx_size)
            group = out.setdefault(
                key, {"nodes": set(), "rates": set(), "cells": {}})
            group["nodes"].add(setup.nodes)
            group["rates"].add(setup.rate)
            cell = {
                "tps": result.mean_tps, "tps_std": result.std_tps,
                "latency_ms": result.mean_latency,
                "latency_std": result.std_latency,
                "runs": result.runs,
            }
            if setup in self.chaos:
                cell["chaos"] = self.chaos[setup]
            # Clean and chaos runs of the same cell aggregate apart;
            # when both exist, the clean mean owns the grid slot and the
            # chaos mean rides along under "chaos_run" (never averaged).
            slot = group["cells"].get((setup.nodes, setup.rate))
            if slot is None:
                group["cells"][(setup.nodes, setup.rate)] = cell
            elif "chaos" in cell:
                slot["chaos_run"] = cell
            else:
                cell["chaos_run"] = slot
                group["cells"][(setup.nodes, setup.rate)] = cell
        for group in out.values():
            group["nodes"] = sorted(group["nodes"])
            group["rates"] = sorted(group["rates"])
        return out

    def print_matrix(self):
        """Write the nodes×rate matrix artifacts: one human-readable
        ``plots/matrix-<faults>-<txsize>.txt`` per group (a TPS/latency
        grid plus a peak-TPS table in the §6 baseline-table column
        order) and machine-readable ``plots/matrix.json`` covering all
        groups.  No result files -> no artifacts, silently (a fresh
        checkout has nothing to matrix)."""
        groups = self.matrix()
        if not groups:
            return
        os.makedirs(PathMaker.plot_path(), exist_ok=True)
        as_json = {}
        for (faults, tx_size), group in sorted(groups.items()):
            nodes, rates, cells = \
                group["nodes"], group["rates"], group["cells"]
            lines = [
                "-----------------------------------------",
                " MATRIX (end-to-end TPS / latency ms):",
                "-----------------------------------------",
                f" Faults: {faults}",
                f" Transaction size: {tx_size} B",
                "",
            ]
            header = " nodes\\rate |" + "".join(
                f" {r:>14,} |" for r in rates)
            lines += [header, " " + "-" * (len(header) - 1)]
            for n in nodes:
                row = f" {n:>10} |"
                for r in rates:
                    cell = cells.get((n, r))
                    if cell is None:
                        row += f" {'-':>14} |"
                        continue
                    text = f"{cell['tps']:,}/{cell['latency_ms']:,}"
                    if cell.get("chaos"):
                        c = cell["chaos"]
                        text += " C" if not c["slo_fail"] else " C!"
                    elif cell.get("chaos_run"):
                        text += " +C"
                    row += f" {text:>14} |"
                lines.append(row)
            lines += [
                "",
                " C = chaos/WAN run (SLO pass), C! = SLO breach,"
                " +C = separate chaos run of this cell (see matrix.json)",
                "",
                " Peak end-to-end TPS per committee size"
                " (the SURVEY §6 baseline-table shape):",
                " | Nodes | Faults | Input rate | Peak e2e TPS |"
                " e2e latency | Chaos |",
                " |---|---|---|---|---|---|",
            ]
            for n in nodes:
                best = None
                for r in rates:
                    cell = cells.get((n, r))
                    if cell and (best is None
                                 or cell["tps"] > best[1]["tps"]):
                        best = (r, cell)
                if best is None:
                    continue
                r, cell = best
                c = cell.get("chaos")
                chaos_col = "-" if not c else (
                    f"{c['slo_pass']} SLO pass"
                    + (f", {c['slo_fail']} FAIL" if c["slo_fail"] else "")
                    + (f"; {c['wan']}" if c.get("wan") else ""))
                lines.append(
                    f" | {n} | {faults} | {r:,} | {cell['tps']:,} |"
                    f" {cell['latency_ms']:,} ms | {chaos_col} |")
            filename = join(PathMaker.plot_path(),
                            f"matrix-{faults}-{tx_size}.txt")
            with open(filename, "w") as f:
                f.write("\n".join(lines) + "\n")
            as_json[f"{faults}-{tx_size}"] = {
                "faults": faults, "tx_size": tx_size,
                "nodes": nodes, "rates": rates,
                "cells": {f"{n}-{r}": cell
                          for (n, r), cell in sorted(cells.items())},
            }
        with open(join(PathMaker.plot_path(), "matrix.json"), "w") as f:
            json.dump(as_json, f, indent=1, sort_keys=True)
