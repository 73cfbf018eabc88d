"""Speedup / efficiency tables from the recorded experiment CSVs.

The reference report leads with speedup and efficiency tables (PDF
docs/jfr226_JaredFrazier_mpi_report.pdf Tables 1-2 pure-MPI, Tables 5-6
hybrid; runtime Tables 3/7).  This script computes the same analysis from
this repo's recorded experiment sweeps:

  speedup(P, N)    = median RTIME_seq(N) / median RTIME_par(P, N)
  efficiency(P, N) = speedup(P, N) / P * 100%

Inputs (reference-contract CSVs, nbody-par.c:956 / nbody-seq.c:488):
  sequential-experiments.csv : NBODIES,RTIME,GFLOPS        (bin/sequential-experiments.sh)
  experiments_comm.csv       : SIZE,NODES,CPUS_PER_NODE,NBODIES,RTIME,COMMTIME,RATIO,GFLOPS
                               (bin/experiments.sh --measure-comm)

Usage: python benchmarks/speedup_tables.py [par_csv] [seq_csv]
Emits the tables as markdown.
"""

from __future__ import annotations

import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read_csv(path):
    import csv

    with open(path) as f:
        return [{k: v.strip() for k, v in row.items()}
                for row in csv.DictReader(f)]


def median_runtimes(par_csv, seq_csv):
    """-> (seq: {N: median_rtime}, par: {(P, N): median_rtime},
           ratio: {(P, N): median_comm_ratio})."""
    seq_samples, par_samples, ratio_samples = {}, {}, {}
    for r in _read_csv(seq_csv):
        seq_samples.setdefault(int(r["NBODIES"]), []).append(float(r["RTIME"]))
    for r in _read_csv(par_csv):
        key = (int(r["SIZE"]), int(r["NBODIES"]))
        par_samples.setdefault(key, []).append(float(r["RTIME"]))
        if "RATIO" in r:
            ratio_samples.setdefault(key, []).append(float(r["RATIO"]))
    seq = {n: statistics.median(v) for n, v in seq_samples.items()}
    par = {k: statistics.median(v) for k, v in par_samples.items()}
    ratio = {k: statistics.median(v) for k, v in ratio_samples.items()}
    return seq, par, ratio


def tables(seq, par, ratio=None):
    ns = sorted(seq)
    ps = sorted({p for p, _ in par})
    header = "| N \\ shards | " + " | ".join(str(p) for p in ps) + " |"
    rule = "|---|" + "---|" * len(ps)

    def fmt(title, cell):
        lines = ["**%s**" % title, "", header, rule]
        for n in ns:
            cells = []
            for p in ps:
                if (p, n) in par and n in seq:
                    cells.append(cell(seq[n], par[(p, n)], p))
                else:
                    cells.append("—")
            lines.append("| %s | %s |" % ("{:,}".format(n), " | ".join(cells)))
        return "\n".join(lines)

    speedup = fmt("Speedup vs 1 shard (Tables 1/5 analog)",
                  lambda ts, tp, p: "%.2f×" % (ts / tp))
    eff = fmt("Efficiency = speedup/P (Tables 2/6 analog)",
              lambda ts, tp, p: "%.1f %%" % (ts / tp / p * 100.0))
    runtime = fmt("Median runtime, s (Tables 3/7 analog)",
                  lambda ts, tp, p: "%.3f" % tp)
    seq_line = ("1-shard medians (s): "
                + ", ".join("N=%d: %.3f" % (n, seq[n]) for n in ns))
    parts = [speedup, eff, runtime, seq_line]
    if ratio:
        lines = ["**Communication share (Tables 4/8 analog, median RATIO)**",
                 "", header, rule]
        for n in ns:
            cells = ["%.4f %%" % (ratio[(p, n)] * 100.0)
                     if (p, n) in ratio else "—" for p in ps]
            lines.append("| %s | %s |"
                         % ("{:,}".format(n), " | ".join(cells)))
        parts.append("\n".join(lines))
    return "\n\n".join(parts)


def main(argv):
    par_csv = argv[1] if len(argv) > 1 else os.path.join(
        ROOT, "experiments_comm.csv")
    seq_csv = argv[2] if len(argv) > 2 else os.path.join(
        ROOT, "sequential-experiments.csv")
    seq, par, ratio = median_runtimes(par_csv, seq_csv)
    print(tables(seq, par, ratio))


if __name__ == "__main__":
    main(sys.argv)
