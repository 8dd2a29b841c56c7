"""Two sets of runs of one cell, each run its own process, the same seeds
in both sets, and the spread of each end-to-end metric: what a cell's
bounds are set from.  Not run by the benchmark.

    python3 -m slambench.sets --workload <cell> --seeds 1,2,3,4,5,6 \\
        --seconds 10 [--trace-seeds 7,8] [--out sets.jsonl]

A spread is the distance between the first and third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median.  Per
metric it prints both sets' medians and spreads, the spread with each
set's run farthest from its median left out, and the spread of all runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def trimmed(values):
    """The spread with the run farthest from the median left out, where
    that narrows it."""
    if len(values) < 4:
        return spread(values)
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    rest = values[:far] + values[far + 1:]
    return min(spread(values), spread(rest))


def one(workload, seed, seconds, trace):
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(int(trace))]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    try:
        res = json.loads(lines[-1]) if p.returncode == 0 else None
    except (IndexError, ValueError):
        res = None
    return dict(seed=seed, trace=trace, rc=p.returncode, wall_s=wall,
                result=res, stderr_tail=p.stderr[-3000:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    runs = []
    plan = [(s, False, k) for k in range(args.sets) for s in seeds]
    plan += [(int(s), True, 0) for s in args.trace_seeds.split(",") if s]
    for seed, trace, k in plan:
        r = one(args.workload, seed, args.seconds, trace)
        r["set"] = k
        runs.append(r)
        line = json.dumps(r)
        if out:
            out.write(line + "\n")
            out.flush()
        res = r["result"]
        print(f"set {k} seed {seed} trace {int(trace)} rc {r['rc']} wall "
              f"{r['wall_s']:.1f} s correct "
              f"{res and res['correct']} " + (json.dumps(
                  {m: v['value'] for m, v in res['metrics'].items()})
                  if res else r["stderr_tail"][-1500:]), flush=True)
    for line in summary(runs, args.sets):
        print(line, flush=True)
    if out:
        out.close()
    return 0


def summary(runs, n_sets: int):
    """Per end-to-end metric: each set's median, spread and trimmed
    spread, and the spread of all runs."""
    ok = [r for r in runs if r["result"] and not r["trace"]]
    names = sorted({m for r in ok for m in r["result"]["metrics"]})
    for m in names:
        sets = [[r["result"]["metrics"][m]["value"] for r in ok
                 if r["set"] == k] for k in range(n_sets)]
        sets = [s for s in sets if len(s) >= 3]
        if not sets:
            continue
        allv = [v for s in sets for v in s]
        yield (f"{m}: medians {[round(statistics.median(s), 4) for s in sets]}"
               f" spreads {[round(spread(s), 4) for s in sets]} trimmed "
               f"{[round(trimmed(s), 4) for s in sets]} all "
               f"{spread(allv):.4f}")


if __name__ == "__main__":
    sys.exit(main())
