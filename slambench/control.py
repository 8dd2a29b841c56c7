"""The study that sets a cell's check limits: the port's numbers on many
seeds and the control's (the plain reference in bfloat16 in the port's
place) on the same frames, in one process so that set-up is paid once a
seed and nothing else.  Not run by the benchmark.

    python3 -m slambench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 2 [--out control.jsonl]

Each seed prints one JSON line: its numbers (the port against the
reference) and the control's.  The lower reading of a number is the
largest the port gives; the upper the smallest the control gives.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from slambench import check, harness


def study(cell, seeds, seconds: float, device, out=None, log=sys.stderr):
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        r = harness.run(cell, seed, seconds, False, device, t,
                        control="bf16", log=log)
        row = dict(seed=seed, correct=r["correct"],
                   numbers={n: r["check"][n]["value"] for n in check.NUMBERS},
                   control=r["control"], metrics=r["metrics"])
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    for n in check.NUMBERS:
        lo = max(r["numbers"][n] for r in rows)
        up = min(r["control"][n] for r in rows)
        print(f"{n}: lower {lo:.6g} upper {up:.6g} limit "
              f"{cell.limits[n]:.6g}", file=log)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    harness.pin_cpus(device)
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    try:
        study(cell, seeds, args.seconds, device, out)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
