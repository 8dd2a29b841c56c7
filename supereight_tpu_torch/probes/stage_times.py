"""Median host time of each stage of a frame, for every preset and phase
G's sharded runs, for the package at a given checkout root.

Run on a CUDA device from the root of this checkout, once for each checkout
to compare, in turns within one machine (for example the parent, this one,
this one, the parent):

    python -m supereight_tpu_torch.probes.stage_times --root DIR \\
        [--runs headline,ofusion,...,G1,G2] [--out FILE]

``DIR`` is the root of a checkout whose ``supereight_tpu_torch`` runs
(built from its own sources); the runs are ``chip_smoke.py``'s, from this
checkout: each preset of ``chip_smoke.RUNS`` at its size over the 96
frames of its cached sequence through ``DenseSLAMSystem.step_staged``
(host clock, the device synchronised after each stage), and G1 / G2 of
``chip_smoke.G_RUNS`` (2 ranks sharing the card over gloo, rank 0's
stages).  Of the other checkout's package only ``DenseSLAMSystem``,
``step_staged``, ``config.apply_preset`` and ``parallel.multihost``'s
``frames`` job are assumed (any checkout with the multi-device map has
them).  Prints one
JSON object: the card's name and power limit, and per run the median ms
of each stage and of their total over the frames after the first 16.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

PKG = "supereight_tpu_torch"
#: frames before the medians start (warm-up, the bootstrap)
SKIP = 16


def _medians(rows):
    out = {k: 1e3 * statistics.median(r[k] for r in rows) for k in rows[0]}
    out["total"] = 1e3 * statistics.median(sum(r.values()) for r in rows)
    return out


def preset_stages(smoke, name: str, dev) -> dict:
    """A preset's stage medians (ms) over its sequence."""
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    sequence = smoke.RUNS[name][0]
    depths, poses = smoke.load_sequence(sequence)
    slam = DenseSLAMSystem((240, 320), smoke.preset_config(name), dev)
    slam.setPose(poses[0])
    rows = []
    for f in range(len(depths)):
        _, stage_s = slam.step_staged(depths[f], smoke.K, f)
        if f >= SKIP:
            rows.append(stage_s)
    return _medians(rows)


def sharded_stages(smoke, name: str, device: str = "cuda") -> dict:
    """Rank 0's stage medians (ms) of a phase-G run, ranks sharing the
    card over gloo."""
    from supereight_tpu_torch.parallel import multihost
    preset, ranks, max_visible, n_frames = smoke.G_RUNS[name]
    job = dict(kind="frames", preset=preset, config=smoke.BASE,
               frames=smoke.FRAMES, n_frames=n_frames,
               max_visible=max_visible, timed=True)
    res = multihost.launch_jobs(ranks, [job], device=device,
                                backend="gloo", timeout=smoke.G_TIMEOUT,
                                group_timeout=smoke.G_GROUP_TIMEOUT)[0]
    return _medians(res[0]["stages"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--runs", default=None,
                    help="comma-separated presets and G runs (default: "
                         "every preset, then G1 and G2)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("stage_times: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    runs = args.runs.split(",") if args.runs else \
        list(smoke.RUNS) + [g for g in smoke.G_RUNS if g != "G3"]
    # the package under ``--root`` in place of this one
    for name in [m for m in sys.modules if m.split(".")[0] == PKG]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(args.root))

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = dict(root=args.root, card=smi, ms={})
    for name in runs:
        res["ms"][name] = sharded_stages(smoke, name) \
            if name in smoke.G_RUNS else preset_stages(smoke, name, dev)
        torch.cuda.empty_cache()
        print(f"# {args.root} {name}: " + ", ".join(
            f"{k} {v:.2f}" for k, v in res["ms"][name].items()),
            flush=True)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
