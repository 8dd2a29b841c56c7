"""Whether the port's CPU path repeats itself bit for bit with several
threads: a preset run twice over its cached sequence on the CPU, every
pose and every map table compared.

Run from the root of a checkout (it reads ``chip_smoke.py``'s presets and
sequences):

    python -m supereight_tpu_torch.probes.cpu_repeat --threads 8 \\
        [--runs quality,ofusion,headline] [--frames 96]

Prints one line a run (blocks, whether the two runs' poses, ``n_blocks``,
``overflow``, ``keys``, ``block_index``, ``active``, every voxel channel
and the reference maps are equal, and which are not), then one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def run_once(smoke, name: str, n_frames: int) -> dict:
    """The preset over the first ``n_frames`` frames of its sequence on the
    CPU: every pose, the map's tables and the reference maps."""
    import torch
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    depths, poses = smoke.load_sequence(smoke.RUNS[name][0])
    slam = DenseSLAMSystem((240, 320), smoke.preset_config(name), "cpu")
    slam.setPose(poses[0])
    est = [slam.step(depths[f], smoke.K, f).pose.clone()
           for f in range(min(n_frames, len(depths)))]
    st = slam.state
    m = st.map
    return dict(poses=torch.stack(est), n_blocks=m.n_blocks.clone(),
                overflow=m.overflow.clone(), keys=m.keys.clone(),
                block_index=m.block_index.clone(), active=m.active.clone(),
                ref_vertex=st.ref_vertex.clone(),
                ref_normal=st.ref_normal.clone(),
                **{f"voxels.{k}": v.clone() for k, v in m.voxels.items()})


def compare(a: dict, b: dict) -> list:
    """The names of the tensors that differ (NaNs equal where both are)."""
    import torch
    return [k for k in a if not torch.equal(torch.nan_to_num(a[k]),
                                            torch.nan_to_num(b[k]))
            or not torch.equal(torch.isnan(a[k].float()),
                               torch.isnan(b[k].float()))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--runs", default="quality,ofusion,headline")
    ap.add_argument("--frames", type=int, default=96)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(args.threads)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    out = dict(threads=torch.get_num_threads(), frames=args.frames, runs={})
    for name in args.runs.split(","):
        a, b = (run_once(smoke, name, args.frames) for _ in range(2))
        differ = compare(a, b)
        out["runs"][name] = dict(blocks=int(a["n_blocks"]),
                                 identical=not differ, differ=differ)
        print(f"# {name}: {args.frames} frames twice at "
              f"{out['threads']} threads, {int(a['n_blocks'])} blocks: "
              + ("identical" if not differ else f"differ in {differ}"),
              flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
