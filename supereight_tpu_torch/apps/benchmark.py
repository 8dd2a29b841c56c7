"""Headless benchmark frontend (counterpart of
`supereight_tpu/apps/benchmark.py`: the same flags, plus ``--device``, and
the same per-frame TSV log).

Reference: `se_apps/src/benchmark.cpp:34-200` (per-frame loop + TSV log) and
the getopt flag set of `se_apps/include/default_parameters.h:63-88`.

Usage (on the card; ``--device cpu`` runs the plain PyTorch path):
    python -m supereight_tpu_torch.apps.benchmark -i scene.raw -s 4.8 \
        -p 0.34,0.5,0.24 -z 4 -c 2 -r 1 -k 481.2,-480,320,240 -o log.tsv
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
import types
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from supereight_tpu_torch import io as seio
from supereight_tpu_torch.config import (SlamConfig, apply_noise_regime,
                                         apply_preset)
from supereight_tpu_torch.io import groundtruth, serialise
from supereight_tpu_torch.pipeline import DenseSLAMSystem
from supereight_tpu_torch.utils.perfstats import Stats


def parse_args(argv=None) -> argparse.Namespace:
    """Flag names follow `default_parameters.h:63-88`."""
    p = argparse.ArgumentParser(description="supereight_tpu_torch benchmark")
    p.add_argument("-i", "--input-file", required=True)
    p.add_argument("-o", "--log-file", default="")
    p.add_argument("-s", "--volume-size", default="4.8",
                   help="metric volume size (one float or x,y,z)")
    p.add_argument("-v", "--volume-resolution", default="256",
                   help="voxels per edge (one int or x,y,z)")
    p.add_argument("-p", "--init-pose", default="0.5,0.5,0",
                   help="initial position as fraction of volume")
    p.add_argument("-k", "--camera", default="",
                   help="fx,fy,cx,cy (at input resolution)")
    p.add_argument("-m", "--mu", type=float, default=0.1)
    p.add_argument("-r", "--compute-size-ratio", type=int, default=1)
    p.add_argument("-t", "--tracking-rate", type=int, default=1)
    p.add_argument("-z", "--integration-rate", type=int, default=2)
    p.add_argument("-c", "--rendering-rate", type=int, default=4)
    p.add_argument("-y", "--pyramid-levels", default="10,5,4")
    p.add_argument("-l", "--icp-threshold", type=float, default=1e-5)
    p.add_argument("-g", "--ground-truth", default="")
    p.add_argument("-G", "--gt-transform", default="",
                   help="16 comma-separated row-major floats")
    p.add_argument("-F", "--bilateral-filter", action="store_true")
    p.add_argument("-d", "--dump-volume", default="",
                   help="save the map checkpoint (.npz) at the end")
    p.add_argument("--dump-mesh", default="",
                   help="write the surface mesh (legacy VTK) at the end")
    p.add_argument("-f", "--fps", type=int, default=0)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--field", choices=("sdf", "ofusion"), default="sdf")
    p.add_argument("--staged", action="store_true",
                   help="time each stage: fills the per-stage TSV columns "
                   "and traces the spans (the summary lists them)")
    p.add_argument("--raycast-rate", type=int, default=1,
                   help="refresh reference maps every Nth frame")
    p.add_argument("--adaptive-raycast", type=float, default=0.0,
                   metavar="DEG",
                   help="motion-adaptive model refresh: raycast once the "
                        "pose has rotated DEG degrees (or moved "
                        "--adaptive-dist metres) since the last refresh")
    p.add_argument("--adaptive-dist", type=float, default=0.12,
                   help="translation trigger (m) for --adaptive-raycast")
    p.add_argument("--adaptive-alloc", type=float, default=0.0,
                   metavar="DEG",
                   help="motion-adaptive allocation march: march once the "
                        "pose has rotated DEG degrees or moved "
                        "--adaptive-alloc-dist metres since the last march")
    p.add_argument("--adaptive-alloc-dist", type=float, default=0.3)
    p.add_argument("--alloc-on-demand", type=float, default=0.0,
                   metavar="FRAC",
                   help="data-driven allocation march: fire when more "
                        "than FRAC of valid depth pixels hits an "
                        "unallocated block")
    p.add_argument("--block-capacity", type=int, default=0,
                   help="voxel-block table capacity (0: auto-size from "
                        "the volume resolution); raise when the run "
                        "warns about dropped allocations")
    p.add_argument("--normals", default="volume",
                   choices=("volume", "stored", "hybrid", "exact"))
    p.add_argument("--icp-decim", type=int, default=1,
                   help="stride the finest ICP level's input maps")
    p.add_argument("--scan-stride", type=float, default=0.5,
                   help="fine-scan step in band thicknesses")
    p.add_argument("--midsolve", action="store_true",
                   help="half-res secant re-solve (pairs with a coarse "
                        "--scan-stride)")
    p.add_argument("--int-budget", type=int, default=0,
                   help="fuse at most this many frustum-candidate blocks "
                        "per frame (0 = the whole table)")
    p.add_argument("--preset", default="",
                   help="named validated knob stack (config.PRESETS); "
                        "explicitly passed flags override preset fields")
    p.add_argument("--live", action="store_true",
                   help="acquire through the live-camera replay reader "
                        "(io.live.LiveReplayReader): the sensor paces the "
                        "stream, slow frames are dropped with the pose held")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline (default: the card)")
    return p.parse_args(argv)


def _triple(text, cast):
    parts = [cast(x) for x in text.split(",")]
    return tuple(parts * 3) if len(parts) == 1 else tuple(parts)


#: explicitly passed flags pin their config fields against preset and
#: noise-regime overrides
_FLAG2FIELD = {
    "--field": "field_type", "--normals": "raycast_normals",
    "-z": "integration_rate", "--integration-rate": "integration_rate",
    "-m": "mu", "--mu": "mu",
    "-v": "volume_resolution",
    "--volume-resolution": "volume_resolution",
    "--block-capacity": "block_capacity",
    "--int-budget": "integrate_budget",
    "--icp-decim": "icp_finest_decimate",
    "--scan-stride": "raycast_scan_stride",
    "--midsolve": "raycast_midsolve",
    "--raycast-rate": "raycast_rate",
    "--adaptive-raycast": "raycast_adaptive_deg",
    "--adaptive-dist": "raycast_adaptive_dist",
    "--adaptive-alloc": "alloc_adaptive_deg",
    "--adaptive-alloc-dist": "alloc_adaptive_dist",
    "--alloc-on-demand": "alloc_on_demand",
    "-F": "bilateral_filter", "--bilateral-filter": "bilateral_filter",
}


def make_config(args, argv) -> SlamConfig:
    """The run's SlamConfig from the flags, with ``--preset`` or, without
    one, the noise regime when -F is on (pinned flags win either way).
    Raises NotImplementedError for a knob the port does not run
    (``SlamConfig.of``)."""
    knobs = dict(
        compute_size_ratio=args.compute_size_ratio,
        tracking_rate=args.tracking_rate,
        integration_rate=args.integration_rate,
        volume_resolution=_triple(args.volume_resolution, int),
        volume_size=_triple(args.volume_size, float),
        initial_pos_factor=_triple(args.init_pose, float),
        pyramid=tuple(int(x) for x in args.pyramid_levels.split(",")),
        mu=args.mu,
        icp_threshold=args.icp_threshold,
        bilateral_filter=args.bilateral_filter,
        field_type=args.field,
        raycast_rate=args.raycast_rate,
        raycast_adaptive_deg=args.adaptive_raycast,
        raycast_adaptive_dist=args.adaptive_dist,
        alloc_adaptive_deg=args.adaptive_alloc,
        alloc_adaptive_dist=args.adaptive_alloc_dist,
        alloc_on_demand=args.alloc_on_demand,
        block_capacity=args.block_capacity or None,
        raycast_normals=args.normals,
        icp_finest_decimate=args.icp_decim,
        raycast_scan_stride=args.scan_stride,
        raycast_midsolve=args.midsolve,
        integrate_budget=args.int_budget,
    )
    cfg = SlamConfig.of(types.SimpleNamespace(**knobs))
    # membership must also catch the --flag=value token form
    pinned = {f for fl, f in _FLAG2FIELD.items()
              if fl in argv or any(a.startswith(fl + "=") for a in argv)}
    if args.preset:
        cfg = apply_preset(args.preset, cfg, pinned=pinned)
        print(f"# preset {args.preset}: field={cfg.field_type}, "
              f"v={cfg.volume_resolution[0]}, -z{cfg.integration_rate}",
              file=sys.stderr)
    else:
        cfg2 = apply_noise_regime(cfg, pinned)
        if cfg2 is not cfg and cfg2.field_type != cfg.field_type:
            print(f"# bilateral filter on: noise regime selected "
                  f"(field={cfg2.field_type}, -z{cfg2.integration_rate}; "
                  f"pass --field to override)", file=sys.stderr)
        cfg = cfg2
    return cfg


def _row(frame, times, pos, tracked, integrated) -> str:
    """One TSV row: frame, the eight times (acquisition .. total), X Y Z,
    tracked, integrated."""
    return (f"{frame}\t" + "\t".join(f"{t:.8f}" for t in times)
            + f"\t{pos[0]:.6f}\t{pos[1]:.6f}\t{pos[2]:.6f}"
            + f"\t{int(tracked)}\t{int(integrated)}\n")


class Run(NamedTuple):
    """What a run leaves: the estimated poses (numpy [4,4], one per sensor
    frame), the system in its final state, the last rendered
    (depth, track, volume) images or None, and the reader it streamed
    from."""
    est_poses: List[np.ndarray]
    system: DenseSLAMSystem
    images: Optional[Tuple]
    reader: object


def run(argv=None) -> Run:
    """The benchmark loop over the stream the flags name."""
    args = parse_args(argv)
    argv_l = sys.argv[1:] if argv is None else list(argv)
    reader = seio.create_reader(args.input_file)
    if args.camera:
        k = np.asarray([float(x) for x in args.camera.split(",")], np.float32)
    else:
        # reference SceneK default (interface.h:171-176)
        k = np.asarray([481.2, -480.0, reader.width / 2.0,
                        reader.height / 2.0], np.float32)
    k = k / args.compute_size_ratio
    cfg = make_config(args, argv_l)

    gt_poses = None
    if args.ground_truth:
        transform = None
        if args.gt_transform:
            transform = np.asarray(
                [float(x) for x in args.gt_transform.split(",")],
                np.float32).reshape(4, 4)
        gt_poses = groundtruth.read_poses(args.ground_truth, transform)

    slam = DenseSLAMSystem((reader.height, reader.width), cfg, args.device)
    n = len(reader)
    if args.max_frames:
        n = min(n, args.max_frames)
    t_start = time.perf_counter()
    with (open(args.log_file, "w") if args.log_file
          else contextlib.nullcontext(sys.stdout)) as log, \
            (Stats.tracing() if args.staged else contextlib.nullcontext()):
        est_poses, images = _stream(args, reader, slam, k, gt_poses, n,
                                    t_start, log)
    wall = time.perf_counter() - t_start
    if not args.quiet:
        print(Stats.summary(), file=sys.stderr)
        print(f"{n} frames in {wall:.2f}s -> {n / wall:.2f} fps",
              file=sys.stderr)

    overflow = int(slam.state.map.overflow)
    if overflow:
        # capacity exhaustion silently corrupts the map (and then the
        # trajectory); surface it loudly
        print(f"WARNING: {overflow} block-allocation requests dropped — "
              f"map capacity ({slam.state.map.capacity}) exhausted; "
              f"re-run with a larger --block-capacity", file=sys.stderr)

    if args.dump_volume:
        serialise.save_map(args.dump_volume, slam.state.map)
    if args.dump_mesh:
        slam.dump_mesh(args.dump_mesh)
    return Run(est_poses, slam, images, reader)


def _stream(args, reader, slam, k, gt_poses, n: int, t_start: float, log):
    """The per-frame loop (`benchmark.cpp:115-158`): acquire, step, render
    every ``-c`` frames, one TSV row a sensor frame.  Returns the estimated
    poses and the last rendered images."""
    live_reader = None
    if args.live:
        from supereight_tpu_torch.io.live import LiveReplayReader
        live_reader = LiveReplayReader(args.input_file,
                                       fps=args.fps or 30.0)
    # TSV columns (`benchmark.cpp:110-112`)
    log.write("frame\tacquisition\tpreprocessing\ttracking\tintegration\t"
              "raycasting\trendering\tcomputation\ttotal\tX\tY\tZ\t"
              "tracked\tintegrated\n")
    est_poses, images = [], None
    frame_period = 1.0 / args.fps if args.fps > 0 else 0.0
    stage_names = ("preprocessing", "tracking", "integration", "raycasting")
    for frame in range(n):
        t0 = time.perf_counter()
        if live_reader is not None:
            nxt = live_reader.read_next()
            if nxt is None:
                break                        # stream ended (camera stopped)
            depth = nxt[0]
            # index-align est_poses/TSV with the SENSOR timeline: frames
            # the consumer was too slow to see keep the previous pose
            src = live_reader._last
            pose_np = slam.state.pose.cpu().numpy()
            while len(est_poses) < src:
                est_poses.append(pose_np)
                log.write(_row(len(est_poses) - 1, (0,) * 8, pose_np[:3, 3],
                               0, 0))
            frame = src
        else:
            depth, _ = reader.read(frame)
        # -f fps pacing: drop frames that arrive late, like the reference's
        # DepthReader::get_next_frame (`interface.h:80-116`)
        if live_reader is None and frame_period > 0:
            due = t_start + frame * frame_period
            lag = time.perf_counter() - due
            if lag > frame_period:
                # a dropped frame keeps the pose and still gets a row, so
                # that est_poses stays index-aligned with the ground truth
                pose_np = slam.state.pose.cpu().numpy()
                est_poses.append(pose_np)
                log.write(_row(frame, (time.perf_counter() - t0,)
                               + (0,) * 7, pose_np[:3, 3], 0, 0))
                continue
            if lag < 0:
                time.sleep(-lag)
        t1 = time.perf_counter()
        gt = gt_poses[frame] if gt_poses is not None else None
        if args.staged:
            st, stage_t = slam.step_staged(depth, k, frame, gt_pose=gt)
            for name, dt in stage_t.items():
                Stats.sample(name, dt)
        else:
            st = slam.step(depth, k, frame, gt_pose=gt)
            slam.synchronize()
            stage_t = {}
        t2 = time.perf_counter()
        # render the triptych every rendering_rate frames
        # (`benchmark.cpp:150-158`)
        t_render = 0.0
        if args.rendering_rate > 0 and frame % args.rendering_rate == 0:
            tr = time.perf_counter()
            images = (slam.renderDepth(), slam.renderTrack(),
                      slam.renderVolume())
            slam.synchronize()
            t_render = time.perf_counter() - tr
            Stats.sample("rendering", t_render)
        t3 = time.perf_counter()
        pose_np = st.pose.cpu().numpy()
        est_poses.append(pose_np)
        Stats.sample("computation", t2 - t1)
        Stats.sample("total", t3 - t0)
        log.write(_row(frame, (t1 - t0,)
                       + tuple(stage_t.get(s, 0.0) for s in stage_names)
                       + (t_render, t2 - t1, t3 - t0), pose_np[:3, 3],
                       st.tracked, st.integrated))
    return est_poses, images


def main(argv=None) -> List[np.ndarray]:
    """Runs the stream; returns the estimated poses."""
    return run(argv).est_poses


if __name__ == "__main__":
    main()
