"""The launcher and the worker of the multi-device map (counterpart of
`supereight_tpu/parallel/multihost.py`).

JAX runs one controller process per host over one global mesh
(``jax.distributed``); here every rank is a process.  :func:`launch_jobs`
starts D worker processes (``python -c``, so a child imports the port and
nothing else), each joining one ``torch.distributed`` group over
``tcp://127.0.0.1:<port>`` (a free port the launcher binds first) with an
explicit backend, and runs a list of jobs on every rank; it waits for all
of them with a timeout and kills every worker if one fails or the time
runs out.  Each rank reads its frames itself, as a host of a pod reads its
own stream: nothing broadcasts frames.

Jobs (dicts; see :func:`run_job`):

* ``frames``: the sharded frame (`frame_dist.py`) over a sequence: a
  cached ``.npz`` (``depths`` uint16, ``poses``, ``k``) or the small
  synthetic orbit of the JAX launcher (48x64 at 64^3, rendered by each
  rank); each rank's final state, per-frame poses and times, and the
  fusion and ICP kernels' launches;
* ``split``: the sharded frame from given states, its two halves held
  apart (the tracking half from the state before a frame, the mapping
  half from the pose after it), as ``tests/torch_port_util.step_split``
  does on one device;
* ``mask`` / ``reduce`` / ``raycast`` / ``track``: one sharded stage on
  given inputs (``track``: the strip-sharded coarse-to-fine ICP of
  ``tracking.track(shard=)``, with its final carry);
* ``collectives``: each collective the map issues, on each dtype it
  sends, with rank-dependent values (a check of the backend).

:func:`launch` is the JAX launcher's contract: the ``frames`` job on D
ranks, then the same frames through the one-device partitioned system in
this process, compared (:func:`compare`), returning ``(multi, single)``.

    python -m supereight_tpu_torch.parallel.multihost --ranks 2 \\
        [--preset headline] [--frames N] [--device cuda|cpu] \\
        [--backend nccl|gloo]

Without ``--preset`` it runs the JAX launcher's small orbit; with it the
preset at its full size (256^3 over 4.8 m, capacity 6144, 320x240) over
the first N frames (4 by default, as the JAX launcher runs) of
``bench_data/synthetic_256_frames.npz``.  The comparison holds through
the bootstrap frames; once ICP runs, the order in which the all-reduced
sums add (another order than one device's) moves the pose in its last
bits, and ICP amplifies that from frame to frame.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

#: the JAX launcher's small scale (`supereight_tpu/parallel/multihost.py`)
H, W = 48, 64
N_FRAMES = 4
SIZE, DIM, CAPACITY = 64, 4.8, 1024
K4 = [48.0 * W / 160, 48.0 * H / 120, W / 2.0, H / 2.0]
#: a timed ``frames`` job times rank 0's frames from this one on
TIME_AFTER = 16
#: the preset runs' size and sequence
FULL = dict(volume_resolution=(256,) * 3, volume_size=(4.8,) * 3,
            block_capacity=6144)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEQUENCE = os.path.join(ROOT, "bench_data", "synthetic_256_frames.npz")
K_SEQUENCE = [240.6, 240.0, 160.0, 120.0]

_WORKER_BOOT = ("import sys, json; "
                "from supereight_tpu_torch.parallel import multihost; "
                "multihost.worker_main(json.loads(sys.argv[1]))")


def free_port() -> int:
    """A TCP port free on 127.0.0.1 (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(device: str, ranks: int) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    if device == "cuda":
        import torch
        if torch.cuda.device_count() >= ranks:
            return "nccl"
    return "gloo"


# ----------------------------------------------------------------------
# Frames, configurations, states as numpy
# ----------------------------------------------------------------------

def small_config(**kw) -> dict:
    """The SlamConfig fields of the JAX launcher's small scale."""
    base = dict(volume_resolution=(SIZE,) * 3, volume_size=(DIM,) * 3,
                pyramid=(3, 2, 2), block_capacity=CAPACITY,
                integration_rate=1)
    base.update(kw)
    return base


def small_frames(n: int = N_FRAMES):
    """The JAX launcher's orbit (depths uint16 [n, H, W], poses, k),
    rendered on the CPU by the port's sphere tracer."""
    import torch
    from supereight_tpu_torch.io.synthetic import orbit_poses, render_depth
    k = np.asarray(K4, np.float32)
    poses = orbit_poses(n, DIM, sweep=0.02)
    depths = [np.clip(render_depth(torch.from_numpy(p),
                                   torch.from_numpy(k), DIM, H,
                                   W).numpy() * 1000,
                      0, 65535).astype(np.uint16) for p in poses]
    return np.stack(depths), poses, k


def load_frames(spec: dict):
    """(depths, poses, k) of a job: its ``frames`` npz, else the small
    orbit; the first ``n_frames``."""
    if spec.get("frames"):
        z = np.load(spec["frames"])
        k = np.asarray(z["k"] if "k" in z else K_SEQUENCE, np.float32)
        depths, poses = z["depths"], z["poses"]
    else:
        depths, poses, k = small_frames(spec.get("n_frames", N_FRAMES))
    n = spec.get("n_frames", len(depths))
    return depths[:n], poses[:n], k


def job_config(spec: dict, ranks: int):
    """The job's SlamConfig: ``preset`` over ``config``, partitioned into
    ``ranks``."""
    import dataclasses
    from supereight_tpu_torch.config import SlamConfig, apply_preset
    cfg = SlamConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in spec.get("config", {}).items()})
    if spec.get("preset"):
        cfg = apply_preset(spec["preset"], cfg)
    return dataclasses.replace(cfg, map_partitions=ranks)


def _np(t):
    return t.detach().cpu().numpy()


def state_record(st) -> dict:
    """A FrameState's fields as numpy (the map's ``voxels`` as given: a
    rank's rows of a sharded state)."""
    m = st.map
    return dict(
        pose=_np(st.pose), raycast_pose=_np(st.raycast_pose),
        prev_pose=_np(st.prev_pose), alloc_pose=_np(st.alloc_pose),
        alloc_count=int(st.alloc_count), tracked=bool(st.tracked),
        integrated=bool(st.integrated), model_ref=bool(st.model_ref),
        ref_vertex=_np(st.ref_vertex), ref_normal=_np(st.ref_normal),
        track_result=_np(st.track_result),
        block_index=_np(m.block_index), keys=_np(m.keys),
        n_blocks=int(m.n_blocks), part_counts=_np(m.part_counts),
        active=_np(m.active), overflow=int(m.overflow),
        voxels={k: _np(v) for k, v in m.voxels.items()})


# ----------------------------------------------------------------------
# The worker
# ----------------------------------------------------------------------

def worker_main(spec: dict) -> None:
    """One rank: join the group, run the jobs, write their results to
    ``out_dir/rank<r>.pkl``."""
    import torch
    import torch.distributed as dist
    from .sharding import init_group

    rank, n = spec["rank"], spec["ranks"]
    torch.set_num_threads(1)
    if spec["device"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    comm = init_group(rank, n, spec["init_method"], spec["backend"],
                      spec["timeout"])
    try:
        results = [run_job(comm, job, dev) for job in spec["jobs"]]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(spec["out_dir"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_job(comm, job: dict, dev) -> dict:
    """One job on this rank (see the module docstring)."""
    kind = job["kind"]
    if kind == "frames":
        return _frames_job(comm, job, dev)
    if kind == "split":
        return _split_job(comm, job, dev)
    if kind == "collectives":
        return _collectives_job(comm, dev)
    if kind in _PROBES:
        with open(job["inputs"], "rb") as f:
            inputs = pickle.load(f)
        return _PROBES[kind](comm, inputs, dev)
    raise ValueError(f"unknown job {kind!r}")


def _sharded_step(comm, cfg, slam, job):
    from .frame_dist import frame_knobs, make_process_frame_sharded
    return make_process_frame_sharded(
        comm, slam.field, slam.H, slam.W, **frame_knobs(cfg),
        max_visible_per_device=job.get("max_visible", 1024))


def _frames_job(comm, job: dict, dev) -> dict:
    """The sharded frame over the job's frames; the fusion kernels' counts
    are set to 0 just before the frames and read just after."""
    import torch
    from supereight_tpu_torch.ops import icp_kernel, integrate_kernel as ik
    from supereight_tpu_torch.ops import (numerics_kernel, pyramid_kernel,
                                          raycast_kernel)
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    from .frame_dist import frame_sharding

    rank, n = comm.rank, comm.size
    cfg = job_config(job, n)
    depths, poses, k = load_frames(job)
    slam = DenseSLAMSystem(depths.shape[1:], cfg, dev)
    slam.setPose(poses[0])
    st = frame_sharding(rank, n)(slam.state)
    slam.state = None
    step = _sharded_step(comm, cfg, slam, job)
    kd, neg_y = slam._k(k)
    stats = {} if job.get("timed") else None
    est, tracked, integrated, ms, stages = [], [], [], [], []
    for counts in (ik.LAUNCHES, icp_kernel.LAUNCHES, pyramid_kernel.LAUNCHES,
                   numerics_kernel.LAUNCHES, raycast_kernel.LAUNCHES):
        for name in counts:
            counts[name] = 0
    for f in range(len(depths)):
        depth = slam._depth(depths[f])
        timed = stats is not None and f >= TIME_AFTER and rank == 0
        comm.timed = timed
        times = {} if timed else None
        step.stats = stats if timed else None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        st = step(st, depth, kd, f, neg_y=neg_y, times=times)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        if times is not None:
            stages.append(times)
        est.append(_np(st.pose))
        tracked.append(bool(st.tracked))
        integrated.append(bool(st.integrated))
    out = dict(rank=rank, est=np.stack(est), tracked=tracked,
               integrated=integrated, ms=ms, stages=stages,
               launches={**ik.LAUNCHES, **pyramid_kernel.LAUNCHES,
                         **numerics_kernel.LAUNCHES,
                         **raycast_kernel.LAUNCHES},
               icp_launches=dict(icp_kernel.LAUNCHES),
               state=state_record(st),
               collectives=dict(seconds=dict(comm.seconds),
                                calls=dict(comm.calls),
                                bytes=dict(comm.bytes)),
               exchange=stats)
    if job.get("dump_operands") and rank == 0:
        out["operands"] = fusion_operands_record(st, cfg, n, k,
                                                 len(depths) - 1)
    return out


def fusion_operands_record(st, cfg, n: int, k, frame: int) -> dict:
    """Rank 0's operands of its fusion kernel at ``frame``'s state (its
    local table, the depth, T_cw, K and the timestamp), as numpy, for
    holding the kernel against its twin elsewhere."""
    from supereight_tpu_torch.core.numerics import inv
    from supereight_tpu_torch.pipeline import camera
    from .frame_dist import local_map
    import torch
    loc = local_map(st.map, 0, n)
    depth = st.scaled_depth if cfg.fuse_filtered else st.float_depth
    K = camera.camera_matrix(torch.as_tensor(k, device=depth.device))
    return dict(keys=_np(loc.keys), active=_np(loc.active),
                n_blocks=int(loc.n_blocks),
                voxels={k: _np(v) for k, v in loc.voxels.items()},
                size=loc.size, dim=loc.dim,
                channels=[(c.name, str(c.dtype).removeprefix("torch."),
                           c.init, c.empty) for c in loc.channels],
                depth=_np(depth), T_cw=_np(inv(st.pose)), K=_np(K),
                timestamp=float(np.float32(1.0 / 30.0) * np.float32(frame)),
                field=cfg.field_type)


def _split_job(comm, job: dict, dev) -> dict:
    """Per frame of ``job["states"]`` (a pickle of ``{"depths", "k",
    "before": [...], "after": [...]}``, JAX FrameStates as
    ``convert.state_from_numpy`` takes them): the tracking half from the
    state before, then the mapping half from the pose after."""
    import torch
    from supereight_tpu_torch import convert
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    from .frame_dist import frame_sharding

    rank, n = comm.rank, comm.size
    cfg = job_config(job, n)
    with open(job["states"], "rb") as f:
        data = pickle.load(f)
    depths, k = data["depths"], np.asarray(data["k"], np.float32)
    slam = DenseSLAMSystem(depths.shape[1:], cfg, dev)
    step = _sharded_step(comm, cfg, slam, job)
    kd, neg_y = slam._k(k)
    place = frame_sharding(rank, n)
    records = []
    for f, (before, after) in enumerate(zip(data["before"],
                                            data["after"])):
        st = place(convert.state_from_numpy(before, dev))
        st = step.track_half(st, slam._depth(depths[f]), kd, f,
                             neg_y=neg_y)
        rec = dict(pose=_np(st.pose), tracked=bool(st.tracked),
                   track_result=_np(st.track_result))
        t = lambda name, dt: torch.as_tensor(np.array(after[name]),
                                             dtype=dt, device=dev)
        st = st.replace(pose=t("pose", torch.float32),
                        prev_pose=t("prev_pose", torch.float32),
                        track_result=t("track_result", torch.int32),
                        tracked=bool(after["tracked"]))
        st = step.map_half(st, kd, f, neg_y=neg_y)
        m = st.map
        rec.update(integrated=bool(st.integrated),
                   alloc_count=int(st.alloc_count), n_blocks=int(m.n_blocks),
                   overflow=int(m.overflow),
                   fired=bool(torch.equal(st.raycast_pose, st.pose)),
                   model_ref=bool(st.model_ref),
                   block_index=_np(m.block_index), keys=_np(m.keys),
                   active=_np(m.active), part_counts=_np(m.part_counts),
                   voxels={name: _np(v) for name, v in m.voxels.items()})
        records.append(rec)
    return dict(rank=rank, records=records)


def _collectives_job(comm, dev) -> dict:
    """Every rank sends values made from its rank: the ICP sums (float32),
    a request mask (int32), brick rows (bfloat16), inside flags (bool),
    block rows (int64) and map strips (float32); returns what came
    back."""
    import torch
    r = comm.rank
    # integers below 256: exact in bfloat16
    rows = (torch.arange(4 * 512, device=dev).reshape(4, 512) % 61
            + 64 * r).to(torch.bfloat16)
    return dict(
        sums=_np(comm.all_reduce_sum(torch.full((44,), r + 0.5,
                                                device=dev))),
        mask=_np(comm.all_reduce_sum(torch.arange(
            8, dtype=torch.int32, device=dev) % (r + 2))),
        rows=_np(comm.all_gather_cat(rows).float()),
        flags=_np(comm.all_gather_cat(torch.arange(6, device=dev) % 2
                                      == r % 2)),
        tgt=_np(comm.all_gather_cat(torch.arange(
            5, dtype=torch.int64, device=dev) + 10 * r)),
        maps=_np(comm.all_gather_cat(torch.full((3, 4, 6), float(r),
                                                device=dev))))


def _mask_probe(comm, inp: dict, dev) -> dict:
    import torch
    from .allocation_dist import sharded_sdf_wanted_mask
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    depth = t(inp["depth"])
    fn = sharded_sdf_wanted_mask(comm, *depth.shape, size=inp["size"],
                                 dim=inp["dim"], band=inp["band"])
    return dict(mask=_np(fn(depth, t(inp["pose"]), t(inp["K"]))))


def _reduce_probe(comm, inp: dict, dev) -> dict:
    import torch
    from .tracking_dist import track_step_sharded
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pose, e2, count = track_step_sharded(
        comm, t(inp["pose"]), t(inp["in_vertex"]), t(inp["in_normal"]),
        t(inp["ref_vertex"]), t(inp["ref_normal"]), t(inp["view"]))
    return dict(pose=_np(pose), error2=float(e2), count=float(count))


def _track_probe(comm, inp: dict, dev) -> dict:
    """``tracking.track`` with this rank's strips (``inp``: the pyramid's
    ``depths`` / ``vertices`` / ``normals`` lists, the reference maps, the
    raycast pose, ``k``, ``iterations``, ``icp_threshold``,
    ``finest_decimate`` and the ICP knobs ``kw``)."""
    import torch
    from supereight_tpu_torch.core.numerics import inv
    from supereight_tpu_torch.pipeline import camera, tracking
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    lists = {k: [t(a) for a in inp[k]]
             for k in ("depths", "vertices", "normals")}
    args = (t(inp["pose"]), lists["depths"], lists["vertices"],
            lists["normals"], t(inp["ref_vertex"]), t(inp["ref_normal"]))
    kw = dict(inp["kw"], finest_decimate=inp["finest_decimate"],
              shard=(comm, comm.rank, comm.size))
    pose, ok, result = tracking.track(*args, t(inp["raycast_pose"]),
                                      t(inp["k"]), inp["iterations"],
                                      inp["icp_threshold"], **kw)
    view = camera.camera_matrix(t(inp["k"])) @ inv(t(inp["raycast_pose"]))
    st, _, _ = tracking.track_levels(
        args[0], lists["vertices"], lists["normals"], *args[4:], view,
        inp["iterations"], inp["icp_threshold"], **kw)
    return dict(pose=_np(pose), ok=bool(ok), result=_np(result),
                iteration=int(st.iteration), converged=bool(st.converged))


def _raycast_probe(comm, inp: dict, dev) -> dict:
    import torch
    from supereight_tpu_torch import convert
    from supereight_tpu_torch.config import SlamConfig
    from supereight_tpu_torch.pipeline.system import config_field
    from .raycast_dist import sharded_raycast
    from .sharding import map_sharding
    m = map_sharding(convert.map_from_numpy(inp["map"], dev), comm.rank,
                     comm.size)
    field = config_field(SlamConfig(**inp["config"]))
    fn = sharded_raycast(comm, field, inp["H"], inp["W"], inp["near"],
                         inp["far"], **inp.get("kw", {}))
    v, nrm, t, dropped = fn(m, torch.as_tensor(
        np.asarray(inp["view"], np.float32), device=dev))
    return dict(vertex=_np(v), normal=_np(nrm), t_hit=_np(t),
                dropped=_np(dropped))


_PROBES = {"mask": _mask_probe, "reduce": _reduce_probe,
           "raycast": _raycast_probe, "track": _track_probe}


# ----------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------

def launch_jobs(ranks: int, jobs: list, *, device: str = "cuda",
                backend: Optional[str] = None, timeout: float = 600.0,
                group_timeout: float = 120.0) -> list:
    """Run ``jobs`` on ``ranks`` worker processes; returns, per job, the
    list of every rank's result.  Every worker is killed if one fails or
    the ``timeout`` (seconds, for the whole run) passes; a collective
    waits at most ``group_timeout``."""
    backend = backend or default_backend(device, ranks)
    out_dir = tempfile.mkdtemp(prefix="se_ranks_")
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs, logs = [], []
    try:
        for rank in range(ranks):
            spec = dict(rank=rank, ranks=ranks, device=device,
                        backend=backend, timeout=group_timeout,
                        init_method=f"tcp://127.0.0.1:{port}", jobs=jobs,
                        out_dir=out_dir)
            log = open(os.path.join(out_dir, f"rank{rank}.log"), "w+b")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER_BOOT, json.dumps(spec)],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = "timeout"
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode != 0), None)
        if failed is not None:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            tails = []
            for r, log in enumerate(logs):
                log.seek(0)
                tails.append(f"--- rank {r} (rc {procs[r].returncode}):\n"
                             + log.read().decode(errors="replace")[-3000:])
            raise RuntimeError(
                f"{ranks} ranks on {device}/{backend}: "
                f"{'timed out after %.0f s' % timeout if failed == 'timeout' else 'rank %s failed' % failed}"
                "\n" + "\n".join(tails))
        per_rank = []
        for rank in range(ranks):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                per_rank.append(pickle.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(out_dir, ignore_errors=True)
    return [[per_rank[r][j] for r in range(ranks)] for j in range(len(jobs))]


def gather_ranks(results: list) -> dict:
    """The ``frames`` job's result of rank 0 with the whole brick table
    (every rank's rows in rank order) and every rank's launches (the
    fusion and glue kernels' in ``launches``, the ICP kernels' in
    ``icp_launches``)."""
    out = dict(results[0])
    st = dict(out["state"])
    st["voxels"] = {k: np.concatenate([r["state"]["voxels"][k]
                                       for r in results])
                    for k in st["voxels"]}
    out["state"] = st
    out["launches_per_rank"] = [r["launches"] for r in results]
    out["launches"] = {k: sum(r["launches"][k] for r in results)
                       for k in results[0]["launches"]}
    out["icp_launches_per_rank"] = [r["icp_launches"] for r in results]
    out["icp_launches"] = {k: sum(r["icp_launches"][k] for r in results)
                           for k in results[0]["icp_launches"]}
    return out


def run_single(job: dict, ranks: int, device: str = "cuda") -> dict:
    """The control: the job's frames through the one-device system with
    the same ``ranks`` partitions in this process, without the fusion
    budget (the sharded frame streams every row of a rank)."""
    import dataclasses
    import torch
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    cfg = dataclasses.replace(job_config(job, ranks), integrate_budget=0)
    depths, poses, k = load_frames(job)
    dev = torch.device(device)
    slam = DenseSLAMSystem(depths.shape[1:], cfg, dev)
    slam.setPose(poses[0])
    est, tracked = [], []
    for f in range(len(depths)):
        st = slam.step(depths[f], k, f)
        est.append(_np(st.pose))
        tracked.append(bool(st.tracked))
    return dict(est=np.stack(est), tracked=tracked,
                state=state_record(slam.state))


def compare(multi: dict, single: dict) -> dict:
    """The D-rank run against the one-device control at the JAX package's
    1-vs-N tolerances (`tests/test_sharding.py:324-345`): ``n_blocks``,
    ``part_counts`` and ``overflow`` (where the exchange's dropped blocks
    count) equal, pose within 1e-4, ``ref_vertex`` within 1e-3, the live
    voxels within 1e-4.  Raises AssertionError; returns the largest
    differences."""
    a, b = multi["state"], single["state"]
    if a["n_blocks"] != b["n_blocks"] or a["overflow"] != b["overflow"] \
            or not np.array_equal(a["part_counts"], b["part_counts"]):
        raise AssertionError(
            f"blocks {a['n_blocks']} {a['part_counts']}, overflow "
            f"{a['overflow']} != {b['n_blocks']} {b['part_counts']}, "
            f"{b['overflow']}")
    cap = len(b["keys"])
    n = len(b["part_counts"])
    per = cap // n
    idx = np.arange(cap)
    live = (idx % per) < b["part_counts"][idx // per]
    diffs = dict(
        pose=float(np.abs(a["pose"] - b["pose"]).max()),
        ref_vertex=float(np.abs(a["ref_vertex"] - b["ref_vertex"]).max()),
        voxels=max(float(np.abs(a["voxels"][k][live]
                                - b["voxels"][k][live]).max(initial=0))
                   for k in b["voxels"]))
    for key, tol in (("pose", 1e-4), ("ref_vertex", 1e-3),
                     ("voxels", 1e-4)):
        if not diffs[key] <= tol:
            raise AssertionError(f"{key} differs by {diffs[key]} > {tol}")
    return diffs


def launch(ranks: int = 2, *, preset: Optional[str] = None,
           n_frames: int = N_FRAMES, device: str = "cuda",
           backend: Optional[str] = None, timeout: float = 600.0):
    """The ``frames`` job on ``ranks`` ranks (a preset at full size over
    the cached sequence, else the small orbit), then the one-device
    control, held together (:func:`compare`, JAX `:145-224`).  Returns
    ``(multi, single)``, ``multi["diffs"]`` the largest differences."""
    job = dict(kind="frames", preset=preset,
               config=dict(FULL) if preset else small_config(),
               frames=SEQUENCE if preset else None, n_frames=n_frames)
    multi = gather_ranks(launch_jobs(ranks, [job], device=device,
                                     backend=backend, timeout=timeout)[0])
    single = run_single(job, ranks, device)
    multi["diffs"] = compare(multi, single)
    return multi, single


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--preset", default=None)
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("multihost: no CUDA device (--device cpu runs "
                             "on the CPU)")
    backend = args.backend or default_backend(args.device, args.ranks)
    multi, single = launch(args.ranks, preset=args.preset,
                           n_frames=args.frames, device=args.device,
                           backend=backend, timeout=args.timeout)
    a, b = multi["state"], single["state"]
    print(json.dumps(dict(
        ranks=args.ranks, device=args.device, backend=backend,
        frames=len(multi["est"]), tracked=sum(multi["tracked"]),
        n_blocks=a["n_blocks"], part_counts=a["part_counts"].tolist(),
        single_n_blocks=b["n_blocks"], overflow=a["overflow"],
        diffs=multi["diffs"], launches=multi["launches"],
        median_ms=float(np.median(multi["ms"])))))


if __name__ == "__main__":
    main()
