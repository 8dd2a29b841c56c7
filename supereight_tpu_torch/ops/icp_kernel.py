"""ICP on the card: the hand-written CUDA kernels (`csrc/icp.cu`) and their
plain PyTorch twins.

:func:`icp_track_levels` runs every trip of every pyramid level of a
tracked frame in one launch: the JAX package's per-level ``lax.while_loop``
(`supereight_tpu/pipeline/tracking.py:_level_loop`) over the levels, coarsest
first, with the carry (``tracking.TrackState``: pose, error2, count,
converged, iteration) on the device, and the tracking view K @
inv(raycast_pose) formed inside the launch.  The one-device frame takes
it.

The sharded frame all-reduces the sums between a trip's two halves, so it
runs a level as one launch a trip and one more: :func:`icp_track_reduce`
(kernel A) applies the previous trip's update from its all-reduced sums,
then associates every pixel of a level with the reference maps, writes the
status image and sums the normal equations; :func:`icp_update` (kernel B)
applies the level's last update alone.  Once ``converged`` is set or
``iteration`` has reached ``n_iters`` both change nothing, so the host can
queue every trip of a level without reading anything back.

The sums are one float32 vector of :data:`N_SUMS`: ``error2``, ``JTe[6]``,
JTJ's 21 distinct entries (``JTJ[b][a]`` for ``a <= b``, in the order of
:data:`TRIU`) and ``count``.  A wrapper launches its kernel for CUDA tensors
and takes its twin only for CPU tensors; there is no fallback between the
two.  On the card the kernel writes its outputs in place (kernel A the
carry, the status image and the sums, kernel B the carry's tensors); the
twins return new tensors, and on the CPU they skip a trip after the level
has ended by reading the carry (a CPU tensor: no device sync).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

_K = _build.constants("icp")
#: pixels a CTA of kernel A
THREADS = _K["kThreads"]
#: the most pyramid levels icp_track_levels takes
MAX_LEVELS = _K["kMaxLevels"]
#: threads a CTA of icp_track_levels
LEVEL_THREADS = _K["kLevelThreads"]
#: error2, JTe[6], JTJ's 21 distinct entries, count
N_SUMS = _K["kSums"]
#: JTJ's distinct entries (a, b), a <= b, in the sums' order
TRIU = tuple((a, b) for a in range(6) for b in range(a, 6))
#: the sums hold JTJ[b][a]: its rows and columns, in the sums' order
_ROWS = [b for _, b in TRIU]
_COLS = [a for a, _ in TRIU]
#: [i][j]: the index in the 21 of JTJ[i][j] = JTJ[j][i]
_SYMMETRIC = [[TRIU.index((min(i, j), max(i, j))) for j in range(6)]
              for i in range(6)]

ROBUST = {"none": 0, "huber": 1, "tukey": 2}
ASSOC = {"nearest": 0, "bilinear": 1}

#: kernel launches so far, one counter per kernel
LAUNCHES = {"icp_track_reduce": 0, "icp_update": 0, "icp_track_levels": 0}
#: icp_track_levels' most CTAs by device index (see :func:`levels_grid`)
_GRID = {}
#: its exchange's words and epoch by (device index, stream) (see _words)
_WORDS = {}


def _tracking():
    from supereight_tpu_torch.pipeline import tracking
    return tracking


def pack_sums(error2, JTe, JTJ, count) -> torch.Tensor:
    """``reduce_kernel``'s sums as one float32 vector of N_SUMS."""
    return torch.cat([error2.reshape(1), JTe, JTJ[_ROWS, _COLS],
                      count.reshape(1)])


def unpack_sums(sums: torch.Tensor):
    """(error2, JTe[6], JTJ[6, 6] made symmetric, count) of a sums
    vector.  Its lower triangle holds the entries as ``reduce_kernel``
    summed them, which is the triangle the Cholesky factorisation reads."""
    tri = sums[7:N_SUMS - 1]
    return (sums[0], sums[1:7],
            tri[torch.tensor(_SYMMETRIC, device=sums.device)],
            sums[N_SUMS - 1])


def term_magnitudes(td, weights) -> torch.Tensor:
    """For each of the N_SUMS sums of the track data ``td`` (a
    ``tracking.TrackData``) with IRLS ``weights``, the sum of its terms'
    absolute values (float64): the scale of a float32 sum's rounding, for
    comparing sums added in different orders."""
    ok = (td.result == 1).reshape(-1).double()
    e = td.error.reshape(-1).double()
    J = td.J.reshape(-1, 6).double()
    w = weights.reshape(-1).double()
    jtj = ((w[:, None] * J[:, _ROWS]) * J[:, _COLS]).abs().sum(0)
    return torch.cat([(ok * e * e).sum().reshape(1),
                      (w[:, None] * e[:, None] * J).abs().sum(0), jtj,
                      ok.sum().reshape(1)])


def live(st, n_iters: int) -> torch.Tensor:
    """Whether the level's loop still runs: the negation of the JAX loop's
    ``cond``."""
    return ~st.converged & (st.iteration < n_iters)


def make_scratch(n_px: int, device) -> Optional[Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """Kernel A's workspace for a level of ``n_px`` pixels: a CTA's partial
    sums each and the last-CTA ticket (zero, and the kernel leaves it
    zero); None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    n_cta = -(-n_px // THREADS)
    return (torch.empty((max(n_cta, 1), N_SUMS), dtype=torch.float32,
                        device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def icp_track_reduce_twin(in_vertex, in_normal, ref_vertex, ref_normal,
                          view, st, n_iters: int, result, sums,
                          symmetric=False, robust: str = "none",
                          robust_delta: float = 0.01,
                          assoc: str = "nearest",
                          pending: Optional[torch.Tensor] = None,
                          icp_threshold: float = 0.0):
    """Plain PyTorch version of kernel A: :func:`icp_update_twin` of the
    ``pending`` sums (the previous trip's; none at a level's first trip),
    then ``tracking.track_kernel`` and ``reduce_kernel`` at the carry's
    pose.  Returns (carry, status image, sums): the new ones while the
    level runs, ``result`` and ``sums`` after it has ended."""
    if pending is not None:
        st = icp_update_twin(pending, st, n_iters, icp_threshold)
    tr = _tracking()
    go = live(st, n_iters)
    if not go.is_cuda and not bool(go):
        return st, result, sums
    td = tr.track_kernel(in_vertex, in_normal, ref_vertex, ref_normal,
                         st.pose, view, symmetric=symmetric, assoc=assoc)
    new = pack_sums(*tr.reduce_kernel(td, robust, robust_delta))
    return st, torch.where(go, td.result, result), torch.where(go, new, sums)


def icp_update_twin(sums, st, n_iters: int, icp_threshold: float,
                    twist: Optional[torch.Tensor] = None):
    """Plain PyTorch version of kernel B: ``solve_normal_equations``,
    ``se3_exp``, the pose product and the convergence test.  Returns the
    next carry (``st`` after the level has ended); ``twist``, if given,
    takes the solved twist."""
    from supereight_tpu_torch.pipeline import camera
    from supereight_tpu_torch.pipeline.preprocessing import norm
    tr = _tracking()
    go = live(st, n_iters)
    if not go.is_cuda and not bool(go):
        return st
    error2, JTe, JTJ, count = unpack_sums(sums)
    x = tr.solve_normal_equations(JTe, JTJ)
    if twist is not None:
        twist.copy_(torch.where(go, x, twist))
    return st._replace(
        pose=torch.where(go, camera.se3_exp(x) @ st.pose, st.pose),
        error2=torch.where(go, error2, st.error2),
        count=torch.where(go, count, st.count),
        converged=torch.where(go, norm(x) < icp_threshold, st.converged),
        iteration=st.iteration + go.to(torch.int32))


def _check(fn: str, dev, specs) -> None:
    for name, t, dt, shape in specs:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous {dt} "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _carry_specs(st):
    return [("pose", st.pose, torch.float32, (4, 4)),
            ("error2", st.error2, torch.float32, ()),
            ("count", st.count, torch.float32, ()),
            ("converged", st.converged, torch.bool, ()),
            ("iteration", st.iteration, torch.int32, ())]


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _array(ctype, values):
    """A C array of ``values`` as a (ctypes type, value) pair of
    :func:`_call`."""
    a = (ctype * len(values))(*values)
    return type(a), a


def _lib():
    """The built `csrc/icp.cu`."""
    return _build.load("icp")


def _call(fn: str, args, stream, count: bool = True) -> None:
    """Call ``fn`` of the built `csrc/icp.cu` with ``args`` ((ctypes type,
    value) pairs, a tensor's value its data pointer or None), raise on its
    CUDA error, count the launch (unless ``count`` is False)."""
    c_fn = getattr(_lib(), fn)
    c_fn.argtypes = [t for t, _ in args] + [ctypes.c_void_p]
    c_fn.restype = ctypes.c_int
    err = c_fn(*(v.data_ptr() if isinstance(v, torch.Tensor) else v
                 for _, v in args), stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    if count:
        LAUNCHES[fn] += 1


def icp_track_reduce(in_vertex, in_normal, ref_vertex, ref_normal, view, st,
                     n_iters: int, result, sums, symmetric=False,
                     robust: str = "none", robust_delta: float = 0.01,
                     assoc: str = "nearest", scratch=None,
                     pending: Optional[torch.Tensor] = None,
                     icp_threshold: float = 0.0):
    """Kernel A, one trip of the sharded frame, in one launch: the previous
    trip's update from its all-reduced sums ``pending`` (float32 [N_SUMS],
    as :func:`icp_update` with ``icp_threshold``; None at a level's first
    trip), then the status image (int32 ``result`` [rows, cols]) and the
    sums (float32 ``sums`` [N_SUMS], not ``pending``) of the level
    ``in_vertex`` / ``in_normal`` (float32 [rows, cols, 3], any row and
    column strides, the last dimension contiguous: a strided level or a row
    strip is read in place) against ``ref_vertex`` / ``ref_normal``
    (contiguous float32 [rH, rW, 3]) at that pose; ``view`` = K @
    inv(raycast_pose) (float32 [4, 4]).  ``symmetric``: False, True or a
    bool tensor (the per-frame gate, read on the device); ``robust`` /
    ``robust_delta`` and ``assoc`` as in ``pipeline/tracking.py``.  Returns
    (carry, result, sums).  Where the update ends the level the carry takes
    it and ``result`` and ``sums`` are left as they are; after the level has
    ended nothing changes.  CPU tensors take the twin; CUDA tensors launch
    the kernel, which updates the carry's tensors, ``result`` and ``sums``
    in place, with ``scratch`` from :func:`make_scratch` (allocated here
    when None)."""
    args = (in_vertex, in_normal, ref_vertex, ref_normal, view, st, n_iters,
            result, sums)
    knobs = dict(symmetric=symmetric, robust=robust,
                 robust_delta=robust_delta, assoc=assoc)
    if in_vertex.device.type == "cpu":
        return icp_track_reduce_twin(*args, **knobs, pending=pending,
                                     icp_threshold=icp_threshold)
    dev = in_vertex.device
    if dev.type != "cuda":
        raise ValueError(f"icp_track_reduce: no kernel for device {dev}")
    if robust not in ROBUST or assoc not in ASSOC:
        raise ValueError(f"icp_track_reduce: robust {robust!r}, assoc "
                         f"{assoc!r}")
    rows, cols = in_vertex.shape[:2]
    rH, rW = ref_vertex.shape[:2]
    for name, t in (("in_vertex", in_vertex), ("in_normal", in_normal)):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (rows, cols, 3) or t.stride(2) != 1
                or t.stride()[:2] != in_vertex.stride()[:2]):
            raise ValueError(
                f"icp_track_reduce: {name} must be a float32 ({rows}, "
                f"{cols}, 3) tensor on {dev} with a contiguous last "
                f"dimension and in_vertex's strides, got {t.dtype} "
                f"{tuple(t.shape)} strides {t.stride()} on {t.device}")
    if scratch is None:
        scratch = make_scratch(rows * cols, dev)
    partials, ticket = scratch
    specs = [("ref_vertex", ref_vertex, torch.float32, (rH, rW, 3)),
             ("ref_normal", ref_normal, torch.float32, (rH, rW, 3)),
             ("view", view, torch.float32, (4, 4)),
             ("result", result, torch.int32, (rows, cols)),
             ("sums", sums, torch.float32, (N_SUMS,)),
             ("partials", partials, torch.float32,
              (max(-(-rows * cols // THREADS), 1), N_SUMS)),
             ("ticket", ticket, torch.int32, (1,))] + _carry_specs(st)
    if pending is not None:
        specs.append(("pending", pending, torch.float32, (N_SUMS,)))
        if pending.data_ptr() == sums.data_ptr():
            raise ValueError("icp_track_reduce: pending and sums must be "
                             "two buffers")
    gate = None
    if isinstance(symmetric, torch.Tensor):
        gate = symmetric
        specs.append(("symmetric", gate, torch.bool, ()))
        mode = 2
    else:
        mode = int(bool(symmetric))
    _check("icp_track_reduce", dev, specs)

    from supereight_tpu_torch.pipeline.constants import (DIST_THRESHOLD,
                                                         NORMAL_THRESHOLD)
    delta = np.float32(robust_delta)
    P, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    with torch.cuda.device(dev):
        _call("icp_track_reduce", [
            (P, in_vertex), (P, in_normal),
            (ctypes.c_longlong, in_vertex.stride(0)),
            (ctypes.c_longlong, in_vertex.stride(1)), (i, rows), (i, cols),
            (P, ref_vertex), (P, ref_normal), (i, rH), (i, rW), (P, view),
            (P, st.pose), (P, st.error2), (P, st.count), (P, st.converged),
            (P, st.iteration), (i, n_iters), (f, icp_threshold),
            (P, pending), (i, mode), (P, gate), (i, ROBUST[robust]),
            (f, float(delta)), (f, float(np.float32(1.0) / delta)),
            (i, ASSOC[assoc]), (f, DIST_THRESHOLD), (f, NORMAL_THRESHOLD),
            (P, result), (P, partials), (P, ticket), (P, sums)], _stream(dev))
    return st, result, sums


def icp_update(sums, st, n_iters: int, icp_threshold: float,
               twist: Optional[torch.Tensor] = None):
    """Kernel B, one trip: from the sums (float32 [N_SUMS]) the 6x6
    Cholesky solve (a zero twist where a pivot is not positive or the twist
    is not finite), ``pose = se3_exp(x) @ pose``, ``converged = |x| <
    icp_threshold``, ``iteration + 1``, and the sums' ``error2`` and
    ``count``: the next carry of ``st`` (a ``tracking.TrackState``).  After
    the level has ended the carry is left as it is.  ``twist`` (float32
    [6]), if given, takes the solved twist.  CPU tensors take the twin;
    CUDA tensors launch the kernel, which updates ``st``'s tensors in place
    and returns ``st``."""
    if sums.device.type == "cpu":
        return icp_update_twin(sums, st, n_iters, icp_threshold, twist)
    dev = sums.device
    if dev.type != "cuda":
        raise ValueError(f"icp_update: no kernel for device {dev}")
    specs = [("sums", sums, torch.float32, (N_SUMS,))] + _carry_specs(st)
    if twist is not None:
        specs.append(("twist", twist, torch.float32, (6,)))
    _check("icp_update", dev, specs)
    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        _call("icp_update", [
            (P, sums), (P, st.pose), (P, st.error2), (P, st.count),
            (P, st.converged), (P, st.iteration), (ctypes.c_int, n_iters),
            (ctypes.c_float, icp_threshold), (P, twist)], _stream(dev))
    return st


def levels_grid(dev) -> int:
    """The most CTAs :func:`icp_track_levels` may launch on the CUDA device
    ``dev``: those the card holds at once (the CTAs an SM holds times the
    SMs), as a cooperative launch needs.  Asked of the card once a
    device."""
    dev = torch.device(dev)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _GRID:
        fn = _lib().icp_track_levels_grid
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        n = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = fn(ctypes.byref(n))
        if err != 0 or n.value < 1:
            raise RuntimeError(f"icp_track_levels_grid: CUDA error {err}, "
                               f"{n.value} CTAs")
        _GRID[idx] = n.value
    return _GRID[idx]


def levels_launch(dev, levels, iterations) -> int:
    """The CTAs of :func:`icp_track_levels` on these levels: those that own
    pixels at the largest level that runs a trip, at least 1 and at most
    :func:`levels_grid`'s (a grid the card cannot hold at once is refused
    by the launch)."""
    most = max([iv.shape[0] * iv.shape[1]
                for (iv, _), it in zip(levels, iterations) if it > 0],
               default=0)
    return max(1, min(levels_grid(dev), -(-most // LEVEL_THREADS)))


def _words(dev, n_cta: int):
    """The exchange's tagged words and epoch for the current stream of
    ``dev``, zero when made (each launch leaves them fit for the next; see
    `csrc/icp.cu` ``level_exchange``): one pair a (device, stream), for
    ``n_cta`` CTAs or more."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    have = _WORDS.get(key)
    if have is None or have[0].shape[1] < n_cta:
        have = (torch.zeros((2, n_cta, 32), dtype=torch.int64, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
        _WORDS[key] = have
    return have


def tracking_view(raycast_pose, k) -> torch.Tensor:
    """The tracking view K @ inv(raycast_pose) of the intrinsics ``k`` (fx,
    fy, cx, cy), as ``tracking.track`` forms it on the CPU (on the card
    :func:`icp_track_levels` forms it inside its launch, with these bits)."""
    from supereight_tpu_torch.core.numerics import inv
    from supereight_tpu_torch.pipeline import camera
    return camera.camera_matrix(k) @ inv(raycast_pose)


def icp_track_levels_twin(pose, levels, ref_vertex, ref_normal, view,
                          iterations: Sequence[int], icp_threshold: float,
                          symmetric=False, robust: str = "none",
                          robust_delta: float = 0.01,
                          assoc: str = "nearest", sums=None):
    """Plain PyTorch version of :func:`icp_track_levels`: each level's loop
    as ``tracking._level_loop`` runs it on the CPU (all ``n_iters`` trips
    of :func:`icp_track_reduce_twin` then :func:`icp_update_twin`, the
    carry's ``converged`` and ``iteration`` restarting at 0), coarsest
    first.  ``sums``, if given, takes the last trip's sums."""
    tr = _tracking()
    dev = pose.device
    zero = lambda dt: torch.zeros((), dtype=dt, device=dev)
    st = tr.TrackState(pose=pose.clone(), error2=zero(torch.float32),
                       count=zero(torch.float32), converged=zero(torch.bool),
                       iteration=zero(torch.int32))
    last = torch.zeros(N_SUMS, dtype=torch.float32, device=dev)
    knobs = dict(symmetric=symmetric, robust=robust,
                 robust_delta=robust_delta, assoc=assoc)
    for level in range(len(levels) - 1, -1, -1):
        iv, inm = levels[level]
        n_iters = iterations[level]
        st = st._replace(converged=zero(torch.bool),
                         iteration=zero(torch.int32))
        result = torch.zeros(iv.shape[:-1], dtype=torch.int32, device=dev)
        for _ in range(n_iters):
            _, result, last = icp_track_reduce_twin(
                iv, inm, ref_vertex, ref_normal, view, st, n_iters, result,
                last, **knobs)
            st = icp_update_twin(last, st, n_iters, icp_threshold)
    if sums is not None:
        sums.copy_(last)
    return st, result


def icp_track_levels(pose, levels, ref_vertex, ref_normal, raycast_pose, k,
                     iterations: Sequence[int], icp_threshold: float,
                     symmetric=False, robust: str = "none",
                     robust_delta: float = 0.01, assoc: str = "nearest",
                     sums=None, view=None):
    """Every level's ICP loop of a tracked frame from ``pose`` (float32
    [4, 4]), coarsest first: ``levels[l]`` = (input vertices, input normals)
    of level l (float32 [rows, cols, 3], any row and column strides, the
    last dimension contiguous: the finest level strided by
    ``finest_decimate`` is read in place), at most ``iterations[l]`` trips
    with the exit on ``|twist| < icp_threshold``, against ``ref_vertex`` /
    ``ref_normal`` (contiguous float32 [rH, rW, 3]) seen from
    ``raycast_pose`` (float32 [4, 4]) through the intrinsics ``k`` (float32
    [4]: fx, fy, cx, cy), the view :func:`tracking_view`; the knobs as
    :func:`icp_track_reduce`'s.  Returns (final ``tracking.TrackState``,
    level 0's status image of its last trip, zeros where it ran none);
    ``sums`` (float32 [N_SUMS]), if given, takes the last trip's sums and
    ``view`` (float32 [4, 4]) the view.  CPU tensors take the twin on
    :func:`tracking_view`; CUDA tensors launch the kernel once (a
    cooperative grid of :func:`levels_launch`'s CTAs), which forms the view
    inside its launch, or raise where it cannot launch."""
    knobs = dict(symmetric=symmetric, robust=robust,
                 robust_delta=robust_delta, assoc=assoc)
    if pose.device.type == "cpu":
        v = tracking_view(raycast_pose, k)
        if view is not None:
            view.copy_(v)
        return icp_track_levels_twin(pose, levels, ref_vertex, ref_normal,
                                     v, iterations, icp_threshold,
                                     sums=sums, **knobs)
    dev = pose.device
    fn = "icp_track_levels"
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    if robust not in ROBUST or assoc not in ASSOC:
        raise ValueError(f"{fn}: robust {robust!r}, assoc {assoc!r}")
    n = len(levels)
    if not 1 <= n <= MAX_LEVELS or len(iterations) != n:
        raise ValueError(f"{fn}: {n} levels and {len(iterations)} "
                         f"iteration counts (1 to {MAX_LEVELS} levels)")
    for l, (iv, inm) in enumerate(levels):
        rows, cols = iv.shape[:2]
        for name, t in (("vertices", iv), ("normals", inm)):
            if (t.device != dev or t.dtype != torch.float32
                    or tuple(t.shape) != (rows, cols, 3) or t.stride(2) != 1
                    or t.stride()[:2] != iv.stride()[:2]):
                raise ValueError(
                    f"{fn}: level {l}'s {name} must be a float32 ({rows}, "
                    f"{cols}, 3) tensor on {dev} with a contiguous last "
                    f"dimension and the vertices' strides, got {t.dtype} "
                    f"{tuple(t.shape)} strides {t.stride()} on {t.device}")
    rH, rW = ref_vertex.shape[:2]
    specs = [("pose", pose, torch.float32, (4, 4)),
             ("ref_vertex", ref_vertex, torch.float32, (rH, rW, 3)),
             ("ref_normal", ref_normal, torch.float32, (rH, rW, 3)),
             ("raycast_pose", raycast_pose, torch.float32, (4, 4)),
             ("k", k, torch.float32, (4,))]
    if sums is not None:
        specs.append(("sums", sums, torch.float32, (N_SUMS,)))
    if view is not None:
        specs.append(("view", view, torch.float32, (4, 4)))
    gate = None
    if isinstance(symmetric, torch.Tensor):
        gate = symmetric
        specs.append(("symmetric", gate, torch.bool, ()))
        mode = 2
    else:
        mode = int(bool(symmetric))
    _check(fn, dev, specs)

    n_cta = levels_launch(dev, levels, iterations)
    words, epoch = _words(dev, n_cta)
    f32 = lambda shape: torch.empty(shape, dtype=torch.float32, device=dev)
    st = _tracking().TrackState(
        pose=f32((4, 4)), error2=f32(()), count=f32(()),
        converged=torch.empty((), dtype=torch.bool, device=dev),
        iteration=torch.empty((), dtype=torch.int32, device=dev))
    result = torch.empty(levels[0][0].shape[:2], dtype=torch.int32,
                         device=dev)

    from supereight_tpu_torch.pipeline.constants import (DIST_THRESHOLD,
                                                         NORMAL_THRESHOLD)
    delta = np.float32(robust_delta)
    P, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    with torch.cuda.device(dev):
        _call(fn, [
            (i, n_cta), (i, n),
            _array(P, [iv.data_ptr() for iv, _ in levels]),
            _array(P, [inm.data_ptr() for _, inm in levels]),
            _array(ctypes.c_longlong, [iv.stride(0) for iv, _ in levels]),
            _array(ctypes.c_longlong, [iv.stride(1) for iv, _ in levels]),
            _array(i, [iv.shape[0] for iv, _ in levels]),
            _array(i, [iv.shape[1] for iv, _ in levels]),
            _array(i, [int(it) for it in iterations]),
            (P, ref_vertex), (P, ref_normal), (i, rH), (i, rW),
            (P, raycast_pose), (P, k), (P, pose), (f, icp_threshold),
            (i, mode), (P, gate), (i, ROBUST[robust]), (f, float(delta)),
            (f, float(np.float32(1.0) / delta)), (i, ASSOC[assoc]),
            (f, DIST_THRESHOLD), (f, NORMAL_THRESHOLD), (P, words),
            (P, epoch), (P, st.pose), (P, st.error2), (P, st.count),
            (P, st.converged), (P, st.iteration), (P, result), (P, sums),
            (P, view)], _stream(dev))
    return st, result


def solve_check(sums, poses, icp_threshold: float):
    """The kernel's warp solve and ``solve_step`` (one thread, as
    :func:`icp_update` runs it) on the CUDA tensors ``sums`` (float32 [n,
    N_SUMS]) and ``poses`` (float32 [n, 4, 4]): ((pose, twist, converged)
    of the warp solve, the same of ``solve_step``), for holding the two bit
    for bit.  A check of the kernel's solve, not a path of the frame: its
    launches are not counted."""
    dev = sums.device
    if dev.type != "cuda":
        raise ValueError(f"solve_check: no kernel for device {dev}")
    m = sums.shape[0]
    _check("solve_check", dev, [
        ("sums", sums, torch.float32, (m, N_SUMS)),
        ("poses", poses, torch.float32, (m, 4, 4))])
    out = [(torch.empty((m, 4, 4), dtype=torch.float32, device=dev),
            torch.empty((m, 6), dtype=torch.float32, device=dev),
            torch.empty(m, dtype=torch.bool, device=dev)) for _ in range(2)]
    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        _call("icp_solve_check", [
            (P, sums), (P, poses), (ctypes.c_int, m),
            (ctypes.c_float, icp_threshold),
            *((P, t) for t in out[0]), *((P, t) for t in out[1])],
            _stream(dev), count=False)
    return tuple(out)
