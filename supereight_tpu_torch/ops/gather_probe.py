"""Gather-rate probe kernels: the hand-written CUDA kernels
(`csrc/gather_probe.cu`) and their plain PyTorch versions.

Counterparts of the two Pallas kernels of `scripts/pallas_gather_probe.py`:
:func:`lane_shuffle_sum` of ``shuffle_kernel`` (K2, the per-lane gather
rate) and :func:`slab_row_sum` of ``rows_kernel`` (K3, the rate of random
8-row slab loads from a resident table).  A wrapper takes its plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
The plain versions are loops in the kernels' summation order, so kernel and
plain version agree bit for bit.  The kernels compute their own launch
grids; the geometry below, which the bounds need, is read from the same
source (`_build.constants`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_K = _build.constants("gather_probe")
LANES = _K["kLanes"]             # K2: lanes per row; lane indices wrap at 128
SLAB_ROWS = _K["kSlabRows"]      # K3: rows per slab
#: K3: columns a CTA owns (one 128-byte line of a bf16 slab row, one thread
#: a column), and the four chains a0..a3, one CTA each, of a tile's cluster
TILE_COLS = _K["kTileCols"]
CHAINS = _K["kChains"]
#: K3: slabs a stage of its ring, and chain steps whose indices are staged
#: in shared memory at a time
SLAB_STAGE = _K["kStageSlabs"]
INDEX_CHUNK = _K["kIndexChunk"]

#: kernel launches so far, one counter per kernel
LAUNCHES = {"lane_shuffle_sum": 0, "slab_row_sum": 0}


def _check(fn: str, dev, *specs):
    for name, t, dt, shape in specs:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous {dt} "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def slab_grid(wide: int) -> int:
    """K3's grid: a cluster of four CTAs (one a chain) for each tile of
    TILE_COLS columns (the last masked) of each of the slab's rows."""
    return CHAINS * SLAB_ROWS * -(-wide // TILE_COLS)


def shuffle_warp_trips(s: int) -> int:
    """Trips of K2's row loop summed over warps: each row is one trip of
    its CTA's four warps."""
    return LANES // 32 * s


def slab_warp_trips(n: int, wide: int) -> int:
    """Trips of K3's main loop (one whole stage of SLAB_STAGE slabs a trip)
    summed over warps: TILE_COLS / 32 warps a CTA, each staged chunk of
    INDEX_CHUNK steps of a chain taken apart."""
    steps = n // 4
    whole = sum(min(INDEX_CHUNK, steps - i) // SLAB_STAGE
                for i in range(0, steps, INDEX_CHUNK))
    return TILE_COLS // 32 * slab_grid(wide) * whole


def _call(fn: str, ptrs, ints, stream) -> None:
    c_fn = getattr(_build.load("gather_probe"), fn)
    c_fn.argtypes = [ctypes.c_void_p] * len(ptrs) \
        + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    c_fn.restype = ctypes.c_int
    err = c_fn(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")


def _launch(fn: str, ptrs, ints, stream) -> None:
    _call(fn, ptrs, ints, stream)
    LAUNCHES[fn] += 1


def empty_launch(device) -> None:
    """Launch an empty kernel on ``device``'s current stream: the fixed cost
    of a launch, the floor under the kernels' times (not counted)."""
    with torch.cuda.device(device):
        _call("empty_launch", (), (),
              torch.cuda.current_stream(device).cuda_stream)


def lane_shuffle_sum_reference(src: torch.Tensor, idx: torch.Tensor,
                               krep: int) -> torch.Tensor:
    """``out[s, l] = sum_{i<krep} src[s, (idx[s, l] + i) & 127]``, summed in
    order i = 0, 1, ... from 0 (``shuffle_kernel``'s fori_loop)."""
    base = idx.to(torch.int64)
    acc = torch.zeros_like(src)
    for i in range(krep):
        acc = acc + torch.gather(src, 1, (base + i) & (LANES - 1))
    return acc


def lane_shuffle_sum(src: torch.Tensor, idx: torch.Tensor,
                     krep: int) -> torch.Tensor:
    """K2: ``src`` float32[S, 128], ``idx`` int32[S, 128] -> float32[S, 128]
    (see :func:`lane_shuffle_sum_reference`)."""
    if src.device.type == "cpu":
        return lane_shuffle_sum_reference(src, idx, krep)
    if src.device.type != "cuda":
        raise ValueError(f"lane_shuffle_sum: no kernel for {src.device}")
    S = src.shape[0]
    _check("lane_shuffle_sum", src.device,
           ("src", src, torch.float32, (S, LANES)),
           ("idx", idx, torch.int32, (S, LANES)))
    if not 0 <= krep < 2 ** 31:
        raise ValueError(f"lane_shuffle_sum: krep must be in [0, 2^31), got "
                         f"{krep}")
    out = torch.empty_like(src)
    if S == 0:
        return out
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        _launch("lane_shuffle_sum", (src.data_ptr(), idx.data_ptr(),
                                     out.data_ptr()), (S, krep), stream)
    return out


def slab_row_sum_reference(rows: torch.Tensor,
                           table: torch.Tensor) -> torch.Tensor:
    """``((a0 + a1) + a2) + a3`` with ``a_j = sum_i f32(table[rows[4i+j] :
    rows[4i+j] + 8, :])``, each a_j summed in order i = 0, 1, ... from 0
    (``rows_kernel``'s fori_loop)."""
    r = rows.to(torch.int64).reshape(-1, 4)
    slab = torch.arange(SLAB_ROWS, device=rows.device)
    acc = [torch.zeros((SLAB_ROWS, table.shape[1]), dtype=torch.float32,
                       device=table.device) for _ in range(4)]
    for i in range(r.shape[0]):
        s = table[r[i][:, None] + slab].to(torch.float32)   # [4, 8, wide]
        acc = [a + s[j] for j, a in enumerate(acc)]
    return ((acc[0] + acc[1]) + acc[2]) + acc[3]


def slab_row_sum(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K3: ``rows`` int32[n] (n a multiple of 4; each a multiple of 8 with
    ``rows + 8 <= len(table)``, which the kernel does not check), ``table``
    bfloat16[cap, wide] -> float32[8, wide] (see
    :func:`slab_row_sum_reference`)."""
    if table.device.type == "cpu":
        return slab_row_sum_reference(rows, table)
    if table.device.type != "cuda":
        raise ValueError(f"slab_row_sum: no kernel for {table.device}")
    if rows.dim() != 1 or rows.shape[0] % 4 or table.dim() != 2:
        raise ValueError(f"slab_row_sum: rows must be int32[n], n a multiple "
                         f"of 4, and table 2-D; got {tuple(rows.shape)} and "
                         f"{tuple(table.shape)}")
    n = rows.shape[0]
    cap, wide = table.shape
    _check("slab_row_sum", table.device,
           ("rows", rows, torch.int32, (n,)),
           ("table", table, torch.bfloat16, (cap, wide)))
    out = torch.empty((SLAB_ROWS, wide), dtype=torch.float32,
                      device=table.device)
    if wide == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        _launch("slab_row_sum", (rows.data_ptr(), table.data_ptr(),
                                 out.data_ptr()),
                (n, wide), stream)
    return out
