"""Map checkpoints (counterpart of `supereight_tpu/io/serialise.py`): the
npz checkpoint of the whole VoxelMap, under the JAX package's keys and
meta so that each package reads the other's files, and the reference's
``Octree::save`` binary, whose bytes equal the JAX writer's for the same
map.  Files are read and written on the host with numpy; ``load_*`` put
the map on ``device``.

The reference binary (`octree.hpp:897-913`): int32 size, f32 dim, u64 node
count, node records {u64 code, i32 side, value_type value_[8]}, u64 block
count, block records {u64 code, i32[3] coords, value_type voxel_block_[512]},
with the SDF ({f32 x, f32 y}, 8 B) and OFusion ({f32 x, pad, f64 y}, 16 B)
``voxel_traits`` layouts (`volume_traits.hpp:41-71`).  It is the map every
reference benchmark run dumps (``test.bin``, `benchmark.cpp:179-181`).
"""

from __future__ import annotations

import ast

import numpy as np
import torch

from supereight_tpu_torch import convert
from supereight_tpu_torch.core import morton, octree
from supereight_tpu_torch.core.octree import BLOCK_VOXELS, VoxelMap

_FORMAT_VERSION = 1


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's numpy name ("float32"), as the JAX meta stores it."""
    return str(dtype).removeprefix("torch.")


def save_map(path: str, m: VoxelMap):
    """The npz checkpoint: the map's arrays under the JAX package's keys
    (keys as uint32) and its meta."""
    arrays = {
        "block_index": _np(m.block_index),
        "keys": _np(m.keys).astype(np.uint32),
        "n_blocks": _np(m.n_blocks),
        "active": _np(m.active),
        "overflow": _np(m.overflow),
        "part_counts": _np(octree.partition_counts(m)),
    }
    for name, arr in m.voxels.items():
        arrays[f"voxel:{name}"] = _np(arr)
    for level, (vals, alloc) in enumerate(zip(m.node_values, m.node_alloc)):
        arrays[f"nodealloc:{level}"] = _np(alloc)
        for name, arr in vals.items():
            arrays[f"nodeval:{level}:{name}"] = _np(arr)
    meta = dict(version=_FORMAT_VERSION, size=m.size, dim=m.dim,
                capacity=m.capacity, partitions=m.partitions,
                channels=[(c.name, _dtype_name(c.dtype), c.init, c.empty)
                          for c in m.channels])
    arrays["meta"] = np.frombuffer(repr(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_map(path: str, device="cuda") -> VoxelMap:
    """A checkpoint written by :func:`save_map` or by the JAX package's."""
    z = np.load(path, allow_pickle=False)
    meta = ast.literal_eval(bytes(z["meta"]).decode())
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported map version {meta['version']}")
    names = [c[0] for c in meta["channels"]]
    levels = range(octree._log2i(meta["size"]) - octree.BLOCK_BITS + 1)
    d = dict(size=meta["size"], dim=meta["dim"], capacity=meta["capacity"],
             channels=meta["channels"],
             partitions=meta.get("partitions", 1),
             **{k: z[k] for k in ("block_index", "keys", "n_blocks", "active",
                                  "overflow")},
             voxels={n: z[f"voxel:{n}"] for n in names},
             node_values=[{n: z[f"nodeval:{lv}:{n}"] for n in names}
                          for lv in levels],
             node_alloc=[z[f"nodealloc:{lv}"] for lv in levels])
    if "part_counts" in z:
        d["part_counts"] = z["part_counts"]
    return convert.map_from_numpy(d, device)


# ----------------------------------------------------------------------
# The reference binary (`Octree::save/load`, se_serialise.hpp)
# ----------------------------------------------------------------------

# voxel_traits value_type layouts; the OFusion struct {float x; double y;}
# has a 4-byte alignment hole before y
_SE_SDF = np.dtype({"names": ["x", "y"], "formats": ["<f4", "<f4"],
                    "offsets": [0, 4], "itemsize": 8})
_SE_OFUSION = np.dtype({"names": ["x", "y"], "formats": ["<f4", "<f8"],
                        "offsets": [0, 8], "itemsize": 16})
_SE_LAYOUTS = {("tsdf", "weight"): _SE_SDF,
               ("occupancy", "timestamp"): _SE_OFUSION}
_MAX_BITS = 21                   # reference octree_defines.h:39
_SCALE_MASK = np.uint64(0x1FF)


def _se_layout(channels):
    names = tuple(c.name for c in channels)
    if names not in _SE_LAYOUTS:
        raise ValueError(f"no reference voxel_traits layout for channel "
                         f"set {names}")
    return _SE_LAYOUTS[names]


def _expand3(v):
    """Reference `morton_utils.hpp:37-45` bit expansion (uint64)."""
    x = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | x << np.uint64(32)) & np.uint64(0x1F00000000FFFF)
    x = (x | x << np.uint64(16)) & np.uint64(0x1F0000FF0000FF)
    x = (x | x << np.uint64(8)) & np.uint64(0x100F00F00F00F00F)
    x = (x | x << np.uint64(4)) & np.uint64(0x10C30C30C30C30C3)
    x = (x | x << np.uint64(2)) & np.uint64(0x1249249249249249)
    return x


def _compact3(v):
    x = v.astype(np.uint64) & np.uint64(0x1249249249249249)
    x = (x | x >> np.uint64(2)) & np.uint64(0x10C30C30C30C30C3)
    x = (x | x >> np.uint64(4)) & np.uint64(0x100F00F00F00F00F)
    x = (x | x >> np.uint64(8)) & np.uint64(0x1F0000FF0000FF)
    x = (x | x >> np.uint64(16)) & np.uint64(0x1F00000000FFFF)
    x = (x | x >> np.uint64(32)) & np.uint64(0x1FFFFF)
    return x


def _se_encode_key(x, y, z, level: int, max_depth: int):
    """`keyops::encode` (`octant_ops.hpp:49-53`): the morton code masked to
    the octant's level prefix, the level in the low SCALE_MASK bits."""
    code = _expand3(np.asarray(x)) | (_expand3(np.asarray(y)) << np.uint64(1)) \
        | (_expand3(np.asarray(z)) << np.uint64(2))
    # MASK[offset] keeps the morton bits of the coarsest offset+1 levels
    # (MASK[0] = 0x7000000000000000, octree_defines.h:48-66)
    offset = _MAX_BITS - max_depth + level - 1
    keep = np.uint64(0)
    top = np.uint64(0x7000000000000000)
    for i in range(offset + 1):
        keep |= top >> np.uint64(3 * i)
    return (code & keep) | np.uint64(level)


def save_se(path: str, m: VoxelMap):
    """Write the map in the reference's ``Octree::save`` format.

    Nodes come level by level, parents first: every octant with a live
    block or a marked node-pyramid cell beneath it, the internal nodes the
    reference's ``insert`` makes on the way to them.  A node's ``value_[8]``
    child slots (child id x + 2y + 4z) come from the node pyramid.  Blocks
    come in slot order."""
    layout = _se_layout(m.channels)
    max_depth, block_level = m.max_depth, m.block_level
    names = [c.name for c in m.channels]
    bi = _np(m.block_index)
    node_alloc = [_np(a) for a in m.node_alloc]

    with open(path, "wb") as fh:
        fh.write(np.int32(m.size).tobytes())
        fh.write(np.float32(m.dim).tobytes())

        # A node at level l exists iff a block or a marked node-value cell
        # lives beneath it; a marked cell at level s is a value slot of its
        # parent node at s - 1, so each level's own marks join the cascade
        # before it is downsampled.
        recs = []
        exists_per_level = {}
        ex = (bi >= 0) | node_alloc[block_level]
        for level in range(block_level - 1, -1, -1):
            s = 1 << (level + 1)
            ex = ex.reshape(s // 2, 2, s // 2, 2, s // 2, 2).any((1, 3, 5))
            exists_per_level[level] = ex
            if level >= 1:
                ex = ex | node_alloc[level]
        for level in range(block_level):
            nx, ny, nz = np.nonzero(exists_per_level[level])
            if nx.size == 0:
                continue
            store = level + 1
            sv = {n: _np(m.node_values[store][n]) for n in names}
            shift = max_depth - level
            rec = np.zeros(nx.size, dtype=np.dtype([
                ("code", "<u8"), ("side", "<i4"), ("value", layout, (8,))]))
            rec["code"] = _se_encode_key(nx << shift, ny << shift,
                                         nz << shift, level, max_depth)
            rec["side"] = m.size >> level
            for cid in range(8):
                cx = 2 * nx + (cid & 1)
                cy = 2 * ny + ((cid >> 1) & 1)
                cz = 2 * nz + ((cid >> 2) & 1)
                rec["value"]["x"][:, cid] = sv[names[0]][cx, cy, cz]
                rec["value"]["y"][:, cid] = sv[names[1]][cx, cy, cz]
            recs.append(rec)
        fh.write(np.uint64(sum(r.size for r in recs)).tobytes())
        for r in recs:
            fh.write(r.tobytes())

        live = octree.live_slots(m)
        n = live.numel()
        bc = _np(octree.block_coords_table(m)[live]).astype(np.int64) * 8
        rec = np.zeros(n, dtype=np.dtype([
            ("code", "<u8"), ("coords", "<i4", (3,)),
            ("voxels", layout, (BLOCK_VOXELS,))]))
        rec["code"] = _se_encode_key(bc[:, 0], bc[:, 1], bc[:, 2],
                                     block_level, max_depth)
        rec["coords"] = bc
        rec["voxels"]["x"] = _np(m.voxels[names[0]][live])
        rec["voxels"]["y"] = _np(m.voxels[names[1]][live])
        fh.write(np.uint64(n).tobytes())
        fh.write(rec.tobytes())


def load_se(path: str, channels, capacity: int | None = None,
            device="cuda") -> VoxelMap:
    """Read a reference ``Octree::save`` binary into a VoxelMap on
    ``device``; ``channels`` (``field.channels``) picks the layout.

    Blocks take slots 0..n-1 in file order.  Node records land in the node
    pyramid; a child slot is marked allocated where its stored value
    differs from the channels' init pair (the format cannot tell a
    pass-through node from a value-carrying one, and for both fields the
    init pair is what the multiscale read falls back to)."""
    channels = tuple(channels)
    layout = _se_layout(channels)
    names = [c.name for c in channels]
    with open(path, "rb") as fh:
        buf = fh.read()
    off = 0
    size = int(np.frombuffer(buf, "<i4", 1, off)[0]); off += 4
    dim = float(np.frombuffer(buf, "<f4", 1, off)[0]); off += 4
    n_nodes = int(np.frombuffer(buf, "<u8", 1, off)[0]); off += 8
    node_dt = np.dtype([("code", "<u8"), ("side", "<i4"),
                        ("value", layout, (8,))])
    nodes = np.frombuffer(buf, node_dt, n_nodes, off)
    off += n_nodes * node_dt.itemsize
    n_blocks = int(np.frombuffer(buf, "<u8", 1, off)[0]); off += 8
    blk_dt = np.dtype([("code", "<u8"), ("coords", "<i4", (3,)),
                       ("voxels", layout, (BLOCK_VOXELS,))])
    blocks = np.frombuffer(buf, blk_dt, n_blocks, off)

    if capacity is None:
        capacity = max(1024, 1 << int(np.ceil(np.log2(max(n_blocks, 1)))))
    if n_blocks > capacity:
        raise ValueError(f"{n_blocks} blocks > capacity {capacity}")
    max_depth = octree._log2i(size)
    block_level = max_depth - octree.BLOCK_BITS
    B = size // octree.BLOCK_SIDE
    dt = {c.name: np.dtype(_dtype_name(c.dtype)) for c in channels}

    bc = (blocks["coords"] >> 3).astype(np.int32)
    block_index = np.full((B, B, B), -1, np.int32)
    block_index[bc[:, 0], bc[:, 1], bc[:, 2]] = np.arange(n_blocks,
                                                          dtype=np.int32)
    keys = np.zeros(capacity, np.int64)
    keys[:n_blocks] = morton.block_key(*torch.from_numpy(bc.T.copy())).numpy()
    vox = {c.name: np.full((capacity, BLOCK_VOXELS), c.init, dt[c.name])
           for c in channels}
    vox[names[0]][:n_blocks] = blocks["voxels"]["x"]
    vox[names[1]][:n_blocks] = blocks["voxels"]["y"]
    active = np.zeros(capacity, bool)
    active[:n_blocks] = True

    node_values = [{c.name: np.full((1 << lv,) * 3, c.init, dt[c.name])
                    for c in channels} for lv in range(block_level + 1)]
    node_alloc = [np.zeros((1 << lv,) * 3, bool)
                  for lv in range(block_level + 1)]
    init = (channels[0].init, channels[1].init)
    levels = (nodes["code"] & _SCALE_MASK).astype(np.int32)
    codes = nodes["code"] & ~_SCALE_MASK
    nx = _compact3(codes)
    ny = _compact3(codes >> np.uint64(1))
    nz = _compact3(codes >> np.uint64(2))
    for level in np.unique(levels):
        store = int(level) + 1
        if store > block_level:
            continue
        sel = levels == level
        shift = max_depth - int(level)
        ox = (nx[sel] >> np.uint64(shift)).astype(np.int32)
        oy = (ny[sel] >> np.uint64(shift)).astype(np.int32)
        oz = (nz[sel] >> np.uint64(shift)).astype(np.int32)
        vals = nodes["value"][sel]
        for cid in range(8):
            cx = 2 * ox + (cid & 1)
            cy = 2 * oy + ((cid >> 1) & 1)
            cz = 2 * oz + ((cid >> 2) & 1)
            vx_ = vals[:, cid]["x"]
            vy_ = vals[:, cid]["y"]
            node_values[store][names[0]][cx, cy, cz] = vx_
            node_values[store][names[1]][cx, cy, cz] = \
                vy_.astype(dt[names[1]])
            node_alloc[store][cx, cy, cz] |= (vx_ != init[0]) | \
                (vy_ != init[1])

    return convert.map_from_numpy(dict(
        size=size, dim=dim, capacity=capacity, block_index=block_index,
        keys=keys, n_blocks=np.int32(n_blocks), active=active,
        overflow=np.int32(0), voxels=vox, node_values=node_values,
        node_alloc=node_alloc), device, channels=channels)
