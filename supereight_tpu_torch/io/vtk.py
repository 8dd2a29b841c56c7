"""VTK / PLY export: meshes, 3D field slices, block lists (counterpart of
`supereight_tpu/io/vtk.py`; given the same inputs each writer gives the
same bytes).

The JAX writers format each float32 value with an f-string, which prints
the shortest repr of the value as a Python float; so do these, through
``tolist()``.
"""

from __future__ import annotations

import numpy as np
import torch

from supereight_tpu_torch.core import octree


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _vertex_lines(tris: np.ndarray) -> str:
    return "".join(f"{x} {y} {z}\n" for x, y, z in
                   tris.reshape(-1, 3).tolist())


def _face_lines(n: int) -> str:
    return "".join(f"3 {3 * i} {3 * i + 1} {3 * i + 2}\n" for i in range(n))


def write_vtk_mesh(path: str, triangles):
    """Legacy-VTK polydata mesh of float32 [n, 3, 3] triangles."""
    tris = _host(triangles, np.float32)
    n = tris.shape[0]
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 1.0\n")
        f.write("vtk mesh generated from supereight_tpu\n")
        f.write("ASCII\n")
        f.write("DATASET POLYDATA\n")
        f.write(f"POINTS {3 * n} FLOAT\n")
        f.write(_vertex_lines(tris))
        f.write(f"POLYGONS {n} {n * 4}\n")
        f.write(_face_lines(n))


def write_ply_mesh(path: str, triangles):
    """ASCII PLY of float32 [n, 3, 3] triangles."""
    tris = _host(triangles, np.float32)
    n = tris.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {3 * n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {n}\n")
        f.write("property list uchar int vertex_index\nend_header\n")
        f.write(_vertex_lines(tris))
        f.write(_face_lines(n))


def save_3d_slice(path: str, m, channel: str, lower, upper):
    """Structured-points VTK export of one channel over the voxels
    [lower, upper), ``empty`` outside allocated blocks."""
    lower = np.asarray(lower, int)
    upper = np.asarray(upper, int)
    axes = [torch.arange(int(lower[a]), int(upper[a]), dtype=torch.int32,
                         device=m.device) for a in range(3)]
    nx, ny, nz = (len(a) for a in axes)
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    vals = _host(octree.get(m, channel, gx, gy, gz), np.float32)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 1.0\n")
        f.write(f"{channel} slice\nASCII\nDATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {nx} {ny} {nz}\n")
        f.write(f"ORIGIN {lower[0]} {lower[1]} {lower[2]}\n")
        f.write("SPACING 1 1 1\n")
        f.write(f"POINT_DATA {nx * ny * nz}\n")
        f.write(f"SCALARS {channel} float 1\nLOOKUP_TABLE default\n")
        # VTK structured points iterate x fastest
        f.write("".join(f"{v}\n" for v in
                        vals.transpose(2, 1, 0).reshape(-1).tolist()))


def save_block_list(path: str, m):
    """The live blocks' coordinates, one ``x y z`` row each, in slot
    order."""
    coords = _host(octree.block_coords_table(m)[octree.live_slots(m)],
                   np.int32)
    with open(path, "w") as f:
        f.write("".join(f"{x} {y} {z}\n" for x, y, z in coords.tolist()))
