"""The raycasting stage's CUDA graph (`pipeline/raycast_graph.py`) on the
CPU: the rule that decides whether a call is captured or runs eagerly, the
key a graph is kept under, and the eager call the CPU makes.  Replays run
only on the card (`tests/test_torch_gpu.py`)."""

import numpy as np
import pytest
import torch

from supereight_tpu_torch.core import octree
from supereight_tpu_torch.fields import make_field
from supereight_tpu_torch.pipeline import camera, raycast, raycast_graph

SDF = make_field("sdf", mu=0.1)
CUDA = torch.device("cuda")
#: the knobs ``system.raycasting_stage`` passes, at the defaults
KNOBS = dict(normals="volume", second_window=True, span_factor=1.6,
             w2_budget=8192, scan_stride=0.5, near_rescue=True, grad_decim=1,
             refine="secant", full_res_scan=False, midsolve=False)
#: another value of each knob
OTHER = dict(normals="hybrid", second_window=False, span_factor=1.2,
             w2_budget=64, scan_stride=1.0, near_rescue=False, grad_decim=2,
             refine="interp", full_res_scan=True, midsolve=True)


@pytest.mark.parametrize("case,kw,want", [
    ("volume", {}, None),
    ("hybrid", dict(normals="hybrid"), None),
    ("cpu", dict(device=torch.device("cpu")), "cpu"),
    ("partitions", dict(partitions=2), "partitions"),
    ("row_range", dict(row_range=(0, 120)), "row_range"),
    ("stored", dict(normals="stored"), "stored"),
    ("exact", dict(normals="exact"), "exact"),
    ("multiscale", dict(field=make_field("ofusion", mu=0.05,
                                         voxel_size=0.01875)), "multiscale"),
])
def test_eager_reason(case, kw, want):
    """Captured: a CUDA map of one partition, the whole image, an SDF
    field, volume or hybrid normals; each other call eager, by its
    reason."""
    call = dict(device=CUDA, partitions=1, field=SDF, normals="volume",
                row_range=None)
    call.update(kw)
    assert raycast_graph.eager_reason(**call) == want


def _map(size=64, capacity=512):
    return octree.init(size, 4.8, SDF.channels, "cpu", capacity=capacity)


def _call(m=None, pose=None, k=None, H=120, W=160, view=None, **knobs):
    m = _map() if m is None else m
    pose = torch.eye(4) if pose is None else pose
    k = torch.tensor([120.0, 120.0, 80.0, 60.0]) if k is None else k
    return dict(m=m, field=SDF, pose=pose, k=k, H=H, W=W, near=0.4,
                far=4.0, view=view, knobs={**KNOBS, **knobs})


def _moved(m):
    return m.replace(voxels={n: v.clone() for n, v in m.voxels.items()})


def _changes():
    """Calls whose key differs from the base call's, by what changes."""
    yield "H", dict(H=240)
    yield "W", dict(W=320)
    for n, v in OTHER.items():
        yield n, {n: v}
    yield "capacity", dict(m=_map(capacity=1024))
    yield "size", dict(m=_map(size=128))
    yield "table", "moved"
    yield "held_view", "view"


@pytest.mark.parametrize("what,change", list(_changes()),
                         ids=[w for w, _ in _changes()])
def test_graph_key_changes(what, change):
    """The key changes with the image, each knob, the map's geometry and
    the address of a table read in place."""
    m = _map()
    base = _call(m=m)
    if change == "moved":
        other = _call(m=_moved(m))
    elif change == "view":
        view = torch.zeros((8 ** 3, 512), dtype=torch.bfloat16)
        base, other = _call(m=m, view=view), _call(m=m, view=view.clone())
        assert raycast_graph.graph_key(**_call(m=m)) != \
            raycast_graph.graph_key(**base)
    else:
        other = _call(**{"m": m, **change})
    assert raycast_graph.graph_key(**base) != \
        raycast_graph.graph_key(**other)


def test_graph_key_ignores_the_copied_values():
    """The pose, the intrinsics and the map's small tensors are copied
    into a graph before each replay: new values, or the same values in new
    tensors (an allocation's), keep the key."""
    m = _map()
    base = raycast_graph.graph_key(**_call(m=m))
    rot = camera.se3_exp(torch.tensor([0.1, -0.2, 0.3, 0.05, 0.1, -0.1]))
    new = m.replace(keys=m.keys + 7, n_blocks=m.n_blocks + 3,
                    active=~m.active, block_index=m.block_index.clone(),
                    part_counts=m.part_counts + 3)
    assert raycast_graph.graph_key(**_call(
        m=new, pose=rot, k=torch.tensor([200.0, 190.0, 81.0, 59.0]))) == base


def _sphere_map(size=64, dim=4.8, radius=1.0):
    """An analytic sphere's TSDF, every block allocated and observed."""
    m = _map(size, (size // 8) ** 3)
    r = torch.arange(size // 8)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1) \
        .reshape(-1, 3)
    m = octree.allocate_blocks(m, coords, torch.ones(len(coords),
                                                     dtype=torch.bool))
    g = torch.arange(size, dtype=torch.float64) * (dim / size) - dim / 2
    gx, gy, gz = torch.meshgrid(g, g, g, indexing="ij")
    sdf = (gx ** 2 + gy ** 2 + gz ** 2).sqrt() - radius
    i = torch.arange(size)
    ix, iy, iz = (a.reshape(-1) for a in torch.meshgrid(i, i, i,
                                                         indexing="ij"))
    tsdf = (sdf / SDF.mu).clamp(-1.0, 1.0).reshape(-1).float()
    m = octree.set_voxels(m, "tsdf", ix, iy, iz, tsdf)
    return octree.set_voxels(m, "weight", ix, iy, iz, torch.ones(size ** 3))


@pytest.mark.parametrize("normals", ["volume", "hybrid"])
def test_cpu_call_is_the_eager_raycast(normals):
    """On the CPU the call is ``raycast.raycast`` of pose @ inv(K), bit
    for bit, and nothing is captured or replayed."""
    torch.set_num_threads(1)
    m = _sphere_map()
    pose = camera.pose_from_translation([2.4, 2.4, 0.3], "cpu")
    k = torch.tensor([60.0, 60.0, 40.0, 30.0])
    counts = dict(raycast_graph.COUNTS)
    knobs = dict(KNOBS, normals=normals, grad_decim=2)
    got = raycast_graph.raycast(m, SDF, pose, k, 60, 80, 0.4, 4.0, **knobs)
    want = raycast.raycast(m, SDF, pose @ camera.inverse_camera_matrix(k),
                           60, 80, 0.4, 4.0, **knobs)
    assert raycast_graph.COUNTS == counts
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float((want.vertex.abs().sum(-1) > 0).float().mean()) > 0.1
    np.testing.assert_array_less(0, want.t_hit.max().item())
