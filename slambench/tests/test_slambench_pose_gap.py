"""The check's pose gap: ICP's point-to-plane distance over the points it
matches, blind to a slide along the surfaces, full across them."""

import math

import pytest
import torch

from slambench import check


def _wall(depth=2.0, n=8):
    """A wall facing the camera at ``depth`` metres, matched at the
    identity: camera-frame points and the model's normals [n * n, 3]."""
    xy = torch.linspace(-0.5, 0.5, n)
    y, x = torch.meshgrid(xy, xy, indexing="ij")
    v = torch.stack([x, y, torch.full_like(x, depth)], -1).reshape(-1, 3)
    nrm = torch.zeros_like(v)
    nrm[:, 2] = -1.0
    return v, nrm


def _moved(dx=0.0, dy=0.0, dz=0.0, yaw=0.0):
    p = torch.eye(4)
    c, s = math.cos(yaw), math.sin(yaw)
    p[:3, :3] = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    p[:3, 3] = torch.tensor([dx, dy, dz])
    return p


@pytest.mark.parametrize("pose", [_moved(dx=2e-3), _moved(dy=2e-3),
                                  _moved(yaw=1e-3)],
                         ids=["slide_x", "slide_y", "turn_in_plane"])
def test_a_slide_along_the_surface_reads_nothing(pose):
    assert check._pose_gap_mm(pose, torch.eye(4), _wall()) < 1e-4


@pytest.mark.parametrize("dz", [1e-3, -2e-3])
def test_a_move_off_the_surface_reads_its_distance(dz):
    gap = check._pose_gap_mm(_moved(dz=dz), torch.eye(4), _wall())
    assert gap == pytest.approx(1e3 * abs(dz), rel=1e-5)


@pytest.mark.parametrize("matched", [None, (torch.zeros(0, 3),
                                             torch.zeros(0, 3))],
                         ids=["no_icp", "nothing_matched"])
def test_without_matches_the_poses_distance(matched):
    pose = _moved(dx=3e-3, yaw=1e-3)
    assert check._pose_gap_mm(pose, torch.eye(4), matched) == pytest.approx(
        check._pose_distance_mm(pose, torch.eye(4)))
