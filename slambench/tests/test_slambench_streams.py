"""The seed moves only the loop's start phase and the noise."""

import copy

import numpy as np
import pytest
import torch

from slambench import streams

K, H, W = (30.075, 30.0, 20.0, 15.0), 30, 40


def mix(name, lap=12):
    m = copy.deepcopy(streams.load_mix(name))
    m["lap_frames"] = lap
    return m


def test_the_loop_closes():
    p = streams.loop_poses(mix("handheld", 360))
    step = np.linalg.norm(p[1, :3, 3] - p[0, :3, 3])
    # frame 360 would be frame 0: the last step is an ordinary step
    assert abs(np.linalg.norm(p[0, :3, 3] - p[-1, :3, 3]) - step) < 1e-4


def test_handheld_is_the_same_lap_rotated(tmp_path):
    m = mix("handheld")
    a = streams.Stream(m, K, H, W, 5, "cpu", str(tmp_path))
    b = streams.Stream(m, K, H, W, 2 ** 40 + 9, "cpu", str(tmp_path))
    assert a.start != b.start
    assert (a.frames == b.frames).all() and a.frames.any()
    h = a.hold
    for i in range(h):          # the still start: the phase's first frame
        assert (a.frame(i) == a.frame(h)).all()
    for i in range(h, h + a.n):
        j = h + (i - h + a.start - b.start) % a.n
        assert (a.frame(i) == b.frame(j)).all()
        assert (a.pose(i) == b.pose(j)).all()


def test_kinect_differs_only_in_its_noise(tmp_path):
    clean = streams.Stream(mix("handheld"), K, H, W, 5, "cpu", str(tmp_path))
    m = mix("kinect")
    a = streams.Stream(m, K, H, W, 5, "cpu", str(tmp_path))
    a2 = streams.Stream(m, K, H, W, 5, "cpu", str(tmp_path))
    b = streams.Stream(m, K, H, W, 6, "cpu", str(tmp_path))
    assert (a.frames == a2.frames).all()
    assert (a.frames != b.frames).any()
    for s in (a, b):
        assert ((s.frames == 0) == (clean.frames == 0)).all()
        d = np.abs(s.frames.astype(np.int64) - clean.frames)
        z = clean.frames / 1000.0
        sigma = 1.2 + 19.0 * np.maximum(z - 0.4, 0.0) ** 2
        # within six sigma plus a disparity step of the clean depth
        assert (d <= 6 * sigma + np.maximum(1.0, 2.85 * z * z) + 1).all()
    assert a.start == clean.start
