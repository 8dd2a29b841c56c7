"""The port's evaluation runner (``supereight_tpu_torch.apps.runner``, on
the CPU with ``device="cpu"``): the cases of `tests/test_runner.py`, and
the synthetic room's run against the JAX runner's."""

import json

import numpy as np
import pytest
import torch

from supereight_tpu.apps import runner as jrunner
from supereight_tpu_torch.apps import runner
from supereight_tpu_torch.io import groundtruth, synthetic

torch.set_num_threads(1)


def test_registry_and_thresholds_match_jax():
    assert runner.DATASETS == jrunner.DATASETS
    assert (runner.TRANS_ROT_MAX_DEG, runner.TRANS_MIN_M,
            runner.MISTRACK_RATIO) == (jrunner.TRANS_ROT_MAX_DEG,
                                       jrunner.TRANS_MIN_M,
                                       jrunner.MISTRACK_RATIO)


def test_synthetic_run_matches_jax(tmp_path):
    """8 frames of the synthetic room at 64^3: the same frames, tracked
    share and motion class as the JAX runner, ATE within 1 mm."""
    res = runner.run("synthetic-room", field="sdf", resolution=64,
                     frames=8, out=str(tmp_path / "t"), device="cpu")
    want = jrunner.run("synthetic-room", field="sdf", resolution=64,
                       frames=8, out=str(tmp_path / "j"))
    assert res["frames"] == want["frames"] == 8
    for key in ("tracked_ratio", "median_rot_deg", "auto_regime",
                "field", "resolution"):
        assert res.get(key) == want.get(key), key
    assert abs(res["ate_rmse_m"] - want["ate_rmse_m"]) < 1e-3
    assert res["ate_rmse_m"] < 0.5
    assert res["fps"] > 0
    for name in ("results.json", "benchmark.log"):
        assert (tmp_path / "t" / name).exists()
    # the sequences: equal millimetres but at a few silhouette pixels
    # (tests/test_torch_synthetic.py)
    from supereight_tpu_torch.io import raw
    got, want = (raw.RawReader(str(tmp_path / d / "synthetic-room.raw"))
                 for d in ("t", "j"))
    assert len(got) == len(want) == 8
    for f in range(8):
        a, b = got.read(f)[0], want.read(f)[0]
        assert (a == b).mean() >= 0.999
        assert np.abs(a.astype(int) - b).max() <= 1


def test_noise_dataset_run(tmp_path):
    """The sensor-noise entry: -F selects the noise regime."""
    res = runner.run("synthetic-room-noise", field="sdf", resolution=64,
                     frames=8, out=str(tmp_path), device="cpu")
    assert res["frames"] == 8
    assert res["ate_rmse_m"] < 0.8


def test_tum_directory_ingestion(tmp_path, monkeypatch):
    """A TUM rgbd directory converts (tools/tum2raw, timestamp
    association) and runs through the registry."""
    from PIL import Image
    root = tmp_path / "datasets"
    seq = root / "rgbd_dataset_freiburg1_desk"
    (seq / "depth").mkdir(parents=True)
    depths, poses, k = synthetic.generate_sequence(6, H=60, W=80,
                                                   room_dim=4.8, device="cpu")
    with open(seq / "depth.txt", "w") as f:
        f.write("# depth maps\n")
        for i, d in enumerate(depths):
            ts = 1000.0 + 0.033 * i
            png = (d.astype(np.float32) * 5.0).astype(np.uint16)
            Image.fromarray(png, mode="I;16").save(
                seq / "depth" / f"{ts:.6f}.png")
            f.write(f"{ts:.6f} depth/{ts:.6f}.png\n")
    groundtruth.write_poses(str(seq / "groundtruth.txt"), poses,
                            timestamps=[1000.004 + 0.033 * i
                                        for i in range(len(poses))])
    monkeypatch.setenv("SE_DATASETS", str(root))
    res = runner.run("tum-fr1-desk", field="sdf", resolution=64, frames=6,
                     out=str(tmp_path / "out"),
                     extra_args=("-k", "30,30,40,30"), device="cpu")
    assert res["frames"] == 6
    assert (root / "rgbd_dataset_freiburg1_desk.raw").exists()
    assert res["ate_rmse_m"] < 1.0


def test_icl_scene_directory_ingestion(tmp_path, monkeypatch):
    """An ICL-NUIM scene directory (euclidean-ray .depth text files)
    converts through tools/scene2raw and runs."""
    from supereight_tpu_torch.tools.scene2raw import (SCENE_H, SCENE_K,
                                                      SCENE_W)
    root = tmp_path / "datasets"
    seq = root / "living_room_traj0_loop"
    seq.mkdir(parents=True)
    depths, poses, k = synthetic.generate_sequence(
        3, H=SCENE_H, W=SCENE_W, room_dim=4.8, device="cpu")
    fx, fy, cx, cy = SCENE_K
    u = (np.arange(SCENE_W, dtype=np.float32) - cx) / fx
    v = (np.arange(SCENE_H, dtype=np.float32) - cy) / fy
    norm = np.sqrt(1.0 + u[None, :] ** 2 + v[:, None] ** 2)
    for i, d in enumerate(depths):
        eu = (np.asarray(d, np.float32) / 1000.0) * norm
        with open(seq / f"scene_00_{i:04d}.depth", "w") as f:
            eu.astype(np.float32).tofile(f, sep=" ")
    groundtruth.write_poses(str(root / "livingRoom0.gt.freiburg"), poses)
    monkeypatch.setenv("SE_DATASETS", str(root))
    kk = ",".join(str(float(x)) for x in k)
    res = runner.run("icl-lr-traj0", field="sdf", resolution=64, frames=3,
                     out=str(tmp_path / "out"),
                     extra_args=("-r", "8", "-k", kk), device="cpu")
    assert (root / "living_room_traj0_loop.raw").exists()
    assert res["frames"] == 3
    assert res["ate_rmse_m"] < 1.0


def test_missing_dataset_names_its_sources(tmp_path, monkeypatch):
    monkeypatch.setenv("SE_DATASETS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="SE_DATASETS"):
        runner.run("icl-lr-traj2", resolution=64, frames=2,
                   out=str(tmp_path / "out"), device="cpu")


def test_classify_motion_matches_jax():
    """Orbits are rotation-rich, dollies are not; the same statistics as
    the JAX runner's."""
    orbit = list(synthetic.orbit_poses(12, 4.8, sweep=0.3))
    dolly = list(synthetic.translation_poses(12, 4.8))
    for poses in (orbit, dolly, orbit[:1]):
        assert runner.classify_motion(poses) == \
            jrunner.classify_motion(poses)
    rot_o, _ = runner.classify_motion(orbit)
    rot_t, tr_t = runner.classify_motion(dolly)
    assert rot_o > runner.TRANS_ROT_MAX_DEG > rot_t
    assert tr_t > runner.TRANS_MIN_M


def test_auto_regime_dispatches_dolly(tmp_path, monkeypatch):
    """A translation-dominant stream under the default SDF stack reruns on
    the occupancy preset 'trans'."""
    from supereight_tpu_torch.io import raw
    H, W = 60, 80
    k = np.asarray([60.0 * W / 160, 60.0 * H / 120, W / 2, H / 2],
                   np.float32)
    poses = synthetic.translation_poses(8, 4.8)
    wtr = raw.RawWriter(str(tmp_path / "dolly.raw"), W, H)
    for p in poses:
        d = synthetic.render_depth(torch.from_numpy(p), torch.from_numpy(k),
                                   4.8, H, W).numpy()
        wtr.write(np.clip(d * 1000, 0, 65535).astype(np.uint16))
    wtr.close()
    groundtruth.write_poses(str(tmp_path / "dolly.gt"), poses)
    monkeypatch.setitem(runner.DATASETS, "test-dolly", {
        "raw": "dolly.raw", "gt": "dolly.gt",
        "camera": ",".join(str(float(x)) for x in k),
        "volume": 4.8, "init_pose": "0.35,0.5,0.5",
    })
    monkeypatch.setenv("SE_DATASETS", str(tmp_path))
    res = runner.run("test-dolly", field="sdf", resolution=64, frames=8,
                     out=str(tmp_path / "out"), device="cpu")
    assert res["auto_regime"] in ("translation-dominant", "mistracking")
    assert "first_pass_ate_rmse_m" in res
    assert (tmp_path / "out" / "regime_rerun" / "benchmark.log").exists()


def test_main_prints_results(tmp_path, capsys):
    assert runner.main(["--dataset", "synthetic-room", "-v", "64",
                        "--frames", "4", "--out", str(tmp_path),
                        "--no-auto-regime", "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["frames"] == 4 and res["dataset"] == "synthetic-room"
