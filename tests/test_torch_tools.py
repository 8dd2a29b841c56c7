"""The port's dataset converters against the JAX package's (the cases of
`tests/test_tools.py` and the TUM ingestion of `tests/test_runner.py`):
the files they write, byte for byte."""

import numpy as np
import pytest

from supereight_tpu.io import native as jnative
from supereight_tpu.io import raw as jraw
from supereight_tpu.tools import oni2raw as joni
from supereight_tpu.tools import scene2raw as jscene
from supereight_tpu.tools import tum2raw as jtum
from supereight_tpu_torch.io import native, raw
from supereight_tpu_torch.tools import oni2raw, scene2raw, tum2raw


def test_scene2raw_matches(tmp_path, monkeypatch):
    """ICL text depth -> .raw: euclidean ray lengths become planar z mm,
    the same file as the JAX tool's, both with their numpy conversions
    (both native: `tests/test_torch_native_io.py`)."""
    monkeypatch.setattr(jnative, "load_library", lambda: None)
    monkeypatch.setattr(native, "load_library", lambda: None)
    d = tmp_path / "scene"
    d.mkdir()
    W, H = scene2raw.SCENE_W, scene2raw.SCENE_H
    rng = np.random.default_rng(0)
    for i in range(2):
        eu = rng.uniform(0.5, 5.0, (H, W)).astype(np.float32)
        eu[H // 2, W // 2] = 2.0
        np.savetxt(d / f"scene_00_{i:04d}.depth", eu.reshape(1, -1),
                   fmt="%.4f")
    assert scene2raw.convert(str(d), str(tmp_path / "t.raw")) == 2
    assert jscene.convert(str(d), str(tmp_path / "j.raw")) == 2
    assert (tmp_path / "t.raw").read_bytes() == \
        (tmp_path / "j.raw").read_bytes()
    depth, _ = raw.RawReader(str(tmp_path / "t.raw")).read(0)
    assert abs(int(depth[H // 2, W // 2]) - 2000) <= 2
    with pytest.raises(ValueError):
        np.savetxt(d / "scene_00_9999.depth", np.ones((1, 10)))
        scene2raw.convert(str(d), str(tmp_path / "bad.raw"))
    assert scene2raw.main([]) == 1


def test_oni2raw_pgm_packer(tmp_path, capsys):
    d = tmp_path / "frames"
    d.mkdir()
    img = np.arange(40 * 30, dtype=np.uint16).reshape(30, 40) % 5000
    for i in range(2):
        with open(d / f"f{i:04d}.pgm", "wb") as f:
            f.write(b"P5\n# a comment\n40 30\n65535\n")
            f.write((img + i).byteswap().tobytes())
    assert oni2raw.frames_to_raw(str(d), str(tmp_path / "t.raw")) == 2
    assert joni.frames_to_raw(str(d), str(tmp_path / "j.raw")) == 2
    assert (tmp_path / "t.raw").read_bytes() == \
        (tmp_path / "j.raw").read_bytes()
    depth, _ = raw.RawReader(str(tmp_path / "t.raw")).read(1)
    np.testing.assert_array_equal(depth, img + 1)
    assert oni2raw.main([str(d), str(tmp_path / "m.raw")]) == 0
    assert oni2raw.main(["x.oni"]) == 1
    assert "OpenNI2" in capsys.readouterr().out


def test_tum2raw_matches(tmp_path):
    """A fabricated TUM directory (16-bit PNGs at 5000 units a metre, a
    ground truth at offset timestamps): the .raw and the associated .gt
    equal the JAX tool's."""
    from PIL import Image
    from supereight_tpu_torch.io import groundtruth, synthetic
    seq = tmp_path / "tum"
    (seq / "depth").mkdir(parents=True)
    rng = np.random.default_rng(1)
    with open(seq / "depth.txt", "w") as f:
        f.write("# depth maps\n")
        for i in range(4):
            ts = 1000.0 + 0.033 * i
            png = rng.integers(0, 20000, (30, 40)).astype(np.uint16)
            Image.fromarray(png, mode="I;16").save(
                seq / "depth" / f"{ts:.6f}.png")
            f.write(f"{ts:.6f} depth/{ts:.6f}.png\n")
    poses = synthetic.orbit_poses(4, 4.8)
    groundtruth.write_poses(str(seq / "groundtruth.txt"), poses,
                            timestamps=[1000.004 + 0.033 * i
                                        for i in range(4)])
    assert tum2raw.convert(str(seq), str(tmp_path / "t")) == 4
    assert jtum.convert(str(seq), str(tmp_path / "j")) == 4
    for ext in (".raw", ".gt"):
        assert (tmp_path / ("t" + ext)).read_bytes() == \
            (tmp_path / ("j" + ext)).read_bytes()
    got = jraw.RawReader(str(tmp_path / "t.raw"))
    assert (got.width, got.height, len(got)) == (40, 30, 4)
    with pytest.raises(ValueError):
        tum2raw.convert(str(seq), str(tmp_path / "far"), max_difference=1e-4)
    assert tum2raw.main([]) == 2
