"""The port's headless viewer and power monitor against the JAX
package's (`supereight_tpu/apps/viewer.py`, `supereight_tpu/utils/
power.py`).

The viewer runs both packages on the same synthetic ``.raw`` + ground
truth (64^3, 60x80): the port's triptych panels equal the images the JAX
viewer hands to its plot (depth and tracking bit for bit, the shaded
volume on at most 0.1 % of the pixels apart, the renderers' rule of
`tests/test_torch_rendering.py`), and the PNG the port writes decodes to
its triptych."""

import struct
import zlib

import numpy as np
import pytest

from supereight_tpu.apps import viewer as jviewer
from supereight_tpu.io import synthetic as jsynthetic
from supereight_tpu_torch.apps import viewer
from supereight_tpu_torch.utils import power

H, W = 60, 80
#: at most this share of the shaded-volume pixels may differ
MAX_VOLUME_SHARE = 0.001


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB/RGBA PNG of unfiltered rows (what
    ``viewer.png_bytes`` writes)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = ihdr[:4]
    c = {2: 3, 6: 4}[color]
    assert depth == 8
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, c)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viewer")
    rawp, gtp, k = jsynthetic.write_dataset(str(tmp / "seq"), 7, H=H, W=W)
    argv = ["-i", rawp, "-g", gtp, "-k", ",".join(str(float(x))
                                                   for x in k),
            "-v", "64", "--rate", "3"]
    captured = []
    keep = jviewer.save_triptych

    def capture(path, *imgs):
        captured.append([np.asarray(a) for a in imgs])
        keep(path, *imgs)

    jviewer.save_triptych = capture
    try:
        jviewer.main(argv + ["--out-dir", str(tmp / "jax")])
    finally:
        jviewer.save_triptych = keep
    out = viewer.run(argv + ["--out-dir", str(tmp / "port"),
                             "--device", "cpu"])
    return captured, out, tmp / "port"


def test_viewer_panels_match_jax(both):
    captured, out, _ = both
    assert out["frames"] == [3, 6] and len(captured) == 2
    for img, want in zip(out["images"], captured):
        panels = [img[:, i * (W + viewer.GAP):i * (W + viewer.GAP) + W]
                  for i in range(3)]
        assert img.shape == (H, 3 * W + 2 * viewer.GAP, 3)
        assert not img[:, W:W + viewer.GAP].any()
        np.testing.assert_array_equal(panels[0], want[0][..., :3])
        np.testing.assert_array_equal(panels[1], want[1][..., :3])
        differ = (panels[2] != want[2][..., :3]).any(-1).mean()
        assert differ <= MAX_VOLUME_SHARE, differ
        assert (want[2][..., :3].max(-1) > 0).mean() > 0.3


def test_viewer_files(both):
    _, out, port = both
    for f, img in zip(out["frames"], out["images"]):
        np.testing.assert_array_equal(read_png(
            str(port / f"frame_{f:05d}.png")), img)
    traj = read_png(str(port / "trajectory.png"))
    assert traj.shape == (400, 400, 3)
    # ground-truth mode: the estimate (white) is drawn over the ground
    # truth (green) it equals
    assert (traj == 255).all(-1).sum() > 20
    assert set(map(tuple, traj.reshape(-1, 3))) <= {(0, 0, 0), (0, 200, 0),
                                                    (255, 255, 255)}
    html = open(port / "view.html").read()
    assert "frame_00006.png" in html and "trajectory.png" in html
    assert "setInterval" in html


def test_png_rgba_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    viewer.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)


def test_power_monitor_matches_jax():
    """The same rails as the JAX monitor finds, and a no-op sample where
    there are none."""
    from supereight_tpu.utils import power as jpower
    assert power._discover() == jpower._discover()
    pm = power.PowerMonitor()
    assert pm.available == bool(pm.sensors)
    assert pm.sample() is None
