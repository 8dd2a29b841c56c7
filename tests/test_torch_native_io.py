"""The port's native IO (``io/native.py`` over its own
``csrc/io_native.cpp``, built with the host C++ compiler at first use)
against the JAX package's (``csrc/libse_io.so``) and against the numpy
reader, on a fabricated ``.raw`` stream made from a seed:

- ``NativeRawReader``: size, frame count, ``read`` and ``read_float`` (at
  ratios 1 and 2) equal to the JAX reader's bit for bit, every frame;
  ``read``'s depth equal to the numpy ``RawReader``'s bit for bit;
- ``create_reader`` takes the native reader for a ``.raw`` stream and
  falls back to the numpy one for a file the native reader refuses;
- the euclidean -> planar depth conversion equal to the JAX package's
  native one bit for bit, and ``tools.scene2raw``'s file equal to the JAX
  tool's byte for byte, both native.
"""

import numpy as np
import pytest

from supereight_tpu.io import native as jnative
from supereight_tpu.tools import scene2raw as jscene2raw
import supereight_tpu_torch.io as tio
from supereight_tpu_torch.io import native, raw, scene
from supereight_tpu_torch.ops import _build
from supereight_tpu_torch.tools import scene2raw

N, H, W = 6, 48, 64


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    rng = np.random.default_rng(11)
    depths = rng.integers(0, 65536, (N, H, W)).astype(np.uint16)
    depths[:, 0, :4] = (0, 1, 65534, 65535)
    path = str(tmp_path_factory.mktemp("raw") / "s.raw")
    w = raw.RawWriter(path, W, H)
    for d in depths:
        w.write(d, rng.integers(0, 256, (H, W, 3)).astype(np.uint8))
    w.close()
    return path, depths


def test_library_builds_from_the_port():
    assert native.available() and jnative.available()
    lib = _build.library_path("io_native")
    assert lib.parent == _build.BUILD_DIR and lib.exists()
    assert (_build.CSRC / "io_native.cpp").exists()


@pytest.mark.parametrize("ratio", [1, 2])
def test_reader_matches_jax(stream, ratio):
    path, depths = stream
    got, want = native.NativeRawReader(path, ratio), \
        jnative.NativeRawReader(path, ratio)
    assert (got.width, got.height, len(got)) == \
        (want.width, want.height, len(want)) == (W // ratio, H // ratio, N)
    for f in (0, 1, 3, 2, N - 1):          # out of order: the prefetch
        np.testing.assert_array_equal(got.read_float(f), want.read_float(f))
        if ratio == 1:
            a, b = got.read(f), want.read(f)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[0], depths[f])
    with pytest.raises(IndexError):
        got.read_float(N)
    got.close()


def test_reader_matches_numpy(stream):
    path, _ = stream
    r, ref = tio.create_reader(path), raw.RawReader(path)
    assert isinstance(r, native.NativeRawReader)
    assert (r.width, r.height, len(r)) == (ref.width, ref.height, len(ref))
    for f in range(N):
        d, rgb = r.read(f)
        np.testing.assert_array_equal(d, ref.read(f)[0])
        assert d.dtype == np.uint16 and rgb.shape == (H, W, 3)


def test_create_reader_falls_back(tmp_path):
    p = tmp_path / "short.raw"
    p.write_bytes(np.asarray([W, H], np.uint32).tobytes() + b"\0" * 100)
    r = tio.create_reader(str(p))
    assert isinstance(r, raw.RawReader) and len(r) == 0


def test_conversion_matches_jax(tmp_path):
    rng = np.random.default_rng(12)
    eu = rng.uniform(0.3, 70.0, (480, 640)).astype(np.float32)
    eu[rng.random(eu.shape) < 0.05] = 0.0
    got = native.euclidean_to_depth_mm(eu, scene.SCENE_K)
    want = jnative.euclidean_to_depth_mm(eu, scene.SCENE_K)
    np.testing.assert_array_equal(got, want)
    assert got.max() == 65535 and (got == 0).any()
    # against the numpy conversion (float64): at most 1 mm on a few
    # pixels
    diff = np.abs(got.astype(np.int32) - scene.euclidean_to_depth_mm(
        eu, scene.SCENE_K).astype(np.int32))
    assert diff.max() <= 1 and diff.mean() < 1e-2

    d = tmp_path / "scene"
    d.mkdir()
    for i in range(2):
        np.savetxt(d / f"scene_00_{i:04d}.depth",
                   rng.uniform(0.5, 5.0, (1, 640 * 480)), fmt="%.4f")
    assert scene2raw.convert(str(d), str(tmp_path / "t.raw")) == 2
    assert jscene2raw.convert(str(d), str(tmp_path / "j.raw")) == 2
    assert (tmp_path / "t.raw").read_bytes() == \
        (tmp_path / "j.raw").read_bytes()
