"""IO: dataset streams, ground truth, checkpoints, mesh and slice export
(counterpart of `supereight_tpu/io`): the ``.raw`` reader and writer,
ICL-NUIM scene directories, the live replay reader, TUM trajectories, the
synthetic sequence generator, map checkpoints (``serialise``) and the
VTK / PLY writers (``vtk``).

Reference layers: `se_apps/include/interface.h` (readers),
`se_core/include/se/io/` (serialization), `se_denseslam/include/se/vtk-io.h`.
"""

import os

from . import groundtruth, raw, serialise, synthetic, vtk  # noqa: F401


def create_reader(path: str):
    """Reader factory (reference ``createReader``,
    `se_apps/src/reader.cpp:22`): an ICL-NUIM scene directory, or else a
    ``.raw`` stream: the native mmap + prefetch reader (``io.native``),
    or the seek-based numpy reader where the native library cannot be
    built or refuses the file."""
    if os.path.isdir(path):
        from .scene import SceneDepthReader
        return SceneDepthReader(path)
    from . import native
    if native.available():
        try:
            return native.NativeRawReader(path)
        except (IOError, RuntimeError):
            pass            # a corrupt header: the strict numpy reader
    from .raw import RawReader
    return RawReader(path)
