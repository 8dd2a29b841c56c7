"""IO: dataset streams and ground truth (counterpart of
`supereight_tpu/io`): the ``.raw`` reader and writer, ICL-NUIM scene
directories, the live replay reader, TUM trajectories and the synthetic
sequence generator.

Reference layers: `se_apps/include/interface.h` (readers).
"""

import os


def create_reader(path: str):
    """Reader factory (reference ``createReader``,
    `se_apps/src/reader.cpp:22`): an ICL-NUIM scene directory, or else a
    ``.raw`` stream (the seek-based numpy reader)."""
    if os.path.isdir(path):
        from .scene import SceneDepthReader
        return SceneDepthReader(path)
    from .raw import RawReader
    return RawReader(path)
