"""Live-stream reader: the OpenNI depth-camera interface, replayed (a copy
of `supereight_tpu/io/live.py`).

Reference: ``OpenNIDepthReader`` (`se_apps/include/interface.h:532+`)
exposes a camera as a FRAME-PACED stream — `readNextDepthFrame` returns
whatever frame the sensor most recently produced, so a slow consumer
DROPS frames instead of falling behind.  Without camera hardware,
`LiveReplayReader` reproduces that exact contract from a .raw file on a
wall-clock schedule, so every consumer of the live interface
(frame pacing, drop accounting, no random access) can be exercised
end-to-end.  A real OpenNI backend would slot in behind the same three
members (`width/height`, `read_next`, `dropped`).

Differences from the seekable readers (`raw.RawReader`):
* no random access — ``read_next()`` only, like a sensor;
* the frame returned is the one the wall clock says the sensor is
  producing NOW (``fps`` paced from the first call);
* frames skipped between calls are counted in ``dropped``;
* returns None when the stream ends (camera unplugged / file exhausted).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from . import raw


class LiveReplayReader:
    """Frame-paced replay of a .raw stream behind the live-camera
    contract (see module docstring)."""

    def __init__(self, path: str, fps: float = 30.0, clock=time.monotonic):
        self._r = raw.RawReader(path)
        self.width = self._r.width
        self.height = self._r.height
        self.fps = float(fps)
        self._clock = clock
        self._t0: Optional[float] = None
        self._last = -1          # last frame index handed out
        self.dropped = 0         # frames the consumer was too slow to see

    def read_next(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(depth_mm uint16 [H, W], rgb uint8 [H, W, 3]) of the frame the
        sensor is producing now, or None past the end of the stream."""
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        idx = int((now - self._t0) * self.fps)
        idx = max(idx, self._last + 1)     # never replay an old frame
        if idx >= len(self._r):
            return None
        if self._last >= 0:
            self.dropped += max(idx - self._last - 1, 0)
        self._last = idx
        return self._r.read(idx)

    def __iter__(self):
        while True:
            out = self.read_next()
            if out is None:
                return
            yield out
