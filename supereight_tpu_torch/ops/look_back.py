"""The scratch of the decoupled look-back (`csrc/look_back.cuh`), which the
raycast's merged scan (``raycast_kernel.ray_scan``) and the fusion's
frustum selection (``integrate_kernel.frustum_select``) share: a status
word a tile (int64) and two counters (int32 ``ctl``: tickets drawn,
look-backs ended), one scratch for each (device, stream), allocated zeroed
at first use and never read back.  Each launch leaves what it used zero,
so the next launch on the stream finds it clean whatever its tile count."""

from __future__ import annotations

from typing import Dict

import torch


class Scratch:
    """The look-back's status words and counters on one (device,
    stream)."""

    def __init__(self, device):
        self.device = device
        self.status = torch.zeros(0, dtype=torch.int64, device=device)
        self.ctl = torch.zeros(2, dtype=torch.int32, device=device)

    def words(self, tiles: int) -> torch.Tensor:
        """The zero status words [>= tiles] int64 of a look-back over
        ``tiles`` tiles."""
        if self.status.numel() < tiles:
            self.status = torch.zeros(tiles, dtype=torch.int64,
                                      device=self.device)
        return self.status


_SCRATCH: Dict[tuple, Scratch] = {}


def scratch(dev) -> Scratch:
    """The :class:`Scratch` of ``dev`` and its current stream (one for the
    CPU, where no kernel runs)."""
    dev = torch.device(dev)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream
           if dev.type == "cuda" else None)
    if key not in _SCRATCH:
        _SCRATCH[key] = Scratch(dev)
    return _SCRATCH[key]
