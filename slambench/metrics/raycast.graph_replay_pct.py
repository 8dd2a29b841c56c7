"""The share of the traced lap's raycasts that were CUDA graph replays: 100
x the ``se.raycasting.graph.replay`` spans over the raycasts, which are the
replays, the captures (``se.raycasting.graph.capture``) and the eager ones
(``se.raycasting.plan`` spans not inside a capture), from
``slambench/spans.py``.  None where the port has no raycasting graph (a
checkout from before it) or the lap raycast nothing."""

import importlib.util

from slambench import spans

REPLAY = "se.raycasting.graph.replay"
CAPTURE = "se.raycasting.graph.capture"
PLAN = "se.raycasting.plan"


def read(run):
    if importlib.util.find_spec(
            "supereight_tpu_torch.pipeline.raycast_graph") is None:
        return None
    s = spans.lap()
    if s is None:
        return None
    replays = sum(r.path[-1] == REPLAY for r in s)
    captures = sum(r.path[-1] == CAPTURE for r in s)
    eager = sum(r.path[-1] == PLAN and CAPTURE not in r.path for r in s)
    n = replays + captures + eager
    return 100.0 * replays / n if n else None
