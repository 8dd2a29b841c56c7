"""The 95th percentile of the integration stage's host ms over the traced
frames."""

import numpy as np


def read(run):
    t = run["stage_s"]["integration"]
    return 1e3 * float(np.percentile(t, 95)) if t else None
