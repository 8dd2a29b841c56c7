"""The share in % of the device's busy time that the least bytes of the
traced frames' work (``slambench/work.py``) need at the card's peak
bandwidth."""


def read(run):
    t = run["trace"]
    if not t or not t["busy_s"]:
        return None
    return 100.0 * run["least_s"] / t["busy_s"]
