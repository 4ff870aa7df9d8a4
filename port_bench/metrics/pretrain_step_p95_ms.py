"""The 95th percentile of every step of the window, a step running from
one call of the step to the next (the last: to the window's end), so the
wait for its batch is in it."""

import numpy as np


def read(run):
    w = run.window
    if not w or "graphs" not in w:
        return None
    t = np.array(w["starts"] + [w["end"]])
    return float(np.percentile(np.diff(t) * 1e3, 95))
