"""Molecules trained in the window over the window's seconds, the window
ending on the last step's loss read."""


def read(run):
    w = run.window
    if not w or "graphs" not in w:
        return None
    return w["graphs"] / (w["end"] - w["starts"][0])
