"""Device milliseconds a pretraining step: the union of the device
operations' intervals in the traced steps, over their number."""


def read(run):
    stats = getattr(run.driver, "traced_stats", None)
    if run.trace is None or not stats:
        return None
    return 1e3 * run.trace.busy_s() / len(stats)
