"""Device-idle ms a step call (resident cell): each ``scgib.step`` span
less the device's busy time inside it, over the traced steps
(``spans.py``)."""

from port_bench import spans


def read(run):
    found = spans.calls(run)
    return None if found is None else spans.step_idle_ms(run.trace, found)
