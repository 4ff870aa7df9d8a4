"""Host ms a step call (resident cell) inside ``graph.replay()``: the
program's ``scgib.step.replay`` span, over the traced steps (``spans.py``)."""

from port_bench import spans


def read(run):
    found = spans.calls(run)
    return None if found is None else spans.replay_host_ms(found)
