"""Host ms a replayed pretraining step call (resident cell): the program's
``scgib.step`` span, over the traced steps (``spans.py``)."""

from port_bench import spans


def read(run):
    found = spans.calls(run)
    return None if found is None else spans.step_host_ms(found)
