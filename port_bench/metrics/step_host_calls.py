"""The host's CUDA calls a step call (queued cell): the program's counts of
copies into the input buffers and clones of the outputs, plus the graph's
launch, over the traced steps (``spans.py``)."""

from port_bench import spans


def read(run):
    found = spans.calls(run)
    return None if found is None else spans.host_calls(found)
