"""The graph attention's share of its roofline (``kernels.json``'s
``attention`` kernels), from the real rows and edges of the traced
steps."""

from port_bench import roofline


def read(run):
    return roofline.share(run, "attention", roofline.attention_least)
