"""The fused GIN conv's share of its roofline (``kernels.json``'s
``gin_conv`` kernels), from the real rows and edges of the traced steps."""

from port_bench import roofline


def read(run):
    return roofline.share(run, "gin_conv", roofline.gin_conv_least)
