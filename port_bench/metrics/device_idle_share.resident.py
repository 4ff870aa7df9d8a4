"""The share of the resident cell's traced steps in which no operation ran
on the device (``roofline.idle_share``)."""

from port_bench import roofline


def read(run):
    return roofline.idle_share(run, "pretrain")
