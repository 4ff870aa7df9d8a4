"""The share of the traced pretraining window in which no operation ran
on the device."""

from port_bench import roofline


def read(run):
    return roofline.idle_share(run, "pretrain")
