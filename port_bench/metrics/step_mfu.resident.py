"""The whole resident pretraining step's share of the chip's peak: the model's
FLOPs (``counts.step_flops``) of the traced steps over the traced window's
seconds times the configuration's peak (``peaks.json``)."""

from port_bench import roofline


def read(run):
    return roofline.step_mfu(run)
