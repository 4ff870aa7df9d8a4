"""The banded SpMM kernel's share of its roofline (``banded_spmm.py``'s
kernels: the GIN backward's ``spmm_self``, the reconstruction's product
and the pooling), from the real rows and edges of the traced steps and the
calls the program's tally names; None where it names none."""

from port_bench import banded_spmm


def read(run):
    return banded_spmm.roofline(run)
