"""The median host milliseconds of packing one batch alone, as the
pretraining loop's packing thread does (``batch_iterator``, native flat
packer), after the window."""

import statistics


def read(run):
    return statistics.median(run.pack_ms) if run.pack_ms else None
