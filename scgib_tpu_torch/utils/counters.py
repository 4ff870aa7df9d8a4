"""The port's counts: one registry of the kernels' launches and of the
branches a step took, keyed by ``(kind, name)``.

  kind      ticked by                                 name
  launch    each kernel wrapper (``ops/kernels/``)    the wrapper, one of its
                                                      module's ``KERNELS``,
                                                      or ``banded.BLOCKS``
  route     ``gt_flash``'s wrappers with a staged     (wrapper, route)
            route
  encoder   ``models/encoders.py``                    a conv's or an
                                                      attention's path
  pool      ``ops/pool.py``                           the pooling's branch
  recon     ``models/losses.py``                      the reconstruction's
                                                      cross term's path
  gin_bwd   ``banded.py::count_bwd_tiles``            ``tiles``, ``overlapped``
  blocks    ``banded.py::blocks``                     ``entries`` written

A kernel or branch is counted by the module that runs it, and by no other.
A captured step (``train/trainer.py``) takes what its capture ticked as the
difference of two ``snapshot``s, takes it back (capturing runs nothing) and
``add``s it on each replay, so the counts stay counts of work done.
"""

from __future__ import annotations

import collections
from typing import Dict, Hashable, Iterable, Mapping, Tuple

Key = Tuple[str, Hashable]

_counts: collections.Counter = collections.Counter()


def tick(kind: str, name: Hashable, n: int = 1):
    """Add ``n`` to the count of ``name`` of ``kind``."""
    _counts[kind, name] += n


def of(kind: str, names: Iterable[Hashable] = ()) -> Dict[Hashable, int]:
    """``{name: count}`` of one kind: given ``names``, those names, 0 where
    none was counted (a module's ``KERNELS``, say); else every name of the
    kind that has a count."""
    names = tuple(names)
    if names:
        return {name: _counts[kind, name] for name in names}
    return {name: n for (k, name), n in _counts.items() if k == kind}


def reset(*kinds: str):
    """Drop the counts of ``kinds``; with none given, every count."""
    if not kinds:
        _counts.clear()
        return
    for key in [key for key in _counts if key[0] in kinds]:
        del _counts[key]


def snapshot() -> Dict[Key, int]:
    """A copy of every count, by ``(kind, name)``."""
    return dict(_counts)


def add(diff: Mapping[Key, int], sign: int = 1):
    """Add ``sign`` times each count of ``diff`` (as two ``snapshot``s'
    difference gives them); a count that reaches 0 is dropped."""
    for key, n in diff.items():
        _counts[key] += sign * n
        if not _counts[key]:
            del _counts[key]
