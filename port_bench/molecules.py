"""The benchmark's molecules, and the batch plan both sides follow.

A frozen copy of the port's ``data/synthetic.py::random_molecule`` (a random
spanning tree plus ring-closing edges, bidirected and deduped, 9 integer
features in [0, 10)), drawing in the same order, so that a later change to
the program's generator cannot change the traffic.  ``corpus`` draws a
traffic mix's molecules from its seed, with atom counts uniform in the
mix's range.  ``capacities`` and ``plan`` are copies of the port's
``plan_capacities`` and ``plan_batches``: the caps are the benchmark's input
to the program's loops, and the plan tells the reference which molecules a
checked step trained on.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Molecule:
    senders: np.ndarray        # [E] int32, both directions, deduped
    receivers: np.ndarray      # [E] int32
    feat: np.ndarray           # [n, F] float32
    label: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return self.feat.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]


def _symmetrize(s: np.ndarray, r: np.ndarray):
    a = np.concatenate([s, r]).astype(np.int64)
    b = np.concatenate([r, s]).astype(np.int64)
    n = int(max(a.max(initial=-1), b.max(initial=-1))) + 1
    _, idx = np.unique(a * max(n, 1) + b, return_index=True)
    return a[idx].astype(np.int32), b[idx].astype(np.int32)


def random_molecule(rng: np.random.Generator, min_nodes: int, max_nodes: int,
                    feat_dim: int = 9, extra_edge_frac: float = 0.15,
                    num_tasks: Optional[int] = None) -> Molecule:
    n = int(rng.integers(min_nodes, max_nodes + 1))
    parents = np.array([rng.integers(0, i) for i in range(1, n)],
                       dtype=np.int64)
    s = np.arange(1, n, dtype=np.int64)
    r = parents
    n_extra = int(extra_edge_frac * n)
    if n_extra and n > 2:
        es = rng.integers(0, n, size=n_extra)
        er = rng.integers(0, n, size=n_extra)
        keep = es != er
        s = np.concatenate([s, es[keep]])
        r = np.concatenate([r, er[keep]])
    senders, receivers = _symmetrize(s, r)
    feat = rng.integers(0, 10, size=(n, feat_dim)).astype(np.float32)
    label = None
    if num_tasks is not None:
        label = (rng.random(num_tasks) < 0.5).astype(np.float32)
    return Molecule(senders, receivers, feat, label)


def corpus(seed: int, count: int, atoms: Sequence[int],
           num_tasks: Optional[int] = None) -> List[Molecule]:
    """``count`` molecules of ``atoms[0]`` to ``atoms[1]`` atoms from a
    generator seeded with ``seed`` (any non-negative integer)."""
    rng = np.random.default_rng(seed)
    return [random_molecule(rng, atoms[0], atoms[1], num_tasks=num_tasks)
            for _ in range(count)]


def _reach(mol: Molecule, k: int) -> np.ndarray:
    """[n, n] bool: v reaches u within k in-hops."""
    n = mol.num_nodes
    step = np.eye(n, dtype=np.int64)
    step[mol.receivers, mol.senders] = 1   # r reaches its in-neighbour s
    reach = np.eye(n, dtype=np.int64)
    for _ in range(k):
        reach = np.minimum(reach @ step, 1)
    return reach.astype(bool)


def ego_nets(mol: Molecule, k: int):
    """The k-hop in-neighbourhood of every atom: ``(members, (es, er))`` a
    center, members the center first and then the others ascending, the
    edges those of the molecule with both ends inside, in member order."""
    n = mol.num_nodes
    s, r = mol.senders.astype(np.int64), mol.receivers.astype(np.int64)
    reach = _reach(mol, k)
    out = []
    for v in range(n):
        others = np.flatnonzero(reach[v])
        members = np.concatenate([[v], others[others != v]])
        local = np.full(n, -1, np.int64)
        local[members] = np.arange(len(members))
        keep = reach[v, s] & reach[v, r]
        out.append((members, (local[s[keep]], local[r[keep]])))
    return out


def sizes(mols: Sequence[Molecule], k: int) -> np.ndarray:
    """[M, 4] int64: each molecule's atoms, edges, ego-net atoms and
    ego-net edges."""
    rows = np.zeros((len(mols), 4), np.int64)
    for i, m in enumerate(mols):
        reach = _reach(m, k)
        rows[i] = (m.num_nodes, m.num_edges, reach.sum(),
                   (reach[:, m.senders] & reach[:, m.receivers]).sum())
    return rows


@dataclasses.dataclass(frozen=True)
class Caps:
    nodes: int
    edges: int
    graphs: int
    sub_nodes: int
    sub_edges: int


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def capacities(size_table: np.ndarray, batch_size: int,
               safety: float = 1.1) -> Caps:
    """A random batch's buffer sizes: batch_size x mean + 3 sigma x
    sqrt(batch_size), floored at the largest molecule, times ``safety``,
    rounded up to 256 rows, 512 edges and 8 graphs."""
    def cap(col):
        a = size_table[:, col].astype(np.float64)
        if col in (1, 3):
            a = np.maximum(a, 1)
        est = batch_size * a.mean() + 3.0 * a.std() * np.sqrt(batch_size)
        return int(max(est, a.max()) * safety)

    return Caps(nodes=_round_up(cap(0), 256), edges=_round_up(cap(1), 512),
                graphs=_round_up(batch_size, 8),
                sub_nodes=_round_up(cap(2), 256),
                sub_edges=_round_up(cap(3), 512))


def plan(size_table: np.ndarray, batch_size: int, caps: Caps,
         shuffle: bool, seed: int = 0) -> List[np.ndarray]:
    """The molecules of each batch of an epoch: a shuffle seeded with
    ``seed``, then consecutive runs of ``batch_size``, each shortened
    until it fits ``caps``."""
    order = np.arange(len(size_table))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    limits = (caps.nodes, caps.edges, caps.sub_nodes, caps.sub_edges)
    out, i = [], 0
    while i < len(order):
        take = min(batch_size, len(order) - i)
        while take > 1 and any(size_table[order[i:i + take], c].sum() > lim
                               for c, lim in enumerate(limits)):
            take -= 1
        out.append(order[i:i + take])
        i += take
    return out
