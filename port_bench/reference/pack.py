"""The reference's own batch layout.

A batch is the molecules of one step in the order the plan gives them: atom
rows graph after graph, then the ego-net rows center after center (the
center first, the other members ascending), each ego-net row pointing at
the atom it copies and at its center.  Only real rows exist here; the
program pads them to capacities (``caps``), which fix the shapes its noise
is drawn at, so a batch keeps the capacities beside its rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..molecules import Molecule, ego_nets


@dataclasses.dataclass
class Batch:
    x: torch.Tensor              # [n, F] atom features
    node_graph: torch.Tensor     # [n] graph of each atom
    senders: torch.Tensor        # [e] atom edges (global ids)
    receivers: torch.Tensor
    sub_orig: torch.Tensor       # [s] atom each ego-net row copies
    sub_center: torch.Tensor     # [s] center of each ego-net row
    sub_senders: torch.Tensor    # [q] ego-net edges (ego-net row ids)
    sub_receivers: torch.Tensor
    num_graphs: int
    node_cap: int                # the program's padded rows, at which
    sub_cap: int                 # its noise is drawn
    labels: Optional[torch.Tensor] = None   # [G] (fine-tuning)

    @property
    def n(self) -> int:
        return self.x.shape[0]


def pack(mols: Sequence[Molecule], k: int, node_cap: int, sub_cap: int,
         dtype=torch.float64, device="cpu") -> Batch:
    xs, graph, snd, rcv = [], [], [], []
    orig, center, ssnd, srcv = [], [], [], []
    n_off = s_off = 0
    for gi, m in enumerate(mols):
        xs.append(m.feat)
        graph.append(np.full(m.num_nodes, gi))
        snd.append(m.senders + n_off)
        rcv.append(m.receivers + n_off)
        for v, (members, (es, er)) in enumerate(ego_nets(m, k)):
            orig.append(members + n_off)
            center.append(np.full(len(members), v + n_off))
            ssnd.append(es + s_off)
            srcv.append(er + s_off)
            s_off += len(members)
        n_off += m.num_nodes

    def ids(parts):
        return torch.as_tensor(np.concatenate(parts).astype(np.int64),
                               device=device)

    labels = None
    if mols[0].label is not None:
        labels = torch.as_tensor(np.array([m.label[0] for m in mols]),
                                 dtype=dtype, device=device)
    return Batch(x=torch.as_tensor(np.concatenate(xs), dtype=dtype,
                                   device=device),
                 node_graph=ids(graph), senders=ids(snd), receivers=ids(rcv),
                 sub_orig=ids(orig), sub_center=ids(center),
                 sub_senders=ids(ssnd), sub_receivers=ids(srcv),
                 num_graphs=len(mols), node_cap=node_cap, sub_cap=sub_cap,
                 labels=labels)
