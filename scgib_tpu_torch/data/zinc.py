"""ZINC (benchmarking-gnns) dataset reader.

Reads the pickle format consumed by the reference's ``MoleculeDGL`` loader
(reference molecules.py:18-94): ``<root>/<split>.pickle`` is a list of
molecule dicts with

  * ``num_atom``                   — int node count
  * ``atom_type``                  — [n] integer atom-type ids (< 28)
  * ``bond_type``                  — [n, n] integer bond-type adjacency
                                     (0 = no bond; already symmetric)
  * ``logP_SA_cycle_normalized``   — scalar regression target

and the 10k/1k/1k subset is selected via ``<split>.index`` (one CSV row of
indices, molecules.py:27-33).  Tensors inside the pickles may be torch
(the published files are) or NumPy; both are handled and torch is only
imported when actually encountered.

TPU-native representation: atom types become one-hot float features
(ZINC feat_dim=28, ``config.py::DATASETS['ZINC']``) instead of the
reference's integer ``ndata['feat']`` — our ``transfer_d`` projection is a
dense matmul, so categorical ids must be expanded on the host once rather
than embedded per-step.  Bond types are returned separately for callers
that want edge features (the live S-CGIB paths never use them,
molecules.py:62 stores but never reads ``edata['feat']``).

The port's own copy of ``scgib_tpu/data/zinc.py`` (NumPy only), held to
it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

from ..graph.batching import GraphData

NUM_ATOM_TYPES = 28    # reference molecules.py:79
NUM_BOND_TYPES = 4     # reference molecules.py:80

# benchmarking-gnns subset sizes (reference molecules.py:83-93)
SUBSET_SIZES = {"train": 10000, "val": 1000, "test": 1000}
FULL_SIZES = {"train": 220011, "val": 24445, "test": 5000}


def _to_numpy(x) -> np.ndarray:
    """torch tensor | numpy array | python scalar -> numpy array."""
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):          # torch tensor, no hard torch import
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _one_hot(ids: np.ndarray, num: int) -> np.ndarray:
    out = np.zeros((ids.shape[0], num), dtype=np.float32)
    out[np.arange(ids.shape[0]), ids] = 1.0
    return out


def molecule_to_graph(mol: dict) -> Tuple[GraphData, np.ndarray]:
    """One pickle record -> (GraphData with one-hot features, bond types).

    Edge extraction mirrors molecules.py:48-52: every nonzero entry of the
    bond-type adjacency is an edge (the matrix is symmetric, so the edge
    list is already bidirectional).
    """
    n = int(_to_numpy(mol["num_atom"]))
    atom = _to_numpy(mol["atom_type"]).astype(np.int64).reshape(-1)[:n]
    adj = _to_numpy(mol["bond_type"]).astype(np.int64)[:n, :n]
    src, dst = np.nonzero(adj)
    bond = adj[src, dst].astype(np.int32)
    label = np.asarray([float(_to_numpy(mol["logP_SA_cycle_normalized"]))],
                       dtype=np.float32)
    g = GraphData(senders=src.astype(np.int32),
                  receivers=dst.astype(np.int32),
                  node_feat=_one_hot(atom, NUM_ATOM_TYPES),
                  label=label)
    return g, bond


def load_zinc(root: str, split: str = "train", subset: bool = True,
              limit: Optional[int] = None,
              return_bonds: bool = False):
    """Load one ZINC split from ``<root>/<split>.pickle``.

    ``subset=True`` applies ``<split>.index`` when present (the 10k/1k/1k
    benchmarking-gnns subset, molecules.py:27-33); if the index file is
    missing the full pickle order is used.

    Returns a list of ``GraphData`` (or ``(GraphData, bond_types)`` pairs
    when ``return_bonds``).
    """
    if split not in SUBSET_SIZES:
        raise ValueError(f"split must be train|val|test, got {split!r}")
    with open(os.path.join(root, f"{split}.pickle"), "rb") as f:
        data = pickle.load(f)

    index_path = os.path.join(root, f"{split}.index")
    if subset and os.path.exists(index_path):
        with open(index_path) as f:
            rows = [list(map(int, row)) for row in csv.reader(f)]
        data = [data[i] for i in rows[0]]

    if limit is not None:
        data = data[:limit]

    out: List = []
    for mol in data:
        g, bond = molecule_to_graph(mol)
        out.append((g, bond) if return_bonds else g)
    return out
