"""SDF (MDL molfile V2000) reader + QM9 loader.

QM9 is the reference's stage-2 pretraining dataset (feature dim 11,
``exp_pretraining.py:218-219``) and a fine-tune target with all 19
regression targets stored (``exp_qm9.py:399``).  PyG's ``QM9`` builds it
from ``gdb9.sdf`` + ``gdb9.sdf.csv`` with RDKit; this module reads the
same files directly.

The 11-dim QM9 node features replicate PyG's scheme:
``[one-hot(H,C,N,O,F) | atomic_number | aromatic | sp | sp2 | sp3 |
num_hs]`` — hydrogens are kept as explicit atoms (as PyG does), and
``num_hs`` counts hydrogen neighbors of heavy atoms.

The port's own copy of ``scgib_tpu/data/sdf.py`` (NumPy only), held to
it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..graph.batching import GraphData, symmetrize_edges
from .smiles import ATOMIC_NUM, Atom, Bond, Molecule, _finalize

_SDF_BOND_ORDER = {1: 1.0, 2: 2.0, 3: 3.0, 4: 1.5}


def _parse_molblock(lines: List[str]) -> Molecule:
    """One V2000 molblock (header stripped of the terminating M  END)."""
    counts = lines[3]
    n_atoms = int(counts[0:3])
    n_bonds = int(counts[3:6])

    atoms: List[Atom] = []
    for i in range(n_atoms):
        ln = lines[4 + i]
        sym = ln[31:34].strip()
        if sym not in ATOMIC_NUM:
            raise ValueError(f"unknown element {sym!r} in molblock")
        # molfile charge field: 0=none 1=+3 2=+2 3=+1 4=radical 5=-1 6=-2 7=-3
        cc = int(ln[36:39]) if len(ln) >= 39 and ln[36:39].strip() else 0
        charge = {1: 3, 2: 2, 3: 1, 5: -1, 6: -2, 7: -3}.get(cc, 0)
        atoms.append(Atom(symbol=sym, charge=charge,
                          explicit_h=0 if sym != "H" else 0))

    bonds: List[Bond] = []
    for i in range(n_bonds):
        ln = lines[4 + n_atoms + i]
        a = int(ln[0:3]) - 1
        b = int(ln[3:6]) - 1
        t = int(ln[6:9])
        order = _SDF_BOND_ORDER.get(t, 1.0)
        if order == 1.5:
            atoms[a].aromatic = atoms[b].aromatic = True
        bonds.append(Bond(a=a, b=b, order=order))

    # property block: M  CHG overrides the deprecated charge column
    for ln in lines[4 + n_atoms + n_bonds:]:
        if ln.startswith("M  CHG"):
            parts = ln.split()
            k = int(parts[2])
            for j in range(k):
                atoms[int(parts[3 + 2 * j]) - 1].charge = \
                    int(parts[4 + 2 * j])

    mol = Molecule(atoms=atoms, bonds=bonds)
    _finalize(mol)   # rings, hybridization; explicit_h=0 => no implicit H
    return mol


def iter_sdf(path: str) -> Iterator[Tuple[Optional[Molecule], str]]:
    """Yield (molecule_or_None, raw_block_title) per $$$$-record.  A
    malformed record yields (None, title) so callers can count skips the
    way the reference swallows per-graph failures
    (``exp_qm9.py`` try/except pattern)."""
    with open(path, encoding="utf-8", errors="replace") as f:
        block: List[str] = []
        for line in f:
            if line.startswith("$$$$"):
                title = block[0].strip() if block else ""
                try:
                    yield _parse_molblock(block), title
                except (ValueError, IndexError):
                    yield None, title
                block = []
            else:
                block.append(line.rstrip("\n"))
        if any(l.strip() for l in block):
            title = block[0].strip() if block else ""
            try:
                yield _parse_molblock(block), title
            except (ValueError, IndexError):
                yield None, title


_QM9_TYPES = ["H", "C", "N", "O", "F"]


def qm9_features(mol: Molecule) -> np.ndarray:
    """[n, 11] float32 per PyG QM9's node feature layout."""
    n = mol.num_atoms
    x = np.zeros((n, 11), np.float32)
    h_neighbors = np.zeros(n, np.int32)
    for b in mol.bonds:
        if mol.atoms[b.b].symbol == "H":
            h_neighbors[b.a] += 1
        if mol.atoms[b.a].symbol == "H":
            h_neighbors[b.b] += 1
    for i, a in enumerate(mol.atoms):
        if a.symbol in _QM9_TYPES:
            x[i, _QM9_TYPES.index(a.symbol)] = 1.0
        x[i, 5] = ATOMIC_NUM.get(a.symbol, 0)
        x[i, 6] = float(a.aromatic)
        x[i, 7] = float(a.hybridization == "SP")
        x[i, 8] = float(a.hybridization == "SP2")
        x[i, 9] = float(a.hybridization == "SP3")
        x[i, 10] = float(h_neighbors[i])
    return x


def mol_to_graph(mol: Molecule,
                 label: Optional[np.ndarray] = None,
                 features: str = "qm9") -> GraphData:
    if features == "qm9":
        x = qm9_features(mol)
    else:
        from .smiles import featurize

        x, _, _ = featurize(mol, scheme=features)
    if mol.bonds:
        s = np.asarray([b.a for b in mol.bonds], np.int32)
        r = np.asarray([b.b for b in mol.bonds], np.int32)
        s, r = symmetrize_edges(s, r)
    else:
        s = np.zeros(0, np.int32)
        r = np.zeros(0, np.int32)
    return GraphData(senders=s, receivers=r, node_feat=x, label=label)


def load_qm9(root: str, limit: Optional[int] = None,
             features: str = "qm9"
             ) -> Tuple[List[GraphData], int]:
    """QM9 from ``gdb9.sdf`` (+ ``gdb9.sdf.csv`` 19-target table when
    present).  Returns (graphs, n_skipped).  The reference caps QM9 at
    100k graphs for pretraining (``exp_qm9.py:372``)."""
    sdf = None
    for cand in (os.path.join(root, "gdb9.sdf"),
                 os.path.join(root, "raw", "gdb9.sdf")):
        if os.path.exists(cand):
            sdf = cand
            break
    if sdf is None:
        raise FileNotFoundError(f"gdb9.sdf not found under {root}")

    labels = {}
    for cand in (sdf + ".csv", os.path.join(root, "gdb9.sdf.csv")):
        if os.path.exists(cand):
            import csv as _csv

            with open(cand, newline="") as f:
                reader = _csv.reader(f)
                header = next(reader)
                for row in reader:
                    labels[row[0].strip()] = np.asarray(
                        [float(v) for v in row[1:]], np.float32)
            break

    graphs: List[GraphData] = []
    skipped = 0
    for mol, title in iter_sdf(sdf):
        if limit is not None and len(graphs) >= limit:
            break
        if mol is None or mol.num_atoms == 0:
            skipped += 1
            continue
        graphs.append(mol_to_graph(mol, label=labels.get(title),
                                   features=features))
    return graphs, skipped
