"""Real-dataset ingestion from the standard on-disk distributions.

The reference obtains every molecular dataset through PyG/OGB downloads
(``exp_moleculenetBACE_BBBP.py:219-224``, ``exp_molhiv.py:223-224``,
``exp_pcqm4mv2.py:260-268``, ``exp_pep_func_5.py:251-257``) and RDKit
featurization.  This module reads the same artifacts those libraries put
on disk -- no PyG/OGB/RDKit needed:

  * **MoleculeNet CSVs** (``bace.csv``, ``BBBP.csv``, ``tox21.csv.gz`` ...):
    SMILES + label columns, featurized by :mod:`.smiles`.  The per-dataset
    column table mirrors PyG's ``MoleculeNet.names``.
  * **OGB graph directories** (``ogbg_molhiv/raw`` style): pre-featurized
    flat CSVs (``node-feat.csv.gz``, ``edge.csv.gz``, ``num-node-list``...)
    -- bit-identical features to what the reference trained on, no RDKit
    involved at all.
  * **PCQM4Mv2** ``raw/data.csv.gz`` (smiles, homolumogap).
  * **LRGB peptides** SMILES/label tables (func: 10 binary tasks;
    struct: 11 regression targets).

All loaders return lists of :class:`~scgib_tpu_torch.graph.batching.GraphData`
with symmetrized edges, matching ``util.load_dgl_fromPyG``
(util.py:277-325: ``dgl.to_bidirected`` + ``ndata['x']``).

The port's own copy of ``scgib_tpu/data/molnet.py`` (NumPy only), held to
it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import csv
import gzip
import io
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..graph.batching import GraphData, symmetrize_edges
from .smiles import SmilesError, smiles_to_graph

# ---------------------------------------------------------------------------
# MoleculeNet CSV table — dataset name -> (csv filename, smiles column,
# label columns).  Columns are header NAMES (more robust than PyG's
# positional slices but selecting the same data).
# ---------------------------------------------------------------------------

MOLECULENET: Dict[str, Tuple[str, str, Union[Sequence[str], slice]]] = {
    "BACE": ("bace.csv", "mol", ["Class"]),
    "BBBP": ("BBBP.csv", "smiles", ["p_np"]),
    "HIV": ("HIV.csv", "smiles", ["HIV_active"]),
    "Tox21": ("tox21.csv.gz", "smiles",
              ["NR-AR", "NR-AR-LBD", "NR-AhR", "NR-Aromatase", "NR-ER",
               "NR-ER-LBD", "NR-PPAR-gamma", "SR-ARE", "SR-ATAD5",
               "SR-HSE", "SR-MMP", "SR-p53"]),
    # ToxCast: 617 task columns -> "all but the smiles column"
    "ToxCast": ("toxcast_data.csv.gz", "smiles", slice(1, None)),
    "SIDER": ("sider.csv.gz", "smiles", slice(1, None)),      # 27 tasks
    "ClinTox": ("clintox.csv.gz", "smiles", ["FDA_APPROVED", "CT_TOX"]),
    "MUV": ("muv.csv.gz", "smiles", slice(0, 17)),            # MUV-* cols
    "ESOL": ("delaney-processed.csv", "smiles",
             ["measured log solubility in mols per litre"]),
    "FreeSolv": ("SAMPL.csv", "smiles", ["expt"]),
    "Lipo": ("Lipophilicity.csv", "smiles", ["exp"]),
}


def _open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8",
                                newline="")
    return open(path, encoding="utf-8", newline="")


def _to_float(cell: str) -> float:
    cell = cell.strip()
    if cell == "" or cell.lower() in ("na", "nan", "none"):
        return float("nan")
    try:
        return float(cell)
    except ValueError:
        return float("nan")


def load_smiles_csv(path: str, smiles_col: Optional[str] = None,
                    label_cols: Union[Sequence[str], slice, None] = None,
                    scheme: str = "ogb", limit: Optional[int] = None,
                    ) -> Tuple[List[GraphData], List[str]]:
    """Generic SMILES-table loader.  Returns (graphs, skipped_smiles);
    unparseable rows are skipped and counted like the reference's silent
    per-graph try/except (``exp_moleculenetBACE_BBBP.py:308-323``)."""
    with _open_text(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)

    if smiles_col is None:
        cands = [h for h in header if h.strip().lower() in
                 ("smiles", "mol", "canonical_smiles")]
        if not cands:
            raise ValueError(f"no smiles column found in {header[:8]}...")
        smiles_col = cands[0]
    si = header.index(smiles_col)

    if label_cols is None:
        li: List[int] = []
    elif isinstance(label_cols, slice):
        li = [i for i in list(range(len(header)))[label_cols] if i != si]
    else:
        li = [header.index(c) for c in label_cols]

    graphs: List[GraphData] = []
    skipped: List[str] = []
    for row in rows:
        if limit is not None and len(graphs) >= limit:
            break
        if not row or si >= len(row):
            continue
        smi = row[si].strip()
        label = (np.asarray([_to_float(row[i]) if i < len(row) else
                             float("nan") for i in li], np.float32)
                 if li else None)
        try:
            g = smiles_to_graph(smi, scheme=scheme, label=label)
        except (SmilesError, IndexError, ValueError):
            skipped.append(smi)
            continue
        if g.num_nodes == 0:
            skipped.append(smi)
            continue
        graphs.append(g)
    return graphs, skipped


def load_moleculenet(root: str, name: str, scheme: str = "ogb",
                     limit: Optional[int] = None
                     ) -> Tuple[List[GraphData], List[str]]:
    """Load one MoleculeNet dataset from its raw CSV (the file PyG's
    ``MoleculeNet`` downloads into ``<root>/<name>/raw/``)."""
    if name not in MOLECULENET:
        raise KeyError(f"unknown MoleculeNet dataset {name!r}; "
                       f"have {sorted(MOLECULENET)}")
    fname, smiles_col, label_cols = MOLECULENET[name]
    for cand in (os.path.join(root, fname),
                 os.path.join(root, name, "raw", fname),
                 os.path.join(root, name.lower(), "raw", fname),
                 os.path.join(root, fname.rstrip(".gz"))):
        if os.path.exists(cand):
            return load_smiles_csv(cand, smiles_col, label_cols,
                                   scheme=scheme, limit=limit)
    raise FileNotFoundError(
        f"{fname} not found under {root} (searched raw/ layouts)")


# ---------------------------------------------------------------------------
# OGB raw graph directories (pre-featurized; no SMILES parsing involved)
# ---------------------------------------------------------------------------

def _read_csv_gz_int(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        return np.loadtxt(f, delimiter=",", dtype=np.int64, ndmin=2)


def _read_csv_gz_float(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        return np.genfromtxt(f, delimiter=",", dtype=np.float32, ndmin=2)


def load_ogb_graphs(raw_dir: str, limit: Optional[int] = None
                    ) -> List[GraphData]:
    """Read an OGB graph-prop dataset from its ``raw/`` flat-CSV layout
    (``edge.csv.gz``, ``node-feat.csv.gz``, ``num-node-list.csv.gz``,
    ``num-edge-list.csv.gz``, ``graph-label.csv.gz``).  These node
    features are exactly the 9-dim vectors the reference's OGB loaders
    produce (``exp_molhiv.py:223-224``) — RDKit never runs here."""
    p = lambda f: os.path.join(raw_dir, f)
    num_nodes = _read_csv_gz_int(p("num-node-list.csv.gz")).ravel()
    num_edges = _read_csv_gz_int(p("num-edge-list.csv.gz")).ravel()
    edges = _read_csv_gz_int(p("edge.csv.gz"))
    feats = _read_csv_gz_float(p("node-feat.csv.gz"))
    labels = None
    if os.path.exists(p("graph-label.csv.gz")):
        labels = _read_csv_gz_float(p("graph-label.csv.gz"))

    graphs: List[GraphData] = []
    no, eo = 0, 0
    n_graphs = len(num_nodes) if limit is None else min(limit, len(num_nodes))
    for i in range(n_graphs):
        nn, ne = int(num_nodes[i]), int(num_edges[i])
        e = edges[eo:eo + ne]
        s, r = (e[:, 0].astype(np.int32), e[:, 1].astype(np.int32)) \
            if ne else (np.zeros(0, np.int32), np.zeros(0, np.int32))
        if ne:
            s, r = symmetrize_edges(s, r)
        graphs.append(GraphData(
            senders=s, receivers=r,
            node_feat=feats[no:no + nn].astype(np.float32),
            label=labels[i] if labels is not None else None))
        no += nn
        eo += ne
    return graphs


def load_pcqm4mv2(root: str, scheme: str = "ogb",
                  limit: Optional[int] = None
                  ) -> Tuple[List[GraphData], List[str]]:
    """PCQM4Mv2 from ``raw/data.csv.gz`` (columns: idx, smiles,
    homolumogap).  The reference caps this at the first 100k graphs for
    pretraining (``exp_pcqm4mv2.py:394``); pass ``limit`` for that."""
    for cand in (os.path.join(root, "raw", "data.csv.gz"),
                 os.path.join(root, "data.csv.gz"),
                 os.path.join(root, "pcqm4m-v2", "raw", "data.csv.gz")):
        if os.path.exists(cand):
            return load_smiles_csv(cand, smiles_col="smiles",
                                   label_cols=["homolumogap"],
                                   scheme=scheme, limit=limit)
    raise FileNotFoundError(f"PCQM4Mv2 data.csv.gz not found under {root}")


# ---------------------------------------------------------------------------
# LRGB peptides (func: 10 binary tasks / struct: 11 regression targets)
# ---------------------------------------------------------------------------

def load_peptides(root: str, which: str = "func", scheme: str = "ogb",
                  limit: Optional[int] = None
                  ) -> Tuple[List[GraphData], List[str]]:
    """LRGB Peptides-func / Peptides-struct from their SMILES+label
    tables.  Order is preserved — the reference keeps LRGB order for the
    splits (shuffle commented out, ``exp_pep_func_5.py:313``)."""
    names = (["peptide_multi_class_dataset.csv.gz"] if which == "func"
             else ["peptide_structure_normalized_dataset.csv.gz",
                   "peptide_structure_dataset.csv.gz"])
    path = None
    for n in names:
        for cand in (os.path.join(root, n), os.path.join(root, "raw", n)):
            if os.path.exists(cand):
                path = cand
                break
        if path:
            break
    if path is None:
        raise FileNotFoundError(f"peptides {which} table not found in {root}")

    if which == "func":
        # label column holds a python-list string "[0, 1, ...]"
        with _open_text(path) as f:
            reader = csv.reader(f)
            header = next(reader)
            si = header.index("smiles")
            ci = header.index("labels")
            graphs: List[GraphData] = []
            skipped: List[str] = []
            for row in reader:
                if limit is not None and len(graphs) >= limit:
                    break
                lab = np.asarray(
                    [float(t) for t in
                     row[ci].strip("[] ").replace(",", " ").split()],
                    np.float32)
                try:
                    g = smiles_to_graph(row[si].strip(), scheme=scheme,
                                        label=lab)
                except (SmilesError, ValueError):
                    skipped.append(row[si])
                    continue
                graphs.append(g)
        return graphs, skipped

    target_cols = ["Inertia_mass_a", "Inertia_mass_b", "Inertia_mass_c",
                   "Inertia_valence_a", "Inertia_valence_b",
                   "Inertia_valence_c", "length_a", "length_b", "length_c",
                   "Spherocity", "Plane_best_fit"]
    with _open_text(path) as f:
        header = next(csv.reader(io.StringIO(f.readline())))
    cols = [c for c in target_cols if c in header]
    return load_smiles_csv(path, smiles_col="smiles",
                           label_cols=cols or slice(1, None),
                           scheme=scheme, limit=limit)
