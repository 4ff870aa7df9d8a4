"""The port's dataset readers, cache and generators against the JAX
package's, on files the tests write (``tmp_path``) or data made from
seeds: each reader's graphs (node features, edges, labels) and skipped
records bit-equal for the same file; the ``.npz`` cache read both ways;
the featurizers on ``tests/test_featurizer_goldens.py``'s SMILES; the rest
of ``data/synthetic.py``; ``graph/pos_enc.py``; ``download`` from a
localhost server, through the function and the verb."""

import csv
import gzip
import http.server
import io
import pickle
import threading
import zipfile

import numpy as np
import pytest

import scgib_tpu.native
from scgib_tpu.data import cache as jcache
from scgib_tpu.data import molnet as jmolnet
from scgib_tpu.data import sdf as jsdf
from scgib_tpu.data import smiles as jsmiles
from scgib_tpu.data import synthetic as jsynthetic
from scgib_tpu.data import tudataset as jtudataset
from scgib_tpu.data import zinc as jzinc
from scgib_tpu.data.loader import GraphDataset as JGraphDataset
from scgib_tpu.graph import pos_enc as jpos_enc

from scgib_tpu_torch import cli
from scgib_tpu_torch.data import cache, molnet, sdf, smiles, synthetic
from scgib_tpu_torch.data import tudataset, zinc
from scgib_tpu_torch.data.download import download_dataset
from scgib_tpu_torch.data.loader import GraphDataset
from scgib_tpu_torch.graph import pos_enc

from test_featurizer_goldens import GOLDENS

SMILES = sorted(GOLDENS) + ["CC(C)Cc1ccc(cc1)C(C)C(=O)O",
                            "c1ccc2c(c1)cccc2", "C[N+](C)(C)C",
                            "O=C([O-])c1ccccc1"]


@pytest.fixture(autouse=True)
def _jax_numpy_packers(monkeypatch):
    """The JAX side's ego-nets from its NumPy BFS: its native library is
    ``tests/test_native.py``'s to build (in place, where a second process
    building it could hand it half a file)."""
    monkeypatch.setattr(scgib_tpu.native, "_load", lambda: None)


def _same_graphs(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for name in ("senders", "receivers", "node_feat"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        assert (a.label is None) == (b.label is None)
        if a.label is not None:
            np.testing.assert_array_equal(np.asarray(a.label),
                                          np.asarray(b.label))


def _same_egonets(ours, theirs):
    assert len(ours) == len(theirs)
    for e1, e2 in zip(ours, theirs):
        for nl1, nl2 in zip(e1.node_lists, e2.node_lists, strict=True):
            np.testing.assert_array_equal(nl1, nl2)
        for (s1, r1), (s2, r2) in zip(e1.edge_lists, e2.edge_lists,
                                      strict=True):
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_array_equal(r1, r2)


# --- SMILES and the MoleculeNet / OGB / PCQM4Mv2 / peptides tables -----------

@pytest.mark.parametrize("scheme", ["ogb", "pyg"])
def test_featurizers_on_the_goldens(scheme):
    for smi in SMILES:
        ours = smiles.smiles_to_graph(smi, scheme=scheme)
        theirs = jsmiles.smiles_to_graph(smi, scheme=scheme)
        _same_graphs([ours], [theirs])
        if scheme == "ogb" and smi in GOLDENS:
            assert ours.node_feat.astype(int).tolist() == GOLDENS[smi]


def _table(path, header, rows, gz=False):
    text = io.StringIO()
    w = csv.writer(text)
    w.writerow(header)
    w.writerows(rows)
    if gz:
        path.write_bytes(gzip.compress(text.getvalue().encode()))
    else:
        path.write_text(text.getvalue())
    return str(path)


ROWS = [["CCO", "1", "0.5"], ["c1ccccc1", "0", ""], ["C1CC", "1", "2"],
        ["CC(=O)O", "", "1.5"], ["not_a_smiles", "1", "1"],
        ["c1ccncc1", "0", "na"]]


def test_smiles_csv(tmp_path):
    path = _table(tmp_path / "t.csv", ["smiles", "a", "b"], ROWS)
    ours = molnet.load_smiles_csv(path, label_cols=slice(1, None))
    theirs = jmolnet.load_smiles_csv(path, label_cols=slice(1, None))
    assert ours[1] == theirs[1] and len(ours[1]) >= 1
    _same_graphs(ours[0], theirs[0])
    lim = molnet.load_smiles_csv(path, label_cols=["b"], limit=2)
    _same_graphs(lim[0], jmolnet.load_smiles_csv(path, label_cols=["b"],
                                                 limit=2)[0])


def test_moleculenet_pcqm4mv2_and_peptides(tmp_path):
    (tmp_path / "BACE" / "raw").mkdir(parents=True)
    _table(tmp_path / "BACE" / "raw" / "bace.csv", ["mol", "CID", "Class"],
           [[r[0], str(i), r[1]] for i, r in enumerate(ROWS)])
    for ours, theirs in (
            (molnet.load_moleculenet(str(tmp_path), "BACE"),
             jmolnet.load_moleculenet(str(tmp_path), "BACE")),):
        assert ours[1] == theirs[1]
        _same_graphs(ours[0], theirs[0])
    (tmp_path / "pcq" / "raw").mkdir(parents=True)
    _table(tmp_path / "pcq" / "raw" / "data.csv.gz",
           ["idx", "smiles", "homolumogap"],
           [[str(i), r[0], r[2]] for i, r in enumerate(ROWS)], gz=True)
    ours = molnet.load_pcqm4mv2(str(tmp_path / "pcq"))
    theirs = jmolnet.load_pcqm4mv2(str(tmp_path / "pcq"))
    assert ours[1] == theirs[1]
    _same_graphs(ours[0], theirs[0])
    _table(tmp_path / "peptide_multi_class_dataset.csv.gz",
           ["smiles", "labels"],
           [[r[0], "[1, 0, 1]"] for r in ROWS[:4]], gz=True)
    _table(tmp_path / "peptide_structure_normalized_dataset.csv.gz",
           ["smiles", "Inertia_mass_a", "length_a"],
           [[r[0], r[2] or "0", "1.0"] for r in ROWS], gz=True)
    for which in ("func", "struct"):
        ours = molnet.load_peptides(str(tmp_path), which)
        theirs = jmolnet.load_peptides(str(tmp_path), which)
        assert ours[1] == theirs[1]
        _same_graphs(ours[0], theirs[0])


def test_ogb_graphs(tmp_path):
    def gz(name, rows):
        (tmp_path / name).write_bytes(gzip.compress(
            "".join(",".join(map(str, r)) + "\n" for r in rows).encode()))
    gz("num-node-list.csv.gz", [[3], [2], [1]])
    gz("num-edge-list.csv.gz", [[2], [1], [0]])
    gz("edge.csv.gz", [[0, 1], [1, 2], [0, 1]])
    rng = np.random.default_rng(0)
    gz("node-feat.csv.gz", rng.integers(0, 5, size=(6, 9)).tolist())
    gz("graph-label.csv.gz", [[1], [0], [1]])
    for limit in (None, 2):
        _same_graphs(molnet.load_ogb_graphs(str(tmp_path), limit=limit),
                     jmolnet.load_ogb_graphs(str(tmp_path), limit=limit))


# --- QM9 (SDF), ZINC (pickles), TUDataset (text) -----------------------------

def _molblock(name, atoms, bonds, extra=""):
    lines = [name, "  test", "",
             f"{len(atoms):3d}{len(bonds):3d}  0  0  0  0  0  0  0  0999 V2000"]
    for sym, cc in atoms:
        lines.append(f"    0.0000    0.0000    0.0000 {sym:<3}"
                     f" 0  {cc}  0  0  0  0  0  0  0  0  0  0")
    for a, b, t in bonds:
        lines.append(f"{a:3d}{b:3d}{t:3d}  0")
    if extra:
        lines.append(extra)
    lines.append("M  END")
    return "\n".join(lines)


def test_qm9(tmp_path):
    blocks = [
        _molblock("gdb_1", [("C", 0)] + [("H", 0)] * 4,
                  [(1, i, 1) for i in range(2, 6)]),
        _molblock("gdb_2", [("O", 0), ("H", 0), ("H", 0)],
                  [(1, 2, 1), (1, 3, 1)]),
        "garbage\n\n\nnot a counts line",
        _molblock("gdb_3", [("C", 0), ("C", 0), ("N", 3), ("O", 0)],
                  [(1, 2, 2), (2, 3, 1), (3, 4, 1)],
                  extra="M  CHG  1   3   1"),
        _molblock("gdb_4", [("C", 0)] * 6,
                  [(i, i % 6 + 1, 4) for i in range(1, 7)])]
    (tmp_path / "gdb9.sdf").write_text("\n$$$$\n".join(blocks) + "\n$$$$\n")
    (tmp_path / "gdb9.sdf.csv").write_text(
        "mol_id,A,B\ngdb_1,1.5,2.5\ngdb_2,3.5,4.5\ngdb_3,5,6\n"
        "gdb_4,7,8\n")
    for limit in (None, 2):
        ours = sdf.load_qm9(str(tmp_path), limit=limit)
        theirs = jsdf.load_qm9(str(tmp_path), limit=limit)
        assert ours[1] == theirs[1]
        _same_graphs(ours[0], theirs[0])
    assert sdf.load_qm9(str(tmp_path))[1] == 1


def test_zinc(tmp_path):
    rng = np.random.default_rng(1)
    mols = []
    for _ in range(12):
        n = int(rng.integers(4, 12))
        adj = np.zeros((n, n), np.int64)
        for i in range(n):
            adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = rng.integers(1, 4)
        mols.append({"num_atom": n,
                     "atom_type": rng.integers(0, zinc.NUM_ATOM_TYPES, n),
                     "bond_type": adj,
                     "logP_SA_cycle_normalized": np.float32(rng.normal())})
    with open(tmp_path / "val.pickle", "wb") as f:
        pickle.dump(mols, f)
    _same_graphs(zinc.load_zinc(str(tmp_path), "val"),
                 jzinc.load_zinc(str(tmp_path), "val"))
    with open(tmp_path / "val.index", "w", newline="") as f:
        csv.writer(f).writerow([3, 0, 7, 11])
    for kw in ({}, {"subset": False, "limit": 5}):
        _same_graphs(zinc.load_zinc(str(tmp_path), "val", **kw),
                     jzinc.load_zinc(str(tmp_path), "val", **kw))


def test_tudataset(tmp_path):
    d = tmp_path / "TINY"
    d.mkdir()
    (d / "TINY_A.txt").write_text(
        "1, 2\n2, 1\n2, 3\n3, 2\n1, 3\n3, 1\n4, 5\n5, 4\n")
    (d / "TINY_graph_indicator.txt").write_text("1\n1\n1\n2\n2\n3\n")
    (d / "TINY_graph_labels.txt").write_text("1\n-1\n1\n")
    (d / "TINY_node_labels.txt").write_text("0\n1\n2\n1\n0\n2\n")
    (d / "TINY_node_attributes.txt").write_text(
        "0.5\n1.5\n2.5\n3.5\n4.5\n5.5\n")
    _same_graphs(tudataset.load_tudataset(str(tmp_path), "TINY"),
                 jtudataset.load_tudataset(str(tmp_path), "TINY"))
    with pytest.raises(FileNotFoundError):
        tudataset.load_tudataset(str(tmp_path), "NOPE")


# --- the cache, the generators, the positional encodings ---------------------

def test_cache_read_both_ways(tmp_path):
    graphs = synthetic.random_dataset(30, seed=3, min_nodes=4, max_nodes=16,
                                      num_tasks=2, label_nan_frac=0.3)
    ours = GraphDataset(graphs, k=2)
    theirs = JGraphDataset(jsynthetic.random_dataset(
        30, seed=3, min_nodes=4, max_nodes=16, num_tasks=2,
        label_nan_frac=0.3), k=2)
    cache.save_dataset(str(tmp_path / "ours.npz"), ours)
    jcache.save_dataset(str(tmp_path / "theirs.npz"), theirs)
    for path in ("ours.npz", "theirs.npz"):
        a = cache.load_dataset(str(tmp_path / path))
        b = jcache.load_dataset(str(tmp_path / path))
        assert a.k == b.k == 2
        _same_graphs(a.graphs, b.graphs)
        _same_graphs(a.graphs, ours.graphs)
        _same_egonets(a.egonets, b.egonets)
        _same_egonets(a.egonets, ours.egonets)


def test_cache_load_reads_each_array_once(tmp_path):
    """Every ego-net of the port's load is a view of one copy of the
    cache's arrays; the JAX package's load decompresses the whole array
    again for each slice, so each of its slices holds a copy of its own
    (ROADMAP.md Queue 3)."""
    ds = GraphDataset(synthetic.random_dataset(30, seed=3), k=1)
    path = str(tmp_path / "c.npz")
    cache.save_dataset(path, ds)
    ours, theirs = cache.load_dataset(path), jcache.load_dataset(path)
    centers = sum(g.num_nodes for g in ds.graphs)

    def copies(d):
        return len({id(nl.base) for e in d.egonets for nl in e.node_lists})
    assert copies(ours) == 1
    assert copies(theirs) == centers
    _same_egonets(ours.egonets, theirs.egonets)


@pytest.mark.parametrize("name", ["structured_dataset", "probe_dataset",
                                  "triangle_probe_dataset",
                                  "learnable_dataset"])
def test_synthetic_generators(name):
    _same_graphs(getattr(synthetic, name)(24, seed=5),
                 getattr(jsynthetic, name)(24, seed=5))


def test_positional_encodings():
    for g in synthetic.random_dataset(6, seed=2, min_nodes=5, max_nodes=14):
        np.testing.assert_array_equal(pos_enc.laplacian_pe(g, 4),
                                      jpos_enc.laplacian_pe(g, 4))
        np.testing.assert_array_equal(pos_enc.wl_pe(g), jpos_enc.wl_pe(g))
        _same_graphs([pos_enc.attach_laplacian_pe(g, 3),
                      pos_enc.make_full_graph(g)],
                     [jpos_enc.attach_laplacian_pe(g, 3),
                      jpos_enc.make_full_graph(g)])


# --- download from a localhost server ----------------------------------------

@pytest.fixture(scope="module")
def http_root(tmp_path_factory):
    src = tmp_path_factory.mktemp("mirror")
    (src / "bace.csv").write_text(
        "mol,CID,Class\nCCO,1,1\nc1ccccc1,2,0\nCC(=O)O,3,1\n")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("Mutagenicity/Mutagenicity_A.txt",
                    "1, 2\n2, 1\n3, 4\n4, 3\n")
        zf.writestr("Mutagenicity/Mutagenicity_graph_indicator.txt",
                    "1\n1\n2\n2\n")
        zf.writestr("Mutagenicity/Mutagenicity_graph_labels.txt", "0\n1\n")
        zf.writestr("Mutagenicity/Mutagenicity_node_labels.txt",
                    "0\n1\n2\n0\n")
    (src / "Mutagenicity.zip").write_bytes(buf.getvalue())

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **k):
            super().__init__(*a, directory=str(src), **k)

        def log_message(self, *a, **k):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    t.join(timeout=10)


def test_download_then_read(http_root, tmp_path):
    root = str(tmp_path / "molnet")
    written = download_dataset("BACE", root, base_url=http_root)
    assert download_dataset("BACE", root, base_url=http_root) == written
    _same_graphs(molnet.load_moleculenet(root, "BACE")[0],
                 jmolnet.load_moleculenet(root, "BACE")[0])
    tu = str(tmp_path / "tu")
    download_dataset("Mutagenicity", tu, base_url=http_root)
    _same_graphs(tudataset.load_tudataset(tu, "Mutagenicity"),
                 jtudataset.load_tudataset(tu, "Mutagenicity"))
    with pytest.raises(KeyError):
        download_dataset("nope", root)


def test_download_and_preprocess_verbs(http_root, tmp_path):
    root = str(tmp_path / "cli")
    out = cli.main(["download", "--dataset", "BACE", "--root", root,
                    "--base_url", http_root])
    assert len(out["BACE"]) == 1
    path = str(tmp_path / "bace.npz")
    ds = cli.main(["preprocess", "--molnet_root", root, "--dataset", "BACE",
                   "--out", path])
    back = jcache.load_dataset(path)
    _same_graphs(back.graphs, ds.graphs)
    _same_graphs(back.graphs, jmolnet.load_moleculenet(root, "BACE")[0])
    _same_egonets(back.egonets, ds.egonets)
