"""The port's flat dataset and native packer (``data/flat.py``,
``native.py``, ``csrc/scgib_native.cc``) against the per-graph packers and
the JAX package's ``pack_flat_batch``: bit-equal arrays, labels and flags,
``pool_fits`` included.  The native library builds once per process from
a fresh directory while other processes build it too, and each of them
loads it; a library that cannot build raises with the compiler's output
and nothing falls back to NumPy."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import scgib_tpu.native
from scgib_tpu.data.flat import pack_flat_batch as jpack_flat_batch
from scgib_tpu.data.loader import GraphDataset as JGraphDataset
from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset

from scgib_tpu_torch import native
from scgib_tpu_torch.data.flat import build_flat, pack_flat_batch
from scgib_tpu_torch.data.loader import (Capacities, GraphDataset,
                                         batch_iterator,
                                         pack_batch, plan_batches,
                                         plan_capacities)
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph.batching import GraphData
from scgib_tpu_torch.graph.egonet import extract_egonets

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _jax_numpy_packers(monkeypatch):
    """The JAX side packs with its NumPy flat packer: its native library
    is ``tests/test_native.py``'s to build (in place)."""
    monkeypatch.setattr(scgib_tpu.native, "_load", lambda: None)


def _labelled(graphs, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, g in enumerate(graphs):
        lab = rng.normal(size=3).astype(np.float32)
        if i % 4 == 0:
            lab[1] = np.nan
        out.append(dataclasses.replace(
            g, label=None if i % 7 == 3 else lab))
    return out


@pytest.fixture(scope="module")
def setup():
    kw = dict(min_nodes=5, max_nodes=30)
    ds = GraphDataset(_labelled(random_dataset(120, seed=0, **kw), 0), k=1)
    jds = JGraphDataset(_labelled(jrandom_dataset(120, seed=0, **kw), 0),
                        k=1)
    caps = plan_capacities(ds, 32)
    return ds, jds, caps, plan_batches(ds, 32, caps, seed=7)


def _assert_equal(a, b, skip=()):
    for f in dataclasses.fields(b):
        if f.name in skip:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or isinstance(x, (bool, int)):
            assert x == y, f.name
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_flat_packer_equals_per_graph_and_jax(setup):
    ds, jds, caps, plans = setup
    fd = ds.flat()
    assert ds.flat() is fd
    for sel in plans:
        g_ref, sub_ref = pack_batch(ds, sel, caps)
        g, sub = pack_batch(ds, sel, caps, use_flat=True)
        _assert_equal(g, g_ref)
        _assert_equal(sub, sub_ref)
        assert sub.pool_fits is sub_ref.pool_fits is True
        jg, jsub = jpack_flat_batch(jds.flat(), sel, caps,
                                    num_tasks=ds.num_tasks())
        _assert_equal(g, jg)
        _assert_equal(sub, jsub, skip=("pool_fits",))


def test_flat_packer_takes_the_scatter_branch_flag():
    """A batch whose first center tile owns more sub-rows than the pooling
    window: ``pool_fits`` False, as the per-graph packer sets it."""
    rng = np.random.default_rng(3)
    graphs = []
    for _ in range(11):
        upper = np.triu(rng.random((12, 12)) < 0.8, 1)
        s, r = np.nonzero(upper | upper.T)
        graphs.append(GraphData(senders=s.astype(np.int32),
                                receivers=r.astype(np.int32),
                                node_feat=rng.normal(size=(12, 9)).astype(
                                    np.float32)))
    graphs += random_dataset(50, seed=4, min_nodes=4, max_nodes=6)
    ds = GraphDataset(graphs, k=1)
    caps = Capacities(nodes=512, edges=2048, graphs=64, sub_nodes=2048,
                      sub_edges=16384)
    sel = np.arange(len(graphs))
    g_ref, sub_ref = pack_batch(ds, sel, caps)
    g, sub = pack_flat_batch(ds.flat(), sel, caps)
    assert sub.pool_fits is sub_ref.pool_fits is False
    _assert_equal(sub, sub_ref)
    _assert_equal(g, g_ref)


def test_batch_iterator_workers_keep_order(setup):
    ds, _, caps, _ = setup
    plain = list(batch_iterator(ds, 32, caps, seed=3, use_flat=False))
    for workers, flat in ((2, True), (3, False)):
        got = list(batch_iterator(ds, 32, caps, seed=3, workers=workers,
                                  use_flat=flat,
                                  transform=lambda b: (b, len(b))))
        assert len(got) == len(plain)
        for ((g, sub), n), (g_ref, sub_ref) in zip(got, plain):
            assert n == 2
            _assert_equal(g, g_ref)
            _assert_equal(sub, sub_ref)


def test_capacity_overflow_raises(setup):
    ds, _, caps, plans = setup
    with pytest.raises(ValueError, match="capacit"):
        pack_flat_batch(ds.flat(), plans[0],
                        dataclasses.replace(caps, nodes=8))
    with pytest.raises(IndexError):
        pack_flat_batch(ds.flat(), [len(ds)], caps)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_native_egonets_equal_numpy(k):
    graphs = random_dataset(20, seed=13, min_nodes=1, max_nodes=24)
    got = native.extract_egonets_batch(graphs, k)
    for e1, g in zip(got, graphs):
        e2 = extract_egonets(g, k)
        for nl1, nl2 in zip(e1.node_lists, e2.node_lists, strict=True):
            np.testing.assert_array_equal(nl1, nl2)
        for (s1, r1), (s2, r2) in zip(e1.edge_lists, e2.edge_lists,
                                      strict=True):
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_array_equal(r1, r2)


def test_gather_rows():
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(50, 9)).astype(np.float32)
    idx = rng.integers(0, 50, size=200).astype(np.int32)
    np.testing.assert_array_equal(native.gather_rows(feat, idx), feat[idx])
    with pytest.raises(IndexError):
        native.gather_rows(feat, np.asarray([50], np.int32))


def test_processes_build_and_load_the_library_at_once(tmp_path):
    """Six processes start together on a fresh build directory: one
    builds (to a temporary name, renamed under the lock), the others wait
    and load it; every one of them runs a packer call."""
    code = textwrap.dedent(f"""
        import sys, pathlib
        sys.path.insert(0, {str(ROOT)!r})
        from scgib_tpu_torch import native
        native.BUILD_DIR = pathlib.Path({str(tmp_path)!r})
        lib = native.load()
        import numpy as np
        feat = np.arange(12, dtype=np.float32).reshape(4, 3)
        out = native.gather_rows(feat, np.asarray([3, 0], np.int32))
        assert lib.scgib_version() == 2 and out[0, 0] == 9.0
        print("loaded")
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "loaded", err
    assert sorted(x.name for x in tmp_path.iterdir()) == sorted(
        [native.so_path().name, "scgib_native.lock"])


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch,
                                                    setup):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeCompileError, match="broken.cc"):
        native.load()
    ds, _, caps, _ = setup
    with pytest.raises(native.NativeCompileError):
        GraphDataset(ds.graphs, k=1)        # its ego-nets need the library
    fresh = GraphDataset(ds.graphs, k=1, egonets=ds.egonets)
    with pytest.raises(native.NativeCompileError):
        next(batch_iterator(fresh, 32, caps, use_flat=True))
    assert not list((tmp_path / "build").glob("*.so*"))
    # the NumPy path is the caller's to ask for, and needs no library
    assert next(batch_iterator(fresh, 32, caps, use_flat=False)) is not None


def test_build_flat_matches_jax(setup):
    ds, jds, _, _ = setup
    from scgib_tpu.data.flat import build_flat as jbuild_flat

    a, b = build_flat(ds), jbuild_flat(jds)
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        np.testing.assert_array_equal(x, y, err_msg=f.name)
