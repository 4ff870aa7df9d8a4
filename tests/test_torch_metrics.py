"""PyTorch port vs the JAX package: the NumPy copies the supervised path
needs — ``config.py`` (the dataclasses, ``DATASETS``, ``reference_split``),
``utils/metrics.py``, ``utils/metric_wrapper.py`` and ``utils/results.py``.

They are copies, so they are held to exact equality: the same values bit
for bit on the same inputs (made from a NumPy seed), the same splits for
every dataset at sizes above and below its table, the same files written.
"""

import dataclasses
import json

import numpy as np
import pytest

from scgib_tpu import config as jconfig
from scgib_tpu.utils import metric_wrapper as jmw
from scgib_tpu.utils import metrics as jm
from scgib_tpu.utils import results as jresults

from scgib_tpu_torch import config
from scgib_tpu_torch.utils import metric_wrapper as mw
from scgib_tpu_torch.utils import metrics as m
from scgib_tpu_torch.utils import results

SEEDS = range(4)


def _same(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _same(a[k], b[k])
    else:
        assert type(a) is type(b)
        assert a == b or (a != a and b != b), (a, b)


def _labels(rng, n, tasks, nan_frac=0.2, ties=False):
    y = (rng.random((n, tasks)) < 0.4).astype(np.float64)
    y[rng.random((n, tasks)) < nan_frac] = np.nan
    p = rng.random((n, tasks))
    if ties:
        p = np.round(p, 1)
    return y, p


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_task_metrics_equal_jax(seed, ties):
    rng = np.random.default_rng(seed)
    y, p = _labels(rng, 60, 3, ties=ties)
    for name in ("eval_rocauc", "eval_ap", "eval_rmse"):
        _same(getattr(m, name)(y, p), getattr(jm, name)(y, p))
    hard = np.round(p)
    _same(m.eval_acc(y, hard), jm.eval_acc(y, hard))
    for name in ("roc_auc_binary", "average_precision_binary"):
        keep = ~np.isnan(y[:, 0])
        _same(getattr(m, name)(y[keep, 0], p[keep, 0]),
              getattr(jm, name)(y[keep, 0], p[keep, 0]))


@pytest.mark.parametrize("seed", SEEDS)
def test_simple_and_cluster_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    s, t = rng.normal(size=40), rng.normal(size=40)
    _same(m.rmse(s, t), jm.rmse(s, t))
    _same(m.mae(s, t), jm.mae(s, t))
    scores = rng.normal(size=(40, 3))
    cls = rng.integers(0, 3, size=40)
    _same(m.accuracy_tu(scores, cls), jm.accuracy_tu(scores, cls))
    a, b = rng.integers(0, 4, size=30), rng.integers(0, 3, size=30)
    for name in ("cluster_precision", "cluster_recall", "cluster_accuracy"):
        _same(getattr(m, name)(a, b), getattr(jm, name)(a, b))
    adj = (rng.random((30, 30)) < 0.2).astype(float)
    adj = np.maximum(adj, adj.T)
    _same(m.modularity(adj, b), jm.modularity(adj, b))
    _same(m.conductance(adj, b), jm.conductance(adj, b))
    refs = [list(rng.integers(0, 5, size=3)) for _ in range(6)]
    preds = [list(rng.integers(0, 5, size=2)) for _ in range(6)]
    _same(m.eval_f1(refs, preds), jm.eval_f1(refs, preds))


def test_metrics_raise_where_jax_raises():
    y = np.ones((5, 1))
    for mod in (m, jm):
        with pytest.raises(RuntimeError):
            mod.eval_rocauc(y, y)
        with pytest.raises(ValueError):
            mod.roc_auc_binary(y[:, 0], y[:, 0])


@pytest.mark.parametrize("mode", [None, 0.5, "ignore-flatten",
                                  "ignore-mean-label"])
def test_metric_wrapper_equals_jax(mode):
    rng = np.random.default_rng(7)
    y, p = _labels(rng, 50, 4)
    y[:, 3] = 1.0                    # a column whose AUC raises

    def auc(preds, target):
        return m.roc_auc_binary(target, preds)
    if mode is None or isinstance(mode, float):
        y = y[:, :1]
        p = p[:, :1]
    if mode is None:
        y = np.nan_to_num(y)
    got = mw.MetricWrapper(auc, target_nan_mask=mode)(p, y)
    want = jmw.MetricWrapper(auc, target_nan_mask=mode)(p, y)
    _same(got, want)
    with pytest.raises(ValueError):
        mw.MetricWrapper(auc, target_nan_mask="bad")(p, y)


def test_config_is_a_copy_of_jax():
    def defaults(cls):
        return [(f.name, dataclasses.asdict(f.default)
                 if dataclasses.is_dataclass(f.default) else f.default)
                for f in dataclasses.fields(cls)]
    for name in ("ModelConfig", "OptimConfig", "PretrainConfig",
                 "FinetuneConfig", "DomainAdaptConfig", "DatasetSpec"):
        assert defaults(getattr(config, name)) == \
            defaults(getattr(jconfig, name)), name
    assert set(config.DATASETS) == set(jconfig.DATASETS)
    for name, spec in jconfig.DATASETS.items():
        assert dataclasses.asdict(config.DATASETS[name]) == \
            dataclasses.asdict(spec), name
    assert config.DATASETS["mol-PCBA"] is config.DATASETS["ogbg-molpcba"]
    assert config.PRETRAIN_STAGES == jconfig.PRETRAIN_STAGES
    assert config.REGRESSION_HEAD_DATASETS == \
        jconfig.REGRESSION_HEAD_DATASETS


@pytest.mark.parametrize("name", sorted(jconfig.DATASETS))
def test_reference_split_equals_jax(name):
    """At sizes below, at and above the table's split (the fallback 8/1/1
    and each split order), the same three ranges."""
    spec, jspec = config.DATASETS[name], jconfig.DATASETS[name]
    b = spec.split[1]
    for n in (10, 101, b, b + 1, b + 313, 2 * b):
        got = config.reference_split(n, spec)
        assert got == jconfig.reference_split(n, jspec), n
        assert sum(len(r) for r in got) >= n


def test_bace_split_at_its_real_size():
    tr, va, te = config.reference_split(1513, config.DATASETS["BACE"])
    assert (len(tr), len(va), len(te)) == (900, 313, 300)


def test_journal_is_written_as_jax_writes_it(tmp_path):
    rec = {"dataset": "BACE", "mean": 0.5, "runs": [0.5], "ts": 1.0}
    results.append_result(str(tmp_path / "a" / "j.jsonl"), rec)
    jresults.append_result(str(tmp_path / "b" / "j.jsonl"), rec)
    a = (tmp_path / "a" / "j.jsonl").read_text()
    assert a == (tmp_path / "b" / "j.jsonl").read_text()
    assert json.loads(a) == rec
    no_ts = {"dataset": "BACE"}
    results.append_result(str(tmp_path / "c.jsonl"), no_ts)
    assert "ts" in json.loads((tmp_path / "c.jsonl").read_text())


def test_sheet_is_written_as_jax_writes_it(tmp_path):
    pytest.importorskip("pandas")
    paths = []
    for mod, d in ((results, "a"), (jresults, "b")):
        (tmp_path / d).mkdir()
        path = str(tmp_path / d / "sheet.xlsx")
        for col, v in (("Mean", 0.75), ("Variant", 0.01),
                       ("Best_epoch", 3)):
            written = mod.update_evaluation_value(path, "BACE", col, v)
        mod.update_evaluation_value(path, "ESOL", "Mean", 1.5)
        paths.append(written)
    import pandas as pd

    read = [pd.read_excel(p, index_col=0) if p.endswith(".xlsx")
            else pd.read_csv(p, index_col=0) for p in paths]
    pd.testing.assert_frame_equal(read[0], read[1])
    assert read[0].loc["BACE", "Mean"] == 0.75
