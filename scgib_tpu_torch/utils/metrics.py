"""Evaluation metrics, NumPy: a copy of ``scgib_tpu/utils/metrics.py``.

The reference's OGB-derived evaluators (reference metrics.py:18-126: per
task with NaN labels masked, averaged over the tasks with both classes),
ROC-AUC as the exact Mann-Whitney statistic with tie correction, AP as
sklearn's step-wise precision-recall integral, the simple metrics
(metrics.py:129-159) and the clustering metrics (metrics.py:219-285).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def roc_auc_binary(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC-AUC for one binary task (sklearn.roc_auc_score equivalent).

    Mann-Whitney U with midranks for ties: AUC = (R_pos - n_pos(n_pos+1)/2)
    / (n_pos * n_neg), where R_pos is the rank-sum of positive scores.
    """
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score).astype(np.float64).ravel()
    pos = y_true == 1
    n_pos = int(pos.sum())
    n_neg = int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("ROC-AUC undefined without both classes")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(y_score)
    ranks[order] = np.arange(1, len(y_score) + 1, dtype=np.float64)
    # midranks for ties
    sorted_scores = y_score[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while (j + 1 < len(sorted_scores)
               and sorted_scores[j + 1] == sorted_scores[i]):
            j += 1
        if j > i:
            mid = 0.5 * (i + j) + 1.0
            ranks[order[i:j + 1]] = mid
        i = j + 1
    r_pos = ranks[pos].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def average_precision_binary(y_true: np.ndarray,
                             y_score: np.ndarray) -> float:
    """AP for one binary task (sklearn.average_precision_score equivalent):
    sum over descending-score thresholds of (R_k - R_{k-1}) * P_k, with
    tied scores grouped into one threshold."""
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score).astype(np.float64).ravel()
    order = np.argsort(-y_score, kind="mergesort")
    yt = y_true[order]
    ys = y_score[order]
    # group boundaries: last index of each tied block
    distinct = np.where(np.diff(ys))[0]
    idx = np.r_[distinct, len(ys) - 1]
    tp = np.cumsum(yt)[idx]
    fp = np.cumsum(1.0 - yt)[idx]
    n_pos = tp[-1]
    if n_pos == 0:
        raise ValueError("AP undefined without positives")
    precision = tp / (tp + fp)
    recall = tp / n_pos
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def _per_task(y_true: np.ndarray, y_pred: np.ndarray):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.ndim == 1:
        y_true = y_true[:, None]
    if y_pred.ndim == 1:
        y_pred = y_pred[:, None]
    return y_true, y_pred


def eval_rocauc(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    """ROC-AUC averaged across tasks, NaN labels ignored, tasks without both
    classes skipped (reference metrics.py:18-37)."""
    y_true, y_pred = _per_task(y_true, y_pred)
    vals = []
    for i in range(y_true.shape[1]):
        labeled = y_true[:, i] == y_true[:, i]
        yt = y_true[labeled, i]
        if (yt == 1).sum() > 0 and (yt == 0).sum() > 0:
            vals.append(roc_auc_binary(yt, y_pred[labeled, i]))
    if not vals:
        raise RuntimeError("No task with both classes; ROC-AUC undefined")
    return {"rocauc": float(np.mean(vals))}


def eval_ap(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """AP averaged across tasks (reference metrics.py:40-61 — note it also
    requires both classes present, like the AUC path)."""
    y_true, y_pred = _per_task(y_true, y_pred)
    vals = []
    for i in range(y_true.shape[1]):
        labeled = y_true[:, i] == y_true[:, i]
        yt = y_true[labeled, i]
        if (yt == 1).sum() > 0 and (yt == 0).sum() > 0:
            vals.append(average_precision_binary(yt, y_pred[labeled, i]))
    if not vals:
        raise RuntimeError("No task with both classes; AP undefined")
    return float(np.mean(vals))


def eval_rmse(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    """RMSE averaged across tasks, NaN ignored (reference metrics.py:64-76)."""
    y_true, y_pred = _per_task(y_true, y_pred)
    vals = []
    for i in range(y_true.shape[1]):
        labeled = y_true[:, i] == y_true[:, i]
        diff = y_true[labeled, i] - y_pred[labeled, i]
        vals.append(float(np.sqrt(np.mean(diff ** 2))))
    return {"rmse": float(np.mean(vals))}


def eval_acc(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    """Accuracy averaged across tasks over hard predictions
    (reference metrics.py:79-87)."""
    y_true, y_pred = _per_task(y_true, y_pred)
    vals = []
    for i in range(y_true.shape[1]):
        labeled = y_true[:, i] == y_true[:, i]
        correct = y_true[labeled, i] == y_pred[labeled, i]
        vals.append(float(np.sum(correct)) / max(len(correct), 1))
    return {"acc": float(np.mean(vals))}


def eval_f1(seq_ref: Sequence, seq_pred: Sequence) -> Dict[str, float]:
    """Set-based precision/recall/F1 averaged over samples
    (reference metrics.py:90-125)."""
    ps, rs, fs = [], [], []
    for l, p in zip(seq_ref, seq_pred):
        label, pred = set(l), set(p)
        tp = len(label & pred)
        fp = len(pred - label)
        fn = len(label - pred)
        prec = tp / (tp + fp) if tp + fp > 0 else 0.0
        rec = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1 = (2 * prec * rec / (prec + rec)) if prec + rec > 0 else 0.0
        ps.append(prec)
        rs.append(rec)
        fs.append(f1)
    return {"precision": float(np.mean(ps)), "recall": float(np.mean(rs)),
            "F1": float(np.mean(fs))}


def rmse(scores: np.ndarray, targets: np.ndarray, eps: float = 1e-6) -> float:
    """sqrt(MSE + 1e-6) — the reference's epsilon'd variant
    (metrics.py:129-137) used as the molsolv eval metric."""
    scores = np.asarray(scores, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    return float(np.sqrt(np.mean((scores - targets) ** 2) + eps))


def mae(scores: np.ndarray, targets: np.ndarray) -> float:
    """Mean absolute error (reference metrics.py:140-143)."""
    scores = np.asarray(scores, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    return float(np.mean(np.abs(scores - targets)))


def accuracy_tu(scores: np.ndarray, targets: np.ndarray) -> float:
    """Count of argmax matches (NOT normalized — the reference returns the
    raw count and divides by dataset size in the train loop,
    metrics.py:146-159 / train_tudataset.py:148)."""
    scores = np.asarray(scores)
    targets = np.asarray(targets).reshape(scores.shape[0], -1)[:, 0]
    pred = scores.argmax(axis=1)
    return float((pred == targets).sum())


# ---------------------------------------------------------------------------
# Clustering metrics (reference metrics.py:219-285, DMoN-derived) — part of
# the inventory (SURVEY.md C20); dense-NumPy equivalents of the sparse
# originals.


def _pair_counts(y_true: np.ndarray, y_pred: np.ndarray):
    """(TP, FP, FN, TN) pair counts from the contingency matrix, exactly as
    the reference's ``_compute_counts`` (metrics.py:222-235)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    t_classes, t_idx = np.unique(y_true, return_inverse=True)
    p_classes, p_idx = np.unique(y_pred, return_inverse=True)
    contingency = np.zeros((len(t_classes), len(p_classes)), dtype=np.int64)
    np.add.at(contingency, (t_idx, p_idx), 1)
    same_true = contingency.max(axis=1)
    same_pred = contingency.max(axis=0)
    diff_true = contingency.sum(axis=1) - same_true
    diff_pred = contingency.sum(axis=0) - same_pred
    total = contingency.sum()
    tp = (same_true * (same_true - 1)).sum()
    fp = (diff_true * same_true * 2).sum()
    fn = (diff_pred * same_pred * 2).sum()
    tn = total * (total - 1) - tp - fp - fn
    return tp, fp, fn, tn


def cluster_precision(y_true, y_pred) -> float:
    tp, fp, _, _ = _pair_counts(y_true, y_pred)
    return float(tp / (tp + fp))


def cluster_recall(y_true, y_pred) -> float:
    tp, _, fn, _ = _pair_counts(y_true, y_pred)
    return float(tp / (tp + fn))


def cluster_accuracy(y_true, y_pred) -> float:
    tp, fp, fn, tn = _pair_counts(y_true, y_pred)
    return float((tp + tn) / (tp + fp + fn + tn))


def modularity(adjacency: np.ndarray, clusters: np.ndarray) -> float:
    """Graph modularity over a dense adjacency (metrics.py:239-257)."""
    adjacency = np.asarray(adjacency, dtype=np.float64)
    clusters = np.asarray(clusters)
    degrees = adjacency.sum(axis=0)
    n_edges = degrees.sum()          # = 2|E| for symmetric A
    result = 0.0
    for cid in np.unique(clusters):
        idx = np.where(clusters == cid)[0]
        sub = adjacency[np.ix_(idx, idx)]
        result += sub.sum() - degrees[idx].sum() ** 2 / n_edges
    return float(result / n_edges)


def conductance(adjacency: np.ndarray, clusters: np.ndarray) -> float:
    """Fraction of inter-cluster edge mass (metrics.py:274-285; the
    reference's variable names swap inter/intra — behavior preserved)."""
    adjacency = np.asarray(adjacency, dtype=np.float64)
    clusters = np.asarray(clusters)
    inside = 0.0
    outside = 0.0
    for cid in np.unique(clusters):
        mask = clusters == cid
        sub = adjacency[mask, :]
        inside += sub[:, mask].sum()
        outside += sub[:, ~mask].sum()
    return float(outside / (inside + outside))
