"""Configuration the port shares with the JAX package's ``config.py``.

A copy of ``scgib_tpu/config.py`` (the port imports nothing of the JAX
package): the config dataclasses with the paper's and the reference CLI's
defaults, ``DatasetSpec`` and ``DATASETS`` (the per-dataset fine-tune matrix
of SURVEY.md §2.2: task, loss, metric, selection direction, output count,
the reference's hardcoded prefix splits, molecules.py:211-343, feature
width, repeats and gradient accumulation), ``reference_split``, the
pretraining curriculum's ``PRETRAIN_STAGES`` (exp_pretraining.py:218-219)
and ``REGRESSION_HEAD_DATASETS`` (models.py:384).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    in_dim: int = 9
    hidden: int = 64
    d_transfer: int = 32
    encoder: str = "GIN"            # GIN | GCN | GraphSAGE | Transformer
    num_layers: int = 4             # conv count (reference num_layers-1)
    num_heads: int = 8
    readout: str = "sum"            # 'sum' | 's2s'
    use_att: bool = True
    recons_type: str = "adj"        # 'adj' | 'logM'
    kl_mode: str = "corrected"      # 'corrected' | 'reference'
    k_transition: int = 1


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    weight_decay: float = 5e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    model: ModelConfig = ModelConfig()
    optim: OptimConfig = OptimConfig(lr=1e-4, weight_decay=5e-5)
    batch_size: int = 128           # graphs per global batch
    epochs: int = 100               # --pt_epoches default
    patience: int = 50              # early stop on best train loss
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    model: ModelConfig = ModelConfig()
    optim: OptimConfig = OptimConfig(lr=1e-3, weight_decay=1e-5)
    batch_size: int = 128
    epochs: int = 50                # --ft_epoches default
    patience: int = 50
    freeze_mode: str = "reference"  # see trainer.finetune_trainable_mask
    grad_accum: int = 1             # peptides-func uses 2
    wallclock_hours: float = 48.0   # reference 48h cap
    seed: int = 41


@dataclasses.dataclass(frozen=True)
class DomainAdaptConfig:
    optim: OptimConfig = OptimConfig(lr=1e-3, weight_decay=1e-5)
    epochs: int = 50                # --adapt_epoches
    patience: int = 20


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """One fine-tune dataset's task wiring (SURVEY.md §2.2)."""

    name: str
    task: str                       # 'classification' | 'regression'
    num_tasks: int
    loss: str                       # trainer loss_type
    metric: str                     # 'rocauc' | 'ap' | 'rmse' | 'mae' | 'acc'
    select: str                     # 'max' | 'min' on validation metric
    regression_head: bool           # True -> no sigmoid (models.py:384)
    nan_mask: Optional[str] = None  # MetricWrapper mode for NaN labels
    # Hardcoded prefix split (molecules.py:211-343): dataset[:a] is train,
    # dataset[a:b] is the middle slice, dataset[b:] the tail.
    # ``split_order`` says which of the two is test vs val:
    #   'tts' train/TEST/val  (most datasets, e.g. BACE molecules.py:252)
    #   'tvt' train/VAL/test  (FreeSolv molecules.py:217, PROTEINS)
    #   'tail_both' test == val == dataset[a:]  (SIDER molecules.py:232-234)
    split: Optional[Tuple[int, int]] = None
    split_order: str = "tts"
    feat_dim: int = 9
    repeats: int = 1                # TUDataset fine-tunes 3x
    grad_accum: int = 1             # peptides-func accumulates 2 steps


DATASETS = {
    # exp_moleculenetBACE_BBBP.py / train_moleculenetBACE.py
    "BACE": DatasetSpec("BACE", "classification", 1, "bce", "rocauc",
                        "max", False, split=(900, 1200)),
    "BBBP": DatasetSpec("BBBP", "classification", 1, "bce", "rocauc",
                        "max", False, split=(1200, 1600)),
    # exp_moleculeSTCT.py / train_molsider.py (multi-task)
    "Tox21": DatasetSpec("Tox21", "classification", 12, "bce", "rocauc",
                         "max", False, nan_mask="ignore-flatten",
                         split=(4800, 6400)),
    "ToxCast": DatasetSpec("ToxCast", "classification", 617, "bce",
                           "rocauc", "max", False,
                           nan_mask="ignore-flatten", split=(5400, 7200)),
    "SIDER": DatasetSpec("SIDER", "classification", 27, "bce", "rocauc",
                         "max", False, split=(1000, 1000),
                         split_order="tail_both"),
    "ClinTox": DatasetSpec("ClinTox", "classification", 2, "bce", "rocauc",
                           "max", False, split=(900, 1200)),
    "MUV": DatasetSpec("MUV", "classification", 17, "bce", "rocauc",
                       "max", False, nan_mask="ignore-flatten",
                       split=(60000, 80000)),
    # exp_molhiv.py
    "ogbg-molhiv": DatasetSpec("ogbg-molhiv", "classification", 1, "bce",
                               "rocauc", "max", False,
                               split=(24000, 32000)),
    # exp_molsolv.py (regression, RMSE)
    "FreeSolv": DatasetSpec("FreeSolv", "regression", 1, "rmse", "rmse",
                            "min", True, split=(380, 500),
                            split_order="tvt"),
    "ESOL": DatasetSpec("ESOL", "regression", 1, "rmse", "rmse", "min",
                        True, split=(650, 850)),
    "Lipo": DatasetSpec("Lipo", "regression", 1, "rmse", "rmse", "min",
                        False, split=(2400, 3200)),
    # exp_tudataset.py (CE on sigmoided logits, accuracy, 3 repeats)
    "Mutagenicity": DatasetSpec("Mutagenicity", "classification", 2, "ce",
                                "acc", "max", False, split=(2800, 3600),
                                feat_dim=14, repeats=3),
    "NCI1": DatasetSpec("NCI1", "classification", 2, "ce", "acc", "max",
                        False, split=(2400, 3200), feat_dim=37, repeats=3),
    "NCI109": DatasetSpec("NCI109", "classification", 2, "ce", "acc",
                          "max", False, split=(2400, 3200), feat_dim=38,
                          repeats=3),
    "PROTEINS": DatasetSpec("PROTEINS", "classification", 2, "ce", "acc",
                            "max", False, split=(700, 900),
                            split_order="tvt", feat_dim=3, repeats=3),
    "ENZYMES": DatasetSpec("ENZYMES", "classification", 6, "ce", "acc",
                           "max", False, split=(480, 540), feat_dim=18,
                           repeats=3),
    # ZINC (regression head per models.py:384)
    "ZINC": DatasetSpec("ZINC", "regression", 1, "mae", "mae", "min",
                        True, split=(10000, 11000), feat_dim=28),
    # LRGB peptides (exp_pep_func_5.py / exp_pep_struct_5.py)
    "Peptides-func": DatasetSpec("Peptides-func", "classification", 10,
                                 "bce", "ap", "max", False,
                                 nan_mask="ignore-flatten",
                                 split=(10000, 12500), grad_accum=2),
    "Peptides-struct": DatasetSpec("Peptides-struct", "regression", 11,
                                   "mae", "mae", "min", True,
                                   split=(10000, 12500)),
    # exp_pcqm4mv2.py / exp_qm9.py / exp_molpcba.py fine-tune paths
    "PCQM4Mv2": DatasetSpec("PCQM4Mv2", "regression", 1, "mae", "mae",
                            "min", True, split=(80000, 90000)),
    "QM9": DatasetSpec("QM9", "regression", 19, "mae", "mae", "min", True,
                       split=(78000, 104000), feat_dim=11),
    "ogbg-molpcba": DatasetSpec("ogbg-molpcba", "classification", 128,
                                "bce", "ap", "max", False,
                                nan_mask="ignore-flatten",
                                split=(240000, 320000)),
}
# backwards-friendly alias used in exp_pretraining's dataset list
DATASETS["mol-PCBA"] = DATASETS["ogbg-molpcba"]


def reference_split(n: int, spec: DatasetSpec):
    """(train_idx, val_idx, test_idx) ranges for a dataset of length n
    following the reference's prefix-slice layout (see DatasetSpec.split).
    Falls back to 8/1/1 when the table overshoots the actual length."""
    if spec.split is None or spec.split[1] >= n:
        a = int(n * 0.8)
        b = int(n * 0.9)
        return range(0, a), range(b, n), range(a, b)
    a, b = spec.split
    if spec.split_order == "tts":
        return range(0, a), range(b, n), range(a, b)
    if spec.split_order == "tvt":
        return range(0, a), range(a, b), range(b, n)
    if spec.split_order == "tail_both":
        return range(0, a), range(a, n), range(a, n)
    raise ValueError(spec.split_order)


# The 3-stage pretraining curriculum (exp_pretraining.py:218-219)
PRETRAIN_STAGES = (("PCQM4Mv2", 9), ("QM9", 11), ("mol-PCBA", 9))

# Datasets whose fine-tune head skips the sigmoid (models.py:384)
REGRESSION_HEAD_DATASETS = ("ZINC", "Peptides-struct", "FreeSolv", "ESOL")
