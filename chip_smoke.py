#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``scgib_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero before the last line:
  1. environment: the card's name and power limit; TF32 off.
  2. build the CUDA kernels from scgib_tpu_torch/csrc/ (one nvcc per
     source, sm_90a, all started together, or none where the libraries
     were built before: each keeps its ptxas report beside it); ptxas's
     registers and spills of every attention instantiation: the WIDE one
     (head widths past 512, swept 512 features at a time) must show no
     spill, and the others none past ``GT_SPILLS``.
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the benchmark batch (128 molecules of 10-30 atoms, k=1:
     N=3072 graph rows, S=9728 ego-net rows; the attention kernels in the
     narrow (64, 128) geometry, 8 heads of 8, and at S also 1 head of 64,
     128, 256, 512 and 1024): error, kernel / plain / library time (median
     of 20 CUDA graph replays, each between CUDA events), the bound and its
     share of
     the kernel time (gin_fwd's and gin_bwd's at the 3xTF32 tensor-core
     rate they run at, with the fp32 SIMT one beside it); the merged
     attention backward against the two-pass one; and the registers,
     shared memory and blocks per SM of every kernel at the main path's
     widths (and the attention's at hd 64 to 1024); and head widths past
     512 through ``gt_flash_attention`` (1024, and 1100 zero-padded to
     1536), output and gradients with either backward against the plain
     attention by autograd.
  4. the full model on that batch, GIN and graph-transformer encoders,
     once on the card and once on the CPU plain path in float64
     (deterministic, dropout off): losses and gradients must agree.
  5. the main paths: ``cli.run_pretrain`` at full width (PretrainModel(9,
     64, 32), batch 128, lr 1e-4, wd 5e-5) for 6 optimizer steps with GIN
     encoders, then 6 with graph transformers (5 layers, 8 heads, dropout
     0.5, two-pass backward), then 2 with the merged backward; the step is
     captured (the first step eager, then CUDA-graph replays); each run
     starts with every launch count at 0, and each kernel's count must be
     its expected per-step count times the steps, the block builds 3 a
     step (4 with graph transformers) times the steps, the pooling must take
     its kernel branch and the encoders their band branches.  Then:
     (a) captured against eager, 6 steps from one start on 6 batches,
     under torch's deterministic algorithms: losses every step, the final
     parameters, BatchNorm statistics, Adam state and generator state
     byte-equal for GIN and the transformer (the merged backward sums with
     atomics, so chained runs drift apart: each of its captured steps is
     held to one eager step from the state it started in, losses
     byte-equal, weights within two Adam updates' reach), and a planted
     fault (replays that stop copying their inputs) must break it; the
     scan step of 3 inner steps against 3 eager
     steps likewise; (b) a skewed batch (one center tile owning more
     sub-rows than the pooling window) through the captured step: the
     scatter branch inside the graph, losses within 1e-4 of float64;
     (c) step medians of the eager and the captured step, alternating,
     for both encoders.
  6. the pretrain verb and its options, at the same width, batch and
     optimizer, on the captured step: (a) the committed JAX checkpoint
     outputs/pre_training_PCQM4Mv2_GIN_64_4_1.msgpack, read by the port's
     own codec, gives on the card the float64 CPU losses on the benchmark
     batch; (b) ``cli.main(["pretrain", "--curriculum", ...])`` on 512
     synthetic molecules for 2 epochs with autosave: three stages, every
     loss finite, each stage's checkpoint written, the launch counts those
     of the steps taken, every stage skipped on a rerun; a run stopped
     after epoch 0 and resumed to epoch 1 against one never stopped, both
     under torch's deterministic algorithms: their final autosaves must be
     byte-equal, and must differ when the resume drops the Adam state or
     shuffles epoch 1 with seed + 1 (planted faults); (c) each option
     (s2s readout, attention off, reference KL, logM reconstruction, dense
     reconstruction): card losses against float64 CPU, then one optimizer
     step; (d) the widths, 4 steps each of ``run_pretrain``: GIN at hidden
     256 (banded SpMM branch) and 30 (fused kernels), the transformer at 1
     head of 64 (both backwards), at hidden 96 with 8 heads of 12
     (zero-padded to 16) and at hidden 256 and 512 with 1 head (both
     backwards), with their launch and branch counts and step times.
  7. where the step time goes: 3 steady steps of each encoder's main path
     under torch.profiler, captured and eager: device time by kernel, the
     device's busy share, and the host's kernel and graph launches a step.
  8. the supervised path (the finetune, eval and adapt verbs) at full
     width on BACE-sized data (1513 labelled molecules, the reference's
     900 / 313 / 300 split): FinetuneModel's BCE loss and the gradients of
     what the ``reference`` freeze mask trains, and DomainAdaptModel's
     loss and gradients, card against float64 CPU; the captured
     fine-tuning step byte-equal to the eager one (GIN, GIN with gradient
     accumulation over 2 batches, the transformer) under deterministic
     algorithms, the stale-input fault breaking it; the launches of one
     fine-tuning step and of one evaluation batch, and the medians of the
     eager and captured step, an evaluation batch and an adaptation step,
     both encoders; then the verbs: ``pretrain`` a checkpoint, ``finetune
     --dataset BACE --synthetic 1513 --pretrained ... --epochs 2 --out ...
     --journal ...``, ``eval --split all`` (its test metric the run's
     final one to 1e-6), ``adapt`` for one epoch, one epoch each at 2
     convs of ESOL (rmse), Peptides-func (ap, gradient accumulation 2) and
     Mutagenicity (ce, acc, 14 features, 2 repeats), and one transformer
     fine-tuning epoch; each run's launch counts those of its steps and
     evaluation batches.
  9. the GCN and GraphSAGE encoders, dense ego-nets, the captured
     evaluation and the reference import: (a) ``cli.run_pretrain`` at
     full width for 6 captured steps with each encoder, every count set to
     0 before each run: 14 ``spmm`` launches a step (3 aggregations an
     encoder, forward and backward, and the reconstruction's 2) and 1
     ``pool``, every aggregation on its band branch; their step medians,
     eager and captured; the launches of one fine-tuning step (12
     ``spmm``, 1 ``pool``) and one evaluation batch (6, 1); (b) the banded SpMM kernel against its plain
     version at the encoders' widths: 128 at N and at S, 64 at S; (c) both
     encoders' PretrainModel, card against float64 on the CPU; (d) the
     captured GCN step byte-equal to the eager one under deterministic
     algorithms, the stale-input fault breaking it; (e) dense ego-nets
     (``subgraph_mode="dense"``, slots of the largest ego-net rounded up to
     8): the dense model's losses against the COO model's on the same
     batch, then 4 captured steps, the launches encoder1's GIN kernels and
     the reconstruction's ``spmm`` with no ``pool``; (f) the captured
     evaluation: scores byte-equal to the eager form's on every BACE
     evaluation batch (GIN and the transformer, ``live_noise`` off and on)
     under deterministic algorithms, the stale-input fault breaking it,
     and the evaluation batch median, eager and captured (``eval --split
     all`` against the run's final test metric is phase 8's, now on the
     captured evaluation); (g) ``finetune --pretrained`` a stand-in of the
     reference's whole-module pickle (tests/reference_cases.py, 5 convs,
     width 64) for one epoch at BACE's size: 5 convs adopted, its launches
     those of 5 convs, its loss finite.
 10. the data path, at full width on the benchmark pool: (a) the native
     flat packer bit-equal to the per-graph packers on the benchmark
     batches, host ms a batch of each; (b) wire bytes a batch in both
     modes, ``wire_compact_ok``'s verdict, ``from_wire_*`` on the card
     equal to the packer's batch on every real entry; (c) the captured
     superbatch step (3 superbatches of 32, the first eager, then replays
     of one graph) against the captured single step on the same decoded
     batches under deterministic algorithms: losses, parameters,
     BatchNorm statistics, Adam state and generator state byte-equal, the
     stale-input fault breaking it, every call's launches 32 x
     ``GIN_PER_STEP``; the same for the transformer at K = 4; (d)
     bench.py's sustained loop, 192 fresh batches as 6 superbatches of 32
     through ``wire_superbatches`` -> ``prefetch_to_device(size=3,
     host_stage=2)`` -> the superbatch step, against the captured single
     step fed by ``prefetch_to_device`` and by packing on the consumer
     thread: ms a batch, edges/s, the device's busy share, the capture's
     time and memory, the buffer's copy into the graph; (e) the verbs:
     ``preprocess --synthetic 4096``, ``pretrain --cache --superbatch 32``
     (2 epochs, the second superbatch a replay), ``finetune --dataset BACE
     --smiles_csv`` (1513 rows cycled from a dozen SMILES), each run's
     launch counts those of its steps; (f) ``profile_trace`` around 3
     captured steps writes a trace.
 11. data parallel and remat: (a) ``parallel/dp.py``'s captured DP
     pretraining step at world size 1 over NCCL (PretrainModel(9, 64, 32),
     GIN, the benchmark batches, 6 steps) byte-equal to the captured single
     step under deterministic algorithms, the planted fault of halved
     gradients (DistributedDataParallel's averaging at world size 2)
     breaking it; the launches of a DP step the single step's, the
     collectives of one DP step, the medians of both steps' calls; (b) two
     ranks on the one card over gloo, spawned (``--gloo-rank``), eager,
     each with half of a benchmark batch: the DP pretraining step, the DP
     fine-tuning step (BACE's recipe, ``bce_sum_count``) and a DP
     superbatch step of K = 2 against the single-device steps on the union
     batches (losses within 1e-4, gradients within 1e-3 of float64 as
     phases 4 and 8 hold them, weights under tests/test_torch_trainer.py's
     mask), the ranks byte-equal; (c) the
     captured remat step byte-equal to the captured plain step at
     bench_peptides.py's k = 3 shapes (32 graphs of 120-160 nodes) and on
     the benchmark batch, their peak memory and call ms, every forward
     launch twice under remat; (d) the fine-tuning step fed as
     ``run_finetune`` feeds it now (prefetched from the native packer)
     and as before (packed per graph on the consumer thread): ms a batch
     of BACE; the ``finetune`` verb's step ms.
 12. node-sharded pretraining (``parallel/sharded_scgib.py``) at full
     width, ShardedPretrainModel(9, 64, 32) on the benchmark batch packed
     with ``banded=False`` and resharded: (a) world size 1 over NCCL: the
     losses within 1e-4 and gradients within 1e-3 of the single-device
     model in float64 on the CPU (phase 4's gates); the captured sharded
     step byte-equal to the eager one over 6 steps under deterministic
     algorithms, the stale-input fault breaking it; 0 launches of every
     hand-written kernel (the JAX path reaches no Pallas kernel); the
     median of a captured sharded call against the captured single
     step's; (b) 2 and 4 gloo ranks at once on the one card, eager,
     spawned (``--shard-rank``): the benchmark batch (its ring radius
     printed) and a batch of 2 graphs spanning ranks (radius 2 at 4
     ranks), summed losses and gradients under the same gates against
     float64 on the union batch, the ring's backward sent the wrong way
     breaking the 4-rank gradients, the ranks' states byte-equal after 3
     timed steps (seconds a step printed; one card, so no scaling); beside
     them two processes (``--p2p-probe``) show what gloo's ``send`` and
     ``recv`` do with a CUDA tensor; (c) ``dryrun_multichip(2,
     device="cuda", backend="gloo")``.
 13. the bf16 compute modes (GIN's ``compute_dtype="bfloat16"``, the
     attention's ``bf16_dots``, the transformer's bf16 dense tail): (a) the
     four bf16 kernels (``gin_fwd_bf16`` at N and S, widths 9 and 64 into
     64; ``gt_fwd_bf16``, ``gt_bwd_rows_bf16``, ``gt_bwd_cols_bf16`` at S,
     8 heads of 8 and 1 of 64) against their plain bf16 versions, within
     1e-3 of the plain version's largest entry, the float32 kernel on the
     same inputs past it (the control): error, kernel, plain and
     float32-kernel ms, the bound at the bf16 tensor-core rate, registers,
     shared memory, blocks per SM and ptxas spills, the route each took
     (``gt_fwd_bf16`` its staged kernel; ``gin_fwd_bf16`` the
     instantiation ``gin_route`` names); the attention forward and
     ``gin_fwd_bf16`` past the gate from the control of each of their
     rounding points (tests/gt_rounding.py, tests/gin_rounding.py) that
     lies twice the gate from the plain version, ``gin_fwd_bf16`` also on
     crafted inputs (``gin_rounding.separating_inputs``) that set both of
     its controls 1/32 of the largest entry apart; (b) PretrainModel(9,
     64, 32) in each mode on the benchmark batch: the card's losses within
     1e-3 of the CPU plain path at the same rounding points and within
     1e-2 of the float32 model in float64, its gradients within 5e-3 of
     the largest entry of the bf16 mode in float64, the float32 model's
     past it (the control); (c) ``cli.run_pretrain`` in each mode
     for 6 captured steps from counts of 0 (8 ``gin_fwd_bf16``, no
     ``gin_fwd``; 10 each of the three bf16 attention kernels, none of
     their float32 forms, a step), then the captured step byte-equal to
     the eager one under deterministic algorithms, the stale-input fault
     breaking it; (d) step medians, eager and captured, float32 against
     bf16, both encoders, and each bf16 mode's captured step profiled as in
     phase 7 with each kernel instantiation's time in the step (recorded
     only).
 14. the JAX package's TPU-default Transformer (``gt_bwd="merged"``,
     ``gt_bf16_dots=True``, float32 dense tail: ``_bwd_merged_kernel`` with
     ``bf16=True``): (a) ``gt_fwd_bf16`` and ``gt_bwd_merged_bf16`` at S,
     8 heads of 8 and 1 head of 64, 128, 256, 512 and 1024 (the WIDE
     instantiation), each on the route ``gt_route`` picks (the staged
     kernels where a block fits: 8 x 8, 1 x 64, 1 x 128) and, at 8 x 8
     and 1 x 64, on the lane-group kernel too (the other route), against
     its plain bf16 version within 1e-3 of the largest entry past one bf16
     step of each term whose rounded factor (w, dS) ties within 2^-14 of a
     rounding midpoint (``gt_rounding.tie_slack``: a float32 sum in
     another order may round it either way), the error itself recorded,
     the float32
     kernel on the same inputs past it (the control), the merged pass's
     distance from the two-pass bf16 kernels recorded; the control of each
     single rounding point (q, k, v, g, dS before dq, dS before dk, W
     before dv; tests/gt_rounding.py) for it and the two-pass bf16 passes,
     on random inputs and, for the points those leave within twice the
     gate (v and w before out, dS before dk, W before dv), on crafted ones
     (``gt_rounding.separating_inputs``) at 8 x 8 and 1 x 64 on both
     routes: every control at least twice the gate from the plain version
     must lie past the gate from the kernel; ms, bound, resources and
     ptxas spills of each route; (b)
     PretrainModel(9, 64, 32) in that mode, card against the CPU plain path
     and float64 under phase 13 (b)'s gates, the gradients' at 4e-4 of the
     largest entry (the float32 model's past it, the control); (c) ``cli.run_pretrain`` for 6
     captured steps from counts of 0: 10 ``gt_bwd_merged_bf16``, 10
     ``gt_fwd_bf16``, 2 ``spmm`` and 1 ``pool`` a step, no other attention
     kernel; each captured step held to one eager step from a shared state
     (``stepwise_vs_eager``: dk and dv are summed with atomics), the
     stale-input fault breaking it; every ``gt_fwd_bf16`` and
     ``gt_bwd_merged_bf16`` launch on the staged route; (d) ``pretrain``,
     ``finetune``, ``eval`` and ``adapt`` with ``--encoder Transformer
     --gt_bwd merged --gt_bf16_dots``, one short epoch each, their launch
     counts those of their steps and evaluation batches; (e) step medians,
     captured and eager, merged-bf16 beside two-pass-bf16 and
     merged-float32, and the captured merged-bf16 step on its staged
     kernels, on the lane-group ones and on the staged ones in two other
     splits, and the merged-float32 step, in turns, profiled as in phase
     7, each attention kernel's time in the step read through ``PATH``.
 15. the GIN layer's BatchNorm -> ReLU -> row mask (ops/kernels/batchnorm.py,
     four kernels that replace no Pallas kernel): (a) each kernel against
     its plain version at the benchmark batch's N and S rows, width 64,
     with the batch's own row masks: error, kernel / plain time, the bytes'
     bound and its share, resources and grid; (b) its launches in 3 GIN
     pretraining steps (8 of each kernel a step), 2 Transformer steps
     (none), one captured fine-tuning step and one evaluation batch (GIN);
     (c) the captured GIN step profiled as in phase 7 with the composed
     ops in the kernels' place and with the kernels, in turns (composed,
     kernels, kernels, composed): device ms and device kernels a step, and
     each kernel's time in the step.
 16. S-CGIB at Peptides-func sizes (128 of the generator's molecules of
     120-182 atoms, 3-hop ego-nets) on the bands sized from the data: (a)
     the widths, 512 for the atoms and 384 for the ego-nets, every edge
     kept in its window; (b) gin_fwd, gin_bwd, spmm_self and spmm at those
     bands and rows on exact integer inputs, gin_fwd and gin_bwd on
     positive random ones at d 32 and 64 (the plain versions in TF32 past the
     tolerance), and the pooling, against their plain versions and timed;
     (c) the captured GIN step's launches and branches a replay (8 fused
     convs each way, the reconstruction and the pooling banded, no COO
     aggregation, gin_bwd's row tiles and overlapped tiles) and its host ms to the loss read against the same step
     on the COO path, in turns (banded, coo, coo, banded); (d) the
     benchmark batch keeps 256; (e) gin_bwd at the benchmark batch's S
     (W 256) and the peptide batch's N (W 512) and S (W 384), d 32 and 64,
     on exact integer inputs: against its plain version, bitwise equal in
     two runs, its row tiles and overlapped tiles as counted, its
     registers, shared bytes, blocks an SM, threads and rows a tile (the
     last two as the wrapper's mirror of the plan gives them), and its
     time; with ``--against DIR`` (another checkout), that checkout's
     gin_fused_bwd built and timed in turns with this one's (this, other,
     other, this) and compared bitwise; (f) the blocks kernel alone on the
     peptide batch's atom band, ego-net band and pooling blocks, and on the
     benchmark batch's (W 256, and its two bands in the transformer's
     narrow geometry), against the plain route (float32 zeros, index_add_,
     the cast): bitwise equal, timed beside it and beside PyTorch's bf16
     route (bf16 zeros, index_add_ of bf16 ones), the zero pass beside
     torch.zeros, with the bound of the bytes it writes, and (c)'s replay
     making 3 builds of the peptide batch's entries.
 17. one JSON line of the kernels (with the launches of a fine-tuning step
     and an evaluation batch, and of each main-path run, the superbatch,
     phase 11, 12, 13 and 14 runs among them), the nvidia-smi line, and
     {"ok": true, "device": {...}} as the last line.

``python3 chip_smoke.py --gloo-rank R PORT`` is one rank of phase 11 (b),
``--shard-rank R WORLD PORT`` one of phase 12 (b) and ``--p2p-probe R
PORT`` one of its probe; the script starts them itself.  ``python3
chip_smoke.py --wide-bands`` runs the build and phase 16 alone; ``--against
DIR`` adds phase 16 (e)'s turns with DIR's kernel, to either form.
"""

import collections
import contextlib
import copy
import ctypes
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time

# torch's deterministic algorithms (phase 6's resume check) refuse cuBLAS
# products unless its workspace is fixed before the first one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from scgib_tpu_torch import cli  # noqa: E402
from scgib_tpu_torch.cli import run_pretrain  # noqa: E402
from scgib_tpu_torch.data import loader  # noqa: E402
from scgib_tpu_torch.data.loader import (  # noqa: E402
    GraphDataset, batch_iterator, pack_batch, plan_batches, plan_capacities,
    superbatch_spec)
from scgib_tpu_torch.graph import wire  # noqa: E402
from scgib_tpu_torch.graph.banded import (  # noqa: E402
    GT_ALIGN, GT_BAND, GT_TILE, TILE, device_col_off)
from scgib_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from scgib_tpu_torch.models import encoders  # noqa: E402
from scgib_tpu_torch.models.scgib import (  # noqa: E402
    DomainAdaptModel, FinetuneModel, PretrainModel, _resolve_band,
    uniform_draws)
from scgib_tpu_torch.ops import pool as pool_mod  # noqa: E402
from scgib_tpu_torch.ops.kernels import banded as kb  # noqa: E402
from scgib_tpu_torch.ops.kernels import batchnorm as kbn  # noqa: E402
from scgib_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from scgib_tpu_torch.ops.kernels import gt_flash as kg  # noqa: E402
from scgib_tpu_torch.train import checkpoint, loops  # noqa: E402
from scgib_tpu_torch.graph.batching import (  # noqa: E402
    GraphData, max_egonet_size, pack_graphs, pack_subgraphs,
    pack_subgraphs_dense)
from scgib_tpu_torch.graph.egonet import extract_egonets  # noqa: E402
from scgib_tpu_torch.parallel import (collectives, dp,  # noqa: E402
                                      multihost)
from scgib_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from scgib_tpu_torch.parallel.sharded_batch import (  # noqa: E402
    local_slice, shard_pretrain_batch)
from scgib_tpu_torch.parallel.sharded_scgib import (  # noqa: E402
    ShardedPretrainModel, make_sharded_pretrain_step)
from scgib_tpu_torch.ops.spmm_banded import (  # noqa: E402
    gt_banded_attention)
from scgib_tpu_torch.train import trainer  # noqa: E402
from scgib_tpu_torch.train.trainer import (  # noqa: E402
    adam_l2, finetune_trainable_mask, make_domainadapt_step, make_eval_fn,
    make_finetune_step, make_pretrain_scan_step, make_pretrain_step,
    make_pretrain_superbatch_step, masked_adam, pretrain_step_eager)
from scgib_tpu_torch.utils import counters  # noqa: E402
from scgib_tpu_torch.utils.msgpack_codec import unpackb  # noqa: E402
from scgib_tpu_torch.utils.params import (from_jax_variables,  # noqa: E402
                                          init_flax_style_, sorted_leaves)
from scgib_tpu_torch.utils.profiling import profile_trace  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tests"))
import gin_rounding  # noqa: E402
import gt_rounding  # noqa: E402
from reference_cases import write_stand_in  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
TF32X3_FLOPS_PER_S = 495e12 / 3   # 3xTF32: three TF32 tensor-core products
KERNEL_RTOL = 1e-4            # max |kernel - plain| / max |plain|
MODEL_RTOL = 1e-4             # losses, card vs float64 CPU
GRAD_RTOL = 1e-3              # gradients, card vs float64 CPU, per tensor
GRAD_FLOOR = 1e-3             # ... relative to max(|that tensor|, this
                              # fraction of the largest gradient)
STEPS = 6                     # main-path optimizer steps (1 warm-up)
LR = 1e-4                     # the verb's learning rate in phase 6
WIDTH_STEPS = 4               # steps of each repaired width (1 warm-up)
CHECKPOINT = os.path.join(ROOT, "outputs",
                          "pre_training_PCQM4Mv2_GIN_64_4_1.msgpack")
VERB_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_verb")
GIN_PER_STEP = {"gin_fwd": 8, "gin_bwd": 8, "spmm_self": 8, "spmm": 2,
                "pool": 1}
GT_PER_STEP = {"gt_fwd": 10, "gt_bwd_rows": 10, "gt_bwd_cols": 10,
               "spmm": 2, "pool": 1}
MERGED_PER_STEP = {"gt_fwd": 10, "gt_bwd_merged": 10, "spmm": 2, "pool": 1}
# GCN and GraphSAGE: 3 banded aggregations an encoder, forward and backward
# (every aggregation's input needs a gradient), and the reconstruction's 2
SPMM_ENCODER_PER_STEP = {"spmm": 3 * 2 * 2 + 2, "pool": 1}
# a fine-tuning step: no reconstruction, and under the ``reference`` freeze
# every aggregation still runs backward (the trained projection's gradient
# passes through them); an evaluation batch: the forward's 6
SPMM_ENCODER_FT_PER_STEP = {"spmm": 3 * 2 * 2, "pool": 1}
SPMM_ENCODER_EVAL_PER_BATCH = {"spmm": 3 * 2, "pool": 1}
MERGED_STEPS = 2              # steps with the merged attention backward
SCAN_INNER = 3                # inner steps of the scan step
HEADS, HEAD_DIM = 8, 8        # the graph transformer's attention
WIDE_HDS = (64, 128, 256, 512, 1024)  # one head of each, checked at S
SERVED_HDS = (1024, 1100)     # through gt_flash_attention (1100 padded)
# wrapper -> (source, TPU kernel line, CUDA kernel; where it has two
# routes, the staged route's kernel and then the lane-group one)
PATH = {"gin_fwd": ("banded", 69, "gin_fused_fwd_kernel"),
        "gin_bwd": ("banded", 141, "gin_fused_bwd_kernel"),
        "spmm_self": ("banded", 177, "banded_spmm_kernel"),
        "spmm": ("banded", 266, "banded_spmm_kernel"),
        "pool": ("banded", 405, "banded_spmm_kernel"),
        "gt_fwd": ("gt_flash", 121, "gt_fwd_kernel"),
        "gt_bwd_rows": ("gt_flash", 146, "gt_row_pass_kernel"),
        "gt_bwd_cols": ("gt_flash", 248, "gt_bwd_cols_kernel"),
        "gt_bwd_merged": ("gt_flash", 181, "gt_row_pass_kernel"),
        # the bf16 instantiations (phase 13)
        "gin_fwd_bf16": ("banded", 69, "gin_fused_fwd_bf16_kernel"),
        "gt_fwd_bf16": ("gt_flash", 121,
                        "gt_fwd_staged_bf16_kernel gt_fwd_kernel"),
        "gt_bwd_rows_bf16": ("gt_flash", 146, "gt_row_pass_kernel"),
        "gt_bwd_cols_bf16": ("gt_flash", 248, "gt_bwd_cols_kernel"),
        # the merged backward's bf16 instantiation (phase 14)
        "gt_bwd_merged_bf16": ("gt_flash", 181,
                               "gt_bwd_merged_staged_bf16_kernel "
                               "gt_row_pass_kernel")}
# main-path run -> (run_pretrain arguments, steps, launches per step; the
# wrappers not named launch 0 times)
RUNS = {"GIN": ({}, STEPS, GIN_PER_STEP),
        "Transformer": ({"encoder": "Transformer"}, STEPS, GT_PER_STEP),
        "Transformer-merged": ({"encoder": "Transformer",
                                "gt_bwd": "merged"}, MERGED_STEPS,
                               MERGED_PER_STEP),
        "GCN": ({"encoder": "GCN"}, STEPS, SPMM_ENCODER_PER_STEP),
        "GraphSAGE": ({"encoder": "GraphSAGE"}, STEPS, SPMM_ENCODER_PER_STEP)}
SPMM_ENCODERS = ("GCN", "GraphSAGE")     # their runs are phase 9's
# encoder -> (its branch count's name, convs or attention layers a step)
ENCODER_BRANCHES = {"GIN": ("band", 8), "Transformer": ("gt_band_64x128", 10),
                    "GCN": ("gcn_band", 6), "GraphSAGE": ("sage_band", 6)}
# encoder -> block builds a step (``kb.blocks``, counted as ``kb.BLOCKS``):
# the atom band, the ego-net band and the pooling blocks; the transformer's
# two bands in the narrow geometry, the reconstruction's atom band at W 256
# and the pooling blocks
BUILDS_PER_STEP = {"GIN": 3, "Transformer": 4, "GCN": 3, "GraphSAGE": 3}
# which run's count each kernel reports
REPORT_RUN = {"gt_fwd": "Transformer", "gt_bwd_rows": "Transformer",
              "gt_bwd_cols": "Transformer",
              "gt_bwd_merged": "Transformer-merged",
              "gin_fwd_bf16": "GIN-bf16", "gt_fwd_bf16": "Transformer-bf16",
              "gt_bwd_rows_bf16": "Transformer-bf16",
              "gt_bwd_cols_bf16": "Transformer-bf16",
              "gt_bwd_merged_bf16": "Transformer-merged-bf16"}
# the BatchNorm tail's wrappers -> their CUDA kernels (phase 15), and the
# launches of each a GIN step (one a conv of the two 4-conv encoders)
BN_PATH = {k: f"{k}_kernel" for k in kbn.KERNELS}
BN_PER_STEP = 8
GIN_NO_LIBRARY = ("no single PyTorch call computes it: the conv is two "
                  "products around the aggregation (relu((h + A h) W1 + b1) "
                  "W2 + b2) and its backward stage gz0 with dW1, db1, dW2, "
                  "db2; no library call fuses them")
NO_LIBRARY = ("no single PyTorch call computes it: scaled_dot_product_"
              "attention takes a max-shifted softmax, with no clamp of the "
              "scores and no eps in the denominator")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20):
    """Device time of one call of ``fn``: the call is captured once in a
    CUDA graph, and the graph is replayed ``reps`` times, each between two
    CUDA events; the median is returned.  Replaying a graph keeps the
    host's per-call Python and launch cost out of the reading, which
    would otherwise exceed these kernels' device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in events:
        a.record()
        graph.replay()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def launch_counts():
    """The banded and attention kernels' launches, 0 where none; the
    BatchNorm kernels' are ``counters.of("launch", kbn.KERNELS)``."""
    return counters.of("launch", kb.KERNELS + kg.KERNELS)


def reset_launch_counts():
    counters.reset("launch", "route")


def bound_ms(nbytes, flops, flops_per_s=FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def rel_err(got, want):
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def windows(blocks, col_off, x):
    idx = col_off[:, None] + torch.arange(blocks.shape[2], device=x.device)
    return x[idx]


def check(name, shape, kernel_fn, plain_fn, nbyt, flops, library_fn=None,
          tf32x3=False, tol=KERNEL_RTOL, flops_per_s=FP32_FLOPS_PER_S,
          ties=None):
    """Compare one kernel configuration with its plain version and time
    both; returns the record.  ``tf32x3``: the kernel runs its products in
    3xTF32, so its bound is taken at that rate, and the bound at the fp32
    SIMT rate is recorded beside it.  ``tol``: the largest error relative
    to the plain version's largest entry; ``flops_per_s``: the rate of the
    operations' bound (phase 13's bf16 kernels: the bf16 one).  ``ties``:
    a bf16 kernel's ``gt_rounding.tie_slack`` (a callable): each entry may
    also lie one bf16 step of every term whose rounded factor ties, which
    a float32 sum in another order rounds either way; the error past that
    is held to ``tol``, and the error itself is recorded beside it."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    max_abs = max(e[0] for e in errs)
    max_rel = max(e[1] for e in errs)
    gated = max_rel
    rec = {"name": name, "shape": shape, "max_abs_err": max_abs,
           "max_rel_err": max_rel, "tol_rel": tol,
           "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
           "library_ms": time_ms(library_fn) if library_fn else None}
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        nbyt, flops, TF32X3_FLOPS_PER_S if tf32x3 else flops_per_s)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    extra = ""
    if tf32x3:
        rec["bound_fp32_ms"] = bound_ms(nbyt, flops)[0]
        extra = (f" at the 3xTF32 rate; at the fp32 SIMT rate "
                 f"{rec['bound_fp32_ms'] * 1e3:.3f} us (share "
                 f"{rec['bound_fp32_ms'] / rec['ms']:.3f})")
    if ties is not None:
        gated, rec["tie_entries"] = gt_rounding.beyond_ties(got, want,
                                                            ties())
        rec["max_rel_err_beyond_ties"] = gated
        extra += (f"; past the ties {gated:.3e} ({rec['tie_entries']} "
                  f"entries took a tie's step)")
    print(f"kernel {name} {shape}: max_abs_err {max_abs:.3e} rel "
          f"{max_rel:.3e} (tol {tol}) | ms {rec['ms']:.4f} plain "
          f"{rec['plain_ms']:.4f} library {rec['library_ms']} bound "
          f"{rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']}, share "
          f"{rec['bound_share']:.3f}){extra}", flush=True)
    if not gated <= tol:
        raise AssertionError(f"{name} {shape} disagrees with its plain "
                             f"version: {gated:.3e} > {tol}")
    return rec


# The spills (bytes stored, loaded) ptxas gives the attention's
# instantiations up to hd 512 in the sources as they stand; the WIDE one
# (head widths past 512) has none.  Phase 2 fails on any other spill, or a
# larger one, in any instantiation.
GT_SPILLS = {("gt_fwd", 2): (4, 4), ("gt_fwd", 4): (4, 4),
             ("gt_bwd_rows", 4): (8, 16), ("gt_bwd_rows", 8): (4, 4),
             ("gt_bwd_rows", 64): (4, 4), ("gt_bwd_cols", 256): (16, 16),
             ("gt_bwd_rows_bf16", 4): (8, 16),
             ("gt_bwd_rows_bf16", 8): (4, 4)}


def attention_ptxas():
    """Registers and spill bytes of every instantiation of
    csrc/gt_flash.cu, from the ptxas report kept beside its library (built
    in this run or before it): every wrapper's lane-group kernel at every
    width of ``HEAD_WIDTHS`` and WIDE (0), and the staged kernels at every
    width of ``STAGED_HEAD_WIDTHS``, none spilling past ``GT_SPILLS``."""
    report = kg.ptxas_report()
    want = {(k, hd) for k in kg.KERNELS for hd in kg.HEAD_WIDTHS + (0,)} | {
        (kg.ptxas_key(k, "staged"), hd) for k in kg.STAGED
        for hd in kg.STAGED_HEAD_WIDTHS}
    faults = sorted(want - set(report))
    for key, rec in sorted(report.items()):
        spill = (rec.get("spill_stores"), rec.get("spill_loads"))
        allowed = GT_SPILLS.get(key, (0, 0))
        if None in spill or spill[0] > allowed[0] or spill[1] > allowed[1]:
            faults.append((key, spill))
    out = {f"{k} hd {hd or 'WIDE'}": rec for (k, hd), rec in
           sorted(report.items())}
    print(f"attention ptxas: {json.dumps(out)}", flush=True)
    if faults:
        raise AssertionError(f"attention instantiations missing or "
                             f"spilling past {GT_SPILLS}: {faults}")
    return out


def served_phase(sub, dev, gen):
    """Head widths past 512 through ``gt_flash_attention`` on the card, at
    S in the narrow geometry, one head: 1024 as the kernels take it (two
    sweeps) and 1100 zero-padded to 1536 (three sweeps).  The output and
    the gradients of q, k and v, with either backward, against
    ``gt_banded_attention`` (plain torch ops, by autograd) at the original
    width."""
    blocks, off = _resolve_band(sub, gt=True)
    n = blocks.shape[0] * blocks.shape[1]
    out = {}
    for hd in SERVED_HDS:
        q, k, v, ct = (torch.randn(n, 1, hd, device=dev, generator=gen)
                       for _ in range(4))
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        want = gt_banded_attention(blocks, off, *ref)
        (want * ct).sum().backward()
        for bwd in kg.BWD:
            ts = [t.clone().requires_grad_() for t in (q, k, v)]
            before = launch_counts()
            got = kg.gt_flash_attention(blocks, off, *ts, bwd=bwd)
            (got * ct).sum().backward()
            torch.cuda.synchronize()
            launched = {k: n - before[k] for k, n in launch_counts().items()
                        if n != before[k]}
            errs = [rel_err(got.detach(), want.detach())[1]] + [
                rel_err(a.grad, b.grad)[1] for a, b in zip(ts, ref)]
            rec = {"served_as": kg.served_head_width(1, hd),
                   "max_rel_err": max(errs), "launches": launched}
            out[f"hd {hd} {bwd}"] = rec
            print(f"served head width {hd} ({bwd}): {json.dumps(rec)} (tol "
                  f"{KERNEL_RTOL})", flush=True)
            if not (max(errs) <= KERNEL_RTOL
                    and launched.get("gt_fwd") == 1
                    and sum(launched.values()) == (2 if bwd == "merged"
                                                   else 3)):
                raise AssertionError(f"head width {hd}, {bwd}: {rec}")
    return out


def kernel_phase(g, sub, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    one = torch.zeros(1, device=dev)
    print(f"graph launch floor: a one-element add reads "
          f"{time_ms(lambda: one.add_(1.0)):.4f} ms one-call", flush=True)
    records = []
    hid = 64
    for label, batch in (("N", g), ("S", sub)):
        records += band_records(label, batch, dev, gen)
    records.append(pool_record(g, sub, dev, gen))
    for rec in records:
        if rec["name"] in ("gin_fwd", "gin_bwd"):
            rec["library_note"] = GIN_NO_LIBRARY
    for d in (32, 64):
        for kernel, widths in (("banded_spmm", (d,)),
                               ("gin_fused_fwd", (d, hid, hid)),
                               ("gin_fused_bwd", (d, hid, hid))):
            info = kb.kernel_info(kernel, *widths)
            print(f"resources {kernel} widths {widths}: {info}", flush=True)
            for rec in records:
                if (rec["shape"].endswith(f"d={d}")
                        and PATH[rec["name"]][2] == f"{kernel}_kernel"):
                    rec["resources"] = info
    return records + gt_kernel_phase(g, sub, dev, gen)


def band_records(label, batch, dev, gen, hid=64, width=False):
    """``gin_fwd``, ``gin_bwd`` and ``spmm_self`` at d = 32 and 64, and for
    the atoms (``label`` "N") ``spmm`` at ``hid``, on the batch's band,
    each against its plain version and timed (``check``).  ``width``: the
    shapes name the band's width, and h, W1 and b1 are small integers and
    halves, which every product keeps exact: past a few million rows some
    of random inputs' pre-activations lie within rounding of 0, where the
    kernel's 3xTF32 z1 and the plain float32 one take the ReLU apart."""
    records = []
    blocks, col_off = _resolve_band(batch)
    n = blocks.shape[0] * blocks.shape[1]
    nnz = int((blocks != 0).sum())
    bf = blocks.float()
    tag = f" W={blocks.shape[2]}" if width else ""

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, device=dev,
                             generator=gen).float()
    for d in (32, 64):
        if width:
            h, w1 = ints(-3, 4, n, d), ints(-2, 3, d, hid)
            b1 = ints(-4, 4, hid) + 0.5
        else:
            h = torch.randn(n, d, device=dev, generator=gen)
            w1 = torch.randn(d, hid, device=dev,
                             generator=gen) / math.sqrt(d)
            b1 = torch.randn(hid, device=dev, generator=gen) * 0.1
        w2 = torch.randn(hid, hid, device=dev, generator=gen) / 8.0
        b2 = torch.randn(hid, device=dev, generator=gen) * 0.1
        gr = torch.randn(n, hid, device=dev, generator=gen)
        shape = f"{label}={n}{tag} d={d}"
        mlp = 2 * n * (d * hid + hid * hid)
        records.append(check(
            "gin_fwd", shape,
            lambda: kb.gin_fwd(blocks, col_off, h, w1, b1, w2, b2),
            lambda: kb.gin_fwd_plain(blocks, col_off, h, w1, b1, w2, b2),
            nbytes(blocks, col_off, h, w1, b1, w2, b2) + n * hid * 4,
            2 * nnz * d + n * d + mlp, tf32x3=True))
        records.append(check(
            "gin_bwd", shape,
            lambda: kb.gin_bwd(blocks, col_off, h, gr, w1, b1, w2),
            lambda: kb.gin_bwd_plain(blocks, col_off, h, gr, w1, b1, w2),
            nbytes(blocks, col_off, h, gr, w1, b1, w2)
            + nbytes(h, w1, b1, w2, b2),            # gz0, dW1 .. db2
            2 * nnz * d + n * d + 2 * n * (3 * d * hid + 2 * hid * hid),
            tf32x3=True))
        win = windows(blocks, col_off, h)
        records.append(check(
            "spmm_self", shape,
            lambda: kb.spmm_self(blocks, col_off, h),
            lambda: kb.spmm_self_plain(blocks, col_off, h),
            nbytes(blocks, col_off, h) + n * d * 4, 2 * nnz * d + n * d,
            lambda: torch.baddbmm(h.view(-1, 128, d), bf, win)))
        del win
    if label == "N":
        x = torch.randn(n, hid, device=dev, generator=gen)
        win = windows(blocks, col_off, x)
        records.append(check(
            "spmm", f"N={n}{tag} d={hid}",
            lambda: kb.spmm(blocks, col_off, x),
            lambda: kb.spmm_plain(blocks, col_off, x),
            nbytes(blocks, col_off, x) + n * hid * 4, 2 * nnz * hid,
            lambda: torch.bmm(bf, win)))
    return records


def random_product_records(label, batch, dev, gen, d=64, hid=64):
    """``gin_fwd`` and ``gin_bwd`` on the batch's band on random inputs,
    beside ``band_records(..., width=True)``'s exact ones: h, W1 and b1
    positive keep every pre-activation at least 0.1 from 0 (no ReLU flip),
    so z1 carries the 3xTF32 products' rounding; the plain versions in
    TF32 (the control, ``control_rel_err``) must lie past the tolerance."""
    blocks, col_off = _resolve_band(batch)
    n = blocks.shape[0] * blocks.shape[1]
    h = torch.rand(n, d, device=dev, generator=gen)
    w1 = torch.rand(d, hid, device=dev, generator=gen) / d
    b1 = 0.1 + 0.1 * torch.rand(hid, device=dev, generator=gen)
    w2 = torch.randn(hid, hid, device=dev, generator=gen) / 8.0
    b2 = torch.randn(hid, device=dev, generator=gen) * 0.1
    gr = torch.randn(n, hid, device=dev, generator=gen)
    nnz = int((blocks != 0).sum())
    shape = f"{label}={n} W={blocks.shape[2]} d={d} random"
    pairs = (
        ("gin_fwd", lambda: kb.gin_fwd(blocks, col_off, h, w1, b1, w2, b2),
         lambda: kb.gin_fwd_plain(blocks, col_off, h, w1, b1, w2, b2),
         nbytes(blocks, col_off, h, w1, b1, w2, b2) + n * hid * 4,
         2 * nnz * d + n * d + 2 * n * (d * hid + hid * hid)),
        ("gin_bwd", lambda: kb.gin_bwd(blocks, col_off, h, gr, w1, b1, w2),
         lambda: kb.gin_bwd_plain(blocks, col_off, h, gr, w1, b1, w2),
         nbytes(blocks, col_off, h, gr, w1, b1, w2)
         + nbytes(h, w1, b1, w2, b2),
         2 * nnz * d + n * d + 2 * n * (3 * d * hid + 2 * hid * hid)))
    records = []
    for name, kernel_fn, plain_fn, nbyt, flops in pairs:
        rec = check(name, shape, kernel_fn, plain_fn, nbyt, flops,
                    tf32x3=True)
        want = plain_fn()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            control = plain_fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        control = control if isinstance(control, tuple) else (control,)
        want = want if isinstance(want, tuple) else (want,)
        rec["control_rel_err"] = max(rel_err(a, b)[1]
                                     for a, b in zip(control, want))
        print(f"kernel {name} {shape}: the TF32 control "
              f"{rec['control_rel_err']:.3e}", flush=True)
        if not rec["control_rel_err"] > rec["tol_rel"]:
            raise AssertionError(f"{name} {shape}: the TF32 control lies "
                                 f"within the tolerance")
        records.append(rec)
    return records


def pool_record(g, sub, dev, gen, hid=64):
    """The candidate pooling: S ego-net rows onto N centers."""
    s_rows, n_seg = sub.num_nodes, g.num_nodes
    window = pool_mod.default_window(s_rows, n_seg)
    if not sub.pool_fits:
        raise AssertionError("benchmark batch does not fit the pool window")
    off = pool_mod.window_offsets(sub.node_center, sub.node_mask, n_seg, 128,
                                  window)
    pblocks, _ = pool_mod.pool_blocks(sub.node_center, sub.node_mask, off,
                                      n_seg, 128, window)
    data = torch.randn(s_rows, hid, device=dev, generator=gen)
    pbf = pblocks.float()
    pwin = windows(pblocks, off, data)
    return check(
        "pool", f"S={s_rows}->N={n_seg} W={window} d={hid}",
        lambda: kb.pool(pblocks, off, data),
        lambda: kb.spmm_plain(pblocks, off, data),
        nbytes(pblocks, off, data) + n_seg * hid * 4,
        2 * int((pblocks != 0).sum()) * hid,
        lambda: torch.bmm(pbf, pwin))


def gt_kernel_phase(g, sub, dev, gen):
    """The four attention kernels at the bench shapes, in the narrow
    geometry the main path gives them (8 heads of 8), and at S also at one
    head of 64, 128 and 256; then the merged backward against the two-pass
    one.  Operations are counted per edge and head (the kernels skip zero
    gate entries): 2 hd per product of two hd-vectors, plus the clip,
    exponential, gate and sums."""
    records = []
    for label, batch, heads, hd in (("N", g, HEADS, HEAD_DIM),
                                    ("S", sub, HEADS, HEAD_DIM),
                                    *(("S", sub, 1, w) for w in WIDE_HDS)):
        blocks, off = _resolve_band(batch, gt=True)
        n = blocks.shape[0] * blocks.shape[1]
        edges = int((blocks != 0).sum()) * heads
        q, k, v, gr = (torch.randn(n, heads, hd, device=dev, generator=gen)
                       for _ in range(4))
        z = kg.gt_fwd_plain(blocks, off, q, k, v)[1]
        rho = kg.gt_bwd_rows_plain(blocks, off, q, k, v, gr, z)[1]
        shape = (f"{label}={n} H={heads} hd={hd} "
                 f"blocks={tuple(blocks.shape)}")
        ins = nbytes(blocks, off, q, k, v)
        feat, stat = nbytes(q), nbytes(z)
        new = [check(
            "gt_fwd", shape, lambda: kg.gt_fwd(blocks, off, q, k, v),
            lambda: kg.gt_fwd_plain(blocks, off, q, k, v),
            ins + feat + stat, edges * (4 * hd + 5))]
        new.append(check(
            "gt_bwd_rows", shape,
            lambda: kg.gt_bwd_rows(blocks, off, q, k, v, gr, z),
            lambda: kg.gt_bwd_rows_plain(blocks, off, q, k, v, gr, z),
            ins + feat + stat + feat + stat, edges * (6 * hd + 8)))
        new.append(check(
            "gt_bwd_cols", shape,
            lambda: kg.gt_bwd_cols(blocks, off, q, k, v, gr, z, rho),
            lambda: kg.gt_bwd_cols_plain(blocks, off, q, k, v, gr, z, rho),
            ins + feat + 2 * stat + 2 * feat, edges * (8 * hd + 10)))
        new.append(check(
            "gt_bwd_merged", shape,
            lambda: kg.gt_bwd_merged(blocks, off, q, k, v, gr, z),
            lambda: kg.gt_bwd_merged_plain(blocks, off, q, k, v, gr, z),
            ins + feat + stat + 3 * feat, edges * (10 * hd + 10)))
        for rec in new:
            rec["main"] = hd == HEAD_DIM
        records += new
        dq, rho_k = kg.gt_bwd_rows(blocks, off, q, k, v, gr, z)
        twopass = (dq,) + kg.gt_bwd_cols(blocks, off, q, k, v, gr, z, rho_k)
        merged = kg.gt_bwd_merged(blocks, off, q, k, v, gr, z)
        torch.cuda.synchronize()
        worst = max(rel_err(a, b)[1] for a, b in zip(merged, twopass))
        print(f"gt merged vs two-pass backward on the card, {shape}: max "
              f"rel err {worst:.3e} (tol {KERNEL_RTOL})", flush=True)
        if not worst <= KERNEL_RTOL:
            raise AssertionError(f"merged backward disagrees with two-pass: "
                                 f"{worst:.3e}")
    for rec in records:
        rec["library_note"] = NO_LIBRARY
    for hd in (HEAD_DIM,) + WIDE_HDS:
        for kernel in ("gt_fwd", "gt_bwd_rows", "gt_bwd_cols",
                       "gt_bwd_merged"):
            info = kg.kernel_info(kernel, hd)
            print(f"resources {kernel} hd={hd}: {info}", flush=True)
            for rec in records:
                if rec["name"] == kernel and f"hd={hd} " in rec["shape"]:
                    rec["resources"] = info
    return records


def card_vs_float64(model, g, sub, label, grads=True):
    """Deterministic losses (and, with ``grads``, gradients) of ``model`` on
    the card against a float64 copy of it on the CPU plain path, on the
    same batch; raises where they disagree."""
    ref = copy.deepcopy(model).to("cpu", torch.float64)
    model.to(g.node_feat.device)
    g64, sub64 = g.to("cpu"), sub.to("cpu")
    for name in ("node_feat", "logm_targets", "logm_weights"):
        if getattr(g64, name) is not None:
            setattr(g64, name, getattr(g64, name).double())
    results = []
    for m, gb, sb in ((model, g, sub), (ref, g64, sub64)):
        m.train()
        with torch.set_grad_enabled(grads):
            losses = m(gb, sb)
            if grads:
                losses.total.backward()
        results.append(([float(v.detach()) for v in losses],
                        {k: p.grad.detach().cpu().double()
                         for k, p in m.named_parameters()} if grads else {}))
    (l_dev, g_dev), (l_ref, g_ref) = results
    for a, b, name in zip(l_dev, l_ref, ("kl", "contrastive", "recon")):
        if not (math.isfinite(a) and abs(a - b) <= MODEL_RTOL * abs(b)):
            raise AssertionError(f"{label}: loss {name}: card {a} vs "
                                 f"float64 {b}")
    if not grads:
        print(f"model ({label}) card vs float64 CPU: losses {l_dev} vs "
              f"{l_ref} (tol {MODEL_RTOL})", flush=True)
        return
    # Some gradients are zero but for rounding (biases feeding a BatchNorm,
    # the attention scorer's bias); they are held against GRAD_FLOOR of the
    # largest gradient.  On the CPU, float32 against float64 leaves them
    # 3e-4 of that apart at this batch.
    floor = GRAD_FLOOR * max(float(v.abs().max()) for v in g_ref.values())
    errs = sorted((float((g_dev[k] - g_ref[k]).abs().max())
                   / max(float(g_ref[k].abs().max()), floor), k)
                  for k in g_ref)
    worst = errs[-1][0]
    print(f"model ({label}) card vs float64 CPU: losses {l_dev} vs "
          f"{l_ref}; worst "
          f"gradient rel errs {errs[-3:]} (tol {GRAD_RTOL})", flush=True)
    if not worst <= GRAD_RTOL:
        raise AssertionError(f"gradients disagree: {worst:.3e}")


def model_phase(g, sub, dev, encoder="GIN"):
    """Deterministic losses and gradients of the full model on the
    benchmark batch: the card (kernels, float32) against the CPU plain path
    in float64, with the transformer's dropout off."""
    model = PretrainModel(9, hidden=64, d_transfer=32, encoder=encoder,
                          num_heads=HEADS, deterministic=True)
    init_flax_style_(model, torch.Generator().manual_seed(3))
    for m in model.modules():
        if isinstance(m, encoders.GraphTransformerLayer):
            m.dropout = 0.0
    card_vs_float64(model.to(dev), g, sub, encoder)


# host API calls a step the profile counts: kernel launches, graph
# launches, and the copies (the captured step's input copies among them)
HOST_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
              "cudaGraphLaunch", "cudaMemcpyAsync")


@contextlib.contextmanager
def eager_steps():
    """``run_pretrain`` and the verb with the eager step in place of the
    captured one (the comparisons of phases 5 and 7)."""
    real = cli.make_pretrain_step
    cli.make_pretrain_step = lambda model, opt: functools.partial(
        pretrain_step_eager, model, opt)
    try:
        yield
    finally:
        cli.make_pretrain_step = real


def profile_phase(encoder="GIN", eager=False, **options):
    """Device time by kernel over 3 steady steps of a main path (after
    2 unprofiled ones; the captured path's first is its eager warm-up and
    capture), the device's busy share of those steps' wall time (host
    clock, with the profiler's own overhead in it), and the host's launch
    and copy calls a step; ``port``: [ms, calls] per step of each of the
    port's CUDA kernels.  Where the profiler records no device time (a
    replay it does not break into kernels), the device ms come from CUDA
    events around each step instead, and ``device_ms_from`` says so.
    ``options`` go to ``run_pretrain`` (phase 13: the bf16 modes)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=1, warmup=1, active=3))
    with prof, (eager_steps() if eager else contextlib.nullcontext()):
        steps = run_pretrain(synthetic=1024, batch_size=128, steps=5,
                             lr=1e-4, weight_decay=5e-5, device="cuda",
                             encoder=encoder, log=lambda _: None,
                             profiler=prof, **options)
    wall_ms = sum(r["ms"] for r in steps[2:]) / 3
    events = prof.key_averages()
    # device-side events, less the user annotations (ProfilerStep*, the
    # optimizer's step), which span kernels rather than being one
    kernels = sorted(
        ((e.self_device_time_total / 1e3 / 3, e.count / 3, e.key)
         for e in events
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and not e.key.startswith("ProfilerStep")),
        reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    port_names = ({name for v in PATH.values() for name in v[2].split()}
                  | set(BN_PATH.values()))
    host = {name: sum(e.count for e in events if e.key == name) / 3
            for name in HOST_CALLS}
    # what each host kernel launch of the profiled steps was for
    parents = collections.Counter(
        (e.cpu_parent.name if e.cpu_parent is not None else "-")
        for e in prof.events() if e.name in HOST_CALLS[:3])
    summary = {"path": "eager" if eager else "captured",
               "wall_ms_per_step": wall_ms, "device_ms_per_step": busy_ms,
               "device_ms_from": "profiler",
               "device_busy_share": busy_ms / wall_ms if busy_ms else None,
               "device_kernels_per_step": sum(k[1] for k in kernels),
               "host_calls_per_step": host,
               "kernel_launches_by_op": {k: n / 3 for k, n in
                                         parents.most_common(8)},
               "index_kernels": [{"kernel": name[:100], "ms_per_step": ms,
                                  "calls_per_step": n}
                                 for ms, n, name in kernels
                                 if "index" in name.lower()],
               "top": [{"kernel": name[:80], "ms_per_step": ms,
                        "calls_per_step": n}
                       for ms, n, name in kernels[:12]],
               "port": {k: [sum(ms for ms, _, name in kernels if k in name),
                            sum(n for _, n, name in kernels if k in name)]
                        for k in sorted(port_names)},
               "port_instances": port_instances(kernels, port_names)}
    if not busy_ms:
        summary["device_ms_per_step"] = event_device_ms(encoder, eager,
                                                        **options)
        summary["device_ms_from"] = "CUDA events around the step"
        summary["device_busy_share"] = (summary["device_ms_per_step"]
                                        / wall_ms)
    print(f"profile ({encoder}, {summary['path']}"
          f"{', ' + json.dumps(options, default=str) if options else ''}): "
          f"{json.dumps(summary)}", flush=True)
    return summary


def port_instances(kernels, names):
    """[ms, calls] a step of each instantiation (``name<args>``) of the
    port's kernels ``names`` among a profile's (ms, calls, name) rows."""
    out = {}
    for ms, n, name in kernels:
        m = re.search(r"(\w+_kernel<[^>]*>)", name)
        if m and m.group(1).split("<")[0] in names:
            rec = out.setdefault(m.group(1), [0.0, 0.0])
            rec[0] += ms
            rec[1] += n
    return out


def event_device_ms(encoder, eager, **options):
    """Median device time of a steady step, between CUDA events recorded
    before and after it on the current stream."""
    times = []

    class Timed:
        def step(self):
            pass

    real = cli.make_pretrain_step

    def timed(model, opt):
        inner = (functools.partial(pretrain_step_eager, model, opt) if eager
                 else real(model, opt))

        def step(*args):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = inner(*args)
            b.record()
            times.append((a, b))
            return out
        return step
    cli.make_pretrain_step = timed
    try:
        run_pretrain(synthetic=1024, batch_size=128, steps=5, lr=1e-4,
                     weight_decay=5e-5, device="cuda", encoder=encoder,
                     log=lambda _: None, profiler=Timed(), **options)
    finally:
        cli.make_pretrain_step = real
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in times[2:])


# --- 5. the captured step against the eager one ------------------------------

def step_bytes(model, opt, gen):
    """Everything a step changes, as bytes: the parameters and BatchNorm
    statistics, Adam's state and the generator's."""
    out = {f"model {k}": v.detach().cpu().numpy().tobytes()
           for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        for key, t in opt.state[p].items():
            out[f"adam {name} {key}"] = t.detach().cpu().numpy().tobytes()
    out["generator"] = gen.get_state().numpy().tobytes()
    return out


def bytes_apart(a, b):
    """The entries of two ``step_bytes`` (or loss lists) that differ."""
    return [k for k in a if a[k] != b[k]]


def compared_run(dev, batches, kwargs, how):
    """One step a batch from one start (PretrainModel(9, 64, 32), seeded
    weights, Adam, generator) on ``batches``; ``how``: "eager", "captured"
    or "scan" (calls of the scan step of SCAN_INNER inner steps on the
    first batch, the first eager and the rest replays; the eager run to
    compare it with takes the first batch every step).  Returns (losses as
    bytes per step, step_bytes, launch counts, (model, optimizer))."""
    model = PretrainModel(9, hidden=64, d_transfer=32, num_heads=HEADS,
                          **kwargs)
    init_flax_style_(model, torch.Generator().manual_seed(11))
    model.to(dev)
    opt = adam_l2(model, 1e-4, 5e-5)
    gen = torch.Generator(device=dev).manual_seed(12)
    reset_launch_counts()
    if how == "scan":
        step = make_pretrain_scan_step(model, opt, SCAN_INNER)
        losses = [[t[i] for t in out] for out in (
            step(*batches[0], gen) for _ in range(len(batches) // SCAN_INNER))
            for i in range(SCAN_INNER)]
    else:
        step = (make_pretrain_step(model, opt) if how == "captured"
                else functools.partial(pretrain_step_eager, model, opt))
        losses = [step(g, s, gen) for g, s in batches]
    torch.cuda.synchronize()
    as_bytes = {f"step {i} {name}": t.detach().cpu().numpy().tobytes()
                for i, ls in enumerate(losses)
                for name, t in zip(("kl", "contrastive", "recon"), ls)}
    return as_bytes, step_bytes(model, opt, gen), launch_counts(), (
        model, opt)


def stale_inputs(real):
    """A planted fault: replays copy their inputs only the first time, and
    then run on the batch they were first given."""
    seen = set()

    def replay(self, entry, batches, spans=None):
        if id(entry) not in seen:
            seen.add(id(entry))
            return real(self, entry, batches, spans)
        graph, _, out, added = entry
        graph.replay()
        counters.add(added)
        return trainer._clone(out)
    return replay


COMPARED = {"GIN": ({}, GIN_PER_STEP),
            "Transformer": ({"encoder": "Transformer"}, GT_PER_STEP),
            "Transformer-merged": ({"encoder": "Transformer",
                                    "gt_bwd": "merged"}, MERGED_PER_STEP)}


@contextlib.contextmanager
def stale_replays():
    """The planted fault of ``stale_inputs`` in place for the block."""
    real = trainer._CapturedSteps._replay
    trainer._CapturedSteps._replay = stale_inputs(real)
    try:
        yield
    finally:
        trainer._CapturedSteps._replay = real


def captured_vs_eager(dev, batches, label, kwargs, per_step):
    """One step a batch, eager, captured and captured with the stale-input
    fault, from one start: the captured run's losses and state byte-equal
    to the eager run's (the merged attention backward's within
    tolerances), the fault's not, each run's launches ``per_step`` a
    step."""
    eager = compared_run(dev, batches, kwargs, "eager")
    captured = compared_run(dev, batches, kwargs, "captured")
    with stale_replays():
        fault = compared_run(dev, batches, kwargs, "captured")
    rec = {"losses_apart": bytes_apart(eager[0], captured[0]),
           "state_apart": bytes_apart(eager[1], captured[1]),
           "fault_losses_apart": len(bytes_apart(eager[0], fault[0])),
           "fault_state_apart": len(bytes_apart(eager[1], fault[1]))}
    for name, run in (("eager", eager), ("captured", captured)):
        want = {k: n * len(batches) for k, n in per_step.items()}
        got = {k: n for k, n in run[2].items() if n}
        if got != want:
            raise AssertionError(f"{label} {name}: launches {got}, "
                                 f"expected {want}")
    if "merged" in label:
        # dk and dv summed with atomics: two chained runs drift apart
        # (recorded, not held), so each captured step is held to one eager
        # step from the state it started in, and so is the fault
        again = compared_run(dev, batches, kwargs, "eager")
        rec["chained"] = merged_apart(eager, captured)
        rec["chained_eager_twice"] = merged_apart(eager, again)
        rec.update(stepwise_vs_eager(dev, batches, kwargs))
        with stale_replays():
            fault = stepwise_vs_eager(dev, batches, kwargs)
        rec["fault_losses_apart"] = len(fault["losses_apart"])
        ok = not rec["losses_apart"] and rec["weights_reach"] <= 1
    else:
        ok = not rec["losses_apart"] and not rec["state_apart"]
    print(f"captured vs eager ({label}), {len(batches)} steps: "
          f"{json.dumps(rec)}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the captured step is not the eager "
                             f"one: {rec}")
    if not (rec["fault_losses_apart"] and rec["fault_state_apart"]):
        raise AssertionError(f"{label}: the planted fault went unseen")
    return rec


def adam_reach(t, betas=(0.9, 0.999)):
    """The most Adam's update at step ``t`` can move a weight, in units of
    the learning rate, whatever the gradients: |m_hat| / sqrt(v_hat) by
    Cauchy-Schwarz over the ``t`` gradients (1 at t = 1, under 1.02 up to
    t = 6)."""
    b1, b2 = betas
    return (math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
            * (1 - b1) / math.sqrt(1 - b2)
            * math.sqrt(sum((b1 * b1 / b2) ** k for k in range(t))))


def stepwise_vs_eager(dev, batches, kwargs):
    """Each step of a captured run (``compared_run``'s start) against one
    eager step from the state that step started in (weights, statistics,
    Adam's state, the generator's).  Returns the losses that are not
    byte-equal (the forward has no atomics, so none may be) and the
    largest weight difference over what two Adam updates can differ by
    plus two float32 roundings of the weight (``weights_reach``, at most 1
    however the gradients' rounding differs: Adam makes a gradient of
    rounding alone a whole update)."""
    def fresh():
        model = PretrainModel(9, hidden=64, d_transfer=32, num_heads=HEADS,
                              **kwargs)
        init_flax_style_(model, torch.Generator().manual_seed(11))
        model.to(dev)
        return model, adam_l2(model, LR, 5e-5)
    (model, opt), (ref, ref_opt) = fresh(), fresh()
    gen = torch.Generator(device=dev).manual_seed(12)
    ref_gen = torch.Generator(device=dev)
    step = make_pretrain_step(model, opt)
    apart, reach = [], 0.0
    ulp = torch.finfo(torch.float32).eps
    for i, (g, s) in enumerate(batches):
        ref.load_state_dict(model.state_dict())
        # a copy: load_state_dict keeps the state tensors it is given
        ref_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
        ref_gen.set_state(gen.get_state())
        want = pretrain_step_eager(ref, ref_opt, g, s, ref_gen)
        got = step(g, s, gen)
        apart += [f"step {i} {name}" for name, a, b in zip(
            ("kl", "contrastive", "recon"), want, got)
            if a.cpu().numpy().tobytes() != b.cpu().numpy().tobytes()]
        bound = 2 * adam_reach(i + 1) * LR
        with torch.no_grad():
            reach = max([reach] + [float(
                ((a - b).abs() / (bound + 2 * ulp * torch.maximum(
                    a.abs(), b.abs()))).max())
                for a, b in zip(ref.parameters(), model.parameters())])
    torch.cuda.synchronize()
    return {"losses_apart": apart, "weights_reach": reach}


def bench_batches(dev, ds, caps, n=STEPS):
    return [(g.to(dev), s.to(dev)) for g, s in itertools.islice(
        batch_iterator(ds, 128, caps, seed=7), n)]


def captured_phase(dev, ds, caps):
    """Phase 5 (a): the captured step against the eager one."""
    batches = bench_batches(dev, ds, caps)
    report = {}
    with deterministic():
        for label, (kwargs, per_step) in COMPARED.items():
            report[label] = captured_vs_eager(dev, batches, label, kwargs,
                                              per_step)
        # the scan step: two calls of SCAN_INNER steps on one batch, the
        # second one graph launch for all of them
        first = [batches[0]] * STEPS
        eager = compared_run(dev, first, {}, "eager")
        scan = compared_run(dev, first, {}, "scan")
        rec = {"losses_apart": bytes_apart(eager[0], scan[0]),
               "state_apart": bytes_apart(eager[1], scan[1]),
               "launches": {k: n for k, n in scan[2].items() if n}}
        print(f"scan step, {STEPS // SCAN_INNER} calls of {SCAN_INNER} vs "
              f"{STEPS} eager steps (GIN): {json.dumps(rec)}", flush=True)
        want = {k: n * STEPS for k, n in GIN_PER_STEP.items()}
        if rec["losses_apart"] or rec["state_apart"] or \
                rec["launches"] != want:
            raise AssertionError(f"the scan step is not {STEPS} eager "
                                 f"steps: {rec}")
        report["GIN scan"] = rec
    return report


def merged_apart(eager, captured):
    """The largest relative loss difference and weight difference (in
    units of the learning rate) between two runs."""
    (l1, _, _, (m1, _)), (l2, _, _, (m2, _)) = eager, captured
    loss = max(abs(float(np.frombuffer(l1[k], np.float32)[0])
                   - float(np.frombuffer(l2[k], np.float32)[0]))
               / abs(float(np.frombuffer(l1[k], np.float32)[0]))
               for k in l1)
    weights = max(float((a - b).detach().abs().max()) for a, b in
                  zip(m1.parameters(), m2.parameters())) / LR
    return {"loss_rel": loss, "weights_lr": weights}


def skewed_batch():
    """11 dense graphs of 12 nodes (each pair joined with probability 0.8,
    so a 1-hop ego-net holds about 10 rows) and 50 small molecules at N =
    512, S = 2048: the first tile of 128 centers owns about 1250 ego-net
    rows, more than the pooling window's 1024.  (Not complete graphs: a
    GIN conv makes every node of a complete graph equal, and the KL's
    division by a per-graph std of 0 then turns float32 rounding into the
    loss.)"""
    rng = np.random.default_rng(3)
    graphs = []
    for _ in range(11):
        upper = np.triu(rng.random((12, 12)) < 0.8, 1)
        s, r = np.nonzero(upper | upper.T)
        graphs.append(GraphData(
            senders=s.astype(np.int32), receivers=r.astype(np.int32),
            node_feat=rng.normal(size=(12, 9)).astype(np.float32)))
    graphs += random_dataset(50, seed=4, min_nodes=4, max_nodes=6)
    egos = [extract_egonets(x, 1) for x in graphs]
    return (pack_graphs(graphs, 512, 2048, 64),
            pack_subgraphs(graphs, egos, 2048, 16384, num_centers=512))


def skewed_phase(dev):
    """Phase 5 (b): the skewed batch through the captured step (eager
    first, then replays): the pooling's scatter branch inside the graph,
    and each replay's losses within MODEL_RTOL of the float64 CPU model
    (the state before that step)."""
    g, sub = (b.to(dev) for b in skewed_batch())
    if sub.pool_fits is not False:
        raise AssertionError("the skewed batch fits the pooling window")
    model = PretrainModel(9, hidden=64, d_transfer=32, deterministic=True)
    init_flax_style_(model, torch.Generator().manual_seed(5))
    model.to(dev)
    step = make_pretrain_step(model, adam_l2(model, 1e-4, 5e-5))
    reset_launch_counts()
    counters.reset("pool")
    worst = 0.0
    for i in range(3):
        ref = copy.deepcopy(model).to("cpu", torch.float64).train()
        g64, sub64 = g.to("cpu"), sub.to("cpu")
        g64.node_feat = g64.node_feat.double()
        before = counters.snapshot()
        with torch.no_grad():
            want = [float(v) for v in ref(g64, sub64)]
        after = counters.snapshot()          # the reference's branches
        counters.add({k: n - before.get(k, 0)
                      for k, n in after.items()}, -1)
        got = [float(v) for v in step(g, sub)]
        if i:
            worst = max(worst, max(abs(a - b) / abs(b)
                                   for a, b in zip(got, want)))
    counts = launch_counts()
    branches = counters.of("pool")
    rec = {"replay_loss_rel": worst, "pool_branches": branches,
           "pool_launches": counts["pool"], "graphs": len(step.graphs)}
    print(f"skewed batch, captured: {json.dumps(rec)} (tol {MODEL_RTOL})",
          flush=True)
    if not (worst <= MODEL_RTOL and branches == {"scatter": 3}
            and counts["pool"] == 0 and len(step.graphs) == 1):
        raise AssertionError(f"skewed batch: {rec}")
    return rec


def medians_phase(encoder_names=("GIN", "Transformer")):
    """Phase 5 (c): step medians (steps 1-5 of 6) of the eager and the
    captured step, eager / captured / captured / eager, for each
    encoder."""
    out = {}
    for encoder in encoder_names:
        runs = []
        for eager in (True, False, False, True):
            with (eager_steps() if eager else contextlib.nullcontext()):
                recs = run_pretrain(synthetic=1024, batch_size=128,
                                    steps=STEPS, lr=1e-4, weight_decay=5e-5,
                                    device="cuda", encoder=encoder,
                                    log=lambda _: None)
            runs.append(("eager" if eager else "captured",
                         statistics.median(r["ms"] for r in recs[1:])))
        out[encoder] = runs
        print(f"step medians ({encoder}), ms: {runs}", flush=True)
    return out


# --- 15. the GIN layer's BatchNorm -> ReLU -> row mask ----------------------

@contextlib.contextmanager
def composed_bn_tail():
    """Within: ``MaskedBatchNorm.normalize_relu`` takes its composed ops on
    the card too (the tail before the kernels), for a comparison."""
    real = kbn.on_card
    kbn.on_card = lambda name, x: name != "masked_bn_relu" and real(name, x)
    try:
        yield
    finally:
        kbn.on_card = real


def bn_launches(dev):
    """The four kernels' launches: 3 GIN pretraining steps, 2 Transformer
    steps, one captured fine-tuning step and one evaluation batch (GIN),
    each from counts of 0."""
    out = {}
    for label, kwargs, steps in (("GIN", {}, 3),
                                 ("Transformer", {"encoder": "Transformer"},
                                  2)):
        counters.reset("launch")
        run_pretrain(synthetic=1024, batch_size=128, steps=steps, lr=1e-4,
                     weight_decay=5e-5, device="cuda", log=lambda _: None,
                     **kwargs)
        torch.cuda.synchronize()
        out[f"{label} pretraining, {steps} steps"] = counters.of(
            "launch", kbn.KERNELS)
        want = BN_PER_STEP * steps if label == "GIN" else 0
        if out[f"{label} pretraining, {steps} steps"] != dict.fromkeys(
                kbn.KERNELS, want):
            raise AssertionError(f"BatchNorm kernels in {label} steps: "
                                 f"{out}, expected {want} each")
    _, _, batches = bace(dev, 3)
    model, opt = ft_model(dev, {})
    step = make_finetune_step(model, opt, "bce")
    gen = torch.Generator(device=dev).manual_seed(1)
    step(*batches[0], gen)                    # eager warm-up, capture
    counters.reset("launch")
    step(*batches[1], gen)
    torch.cuda.synchronize()
    out["finetune step"] = counters.of("launch", kbn.KERNELS)
    counters.reset("launch")
    make_eval_fn(model)(*fresh(batches[2], dev), gen)
    torch.cuda.synchronize()
    out["eval batch"] = counters.of("launch", kbn.KERNELS)
    if out["eval batch"] != {"bn_stats": 0, "bn_apply": BN_PER_STEP,
                             "bn_grad_stats": 0, "bn_grad_apply": 0}:
        raise AssertionError(f"BatchNorm kernels in an eval batch: {out}")
    return out


def bn_phase(g, sub, dev):
    """Phase 15: the four kernels at the benchmark batch's shapes, their
    launches, and the captured GIN step with and without them."""
    gen = torch.Generator(device=dev).manual_seed(15)
    records = []
    f = 64
    for label, batch in (("N", g), ("S", sub)):
        n, mask = batch.num_nodes, batch.node_mask
        x = 1.5 + torch.randn(n, f, device=dev, generator=gen)
        dy = torch.randn(n, f, device=dev, generator=gen)
        scale = 1 + 0.3 * torch.randn(f, device=dev, generator=gen)
        bias = 0.2 * torch.randn(f, device=dev, generator=gen)
        run = (torch.zeros(f, device=dev), torch.ones(f, device=dev))
        totals = kbn.bn_stats(x, mask)
        _, stats = kbn.bn_apply(x, mask, totals, scale, bias, *run)
        terms = kbn.bn_grad_stats(dy, x, mask, stats, totals, scale)[2]
        rows, shape = n * f * 4, f"{label}={n} d={f}"
        small = nbytes(scale, bias, *run)
        cases = (
            ("bn_stats", lambda: kbn.bn_stats(x, mask),
             lambda: kbn.bn_stats_plain(x, mask),
             rows + n + totals.numel() * 8),
            ("bn_apply",
             lambda: kbn.bn_apply(x, mask, totals, scale, bias, *run),
             lambda: kbn.bn_apply_plain(x, mask, totals, scale, bias, *run),
             2 * rows + n + totals.numel() * 8 + small + stats.numel() * 4),
            ("bn_grad_stats",
             lambda: kbn.bn_grad_stats(dy, x, mask, stats, totals, scale),
             lambda: kbn.bn_grad_stats_plain(dy, x, mask, stats, totals,
                                             scale),
             2 * rows + n + nbytes(stats) + small + 4 * f * 4),
            ("bn_grad_apply",
             lambda: kbn.bn_grad_apply(dy, x, mask, stats, terms),
             lambda: kbn.bn_grad_apply_plain(dy, x, mask, stats, terms),
             3 * rows + n + nbytes(stats, terms)))
        for name, kernel_fn, plain_fn, nbyt in cases:
            rec = check(name, shape, kernel_fn, plain_fn, nbyt, 0)
            rec["resources"] = kbn.kernel_info(name, n, f)
            rec["library_note"] = ("no single PyTorch call computes it: "
                                   "BatchNorm over the rows a mask keeps, "
                                   "one-pass moments, then relu and the "
                                   "row mask")
            records.append(rec)
    launches = bn_launches(dev)
    profiles = []
    for tail in ("composed", "kernels", "kernels", "composed"):
        with (composed_bn_tail() if tail == "composed"
              else contextlib.nullcontext()):
            prof = profile_phase("GIN")
        profiles.append({
            "tail": tail, "device_ms_per_step": prof["device_ms_per_step"],
            "device_kernels_per_step": prof["device_kernels_per_step"],
            "wall_ms_per_step": prof["wall_ms_per_step"],
            "in_step": {k: prof["port"].get(v) for k, v in BN_PATH.items()}})
    report = {"records": records, "launches": launches, "profiles": profiles}
    print(f"phase 15: {json.dumps(report)}", flush=True)
    return report


PEPTIDE_ATOMS = (120, 182)   # LRGB Peptides-func's sizes (150.9 atoms)
PEPTIDE_K = 3                # ego-nets of 3 hops
# the wide bands' widths: molecules of up to 182 atoms, ego-nets of up to
# 128 nodes (graph/banded.py::band_width)
PEPTIDE_WIDTHS = (512, 384)
WIDE_STEPS = 8               # timed steps of each path


def peptide_batches(dev, n=3, seed=21):
    """``n`` batches of 128 Peptides-sized molecules with 3-hop ego-nets,
    as the benchmark's wide-band cell packs them."""
    ds = GraphDataset(random_dataset(128 * n, seed=seed,
                                     min_nodes=PEPTIDE_ATOMS[0],
                                     max_nodes=PEPTIDE_ATOMS[1]),
                      k=PEPTIDE_K)
    caps = plan_capacities(ds, 128)
    return [(g.to(dev), sub.to(dev)) for g, sub in
            batch_iterator(ds, 128, caps, shuffle=False)], caps


BRANCHES = ("encoder", "pool", "recon", "gin_bwd")


def _branches():
    return {kind: counters.of(kind) for kind in BRANCHES}


def _clear_branches():
    counters.reset(*BRANCHES)


def step_bwd_tiles(g, sub, hid=64, d_transfer=32, layers=4):
    """``gin_bwd``'s row tiles and overlapped tiles in one GIN pretraining
    step on (g, sub): ``layers`` convs on each batch's rows, the first from
    ``d_transfer`` features, on this card's grid."""
    tiles = overlapped = 0
    for n in (g.num_nodes, sub.num_nodes):
        for din in [d_transfer] + [hid] * (layers - 1):
            t, o = kb.bwd_tiles(n, din, hid, hid,
                                kb._bwd_grid(n, din, hid, hid, 0))
            tiles, overlapped = tiles + t, overlapped + o
    return {"tiles": tiles, "overlapped": overlapped}


def wide_step_ms(dev, batches, coo):
    """The captured GIN pretraining step on ``batches`` (the COO path
    where ``coo``: every batch's band offsets dropped): the launches and
    branches of one replay, and the median host ms of ``WIDE_STEPS``
    steps, each to its loss read."""
    if coo:
        batches = [(dataclasses.replace(g, band_col_off=None),
                    dataclasses.replace(sub, band_col_off=None))
                   for g, sub in batches]
    torch.manual_seed(16)
    model = PretrainModel(9, 64, 32, k_transition=PEPTIDE_K).to(dev)
    opt = adam_l2(model, 1e-4, 5e-5)
    step = make_pretrain_step(model, opt)
    gen = torch.Generator(device=dev).manual_seed(16)
    for g, sub in batches:                    # eager warm-up, captures
        float(step(g, sub, gen).total)
    reset_launch_counts()
    counters.reset("blocks")
    _clear_branches()
    float(step(*batches[0], gen).total)
    launches = {k: v for k, v in launch_counts().items() if v}
    branches = _branches()
    builds = {"launches": counters.of("launch", [kb.BLOCKS])[kb.BLOCKS],
              **counters.of("blocks")}
    times = []
    for i in range(WIDE_STEPS):
        t0 = time.perf_counter()
        float(step(*batches[i % len(batches)], gen).total)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"launches": launches, "branches": branches, "builds": builds,
            "step_ms": statistics.median(times), "steps_ms": times}


def blocks_torch_bf16(rows, src, mask, off, n_tiles, tile, width):
    """The blocks by PyTorch alone in bf16: ``kb.blocks_plain`` with its
    float32 zeros and ones in bf16 and no cast (exact for counts up to
    256): the control that the blocks kernel is timed beside."""
    size = n_tiles * tile * width
    t_idx = rows // tile
    cols = src if src is not None else torch.arange(rows.shape[0],
                                                    device=rows.device)
    col = cols - off[t_idx.clamp(0, n_tiles - 1)]
    keep = (rows >= 0) & (t_idx < n_tiles) & (col >= 0) & (col < width)
    if mask is not None:
        keep = keep & mask
    lin = torch.where(keep, rows * width + col, torch.full_like(rows, size))
    flat = torch.zeros(size + 1, dtype=torch.bfloat16, device=rows.device)
    flat.index_add_(0, lin, torch.ones(lin.shape, dtype=torch.bfloat16,
                                       device=rows.device))
    return flat[:size].view(n_tiles, tile, width)


def zero_pass(out):
    """``blocks_zero_kernel`` alone over ``out`` (a build of no items)."""
    n_tiles, tile, width = out.shape
    kbuild.raise_on(kb.build().scgib_blocks(
        None, None, None, None, 0, n_tiles, tile, width, kbuild.ptr(out),
        kbuild.stream()), "blocks")


def band_build(b, tile=TILE, width=None, align=None):
    """``kb.blocks``' arguments for batch ``b``'s band: its own offsets and
    width, or the geometry (``tile``, ``width``, ``align``) given."""
    n = b.node_mask.shape[0]
    off = (b.band_col_off if width is None else
           device_col_off(n, tile, width, align, b.receivers.device))
    return (b.receivers, b.senders, b.edge_mask, off, n // tile, tile,
            width or b.band_width)


def pool_build(g, sub):
    """``kb.blocks``' arguments for the pooling blocks of (g, sub), as
    ``ops/pool.py::pool_blocks`` passes them."""
    n_seg, s_rows = g.num_nodes, sub.num_nodes
    window = pool_mod.default_window(s_rows, n_seg)
    poff = pool_mod.window_offsets(sub.node_center, sub.node_mask, n_seg,
                                   TILE, window)
    cc = torch.where(sub.node_mask, sub.node_center, torch.full_like(
        sub.node_center, n_seg)).clamp_max(n_seg - 1)
    return (cc, None, sub.node_mask, poff, n_seg // TILE, TILE, window)


def build_records(g, sub, bench=None):
    """Phase 16 (f): the blocks kernel (``kb.blocks``: a zero pass, then a
    scatter of bf16 counts) alone on the peptide batch's atom band, ego-net
    band and pooling blocks, and on ``bench``'s (the benchmark batch: W 256,
    and its two bands in the graph transformer's narrow geometry), against
    the plain route on the same indices (float32 zeros, ``index_add_`` of
    ones, the cast to bf16): bitwise equal, each timed (``time_ms``) beside
    the plain route and PyTorch's bf16 route (``blocks_torch_bf16``), the
    zero pass alone beside ``torch.zeros`` in bf16, with the bound of the
    bytes the kernel writes at HBM_BYTES_PER_S and its two kernels'
    registers."""
    builds = {("peptides", "atom band"): band_build(g),
              ("peptides", "ego-net band"): band_build(sub),
              ("peptides", "pool"): pool_build(g, sub)}
    if bench is not None:
        bg, bsub = bench
        builds.update({
            ("bench", "atom band"): band_build(bg),
            ("bench", "ego-net band"): band_build(bsub),
            ("bench", "pool"): pool_build(bg, bsub),
            ("bench", "GT atom band"): band_build(bg, GT_TILE, GT_BAND,
                                                  GT_ALIGN),
            ("bench", "GT ego-net band"): band_build(bsub, GT_TILE, GT_BAND,
                                                     GT_ALIGN)})
    registers = {name: rec["registers"] for name, rec in
                 kbuild.ptxas_report("banded").items()
                 for kernel in ("blocks_zero_kernel", "blocks_scatter_kernel")
                 if kernel in name}
    records = []
    for (batch, label), args in builds.items():
        got, want = kb.blocks(*args), kb.blocks_plain(*args)
        bf16 = blocks_torch_bf16(*args)
        torch.cuda.synchronize()
        rec = {"batch": batch, "build": label, "shape": list(got.shape),
               "items": int(args[0].shape[0]), "entries": got.numel(),
               "bitwise_equal_plain": torch.equal(got, want),
               "torch_bf16_bitwise_equal_plain": torch.equal(bf16, want),
               "ms": time_ms(lambda: kb.blocks(*args)),
               "plain_ms": time_ms(lambda: kb.blocks_plain(*args)),
               "torch_bf16_ms": time_ms(lambda: blocks_torch_bf16(*args)),
               "zero_ms": time_ms(lambda: zero_pass(got)),
               "torch_zeros_ms": time_ms(lambda: torch.zeros(
                   got.shape, dtype=torch.bfloat16, device=got.device)),
               "bound_ms": 2 * got.numel() / HBM_BYTES_PER_S * 1e3,
               "registers": registers}
        print(f"blocks {batch} {label}: {json.dumps(rec)}", flush=True)
        if not rec["bitwise_equal_plain"]:
            raise AssertionError(f"blocks {batch} {label}: {rec}")
        records.append(rec)
    return records


def other_banded(root):
    """The banded kernels of another checkout at ``root``: its
    ``scgib_tpu_torch/csrc/banded.cu`` built with nvcc into this one's
    ``_build/`` and bound as ``kb.build`` binds this one's."""
    src = os.path.join(root, "scgib_tpu_torch", "csrc", "banded.cu")
    so = kbuild.BUILD_DIR / "libscgib_banded_other.so"
    kbuild.BUILD_DIR.mkdir(exist_ok=True)
    subprocess.run(kbuild.nvcc_command(src, so), check=True,
                   capture_output=True, text=True)
    return kb.bind(ctypes.CDLL(str(so)))


@contextlib.contextmanager
def banded_library(lib):
    """Within: ``kb``'s wrappers launch ``lib``'s kernels."""
    saved = kb.build()
    kbuild._bound["banded"] = lib
    kb._bwd_grid.cache_clear()
    try:
        yield
    finally:
        kbuild._bound["banded"] = saved
        kb._bwd_grid.cache_clear()


def bwd_in_turns(label, batch, dev, gen, other=None, hid=64):
    """``gin_bwd`` on the batch's band at d = 32 and 64 on exact integer
    inputs (``band_records(..., width=True)``'s): against its plain
    version, bitwise equal in two runs, the launch's row tiles and the
    overlapped ones as the tally counts them, the kernel's resources
    (rows a tile and shared bytes as ``kb.bwd_tile_rows`` and
    ``kb.bwd_smem_bytes`` give them), and its time; with ``other``
    (``other_banded``), that library's kernel timed in turns (this, other,
    other, this) and its output compared bitwise with this one's."""
    blocks, col_off = _resolve_band(batch)
    n = blocks.shape[0] * blocks.shape[1]
    records = []
    for d in (32, 64):
        def ints(lo, hi, *shape):
            return torch.randint(lo, hi, shape, device=dev,
                                 generator=gen).float()
        h, w1 = ints(-3, 4, n, d), ints(-2, 3, d, hid)
        b1 = ints(-4, 4, hid) + 0.5
        w2 = torch.randn(hid, hid, device=dev, generator=gen) / 8.0
        gr = torch.randn(n, hid, device=dev, generator=gen)

        def run():
            return kb.gin_bwd(blocks, col_off, h, gr, w1, b1, w2)
        counters.reset("gin_bwd")
        got, again = run(), run()
        want = kb.gin_bwd_plain(blocks, col_off, h, gr, w1, b1, w2)
        torch.cuda.synchronize()
        grid = kb._bwd_grid(n, d, hid, hid, h.device.index)
        tiles, overlapped = kb.bwd_tiles(n, d, hid, hid, grid)
        rec = {"shape": f"{label}={n} W={blocks.shape[2]} d={d}",
               "max_rel_err": max(rel_err(a, b)[1]
                                  for a, b in zip(got, want)),
               "bitwise_in_two_runs": all(torch.equal(a, b)
                                          for a, b in zip(got, again)),
               "grid": grid, "tiles": tiles, "overlapped": overlapped,
               "counted": counters.of("gin_bwd"),
               "resources": kb.kernel_info("gin_fused_bwd", d, hid, hid)}
        if other is None:
            rec["ms"] = [time_ms(run)]
        else:
            rec["ms"], rec["other_ms"] = [], []
            for mine in (True, False, False, True):
                with contextlib.ExitStack() as stack:
                    if not mine:
                        stack.enter_context(banded_library(other))
                    (rec["ms"] if mine else rec["other_ms"]).append(
                        time_ms(run))
            with banded_library(other):
                theirs = run()
            torch.cuda.synchronize()
            rec["bitwise_equal_other"] = all(
                torch.equal(a, b) for a, b in zip(got, theirs))
        print(f"gin_bwd {rec['shape']}: {json.dumps(rec)}", flush=True)
        res = rec["resources"]
        if not (rec["max_rel_err"] <= KERNEL_RTOL
                and rec["bitwise_in_two_runs"]
                and rec["counted"] == {"tiles": 2 * tiles,
                                       "overlapped": 2 * overlapped}
                and res["tile_rows"] == kb.bwd_tile_rows(d, hid, hid)
                and res["smem_bytes"] == kb.bwd_smem_bytes(d, hid, hid)):
            raise AssertionError(f"gin_bwd {rec['shape']}: {rec}")
        records.append(rec)
    return records


def wide_band_phase(dev, bench=None, other=None):
    """Phase 16: S-CGIB at Peptides-func sizes (the generator's molecules)
    on the wide bands.  (a) the batch's widths, 512 for the atoms and 384
    for the 3-hop ego-nets, with every edge kept in its window; (b)
    ``gin_fwd``, ``gin_bwd``, ``spmm_self`` and ``spmm`` at those bands and
    the batch's rows on exact integer inputs, ``gin_fwd`` and ``gin_bwd``
    on positive random ones beside a TF32 control, and the pooling,
    against their plain versions and timed; (c) the captured
    GIN step's launches and branches a replay (the fused convs 8 times
    each, the reconstruction and the pooling on their bands, no COO
    aggregation, the backward's row tiles and overlapped tiles as
    ``step_bwd_tiles`` counts them) and its host ms to the loss read,
    against the same step
    with the bands dropped (the COO path) in turns, and the block builds
    of a replay (3, and the entries of (f)'s three); (d) the benchmark
    batch ``bench`` keeps the band of 256; (e) ``gin_bwd`` at S of
    ``bench`` and N and S of the peptide batch (``bwd_in_turns``), in turns
    with ``other``'s kernel where given; (f) the block builds alone
    (``build_records``)."""
    report = {}
    batches, caps = peptide_batches(dev)
    g, sub = batches[0]
    report["batch"] = {"caps": dataclasses.asdict(caps),
                       "band_widths": [g.band_width, sub.band_width]}
    if (g.band_width, sub.band_width) != PEPTIDE_WIDTHS or \
            g.band_col_off is None or sub.band_col_off is None:
        raise AssertionError(f"peptide batch bands {report['batch']}, "
                             f"expected {PEPTIDE_WIDTHS}, both banded")
    for b in (g, sub):
        kept = float(_resolve_band(b)[0].float().sum())
        real = int(b.edge_mask.sum())
        if kept != real:
            raise AssertionError(f"the band at W={b.band_width} kept "
                                 f"{kept} of {real} edges")
    print(f"peptide batch: N={g.num_nodes} E={g.num_edges} "
          f"S={sub.num_nodes} Q={sub.num_edges} widths "
          f"{g.band_width} {sub.band_width}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(16)
    records = []
    for label, batch in (("N", g), ("S", sub)):
        records += band_records(label, batch, dev, gen, width=True)
        for d in (32, 64):
            records += random_product_records(label, batch, dev, gen, d=d)
    records.append(pool_record(g, sub, dev, gen))
    report["records"] = records
    report["bwd_in_turns"] = sum(
        (bwd_in_turns(label, batch, dev, gen, other) for label, batch in
         ((("S bench", bench[1]),) if bench is not None else ())
         + (("N", g), ("S", sub))), [])
    report["builds"] = build_records(g, sub, bench)
    torch.cuda.empty_cache()
    runs = {}
    for path in ("banded", "coo", "coo", "banded"):
        rec = wide_step_ms(dev, batches, path == "coo")
        runs.setdefault(path, []).append(rec)
        torch.cuda.empty_cache()
    band = runs["banded"][0]
    want = {"encoder": {"band": 8}, "pool": {"banded": 1},
            "recon": {"band": 1}, "gin_bwd": step_bwd_tiles(g, sub)}
    # the atom band (the encoder's and the reconstruction's), the ego-net
    # band and the pooling blocks: one build each a replay
    builds = {"launches": 3, "entries": sum(
        r["entries"] for r in report["builds"] if r["batch"] == "peptides")}
    if band["launches"] != GIN_PER_STEP or band["branches"] != want \
            or band["builds"] != builds:
        raise AssertionError(f"a wide-band replay: {band}, expected "
                             f"launches {GIN_PER_STEP}, branches {want}, "
                             f"builds {builds}")
    report["steps"] = runs
    if bench is not None:
        report["bench_band_widths"] = [b.band_width for b in bench]
        if report["bench_band_widths"] != [256, 256]:
            raise AssertionError(f"the benchmark batch's bands: "
                                 f"{report['bench_band_widths']}")
    print(f"phase 16: {json.dumps(report)}", flush=True)
    return report


def against():
    """The banded kernels of the checkout that ``--against DIR`` names, or
    None."""
    if "--against" not in sys.argv:
        return None
    return other_banded(sys.argv[sys.argv.index("--against") + 1])


def wide_bands_only():
    """``python3 chip_smoke.py --wide-bands [--against DIR]``: the build and
    phase 16 alone."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | nvidia-smi: {smi_line()}", flush=True)
    t0 = time.perf_counter()
    kb.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    ds = GraphDataset(random_dataset(1024, seed=7, min_nodes=10,
                                     max_nodes=30), k=1)
    bench = tuple(b.to(dev) for b in next(batch_iterator(
        ds, 128, plan_capacities(ds, 128), shuffle=False)))
    t0 = time.perf_counter()
    wide_band_phase(dev, bench, against())
    print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True}), flush=True)


def main():
    # 1. environment
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvidia-smi: {smi}", flush=True)

    phase_s = {}
    clock = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        phase_s[phase] = now - clock[0]
        clock[0] = now
        print(f"phase {phase}: {phase_s[phase]:.1f} s", flush=True)

    # 2. build; the attention's registers and spills
    kbuild.load(*sorted({src for src, _, _ in PATH.values()}))
    kb.build()
    kg.build()
    ptxas = attention_ptxas()
    lap("2 build")
    for name, log in kbuild.logs.items():
        print(f"nvcc {name}.cu:\n{log}", flush=True)

    # 3. kernels against their plain versions at benchmark shapes
    ds = GraphDataset(random_dataset(1024, seed=7, min_nodes=10,
                                     max_nodes=30), k=1)
    caps = plan_capacities(ds, 128)
    g, sub = next(batch_iterator(ds, 128, caps, shuffle=False))
    g, sub = g.to(dev), sub.to(dev)
    print(f"benchmark batch: N={g.num_nodes} E={g.num_edges} "
          f"S={sub.num_nodes} Q={sub.num_edges} gt_fits {g.gt_fits} "
          f"{sub.gt_fits}", flush=True)
    if not (g.gt_fits and sub.gt_fits):
        raise AssertionError("benchmark batch does not fit the narrow "
                             "attention geometry")
    records = kernel_phase(g, sub, dev)
    served = served_phase(sub, dev, torch.Generator(device=dev).manual_seed(1))
    lap("3 kernels")

    # 4. full model, card vs CPU
    for encoder in ("GIN", "Transformer"):
        model_phase(g, sub, dev, encoder)
    lap("4 model")

    # 5. main paths, captured; the captured step against the eager one
    runs = {name: main_path(name, *spec) for name, spec in RUNS.items()
            if name not in SPMM_ENCODERS}
    compiled = {"captured_vs_eager": captured_phase(dev, ds, caps),
                "skewed": skewed_phase(dev), "medians": medians_phase()}
    lap("5 main paths")

    # 6. the pretrain verb, its options and the repaired widths
    verb = verb_phase(g, sub, dev, ds, caps)
    lap("6 verb, options, widths")

    # 7. where the step time goes
    profiles = {f"{encoder} {path}": profile_phase(encoder,
                                                   path == "eager")
                for encoder in ("GIN", "Transformer")
                for path in ("captured", "eager")}
    lap("7 profile")

    # 8. the supervised path
    supervised = supervised_phase(dev)
    lap("8 supervised")

    # 9. GCN and GraphSAGE, dense ego-nets, the captured evaluation, the
    # reference import
    slice9 = slice_phase(g, sub, dev, ds, caps, runs, records, supervised)
    lap("9 encoders, dense, evaluation, import")

    # 10. the data path
    data, data_runs = data_phase(dev, ds, caps)
    lap("10 data path")

    # 11. data parallel and remat
    dp_remat, dp_runs = dp_remat_phase(dev, ds, caps, g, sub)
    lap("11 data parallel, remat")

    # 12. node-sharded pretraining
    sharded, shard_runs = shard_phase(dev, ds, caps)
    lap("12 node-sharded pretraining")

    # 13. the bf16 compute modes
    bf16, bf16_records, bf16_runs = bf16_phase(g, sub, dev, ds, caps)
    records += bf16_records
    runs.update(bf16_runs)
    lap("13 bf16 compute modes")

    # 14. the JAX package's TPU-default Transformer
    tpu_default, tpu_records, tpu_runs = tpu_default_phase(g, sub, dev, ds,
                                                           caps)
    records += tpu_records
    runs.update(tpu_runs)
    lap("14 TPU-default Transformer")

    # 15. the BatchNorm tail's kernels
    batchnorm = bn_phase(g, sub, dev)
    lap("15 BatchNorm tail")

    # 16. the wide bands (Peptides-func sizes)
    wide = wide_band_phase(dev, (g, sub), against())
    lap("16 wide bands")

    # 17. report
    kernels = []
    for name, (src, line, port_kernel) in PATH.items():
        recs = [r for r in records if r["name"] == name]
        widest = max((r for r in recs if r.get("main", True)),
                     key=lambda r: r["bound_ms"])
        run = REPORT_RUN.get(name, "GIN")
        sup = supervised["steps"]["GIN" if run.startswith("GIN")
                                  else "Transformer"]
        # a wrapper with two routes: each route's CUDA kernel (staged, then
        # lane-group), its launches in the reporting run, the shapes held
        names = port_kernel.split()
        routes = {route: {
            "port_kernel": f"scgib_tpu_torch/csrc/{src}.cu::{kernel}",
            "launches": runs[run]["routes"].get(f"{name} {route}", 0),
            "shapes": [r["shape"] for r in recs
                       if r.get("kernel_route") == route]}
            for route, kernel in zip(kg.ROUTES, names)} \
            if len(names) > 1 else None
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"scgib_tpu_torch/csrc/{src}.cu",
            "replaces": f"scgib_tpu/ops/pallas/{src}.py:{line}",
            "status": "ported",
            "port_kernel": f"scgib_tpu_torch/csrc/{src}.cu::{names[0]}",
            "kernel_routes": routes,
            "launches": runs[run]["counts"][name], "launches_run": run,
            "launches_by_run": {
                **{r: runs[r]["counts"][name] for r in runs},
                **{r: c[name] for r, c in data_runs.items()},
                **{r: c.get(name, 0) for r, c in dp_runs.items()},
                **{r: c.get(name, 0) for r, c in shard_runs.items()}},
            "finetune_step_launches": sup["finetune_step_launches"].get(
                name, 0),
            "eval_batch_launches": sup["eval_batch_launches"].get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": widest["ms"], "plain_ms": widest["plain_ms"],
            "bound_ms": widest["bound_ms"], "bound_by": widest["bound_by"],
            "library_ms": widest["library_ms"],
            "library_note": widest.get("library_note"),
            "shape": widest["shape"],
            "configs": recs})
    print(json.dumps({"kernels": kernels,
                      "step_ms": {k: r["step_ms"] for k, r in runs.items()},
                      "steps": {k: r["steps"] for k, r in runs.items()},
                      "verb": verb, "compiled": compiled,
                      "supervised": supervised, "slice9": slice9,
                      "data": data, "dp_remat": dp_remat,
                      "sharded": sharded, "bf16": bf16,
                      "tpu_default": tpu_default,
                      "batchnorm": batchnorm, "wide_bands": wide,
                      "attention_ptxas": ptxas,
                      "wide_heads": served,
                      "profile": profiles,
                      "phase_s": phase_s}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def main_path(name, kwargs, steps, per_step, band=None):
    """One main-path run: every launch count set to 0, ``run_pretrain`` at
    full width, the counts read; each must be its per-step count times
    the steps (0 for the wrappers not in ``per_step``), the block builds
    the encoder's ``BUILDS_PER_STEP`` times the steps, and every conv or
    attention must take the ``band`` branch (by default the fused GIN
    layer's, or the narrow attention's)."""
    reset_launch_counts()
    counters.reset("pool", "encoder")
    records = run_pretrain(synthetic=1024, batch_size=128, steps=steps,
                           lr=1e-4, weight_decay=5e-5, device="cuda",
                           **kwargs)
    torch.cuda.synchronize()
    counts = launch_counts()
    branches = (counters.of("pool"), counters.of("encoder"))
    for rec in records:
        for key in ("kl", "contrastive", "reconstruction"):
            if not math.isfinite(rec[key]):
                raise AssertionError(f"{name} step {rec['step']}: {key} "
                                     "not finite")
    step_ms = statistics.median(r["ms"] for r in records[1:])
    print(f"main path {name}: {steps} steps, median {step_ms:.2f} ms/step "
          f"after warm-up; launches {counts}; branches {branches}",
          flush=True)
    for kernel in PATH:
        want = per_step.get(kernel, 0) * steps
        if counts[kernel] != want:
            raise AssertionError(f"{name}: {kernel} launched "
                                 f"{counts[kernel]} times, expected {want}")
    encoder = kwargs.get("encoder", "GIN")
    builds = counters.of("launch", [kb.BLOCKS])[kb.BLOCKS]
    if builds != BUILDS_PER_STEP[encoder] * steps:
        raise AssertionError(f"{name}: {builds} block builds, expected "
                             f"{BUILDS_PER_STEP[encoder] * steps}")
    default_band, layers = ENCODER_BRANCHES[encoder]
    band = band or default_band
    if branches != ({"banded": steps}, {band: layers * steps}):
        raise AssertionError(f"{name} left the kernel branches: {branches}")
    routes = {f"{k} {r}": c for (k, r), c in counters.of("route").items()}
    heads = kwargs.get("num_heads", HEADS)
    for kernel in kg.STAGED:
        route = kg.gt_route(kernel, heads, kwargs.get("hidden", 64) // heads)
        if routes.get(f"{kernel} {route.name}", 0) != counts[kernel]:
            raise AssertionError(f"{name}: {kernel} left its {route.name} "
                                 f"route: {routes}")
    return {"counts": counts, "routes": routes, "builds": builds,
            "step_ms": step_ms, "steps": records}


# --- 6. the pretrain verb, its options and the repaired widths ---------------

OPTIONS = {"readout s2s": {"readout": "s2s"}, "use_att 0": {"use_att": False},
           "kl_mode reference": {"kl_mode": "reference"},
           "recons_type logM": {"recons_type": "logM"},
           "recons_impl dense": {"recons_impl": "dense"}}
# planted resume faults -> (module, name, stand-in made from the real one)
RESUME_FAULTS = {
    "Adam state not loaded": (checkpoint, "load_adam_state",
                              lambda real: lambda *args: None),
    "epoch 1 shuffled with seed + 1": (
        loops, "batch_iterator",
        lambda real: lambda *args, seed, **kw: real(*args, seed=seed + 1,
                                                    **kw))}
# run -> (run_pretrain arguments, launches per step, encoder branch)
WIDTH_RUNS = {
    "GIN hidden 256": ({"hidden": 256}, {"spmm": 8 * 2 + 2, "pool": 1},
                       "band_spmm"),
    "GIN hidden 30": ({"hidden": 30}, GIN_PER_STEP, "band"),
    "Transformer 1 head of 64": ({"encoder": "Transformer", "num_heads": 1},
                                 GT_PER_STEP, "gt_band_64x128"),
    "Transformer 1 head of 64, merged": (
        {"encoder": "Transformer", "num_heads": 1, "gt_bwd": "merged"},
        MERGED_PER_STEP, "gt_band_64x128"),
    "Transformer hidden 96, 8 heads of 12": (
        {"encoder": "Transformer", "hidden": 96}, GT_PER_STEP,
        "gt_band_64x128"),
    "Transformer hidden 256, 1 head of 256": (
        {"encoder": "Transformer", "hidden": 256, "num_heads": 1},
        GT_PER_STEP, "gt_band_64x128"),
    "Transformer hidden 256, 1 head of 256, merged": (
        {"encoder": "Transformer", "hidden": 256, "num_heads": 1,
         "gt_bwd": "merged"}, MERGED_PER_STEP, "gt_band_64x128"),
    "Transformer hidden 512, 1 head of 512": (
        {"encoder": "Transformer", "hidden": 512, "num_heads": 1},
        GT_PER_STEP, "gt_band_64x128"),
    "Transformer hidden 512, 1 head of 512, merged": (
        {"encoder": "Transformer", "hidden": 512, "num_heads": 1,
         "gt_bwd": "merged"}, MERGED_PER_STEP, "gt_band_64x128")}


def expect_counts(label, per_step, steps):
    counts = launch_counts()
    for kernel in PATH:
        want = per_step.get(kernel, 0) * steps
        if counts[kernel] != want:
            raise AssertionError(f"{label}: {kernel} launched "
                                 f"{counts[kernel]} times, expected {want}")
    return counts


def verb_run(label, argv):
    """``cli.main(argv)`` with the counts set to 0 before; returns its
    result, the counts and the seconds it took."""
    reset_launch_counts()
    counters.reset("pool", "encoder")
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"verb {label}: {secs:.2f} s; launches {launch_counts()}; "
          f"branches {counters.of('pool')} "
          f"{counters.of('encoder')}", flush=True)
    return out, secs


def check_verb_counts(label, steps):
    """The launch and branch counts of ``steps`` GIN steps, as
    ``main_path`` checks them."""
    expect_counts(label, GIN_PER_STEP, steps)
    branches = (counters.of("pool"), counters.of("encoder"))
    if branches != ({"banded": steps}, {"band": 8 * steps}):
        raise AssertionError(f"{label} left the kernel branches: {branches}")


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (index_add_ and the gathers'
    backward sum in a fixed order), uninitialized memory left as it is."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def autosaves_apart(path, ref):
    """How far the autosave at ``path`` is from ``ref``: byte-equal or not,
    the largest weight difference in units of the learning rate, the
    largest relative epoch-loss difference."""
    with open(path, "rb") as f, open(ref, "rb") as r:
        blob, ref_blob = f.read(), r.read()
    got, want = unpackb(blob), unpackb(ref_blob)
    weights = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(
        sorted_leaves(got["state"]["params"]),
        sorted_leaves(want["state"]["params"])))
    a, b = (np.asarray(x["extra"]["history"]) for x in (got, want))
    return {"bitwise": blob == ref_blob, "weights_lr": weights / LR,
            "epoch_loss_rel": float(np.max(np.abs(a - b) / np.abs(b)))}


def verb_phase(g, sub, dev, ds, caps):
    """Phase 6; returns its times and readings."""
    report = {}

    # (a) the committed JAX checkpoint, read by the port's codec
    t0 = time.perf_counter()
    variables, meta = checkpoint.load_checkpoint(CHECKPOINT)
    model = PretrainModel(9, hidden=64, d_transfer=32, deterministic=True)
    model.load_state_dict(from_jax_variables(variables))
    card_vs_float64(model.to(dev), g, sub, "committed checkpoint",
                    grads=False)
    report["checkpoint_s"] = time.perf_counter() - t0

    # (b) the verb: curriculum with autosave, skip on rerun, resume
    shutil.rmtree(VERB_DIR, ignore_errors=True)
    os.makedirs(VERB_DIR)
    base = ["pretrain", "--synthetic", "512", "--batch_size", "128",
            "--lr", str(LR), "--weight_decay", "5e-5", "--epochs", "2"]
    curriculum = base + ["--curriculum", "--out",
                         os.path.join(VERB_DIR, "x"), "--autosave",
                         os.path.join(VERB_DIR, "auto.msgpack")]
    stages, secs = verb_run("curriculum", curriculum)
    steps = sum(st["info"]["throughput"]["steps"] for st in stages)
    check_verb_counts("curriculum", steps)
    for st in stages:
        if not all(math.isfinite(x) for x in st["info"]["history"]):
            raise AssertionError(f"stage {st['stage']}: non-finite loss "
                                 f"{st['info']['history']}")
        checkpoint.load_checkpoint(st["path"])
    report["curriculum"] = {"s": secs, "steps": steps,
                            "history": [st["info"]["history"]
                                        for st in stages]}
    stages, secs = verb_run("curriculum rerun", curriculum)
    if [st["skipped"] for st in stages] != [True] * 3:
        raise AssertionError(f"the rerun did not skip every stage: {stages}")
    expect_counts("curriculum rerun", {}, 0)
    report["rerun_s"] = secs

    # Resume: under deterministic algorithms (index_add_ without atomics)
    # a run stopped after epoch 0 and resumed must write the very autosave
    # bytes of a run never stopped: weights, Adam state, generator, history.
    # Two planted faults, each resuming from the same epoch-0 autosave, must
    # not: the Adam state left unloaded, and epoch 1 shuffled with seed + 1.
    auto = os.path.join(VERB_DIR, "auto.msgpack")
    full_auto = os.path.join(VERB_DIR, "full_auto.msgpack")
    resumed_args = ["--autosave", auto, "--out",
                    os.path.join(VERB_DIR, "resumed.msgpack")]
    shutil.rmtree(VERB_DIR)
    os.makedirs(VERB_DIR)
    with deterministic():
        full, _ = verb_run("2 epochs", base + [
            "--autosave", full_auto, "--out",
            os.path.join(VERB_DIR, "full.msgpack")])
        check_verb_counts("2 epochs", full["throughput"]["steps"])
        first, _ = verb_run("epoch 0, autosaved",
                            base[:-1] + ["1"] + resumed_args)
        shutil.copy(auto, auto + ".epoch0")
        resumed, _ = verb_run("resumed to epoch 1", base + resumed_args)
        check_verb_counts("resumed to epoch 1",
                          resumed["throughput"]["steps"])
        if resumed["throughput"]["steps"] != first["throughput"]["steps"]:
            raise AssertionError("the resumed run did not take epoch 1 alone")
        sound = autosaves_apart(auto, full_auto)
        faults = {}
        for fault, (module, name, stand_in) in RESUME_FAULTS.items():
            shutil.copy(auto + ".epoch0", auto)
            real = getattr(module, name)
            setattr(module, name, stand_in(real))
            try:
                verb_run(f"resumed to epoch 1, {fault}", base + resumed_args)
            finally:
                setattr(module, name, real)
            faults[fault] = autosaves_apart(auto, full_auto)
    print(f"resume vs uninterrupted: {sound}; planted faults: {faults} "
          f"(weights in lr, epoch losses relative; the bound is bitwise)",
          flush=True)
    if not sound["bitwise"]:
        raise AssertionError(f"the resumed run's autosave differs from the "
                             f"uninterrupted run's: {sound}")
    missed = [fault for fault, r in faults.items() if r["bitwise"]]
    if missed:
        raise AssertionError(f"a planted resume fault went unseen: {missed}")
    report["resume"] = {"history": resumed["history"],
                        "uninterrupted": full["history"], "sound": sound,
                        "faults": faults}
    shutil.rmtree(VERB_DIR)

    # (c) each new option: card vs float64 CPU, then one optimizer step
    lg, lsub = next(batch_iterator(ds, 128, caps, shuffle=False, logm_k=1))
    report["options"] = {}
    for label, kw in OPTIONS.items():
        t0 = time.perf_counter()
        gb, sb = (lg.to(dev), lsub.to(dev)) if "recons_type" in kw else \
            (g, sub)
        model = PretrainModel(9, hidden=64, d_transfer=32,
                              deterministic=True, **kw)
        init_flax_style_(model, torch.Generator().manual_seed(3))
        card_vs_float64(model.to(dev), gb, sb, label, grads=False)
        step = make_pretrain_step(model, adam_l2(model, 1e-4, 5e-5))
        reset_launch_counts()
        losses = step(gb, sb)
        torch.cuda.synchronize()
        if not all(math.isfinite(float(v)) for v in losses):
            raise AssertionError(f"{label}: non-finite step {losses}")
        adjacency = "recons_type" not in kw and "recons_impl" not in kw
        expect_counts(label, GIN_PER_STEP if adjacency else
                      dict(GIN_PER_STEP, spmm=0), 1)
        report["options"][label] = time.perf_counter() - t0

    # (d) the repaired widths
    report["widths"] = {}
    for label, (kwargs, per_step, band) in WIDTH_RUNS.items():
        run = main_path(label, kwargs, WIDTH_STEPS, per_step, band)
        report["widths"][label] = {"step_ms": run["step_ms"],
                                   "counts": run["counts"]}
    print(f"phase 6: {json.dumps(report)}", flush=True)
    return report


# --- 8. the supervised path --------------------------------------------------

SUP_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_supervised")
BACE_N = 1513                 # BACE's size: the reference's own prefix split
FT_LR, FT_WD = 1e-3, 1e-5     # the finetune and adapt verbs' defaults
GT_FT_PER_STEP = {"gt_fwd": 10, "gt_bwd_rows": 10, "gt_bwd_cols": 10,
                  "pool": 1}
# launches of one supervised step (no reconstruction, so no spmm) and of one
# evaluation batch, per encoder
FT_PER_STEP = {"GIN": {"gin_fwd": 8, "gin_bwd": 8, "spmm_self": 8,
                       "pool": 1},
               "Transformer": GT_FT_PER_STEP}
EVAL_PER_BATCH = {"GIN": {"gin_fwd": 8, "pool": 1},
                  "Transformer": {"gt_fwd": 10, "pool": 1}}
FT_COMPARED = {"GIN": ({}, 1), "GIN grad_accum 2": ({}, 2),
               "Transformer": ({"encoder": "Transformer"}, 1)}
# one epoch each at small depth: (dataset, graphs, extra flags)
SPEC_RUNS = {"ESOL (rmse, regression head)": ("ESOL", 400, []),
             "Peptides-func (ap, grad_accum 2)": ("Peptides-func", 600, []),
             "Mutagenicity (ce, acc, 14 features, 2 repeats)": (
                 "Mutagenicity", 400, ["--repeats", "2"])}


def add_counts(*parts):
    """Sum of (per-unit counts, units) pairs."""
    out = collections.Counter()
    for per, n in parts:
        for k, v in per.items():
            out[k] += v * n
    return dict(out)


def expect_exact(label, want):
    got = {k: n for k, n in launch_counts().items() if n}
    if got != {k: n for k, n in want.items() if n}:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    return got


def bace(dev, n_batches=STEPS):
    """BACE-sized labelled data (the verb's generator and seed) and its
    first ``n_batches`` shuffled training batches on the card."""
    ds = GraphDataset(random_dataset(BACE_N, seed=42, num_tasks=1), k=1)
    caps = plan_capacities(ds, 128)
    batches = [(g.to(dev), s.to(dev)) for g, s in itertools.islice(
        batch_iterator(ds, 128, caps, seed=7), n_batches)]
    return ds, caps, batches


def fresh(batch, dev):
    """A copy of a card batch for evaluation (inference-mode tensors cached
    on a batch, its banded blocks, cannot serve a training step later)."""
    return tuple(b.to("cpu").to(dev) for b in batch)


def supervised_vs_float64(dev, batch):
    """``FinetuneModel``'s BCE loss and the gradients of the parameters the
    ``reference`` freeze mask trains, and ``DomainAdaptModel``'s loss and
    gradients: the card (kernels, float32) against the CPU plain path in
    float64, deterministic gate."""
    g, sub = batch
    g64, sub64 = g.to("cpu"), sub.to("cpu")
    g64.node_feat, g64.labels = g64.node_feat.double(), g64.labels.double()
    out = {}
    for label, model in (("finetune", FinetuneModel(
            9, hidden=64, d_transfer=32, deterministic=True)),
            ("domainadapt", DomainAdaptModel(9, hidden=64, d_transfer=32,
                                             deterministic=True))):
        init_flax_style_(model, torch.Generator().manual_seed(3))
        keep = set(finetune_trainable_mask(model) if label == "finetune"
                   else (n for n, _ in model.named_parameters()))
        for n, p in model.named_parameters():
            p.requires_grad_(n in keep)
        ref = copy.deepcopy(model).to("cpu", torch.float64)
        res = []
        for m, gb, sb in ((model.to(dev), g, sub), (ref, g64, sub64)):
            m.train()
            loss = (trainer.finetune_loss(m, gb, sb, "bce", None)
                    if label == "finetune" else m(gb, sb))
            loss.backward()
            res.append((float(loss.detach()),
                        {n: p.grad.detach().cpu().double()
                         for n, p in m.named_parameters()
                         if p.requires_grad}))
        (l_dev, g_dev), (l_ref, g_ref) = res
        floor = GRAD_FLOOR * max(float(v.abs().max()) for v in g_ref.values())
        worst = max(float((g_dev[k] - g_ref[k]).abs().max())
                    / max(float(g_ref[k].abs().max()), floor) for k in g_ref)
        rec = {"loss": l_dev, "loss_float64": l_ref,
               "loss_rel": abs(l_dev - l_ref) / abs(l_ref),
               "grad_rel": worst, "trained_tensors": len(g_ref)}
        print(f"supervised ({label}) card vs float64 CPU: {json.dumps(rec)} "
              f"(tol {MODEL_RTOL}, {GRAD_RTOL})", flush=True)
        if not (rec["loss_rel"] <= MODEL_RTOL and worst <= GRAD_RTOL):
            raise AssertionError(f"{label} disagrees with float64: {rec}")
        out[label] = rec
    return out


def ft_model(dev, kwargs, seed=11):
    model = FinetuneModel(9, hidden=64, d_transfer=32, num_heads=HEADS,
                          **kwargs)
    init_flax_style_(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    opt = masked_adam(model, finetune_trainable_mask(model), FT_LR, FT_WD)
    return model, opt


def ft_compared_run(dev, batches, kwargs, accum, how):
    """One fine-tuning step per group of ``accum`` batches from one start
    (``reference`` freeze, BCE), eager or captured."""
    model, opt = ft_model(dev, kwargs)
    gen = torch.Generator(device=dev).manual_seed(12)
    reset_launch_counts()
    groups = [batches[i:i + accum] for i in range(0, len(batches), accum)]
    if how == "captured":
        step = make_finetune_step(model, opt, "bce", accum)
        losses = [step(*((grp[0]) if accum == 1 else
                         ([b[0] for b in grp], [b[1] for b in grp])), gen)
                  for grp in groups]
    else:
        losses = [trainer.finetune_step_eager(model, opt, grp, "bce", gen)
                  for grp in groups]
    torch.cuda.synchronize()
    as_bytes = {f"step {i}": t.cpu().numpy().tobytes()
                for i, t in enumerate(losses)}
    return as_bytes, step_bytes(model, opt, gen), launch_counts()


def ft_captured_phase(dev, batches):
    """The captured fine-tuning step against the eager one under torch's
    deterministic algorithms: losses, weights, BatchNorm statistics, the
    masked Adam state and the generator byte-equal; the stale-input fault
    must break it."""
    report = {}
    with deterministic():
        for label, (kwargs, accum) in FT_COMPARED.items():
            enc = kwargs.get("encoder", "GIN")
            want = {k: n * len(batches) for k, n in FT_PER_STEP[enc].items()}
            eager = ft_compared_run(dev, batches, kwargs, accum, "eager")
            captured = ft_compared_run(dev, batches, kwargs, accum,
                                       "captured")
            with stale_replays():
                fault = ft_compared_run(dev, batches, kwargs, accum,
                                        "captured")
            rec = {"losses_apart": bytes_apart(eager[0], captured[0]),
                   "state_apart": bytes_apart(eager[1], captured[1]),
                   "fault_losses_apart": len(bytes_apart(eager[0],
                                                         fault[0])),
                   "fault_state_apart": len(bytes_apart(eager[1],
                                                        fault[1]))}
            print(f"finetune captured vs eager ({label}), {len(batches)} "
                  f"batches: {json.dumps(rec)}", flush=True)
            for name, run in (("eager", eager), ("captured", captured)):
                got = {k: n for k, n in run[2].items() if n}
                if got != want:
                    raise AssertionError(f"finetune {label} {name}: "
                                         f"launches {got}, expected {want}")
            if rec["losses_apart"] or rec["state_apart"]:
                raise AssertionError(f"finetune {label}: the captured step "
                                     f"is not the eager one: {rec}")
            if not (rec["fault_losses_apart"] and rec["fault_state_apart"]):
                raise AssertionError(f"finetune {label}: the planted fault "
                                     "went unseen")
            report[label] = rec
    return report


def ft_launches_and_medians(dev, batches):
    """Per encoder: the launches of one captured fine-tuning step and of
    one evaluation batch, each with every count set to 0 before; then the
    step medians of the eager and the captured step (alternating), of one
    evaluation batch and of one captured adaptation step (host clock, each
    ended by a device synchronize; the first call of each, the eager
    warm-up and capture, left out)."""
    out = {}
    for enc, kwargs in (("GIN", {}), ("Transformer",
                                      {"encoder": "Transformer"})):
        model, opt = ft_model(dev, kwargs)
        step = make_finetune_step(model, opt, "bce")
        gen = torch.Generator(device=dev).manual_seed(1)
        step(*batches[0], gen)                    # eager warm-up, capture
        reset_launch_counts()
        step(*batches[1], gen)
        torch.cuda.synchronize()
        step_counts = expect_exact(f"one finetune step ({enc})",
                                   FT_PER_STEP[enc])
        run = make_eval_fn(model)
        evals = [fresh(b, dev) for b in batches]
        reset_launch_counts()
        run(*evals[0], gen)
        torch.cuda.synchronize()
        eval_counts = expect_exact(f"one eval batch ({enc})",
                                   EVAL_PER_BATCH[enc])

        def timed(fn, items):
            times = []
            for item in items:
                t0 = time.perf_counter()
                fn(*item)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times[1:])
        medians = []
        for how in ("eager", "captured", "captured", "eager"):
            model, opt = ft_model(dev, kwargs)
            fn = (make_finetune_step(model, opt, "bce") if how == "captured"
                  else lambda g, s, m=model, o=opt: trainer.
                  finetune_step_eager(m, o, [(g, s)], "bce", gen))
            medians.append((how, timed(fn, batches)))
        eval_ms = timed(lambda g, s: run(g, s, gen), evals)
        da = DomainAdaptModel(9, hidden=64, d_transfer=32, num_heads=HEADS,
                              **kwargs)
        init_flax_style_(da, torch.Generator().manual_seed(4))
        da.to(dev)
        adapt_ms = timed(make_domainadapt_step(da, adam_l2(da, FT_LR, FT_WD)),
                         batches)
        out[enc] = {"finetune_step_launches": step_counts,
                    "eval_batch_launches": eval_counts,
                    "finetune_step_ms": medians, "eval_batch_ms": eval_ms,
                    "adapt_step_ms": adapt_ms}
        print(f"supervised ({enc}), ms (medians of {len(batches) - 1} after "
              f"the first): finetune step {medians}, eval batch "
              f"{eval_ms:.3f}, adapt step {adapt_ms:.3f} | {smi_line()}",
              flush=True)
    return out


def device_kernels(prof, steps):
    """(ms a step, calls a step, name) of each device kernel a profile
    recorded, largest first, less the user annotations."""
    return sorted(
        ((e.self_device_time_total / 1e3 / steps, e.count / steps, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and not e.key.startswith("ProfilerStep")), reverse=True)


def ft_profile(dev, batches):
    """Where the captured fine-tuning step's time goes, per encoder: 3
    steady steps (after the eager warm-up and one replay) under
    torch.profiler: wall and device ms a step, the device's busy share,
    kernels a step, the top kernels and the port's kernels."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for enc, kwargs in (("GIN", {}), ("Transformer",
                                      {"encoder": "Transformer"})):
        model, opt = ft_model(dev, kwargs)
        step = make_finetune_step(model, opt, "bce")
        gen = torch.Generator(device=dev).manual_seed(1)
        for g, sub in batches[:2]:
            float(step(g, sub, gen))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for g, sub in batches[2:5]:
                float(step(g, sub, gen))
            wall = (time.perf_counter() - t0) * 1e3 / 3
        kernels = device_kernels(prof, 3)
        busy = sum(k[0] for k in kernels)
        rec = {"wall_ms_per_step": wall, "device_ms_per_step": busy,
               "device_busy_share": busy / wall,
               "device_kernels_per_step": sum(k[1] for k in kernels),
               "top": [{"kernel": name[:80], "ms_per_step": ms,
                        "calls_per_step": n}
                       for ms, n, name in kernels[:10]],
               "port": {k: [sum(ms for ms, _, name in kernels if k in name),
                            sum(n for _, n, name in kernels if k in name)]
                        for k in sorted({name for v in PATH.values()
                                         for name in v[2].split()})}}
        out[enc] = rec
        print(f"profile (finetune, {enc}, captured): {json.dumps(rec)}",
              flush=True)
    return out


def split_batches(spec, graphs, feat_dim, epochs=1, seed=42,
                  batch_size=128):
    """What the verbs' runs on ``graphs`` synthetic molecules of ``spec``
    (seed 42, batches of 128) take: ``steps``, the fine-tuning optimizer
    steps of ``epochs`` epochs (each shuffled with seed + epoch, ragged
    accumulation groups dropped); ``evals``, the val and test batches of
    one evaluation; ``train_evals``, the train split's batches in order
    (``eval --split all``); ``adapt``, the batches of one adaptation
    epoch over the whole dataset."""
    ds = GraphDataset(random_dataset(graphs, seed=seed, feat_dim=feat_dim,
                                     num_tasks=spec.num_tasks), k=1)
    caps = plan_capacities(ds, batch_size)
    train, val, test = cli._splits(ds, spec, seed)
    return {"steps": sum(len(plan_batches(train, batch_size, caps,
                                          seed=seed + e)) // spec.grad_accum
                         for e in range(epochs)),
            "evals": sum(len(plan_batches(d, batch_size, caps,
                                          shuffle=False))
                         for d in (val, test)),
            "train_evals": len(plan_batches(train, batch_size, caps,
                                            shuffle=False)),
            "adapt": len(plan_batches(ds, batch_size, caps, seed=seed))}


def supervised_verbs(dev):
    """``pretrain`` a checkpoint at full width, ``finetune`` BACE from it
    for 2 epochs with ``--out`` and ``--journal``, ``eval --split all``
    (which must give the run's final test metric), ``adapt`` for one
    epoch; then one epoch of a regression spec, a ``grad_accum`` 2 spec
    and a ``ce``/``acc`` spec with repeats at 2 convs, and one Transformer
    fine-tuning epoch at hidden 64, 8 heads.  Every run's launch counts
    must be its steps' and evaluation batches'."""
    shutil.rmtree(SUP_DIR, ignore_errors=True)
    os.makedirs(SUP_DIR)
    pre, ft, ad = (os.path.join(SUP_DIR, f) for f in
                   ("pre.msgpack", "bace.msgpack", "adapted.msgpack"))
    journal = os.path.join(SUP_DIR, "journal.jsonl")
    report = {}
    info, secs = verb_run("pretrain (full width)", [
        "pretrain", "--synthetic", "512", "--epochs", "1", "--out", pre])
    check_verb_counts("pretrain (full width)", info["throughput"]["steps"])
    report["pretrain_s"] = secs
    bace_data = ["--dataset", "BACE", "--synthetic", str(BACE_N)]
    spec = cli.DATASETS["BACE"]
    for enc, extra, epochs, label in (
            ("GIN", ["--pretrained", pre, "--out", ft, "--journal",
                     journal], 2, "finetune BACE"),
            ("Transformer", ["--encoder", "Transformer"], 1,
             "finetune BACE, Transformer")):
        run, secs = verb_run(label, ["finetune"] + bace_data + [
            "--epochs", str(epochs)] + extra)
        got_steps = run["last"]["throughput"]["steps"]
        want = split_batches(spec, BACE_N, 9, epochs)
        if got_steps != want["steps"]:
            raise AssertionError(f"{label}: {got_steps} steps, expected "
                                 f"{want['steps']}")
        expect_exact(label, add_counts((FT_PER_STEP[enc], got_steps),
                                       (EVAL_PER_BATCH[enc],
                                        want["evals"] * epochs)))
        hist = run["last"]["history"]
        if not all(math.isfinite(x) for row in hist for x in row):
            raise AssertionError(f"{label}: non-finite history {hist}")
        report[label] = {"s": secs, "steps": got_steps, "history": hist,
                         "test_at_best_val": run["mean"]}
    final_test = report["finetune BACE"]["history"][-1][2]
    out, secs = verb_run("eval --split all", [
        "eval"] + bace_data + ["--checkpoint", ft, "--split", "all"])
    want = split_batches(spec, BACE_N, 9)
    expect_exact("eval --split all", add_counts(
        (EVAL_PER_BATCH["GIN"], want["evals"] + want["train_evals"])))
    print(f"eval reproduces the run's final test metric: {out['test']!r} "
          f"vs {final_test!r}", flush=True)
    if not abs(out["test"] - final_test) <= 1e-6:
        raise AssertionError(f"eval's test {out['test']} is not the run's "
                             f"final {final_test}")
    report["eval"] = {"s": secs, **out, "run_final_test": final_test}
    with open(journal) as f:
        if json.loads(f.readline())["dataset"] != "BACE":
            raise AssertionError("the journal holds no BACE record")
    info, secs = verb_run("adapt", ["adapt", "--synthetic", str(BACE_N),
                                    "--pretrained", pre, "--epochs", "1",
                                    "--out", ad])
    expect_exact("adapt", add_counts((FT_PER_STEP["GIN"], want["adapt"])))
    checkpoint.load_checkpoint(ad)
    if not math.isfinite(info["best_loss"]):
        raise AssertionError(f"adapt: loss {info['best_loss']}")
    report["adapt"] = {"s": secs, "loss": info["best_loss"]}
    for label, (dataset, graphs, extra) in SPEC_RUNS.items():
        spec = cli.DATASETS[dataset]
        run, secs = verb_run(label, [
            "finetune", "--dataset", dataset, "--synthetic", str(graphs),
            "--epochs", "1", "--num_layers", "2"] + extra)
        want = split_batches(spec, graphs, spec.feat_dim)
        reps = 2 if extra else 1
        per = {k: v // 2 if k.startswith(("gin", "spmm")) else v
               for k, v in FT_PER_STEP["GIN"].items()}     # 2 convs
        expect_exact(label, add_counts(
            (per, want["steps"] * spec.grad_accum * reps),
            ({"gin_fwd": 4, "pool": 1}, want["evals"] * reps)))
        if not all(math.isfinite(v) for v in run["runs"]):
            raise AssertionError(f"{label}: {run['runs']}")
        report[label] = {"s": secs, "runs": run["runs"],
                         "history": run["last"]["history"]}
    shutil.rmtree(SUP_DIR)
    print(f"phase 8 verbs: {json.dumps(report)}", flush=True)
    return report


def supervised_phase(dev):
    """Phase 8; returns its readings."""
    _, _, batches = bace(dev)
    report = {"vs_float64": supervised_vs_float64(dev, fresh(batches[0],
                                                             dev))}
    report["captured_vs_eager"] = ft_captured_phase(dev, batches)
    report["steps"] = ft_launches_and_medians(dev, batches)
    report["profile"] = ft_profile(dev, batches)
    report["verbs"] = supervised_verbs(dev)
    return report


# --- 9. GCN and GraphSAGE, dense ego-nets, the captured evaluation, the
#        reference import -----------------------------------------------------

SPMM_SHAPES = (("N", 128), ("S", 128), ("S", 64))   # GCN's 2h, SAGE's h
DENSE_STEPS = 4
# dense mode: encoder1's 4 fused GIN convs, the reconstruction's 2 spmm
DENSE_PER_STEP = {"gin_fwd": 4, "gin_bwd": 4, "spmm_self": 4, "spmm": 2}
EVAL_ENCODERS = {"GIN": {}, "Transformer": {"encoder": "Transformer"}}
REF_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_reference")
REF_CONVS = 5                 # the shipped artifact's, and the stand-in's


def spmm_shapes(g, sub, dev):
    """Phase 9 (b): the banded SpMM kernel at the widths GCN (2h = 128)
    and GraphSAGE (h = 64) aggregate at.  The records stay out of the
    kernel row's headline (the reconstruction's shape) and go into its
    configs."""
    gen = torch.Generator(device=dev).manual_seed(9)
    out = []
    for label, d in SPMM_SHAPES:
        blocks, col_off = _resolve_band(g if label == "N" else sub)
        n = blocks.shape[0] * blocks.shape[1]
        x = torch.randn(n, d, device=dev, generator=gen)
        bf = blocks.float()
        win = windows(blocks, col_off, x)
        rec = check("spmm", f"{label}={n} d={d}",
                    lambda: kb.spmm(blocks, col_off, x),
                    lambda: kb.spmm_plain(blocks, col_off, x),
                    nbytes(blocks, col_off, x) + n * d * 4,
                    2 * int((blocks != 0).sum()) * d,
                    lambda: torch.bmm(bf, win))
        rec["main"] = False
        out.append(rec)
    return out


def dense_phase(dev, ds, caps):
    """Phase 9 (e): the benchmark's first batches with dense ego-nets
    (``bench.py``'s slot width: the dataset's largest ego-net rounded up
    to 8).  The dense model's losses against the COO model's on the same
    batch and weights (deterministic gate), then DENSE_STEPS captured
    steps from every count at 0."""
    s_max = (max_egonet_size(ds.egonets) + 7) // 8 * 8
    batches = []
    for sel in plan_batches(ds, 128, caps, seed=7)[:DENSE_STEPS]:
        g, coo = pack_batch(ds, sel, caps)
        dense = pack_subgraphs_dense([ds.graphs[j] for j in sel],
                                     [ds.egonets[j] for j in sel],
                                     caps.nodes, s_max)
        batches.append((g.to(dev), coo.to(dev), dense.to(dev)))
    g, coo, dense = batches[0]
    losses = {}
    for mode, sb in (("coo", coo), ("dense", dense)):
        model = PretrainModel(9, hidden=64, d_transfer=32,
                              deterministic=True, subgraph_mode=mode)
        init_flax_style_(model, torch.Generator().manual_seed(3))
        with torch.no_grad():
            losses[mode] = [float(v) for v in model.to(dev).train()(g, sb)]
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["dense"], losses["coo"]))
    model = PretrainModel(9, hidden=64, d_transfer=32, subgraph_mode="dense")
    init_flax_style_(model, torch.Generator().manual_seed(7))
    model.to(dev)
    step = make_pretrain_step(model, adam_l2(model, LR, 5e-5))
    gen = torch.Generator(device=dev).manual_seed(8)
    reset_launch_counts()
    counters.reset("pool", "encoder")
    times, steps = [], []
    for g, _, dense in batches:
        t0 = time.perf_counter()
        out = step(g, dense, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        steps.append([float(v) for v in out])
    counts = expect_counts("dense mode", DENSE_PER_STEP, DENSE_STEPS)
    branches = (counters.of("pool"), counters.of("encoder"))
    rec = {"s_max": s_max, "losses": losses, "loss_rel": loss_rel,
           "steps": steps, "step_ms_median": statistics.median(times[1:]),
           "launches": counts, "branches": branches,
           "graphs": len(step.graphs)}
    print(f"dense ego-nets: {json.dumps(rec)} (tol {MODEL_RTOL})",
          flush=True)
    if not (loss_rel <= MODEL_RTOL
            and all(math.isfinite(v) for row in steps for v in row)
            and branches == ({}, {"band": 4 * DENSE_STEPS})
            and len(step.graphs) == 1):
        raise AssertionError(f"dense mode: {rec}")
    return rec


def eval_splits(dev):
    """Every BACE evaluation batch, val and test, packed as ``PackedEval``
    packs them."""
    ds, caps, _ = bace(dev, 0)
    _, val, test = cli._splits(ds, cli.DATASETS["BACE"], 42)
    return [[(g.to(dev), s.to(dev)) for g, s in
             batch_iterator(d, 128, caps, shuffle=False)] for d in (val, test)]


def eval_scores(run, splits, dev, eager):
    """Each batch's scores as bytes, a generator seeded 0 for each split
    (``PackedEval``'s draws); ``eager``: the evaluation's eager form."""
    out = []
    for batches in splits:
        gen = torch.Generator(device=dev).manual_seed(0)
        for g, s in batches:
            scores = run.run([(g, s)], gen) if eager else run(g, s, gen)
            out.append(scores.cpu().numpy().tobytes())
    return out


def captured_eval_phase(dev):
    """Phase 9 (f): the captured evaluation against its eager form, under
    torch's deterministic algorithms, for each encoder and ``live_noise``
    setting: every batch's scores byte-equal, the model's statistics and
    mode kept, one graph, the launches those of its batches; the
    stale-input fault must break it.  Then the evaluation batch medians,
    eager / captured / captured / eager (the first call, the capture, left
    out)."""
    splits = eval_splits(dev)
    n = sum(map(len, splits))
    report = {}
    with deterministic():
        for enc, kwargs in EVAL_ENCODERS.items():
            for live in (False, True):
                model, _ = ft_model(dev, kwargs)
                before = {k: v.clone() for k, v in
                          model.state_dict().items()}
                eager = eval_scores(make_eval_fn(model, live), splits, dev,
                                    True)
                run = make_eval_fn(model, live)
                reset_launch_counts()
                captured = eval_scores(run, splits, dev, False)
                torch.cuda.synchronize()
                expect_exact(f"captured evaluation ({enc})",
                             add_counts((EVAL_PER_BATCH[enc], n)))
                with stale_replays():
                    fault = eval_scores(make_eval_fn(model, live), splits,
                                        dev, False)
                rec = {"batches": n,
                       "apart": [i for i, (a, b) in
                                 enumerate(zip(eager, captured)) if a != b],
                       "fault_apart": sum(a != b for a, b in
                                          zip(eager, fault)),
                       "graphs": len(run.graphs),
                       "state_kept": all(torch.equal(v, before[k]) for k, v
                                         in model.state_dict().items()),
                       "mode_kept": model.training}
                label = f"{enc}, live_noise {live}"
                print(f"captured vs eager evaluation ({label}): "
                      f"{json.dumps(rec)}", flush=True)
                if rec["apart"] or rec["graphs"] != 1 or not (
                        rec["state_kept"] and rec["mode_kept"]):
                    raise AssertionError(f"captured evaluation ({label}): "
                                         f"{rec}")
                if not rec["fault_apart"]:
                    raise AssertionError(f"captured evaluation ({label}): "
                                         "the planted fault went unseen")
                report[label] = rec
    batches = [b for split in splits for b in split]
    for enc, kwargs in EVAL_ENCODERS.items():
        model, _ = ft_model(dev, kwargs)
        run = make_eval_fn(model)
        gen = torch.Generator(device=dev).manual_seed(0)
        run(*batches[0], gen)                     # eager warm-up, capture
        medians = []
        for how in ("eager", "captured", "captured", "eager"):
            times = []
            for g, s in batches:
                t0 = time.perf_counter()
                if how == "eager":
                    run.run([(g, s)], gen)
                else:
                    run(g, s, gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            medians.append((how, statistics.median(times)))
        report[f"{enc} eval batch ms"] = medians
        print(f"evaluation batch medians ({enc}, {len(batches)} batches), "
              f"ms: {medians} | {smi_line()}", flush=True)
    return report


def reference_import_phase(dev):
    """Phase 9 (g): ``finetune --pretrained`` the stand-in pickle at full
    width for one epoch of BACE: 5 convs adopted, its steps and
    evaluation batches those of 5-conv encoders, its loss finite."""
    shutil.rmtree(REF_DIR, ignore_errors=True)
    os.makedirs(REF_DIR)
    pt = write_stand_in(os.path.join(REF_DIR, "stand_in.pt"), convs=REF_CONVS)
    label = "finetune --pretrained stand_in.pt"
    run, secs = verb_run(label, ["finetune", "--dataset", "BACE",
                                 "--synthetic", str(BACE_N), "--pretrained",
                                 pt, "--epochs", "1"])
    want = split_batches(cli.DATASETS["BACE"], BACE_N, 9)
    steps = run["last"]["throughput"]["steps"]
    per_conv = 2 * REF_CONVS                      # two encoders
    expect_exact(label, add_counts(
        ({"gin_fwd": per_conv, "gin_bwd": per_conv, "spmm_self": per_conv,
          "pool": 1}, steps), ({"gin_fwd": per_conv, "pool": 1},
                               want["evals"])))
    convs = run["last"]["state"].model.core.encoder1.num_convs
    loss = run["last"]["history"][0][0]
    rec = {"s": secs, "convs": convs, "steps": steps, "loss": loss,
           "test": run["mean"]}
    print(f"reference import: {json.dumps(rec)}", flush=True)
    shutil.rmtree(REF_DIR)
    if not (convs == REF_CONVS and steps == want["steps"]
            and math.isfinite(loss)):
        raise AssertionError(f"{label}: {rec}")
    return rec


def spmm_encoders_supervised(dev):
    """Phase 9 (a): the launches of one captured fine-tuning step
    (``reference`` freeze) and of one evaluation batch of each encoder,
    every count set to 0 before each."""
    _, _, batches = bace(dev, 3)
    out = {}
    for enc in SPMM_ENCODERS:
        model, opt = ft_model(dev, {"encoder": enc})
        step = make_finetune_step(model, opt, "bce")
        gen = torch.Generator(device=dev).manual_seed(1)
        step(*batches[0], gen)                    # eager warm-up, capture
        reset_launch_counts()
        step(*batches[1], gen)
        torch.cuda.synchronize()
        ft = expect_exact(f"one finetune step ({enc})",
                          SPMM_ENCODER_FT_PER_STEP)
        run = make_eval_fn(model)
        reset_launch_counts()
        run(*fresh(batches[2], dev), gen)
        torch.cuda.synchronize()
        ev = expect_exact(f"one eval batch ({enc})",
                          SPMM_ENCODER_EVAL_PER_BATCH)
        out[enc] = {"finetune_step_launches": ft, "eval_batch_launches": ev}
    print(f"GCN / GraphSAGE supervised launches: {json.dumps(out)}",
          flush=True)
    return out


def slice_phase(g, sub, dev, ds, caps, runs, records, supervised):
    """Phase 9; adds the GCN and GraphSAGE main paths to ``runs`` and the
    SpMM shapes to ``records``, and returns its readings."""
    report = {}
    for name in SPMM_ENCODERS:
        runs[name] = main_path(name, *RUNS[name])
    report["medians"] = medians_phase(SPMM_ENCODERS)
    report["supervised_launches"] = spmm_encoders_supervised(dev)
    records += spmm_shapes(g, sub, dev)
    for encoder in SPMM_ENCODERS:
        model_phase(g, sub, dev, encoder)
    with deterministic():
        report["captured_vs_eager"] = captured_vs_eager(
            dev, bench_batches(dev, ds, caps), "GCN", {"encoder": "GCN"},
            SPMM_ENCODER_PER_STEP)
    report["dense"] = dense_phase(dev, ds, caps)
    report["evaluation"] = captured_eval_phase(dev)
    report["eval_verb"] = supervised["verbs"]["eval"]
    report["reference_import"] = reference_import_phase(dev)
    print(f"phase 9: {json.dumps(report)}", flush=True)
    return report


# --- 10. the data path -------------------------------------------------------

DATA_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_data")
SUPER_K = 32                  # bench.py's SUPER_K
GT_SUPER_K = 4
SUPERS_COMPARED = 3           # the first call eager, then two replays (the
                              # stale-input fault shows on the second)
SUSTAINED_BATCHES = 192       # bench.py's: 6 superbatches of 32
PREPROCESS_N = 4096
# a dozen molecules the verb's CSV cycles through to BACE's size
SMILES_TABLE = ("CCO", "c1ccccc1O", "CC(=O)Nc1ccc(O)cc1", "CCN(CC)CC",
                "c1ccncc1", "C1CCCCC1N", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
                "O=C(O)c1ccccc1", "CC#N", "c1ccoc1", "CCOC(=O)C",
                "NC(=O)N")


def batches_equal(a, b):
    """Field by field, dtypes and values, flags and absent fields."""
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None or isinstance(y, (bool, int)):
            if x != y:
                return False
        elif x.dtype != y.dtype or not np.array_equal(x, y):
            return False
    return True


def packers_phase(ds, caps):
    """(a) the native flat packer against the per-graph packers on the
    benchmark batches, bit for bit; host ms a batch of each."""
    t0 = time.perf_counter()
    ds.flat()
    flat_s = time.perf_counter() - t0
    per_graph, flat = [], []
    for sel in plan_batches(ds, 128, caps, seed=7):
        t0 = time.perf_counter()
        a = pack_batch(ds, sel, caps)
        t1 = time.perf_counter()
        b = pack_batch(ds, sel, caps, use_flat=True)
        t2 = time.perf_counter()
        per_graph.append((t1 - t0) * 1e3)
        flat.append((t2 - t1) * 1e3)
        if not all(batches_equal(x, y) for x, y in zip(b, a)):
            raise AssertionError("the native flat packer is not the "
                                 "per-graph packers")
    rec = {"batches": len(flat), "per_graph_ms": statistics.median(per_graph),
           "native_flat_ms": statistics.median(flat),
           "flat_view_build_s": flat_s}
    print(f"packers: {json.dumps(rec)}", flush=True)
    return rec


def wire_phase(ds, caps, dev):
    """(b) bytes a batch in both wire modes against the padded batch's,
    ``wire_compact_ok``'s verdict, and ``from_wire_*`` on the card equal
    to the packer's batch on every real entry (masks and flags whole,
    padded indices in range)."""
    g, sub = pack_batch(ds, plan_batches(ds, 128, caps, seed=7)[0], caps,
                        use_flat=True)
    ref_g, ref_s = g.to(dev), sub.to(dev)
    rec = {"compact_ok": loader.wire_compact_ok(ds),
           "padded_bytes": sum(nbytes(v) for b in (ref_g, ref_s)
                               for _, v in trainer._fields(b)
                               if isinstance(v, torch.Tensor))}
    for compact in (False, True):
        pair = (wire.to_wire_graph(g, compact), wire.to_wire_sub(sub, compact))
        spec = wire.byte_spec_of(pair)
        buf = torch.from_numpy(wire.pack_bytes(pair, spec)).to(dev)
        wg, ws = wire.unpack_bytes(buf, spec)
        ws.pool_fits = sub.pool_fits        # beside the buffer, not in it
        for got, want, n_cap in ((wire.from_wire_graph(wg), ref_g,
                                  ref_g.num_nodes),
                                 (wire.from_wire_sub(ws), ref_s,
                                  ref_g.num_nodes)):
            for name, v in trainer._fields(want):
                u = getattr(got, name)
                if not isinstance(v, torch.Tensor):
                    ok = u == v
                elif name in ("senders", "receivers", "node_center",
                              "node_orig"):
                    m = (want.edge_mask if name in ("senders", "receivers")
                         else want.node_mask)
                    cap = (want.node_mask.shape[0]
                           if name in ("senders", "receivers") else n_cap)
                    ok = (u.dtype == v.dtype and torch.equal(u[m], v[m])
                          and int(u.min()) >= 0 and int(u.max()) < cap)
                else:
                    ok = u.dtype == v.dtype and torch.equal(u, v)
                if not ok:
                    raise AssertionError(f"wire (compact={compact}) "
                                         f"{name} differs from the packer's")
        rec["compact_bytes" if compact else "absolute_bytes"] = spec.total
    print(f"wire a batch: {json.dumps(rec)}", flush=True)
    return rec


def reserved_mb():
    """Device memory the caching allocator holds, its free blocks of the
    default pool returned first: what live tensors and graph pools hold."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**20


@contextlib.contextmanager
def capture_probe():
    """Records each capture's seconds and the device memory its graph's
    private pool keeps, and counts the replays."""
    rec = {"captures": [], "replays": 0}
    cap, rep = trainer._CapturedSteps._capture, trainer._CapturedSteps._replay

    def capture(self, *args):
        before, t0 = reserved_mb(), time.perf_counter()
        out = cap(self, *args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rec["captures"].append({"s": secs,
                                "graph_pool_mb": reserved_mb() - before})
        return out

    def replay(self, *args):
        rec["replays"] += 1
        return rep(self, *args)
    trainer._CapturedSteps._capture = capture
    trainer._CapturedSteps._replay = replay
    try:
        yield rec
    finally:
        trainer._CapturedSteps._capture = cap
        trainer._CapturedSteps._replay = rep


def decoded(buf, spec, fits):
    """The batches of a device superbatch, decoded from views of it, each
    with the superbatch's pooling flag."""
    gs, subs = wire.unpack_bytes(buf, spec)
    out = []
    for k in range(gs.n_nodes.shape[0]):
        sub = wire.from_wire_sub(wire.index_wire(subs, k))
        sub.pool_fits = fits
        out.append((wire.from_wire_graph(wire.index_wire(gs, k)), sub))
    return out


def superbatch_run(dev, supers, spec, kwargs, how):
    """One start (PretrainModel(9, 64, 32), seeded weights, Adam,
    generator), then ``supers`` through the superbatch step ("superbatch")
    or each of their decoded batches through the captured single step
    ("single").  Returns (losses as bytes, step_bytes, the launch counts
    of each call, the step)."""
    model = PretrainModel(9, hidden=64, d_transfer=32, num_heads=HEADS,
                          **kwargs)
    init_flax_style_(model, torch.Generator().manual_seed(11))
    model.to(dev)
    opt = adam_l2(model, 1e-4, 5e-5)
    gen = torch.Generator(device=dev).manual_seed(12)
    losses, calls = [], []
    if how == "superbatch":
        step = make_pretrain_superbatch_step(model, opt, spec)
        for buf, _, fits in supers:
            reset_launch_counts()
            out = step(buf, fits, gen)
            losses += [[t[i] for t in out] for i in range(len(out.total))]
            calls.append(launch_counts())
    else:
        step = make_pretrain_step(model, opt)
        reset_launch_counts()
        for buf, _, fits in supers:
            losses += [step(g, s, gen) for g, s in decoded(buf, spec, fits)]
        calls.append(launch_counts())
    torch.cuda.synchronize()
    as_bytes = {f"step {i} {name}": t.detach().cpu().numpy().tobytes()
                for i, ls in enumerate(losses)
                for name, t in zip(("kl", "contrastive", "recon"), ls)}
    return as_bytes, step_bytes(model, opt, gen), calls, step


def superbatch_vs_single(dev, ds, caps, label, kwargs, per_step, k):
    """(c) SUPERS_COMPARED superbatches of ``k`` through the captured
    superbatch step against the captured single step on the same decoded
    batches, under deterministic algorithms: losses and state byte-equal,
    the stale-input fault not; every call's launches ``k`` x ``per_step``
    (the replays' as the eager first call's)."""
    epochs = -(-SUPERS_COMPARED * k // len(plan_batches(ds, 128, caps)))
    spec = superbatch_spec(ds, 128, caps, k, epochs=epochs)
    supers = list(itertools.islice(loader.prefetch_to_device(
        loader.wire_superbatches(ds, 128, caps, k, seed=7, byte_spec=spec,
                                 epochs=epochs),
        size=3, device=dev, host_stage=2), SUPERS_COMPARED))
    with deterministic():
        single = superbatch_run(dev, supers, spec, kwargs, "single")
        with capture_probe() as probe:
            sup = superbatch_run(dev, supers, spec, kwargs, "superbatch")
        with stale_replays():
            fault = superbatch_run(dev, supers, spec, kwargs, "superbatch")
    want = {name: n * k for name, n in per_step.items()}
    rec = {"k": k, "buffer_bytes": spec.total,
           "losses_apart": bytes_apart(single[0], sup[0]),
           "state_apart": bytes_apart(single[1], sup[1]),
           "fault_losses_apart": len(bytes_apart(single[0], fault[0])),
           "fault_state_apart": len(bytes_apart(single[1], fault[1])),
           "graphs": len(sup[3].graphs), "replays": probe["replays"],
           "capture": probe["captures"],
           "replay_launches": {n: c for n, c in sup[2][-1].items() if c}}
    print(f"superbatch vs single steps ({label}, K={k}): "
          f"{json.dumps(rec)}", flush=True)
    for calls in sup[2]:
        if {n: c for n, c in calls.items() if c} != want:
            raise AssertionError(f"{label}: a superbatch call launched "
                                 f"{calls}, expected {want}")
    if {n: c for n, c in single[2][0].items() if c} != {
            n: c * SUPERS_COMPARED for n, c in want.items()}:
        raise AssertionError(f"{label}: the single steps launched "
                             f"{single[2][0]}")
    if rec["losses_apart"] or rec["state_apart"] or rec["graphs"] != 1 \
            or rec["replays"] != SUPERS_COMPARED - 1:
        raise AssertionError(f"{label}: the superbatch step is not the "
                             f"single steps: {rec}")
    if not (rec["fault_losses_apart"] and rec["fault_state_apart"]):
        raise AssertionError(f"{label}: the planted fault went unseen")
    return rec, sup[2][-1]


class DeviceClock:
    """The device time of each call a loop brackets with ``span()``: a
    CUDA event on the current stream before and after it, read once the
    loop is over.  The loop's busy share is their sum over its wall
    time.  A replay's span is device work from end to end; an eager
    call's also holds the device's waits for the host, so a loop with
    one is not read this way."""

    def __init__(self):
        self.marks = []

    @contextlib.contextmanager
    def span(self):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        yield
        b.record()
        self.marks.append((a, b))

    def read(self, wall_s):
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.marks]
        return {"call_device_ms": statistics.median(ms),
                "device_busy_share": sum(ms) / (wall_s * 1e3)}


def superbatch_loop(step, ds, caps, spec, epochs, gen, dev, workers=4):
    """SUSTAINED_BATCHES fresh batches through wire_superbatches ->
    prefetch_to_device(size=3, host_stage=2) -> ``step``, one loss read a
    superbatch: ms a batch, edges/s and the device clock's readings."""
    clock = DeviceClock()
    t0 = time.perf_counter()
    edges = 0
    for buf, n_edges, fits in loader.prefetch_to_device(
            loader.wire_superbatches(ds, 128, caps, SUPER_K, seed=7,
                                     byte_spec=spec, epochs=epochs,
                                     workers=workers),
            size=3, device=dev, host_stage=2):
        with clock.span():
            losses = step(buf, fits, gen)
        float(np.sum(losses.total.cpu().numpy()))
        edges += n_edges
    wall = time.perf_counter() - t0
    return {"ms_per_batch": wall * 1e3 / SUSTAINED_BATCHES,
            "edges_per_s": edges / wall, **clock.read(wall)}


def skewed_pool():
    """The benchmark pool with about 2% of its molecules replaced by dense
    graphs of 20 nodes (each pair joined with probability 0.9, features
    drawn from a seed): some batches' first center tiles own more ego-net
    rows than the pooling window holds (``pool_fits`` False), and most
    superbatches of 32 hold such a batch."""
    rng = np.random.default_rng(0)
    graphs = []
    for g in random_dataset(1024, seed=7, min_nodes=10, max_nodes=30):
        if rng.random() < 0.02:
            upper = np.triu(rng.random((20, 20)) < 0.9, 1)
            s, r = np.nonzero(upper | upper.T)
            g = GraphData(senders=s.astype(np.int32),
                          receivers=r.astype(np.int32),
                          node_feat=rng.integers(0, 4, size=(20, 9)).astype(
                              np.int8))
        graphs.append(g)
    ds = GraphDataset(graphs, k=1)
    return ds, plan_capacities(ds, 128)


def sustained_phase(dev, ds, caps):
    """(d) bench.py's sustained loop: SUSTAINED_BATCHES fresh batches as
    superbatches of SUPER_K, wire_superbatches -> prefetch_to_device(size=3,
    host_stage=2) -> the captured superbatch step (one loss read a
    superbatch), after one warm-up superbatch (its eager steps and the
    capture); then the same batches through the captured single step, fed
    as run_pretraining feeds it (the native packer in prefetch_to_device's
    thread) and by packing on the consumer thread (the per-graph packers
    and a blocking copy), a loss read a step.  Wall ms a batch, edges/s,
    and the device's busy share in the loop (``DeviceClock``: each step
    call's device time, summed, over the wall time); the superbatch loop
    again with 0 and 2 packing threads (4 by default); and once on
    ``skewed_pool()`` from a fresh model: the graphs its superbatch step
    captures (one for each value of the superbatch's one pooling flag),
    against the distinct tuples of per-batch flags its superbatches hold
    (what a key on every batch's flag would capture)."""
    n_super = SUSTAINED_BATCHES // SUPER_K
    per_epoch = len(plan_batches(ds, 128, caps))
    epochs = -(-SUSTAINED_BATCHES // per_epoch)
    spec = superbatch_spec(ds, 128, caps, SUPER_K, epochs=epochs)
    report = {}

    def fresh_model():
        model = PretrainModel(9, hidden=64, d_transfer=32)
        init_flax_style_(model, torch.Generator().manual_seed(11))
        model.to(dev)
        return model, adam_l2(model, 1e-4, 5e-5), torch.Generator(
            device=dev).manual_seed(12)

    # the superbatch loop
    model, opt, gen = fresh_model()
    step = make_pretrain_superbatch_step(model, opt, spec)
    warm = next(loader.wire_superbatches(ds, 128, caps, SUPER_K, seed=99,
                                         byte_spec=spec, epochs=epochs))
    with capture_probe() as probe:
        t0 = time.perf_counter()
        float(step(torch.from_numpy(warm[0]).to(dev), warm[2],
                   gen).total[-1])
        warm_s = time.perf_counter() - t0
        reset_launch_counts()
        rec = superbatch_loop(step, ds, caps, spec, epochs, gen, dev)
        counts = launch_counts()
    src = torch.empty(spec.total, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    report["superbatch"] = {
        **rec, "superbatches": n_super, "graph_keys": len(step.graphs),
        "warmup_s": warm_s, "capture": probe["captures"],
        "buffer_bytes": spec.total,
        "buffer_copy_ms": time_ms(lambda: dst.copy_(src))}
    runs = {"superbatch loop": counts}
    if counts != {n: GIN_PER_STEP.get(n, 0) * SUSTAINED_BATCHES
                  for n in PATH}:
        raise AssertionError(f"sustained superbatch loop: launches {counts}")
    if probe["replays"] != n_super or len(step.graphs) != 1:
        raise AssertionError(f"sustained loop: {len(step.graphs)} graphs, "
                             f"{probe['replays']} replays")
    # the same loop with other numbers of packing threads (4 above)
    for workers in (0, 2):
        rec = superbatch_loop(step, ds, caps, spec, epochs, gen, dev,
                              workers=workers)
        report[f"superbatch, {workers} packing threads"] = rec
    del step, src, dst

    # the superbatch loop on the skewed pool, from its first superbatch
    sds, scaps = skewed_pool()
    s_epochs = -(-SUSTAINED_BATCHES // len(plan_batches(sds, 128, scaps)))
    s_spec = superbatch_spec(sds, 128, scaps, SUPER_K, epochs=s_epochs)
    flags = [s.pool_fits for e in range(s_epochs) for _, s in batch_iterator(
        sds, 128, scaps, seed=7 + e, use_flat=True)][:SUSTAINED_BATCHES]
    tuples = [tuple(flags[i:i + SUPER_K])
              for i in range(0, SUSTAINED_BATCHES, SUPER_K)]
    model, opt, gen = fresh_model()
    step = make_pretrain_superbatch_step(model, opt, s_spec)
    with capture_probe() as probe:
        reset_launch_counts()
        rec = superbatch_loop(step, sds, scaps, s_spec, s_epochs, gen, dev)
        counts = launch_counts()
    report["superbatch, skewed pool"] = {      # its first call is eager
        "ms_per_batch": rec["ms_per_batch"],
        "edges_per_s": rec["edges_per_s"],
        "batches_not_fitting": flags.count(False),
        "superbatches_fitting": sum(all(t) for t in tuples),
        "graph_keys": len(step.graphs),
        "flag_tuples": len(set(tuples)), "capture": probe["captures"]}
    runs["superbatch loop, skewed pool"] = counts
    want = {n: GIN_PER_STEP.get(n, 0) * SUSTAINED_BATCHES for n in PATH}
    want["pool"] = GIN_PER_STEP["pool"] * SUPER_K * sum(all(t)
                                                        for t in tuples)
    if counts != want or len(step.graphs) != len({all(t) for t in tuples}):
        raise AssertionError(f"skewed superbatch loop: launches {counts}, "
                             f"{len(step.graphs)} graphs, "
                             f"{report['superbatch, skewed pool']}")
    del step

    # the captured single step, prefetched and packed on the consumer thread
    for how in ("prefetched", "packed on the consumer thread"):
        model, opt, gen = fresh_model()
        step = make_pretrain_step(model, opt)
        g, s = next(batch_iterator(ds, 128, caps, seed=99))
        float(step(g.to(dev), s.to(dev), gen).total)     # eager + capture
        batches = (b for e in range(epochs) for b in batch_iterator(
            ds, 128, caps, seed=7 + e, use_flat=how == "prefetched"))
        batches = itertools.islice(batches, SUSTAINED_BATCHES)
        reset_launch_counts()
        clock = DeviceClock()
        t0 = time.perf_counter()
        edges = 0
        if how == "prefetched":         # as run_pretraining feeds its steps
            feed = loader.prefetch_to_device(loops._counted(batches),
                                             device=dev)
        else:
            feed = ((g.to(dev), s.to(dev), n, m) for g, s, n, m in
                    loops._counted(batches))
        for g, s, n, _ in feed:
            with clock.span():
                losses = step(g, s, gen)
            float(losses.total)
            edges += n
        wall = time.perf_counter() - t0
        runs[f"single step, {how}"] = launch_counts()
        report[f"single step, {how}"] = {
            "ms_per_batch": wall * 1e3 / SUSTAINED_BATCHES,
            "edges_per_s": edges / wall, **clock.read(wall)}
        del step
    print(f"sustained loop, {SUSTAINED_BATCHES} batches: "
          f"{json.dumps(report)}", flush=True)
    return report, runs


def data_verbs_phase():
    """(e) ``preprocess --synthetic 4096 --k 1``, then ``pretrain --cache
    --superbatch 32`` for 2 epochs (the second superbatch a replay), then
    ``finetune --dataset BACE --smiles_csv`` for one epoch on a CSV of
    BACE's size cycled from SMILES_TABLE with labels from a seed; each
    run's launch counts those of its steps (and evaluation batches)."""
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    os.makedirs(DATA_DIR)
    cache = os.path.join(DATA_DIR, "synth.npz")
    report, runs = {}, {}
    ds, secs = verb_run("preprocess", [
        "preprocess", "--synthetic", str(PREPROCESS_N), "--k", "1",
        "--out", cache])
    report["preprocess"] = {"s": secs, "graphs": len(ds),
                            "bytes": os.path.getsize(cache)}
    with capture_probe() as probe:
        info, secs = verb_run("pretrain --cache --superbatch", [
            "pretrain", "--cache", cache, "--superbatch", str(SUPER_K),
            "--epochs", "2", "--out", os.path.join(DATA_DIR, "p.msgpack")])
    steps = info["throughput"]["steps"] * SUPER_K
    check_verb_counts("pretrain --cache --superbatch", steps)
    runs["pretrain --cache --superbatch"] = launch_counts()
    if probe["replays"] < 1 or not all(math.isfinite(x)
                                       for x in info["history"]):
        raise AssertionError(f"pretrain --superbatch: {probe}, "
                             f"{info['history']}")
    report["pretrain_superbatch"] = {
        "s": secs, "steps": steps, "replays": probe["replays"],
        "capture": probe["captures"], "history": info["history"],
        "edges_per_s": info["throughput"]["edges_per_s"]}
    csv_path = os.path.join(DATA_DIR, "bace.csv")
    labels = np.random.default_rng(0).integers(0, 2, BACE_N)
    with open(csv_path, "w") as f:
        f.write("smiles,Class\n")
        for i in range(BACE_N):
            f.write(f"{SMILES_TABLE[i % len(SMILES_TABLE)]},{labels[i]}\n")
    run, secs = verb_run("finetune --smiles_csv", [
        "finetune", "--dataset", "BACE", "--smiles_csv", csv_path,
        "--epochs", "1"])
    spec = cli.DATASETS["BACE"]
    args = cli.build_parser().parse_args(
        ["finetune", "--dataset", "BACE", "--smiles_csv", csv_path])
    data = cli._build_dataset(args, spec.num_tasks, spec.feat_dim)
    caps = plan_capacities(data, 128)
    _, val, test = cli._splits(data, spec, 42)
    evals = sum(len(plan_batches(d, 128, caps, shuffle=False))
                for d in (val, test))
    got_steps = run["last"]["throughput"]["steps"]
    expect_exact("finetune --smiles_csv", add_counts(
        (FT_PER_STEP["GIN"], got_steps), (EVAL_PER_BATCH["GIN"], evals)))
    runs["finetune --smiles_csv"] = launch_counts()
    if len(data) != BACE_N or not all(
            math.isfinite(x) for row in run["last"]["history"] for x in row):
        raise AssertionError(f"finetune --smiles_csv: {len(data)} graphs, "
                             f"{run['last']['history']}")
    report["finetune_smiles_csv"] = {"s": secs, "steps": got_steps,
                                     "history": run["last"]["history"]}
    shutil.rmtree(DATA_DIR)
    print(f"data verbs: {json.dumps(report)}", flush=True)
    return report, runs


def profile_trace_phase(dev, ds, caps):
    """(f) ``profile_trace`` around 3 captured GIN steps writes a trace."""
    model = PretrainModel(9, hidden=64, d_transfer=32)
    init_flax_style_(model, torch.Generator().manual_seed(11))
    model.to(dev)
    step = make_pretrain_step(model, adam_l2(model, 1e-4, 5e-5))
    batches = bench_batches(dev, ds, caps, 5)
    for g, s in batches[:2]:
        step(g, s)
    log_dir = os.path.join(ROOT, ".scratch", "chip_smoke_trace")
    shutil.rmtree(log_dir, ignore_errors=True)
    with profile_trace(log_dir) as prof:
        for g, s in batches[2:]:
            step(g, s)
        torch.cuda.synchronize()
    files = os.listdir(log_dir)
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    rec = {"files": len(files), "events": len(events),
           "kernel_events": sum(e.get("cat") == "kernel" for e in events),
           "device_ms": sum(e.self_device_time_total
                            for e in prof.key_averages()) / 1e3}
    shutil.rmtree(log_dir)
    print(f"profile_trace: {json.dumps(rec)}", flush=True)
    if rec["files"] != 1 or not rec["events"]:
        raise AssertionError(f"profile_trace wrote no trace: {rec}")
    return rec


def data_phase(dev, ds, caps):
    """Phase 10; returns its readings and the launch counts of its
    runs."""
    report, runs, secs = {}, {}, {}
    clock = [time.perf_counter()]

    def part(name, value):
        now = time.perf_counter()
        secs[name], clock[0] = now - clock[0], now
        report[name] = value

    part("packers", packers_phase(ds, caps))
    part("wire", wire_phase(ds, caps, dev))
    for label, kwargs, per_step, k in (
            ("GIN", {}, GIN_PER_STEP, SUPER_K),
            ("Transformer", {"encoder": "Transformer"}, GT_PER_STEP,
             GT_SUPER_K)):
        rec, runs[f"{label} superbatch replay, K={k}"] = \
            superbatch_vs_single(dev, ds, caps, label, kwargs, per_step, k)
        part(label, rec)
    rec, sustained_runs = sustained_phase(dev, ds, caps)
    runs.update(sustained_runs)
    part("sustained", rec)
    rec, verb_runs = data_verbs_phase()
    runs.update(verb_runs)
    part("verbs", rec)
    part("profile_trace", profile_trace_phase(dev, ds, caps))
    report["seconds"] = secs
    print(f"phase 10: {json.dumps(report)}", flush=True)
    return report, runs


# --- 11. data parallel and remat --------------------------------------------

DP_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_dp")
# one DP GIN pretraining step's collectives on the card.  Forward: the 8
# sync-BN all-reduces, the KL and contrastive counts, the reconstruction's
# node count and gram (12), the contrastive's 3 gathers.  Backward: the 8
# BatchNorms', the 2 gathered readouts' and the gram's (11).  The step: the
# gradients, the losses, the statistics (3).
DP_COLLECTIVES = {"all_reduce card": 12 + 11 + 3, "all_gather card": 3}
GLOO_RANKS = 2
HALF = 64                     # each gloo rank's half of a benchmark batch
TIMED_CALLS = 10
# bench_peptides.py: 32 graphs of 120-160 nodes, k = 3
PEPTIDES = {"graphs": 32, "min_nodes": 120, "max_nodes": 160, "k": 3}
REMAT_STEPS = 3


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def counted_collectives():
    """Counts of ``dist.all_reduce`` and ``dist.all_gather`` calls in the
    block, by the device of their tensor."""
    counts = collections.Counter()
    real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

    def counting(name):
        def call(*args, **kwargs):
            t = args[1] if name == "all_gather" else args[0]
            counts[f"{name} {'card' if t.is_cuda else 'host'}"] += 1
            return real[name](*args, **kwargs)
        return call
    for name in real:
        setattr(dist, name, counting(name))
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


@contextlib.contextmanager
def halved_gradients():
    """A planted fault: the summed gradients halved, as
    DistributedDataParallel's averaging would leave them at world size 2."""
    real = dp._sum_gradients

    def halved(optimizer, group):
        real(optimizer, group)
        for pg in optimizer.param_groups:
            for p in pg["params"]:
                if p.grad is not None:
                    p.grad.div_(2)
    dp._sum_gradients = halved
    try:
        yield
    finally:
        dp._sum_gradients = real


def call_median(step, batch, gen, n=TIMED_CALLS):
    """Median host ms of ``n`` calls of a (captured) step, each ended by a
    synchronize."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dp_run(dev, batches, group):
    """One step a batch from one start (PretrainModel(9, 64, 32), seeded
    weights, Adam, generator): the captured single step (``group`` None)
    or the captured DP step over ``group``.  Returns (losses as bytes,
    step_bytes, launch counts, (step, generator))."""
    model = PretrainModel(9, hidden=64, d_transfer=32, group=group)
    init_flax_style_(model, torch.Generator().manual_seed(11))
    model.to(dev)
    opt = adam_l2(model, 1e-4, 5e-5)
    gen = torch.Generator(device=dev).manual_seed(12)
    step = (make_pretrain_step(model, opt) if group is None
            else dp.make_dp_pretrain_step(model, opt, group))
    reset_launch_counts()
    losses = [step(g, s, gen) for g, s in batches]
    torch.cuda.synchronize()
    counts = launch_counts()
    as_bytes = {f"step {i} {name}": t.cpu().numpy().tobytes()
                for i, ls in enumerate(losses)
                for name, t in zip(("kl", "contrastive", "recon"), ls)}
    return as_bytes, step_bytes(model, opt, gen), counts, (step, gen)


def dp_world1_phase(dev, batches):
    """(a) the captured DP step at world size 1 over NCCL against the
    captured single step, 6 steps from one start under deterministic
    algorithms: losses and state byte-equal, the halved-gradient fault
    apart, the launches of a step the single step's; the collectives of
    one DP step; the medians of both steps' calls."""
    multihost.initialize_distributed(f"tcp://127.0.0.1:{free_port()}",
                                     world_size=1, rank=0)
    try:
        group = dp.make_mesh()
        with deterministic():
            single = dp_run(dev, batches, None)
            dp_step = dp_run(dev, batches, group)
            with halved_gradients():
                fault = dp_run(dev, batches, group)
        rec = {"losses_apart": bytes_apart(single[0], dp_step[0]),
               "state_apart": bytes_apart(single[1], dp_step[1]),
               "fault_state_apart": len(bytes_apart(single[1], fault[1]))}
        want = {k: n * len(batches) for k, n in GIN_PER_STEP.items()}
        for name, run in (("single", single), ("DP", dp_step)):
            got = {k: n for k, n in run[2].items() if n}
            if got != want:
                raise AssertionError(f"DP world 1, {name} step: launches "
                                     f"{got}, expected {want}")
        rec["launches_a_step"] = {k: n // len(batches)
                                  for k, n in dp_step[2].items() if n}
        model = PretrainModel(9, hidden=64, d_transfer=32, group=group)
        model.to(dev)
        with counted_collectives() as coll:
            dp.dp_pretrain_step_eager(model, adam_l2(model, 1e-4, 5e-5),
                                      group, *batches[0])
        torch.cuda.synchronize()
        rec["collectives_a_step"] = dict(coll)
        # call times from fresh captures outside deterministic algorithms
        timed = {"single": dp_run(dev, batches[:2], None)[3],
                 "DP": dp_run(dev, batches[:2], group)[3]}
        rec["call_ms"] = [(name, call_median(*timed[name][:1], batches[1],
                                             timed[name][1]))
                          for name in ("single", "DP", "DP", "single")]
        print(f"phase 11 (a) DP world 1 over NCCL: {json.dumps(rec)}",
              flush=True)
        if rec["losses_apart"] or rec["state_apart"]:
            raise AssertionError(f"the DP step at world size 1 is not the "
                                 f"single step: {rec}")
        if not rec["fault_state_apart"]:
            raise AssertionError("the halved gradients went unseen")
        if rec["collectives_a_step"] != DP_COLLECTIVES:
            raise AssertionError(f"collectives {rec['collectives_a_step']}, "
                                 f"expected {DP_COLLECTIVES}")
        return rec, {"DP world 1 over NCCL, captured": dp_step[2]}
    finally:
        dist.destroy_process_group()


def gloo_data():
    """The host batches of phase 11 (b): for each case, each rank's halves
    and the single device's union batches (the benchmark pool's first 256
    molecules, two batches of 128; BACE's first 128)."""
    def halves_and_unions(d, n_batches):
        half = plan_capacities(d, HALF)
        whole = loader.Capacities(*(GLOO_RANKS * getattr(half, f.name)
                                    for f in dataclasses.fields(half)))
        size = GLOO_RANKS * HALF
        ranks = [[pack_batch(d, np.arange(size * k + HALF * r,
                                          size * k + HALF * (r + 1)),
                             half, use_flat=True) for k in range(n_batches)]
                 for r in range(GLOO_RANKS)]
        unions = [pack_batch(d, np.arange(size * k, size * (k + 1)), whole,
                             use_flat=True) for k in range(n_batches)]
        return ranks, unions
    ds = GraphDataset(random_dataset(1024, seed=7, min_nodes=10,
                                     max_nodes=30), k=1)
    lds = GraphDataset(random_dataset(BACE_N, seed=42, num_tasks=1), k=1)
    pre, pre_u = halves_and_unions(ds, 2)
    ft, ft_u = halves_and_unions(lds, 1)
    return {"pretrain": (pre, pre_u[:1]), "finetune": (ft, ft_u),
            "superbatch": (pre, pre_u)}


def gloo_model(case, group=None):
    if case == "finetune":
        return FinetuneModel(9, hidden=64, d_transfer=32, deterministic=True,
                             group=group)
    return PretrainModel(9, hidden=64, d_transfer=32, deterministic=True,
                         group=group)


def gloo_optimizer(case, model):
    if case == "finetune":
        return masked_adam(model, finetune_trainable_mask(model), FT_LR,
                           FT_WD)
    return adam_l2(model, 1e-4, 5e-5)


def masked(model, keep):
    """The gradients of ``tests/test_torch_trainer.py``'s mask: entries that
    are zero but for rounding at the start are set to 0."""
    for name, p in model.named_parameters():
        if name in keep:
            p.register_hook(lambda g, k=keep[name]: g * k)
    return model


def gloo_single(case, weights, unions, dev):
    """The single-device eager steps on the union batches from ``weights``,
    under the mask of their first gradient, on the card and, for the
    gradients, in float64 on the CPU: (mask, record, float64 gradients)."""
    model = gloo_model(case)
    model.load_state_dict(weights)
    probe = copy.deepcopy(model).to(dev)
    g, s = (b.to(dev) for b in unions[0])
    loss = (trainer.finetune_loss(probe, g, s, "bce", None)
            if case == "finetune" else probe(g, s).total)
    loss.backward()
    grads = {n: p.grad.abs() for n, p in probe.named_parameters()
             if p.grad is not None}
    scale = max(float(v.max()) for v in grads.values())
    keep = {n: (v > 1e-5 * scale).float() for n, v in grads.items()}
    out = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        m = copy.deepcopy(model).to(device, dtype)
        masked(m, {n: k.to(device, dtype) for n, k in keep.items()})
        opt = gloo_optimizer(case, m)
        losses = []
        for g, s in ((b.to(device) for b in pair) for pair in unions):
            g.node_feat = g.node_feat.to(dtype)
            if case == "finetune":
                g.labels = g.labels.to(dtype)
                loss = trainer.finetune_step_eager(m, opt, [(g, s)], "bce")
                losses.append([float(loss)])
            else:
                losses.append([float(x) for x in pretrain_step_eager(
                    m, opt, g, s)])
        out.append(gloo_record(m, opt, losses))
    return keep, out[0], out[1]["grads"]


def grad_gap(got, want):
    """(worst error, tensor): each tensor's largest error over its largest
    entry, floored at GRAD_FLOOR of the largest gradient (phase 4's
    measure)."""
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    return max((float((got[n].double() - w.double()).abs().max())
                / max(float(w.abs().max()), floor), n)
               for n, w in want.items())


def gloo_record(model, opt, losses):
    return {"losses": losses,
            "grads": {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
            "state": {k: v.detach().cpu()
                      for k, v in model.state_dict().items()},
            "bytes": step_bytes(model, opt, torch.Generator())}


def rank_command(rank, port):
    return [sys.executable, os.path.abspath(__file__), "--gloo-rank",
            str(rank), port]


def gloo_rank(rank, port, device="cuda"):
    """One rank of phase 11 (b), in a process of its own: the three DP
    steps over gloo on the card (``device``: a rehearsal's "cpu"), from
    the parent's weights and masks."""
    rank = int(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    multihost.initialize_distributed(f"tcp://127.0.0.1:{port}",
                                     world_size=GLOO_RANKS, rank=rank,
                                     device="cpu")
    group = dp.make_mesh()
    inputs = torch.load(os.path.join(DP_DIR, "inputs.pt"))
    data = gloo_data()
    out = {}
    for case, (ranks, _) in data.items():
        model = gloo_model(case, group)
        model.load_state_dict(inputs["weights"][case])
        model.to(dev)
        masked(model, {n: k.to(dev) for n, k in inputs["keep"][case].items()})
        opt = gloo_optimizer(case, model)
        mine = [tuple(b.to(dev) for b in pair) for pair in ranks[rank]]
        if case == "pretrain":
            step = dp.make_dp_pretrain_step(model, opt, group)
            losses = [[float(x) for x in step(*mine[0])]]
        elif case == "finetune":
            step = dp.make_dp_finetune_step(model, opt, group,
                                            dp.bce_sum_count)
            losses = [[float(step(*mine[0]))]]
        else:
            to_wire = loader._wire_pair(False)
            pairs = [to_wire(pair) for pair in ranks[rank]]
            spec = wire.byte_spec_of(loader._stack_group(pairs))
            buf = torch.from_numpy(wire.pack_bytes_grouped(pairs, spec))
            step = dp.make_dp_superbatch_step(model, opt, group, spec)
            fits = all(v.pool_fits for _, v in pairs)
            ls = step(buf.to(dev), fits)
            losses = [[float(x[k]) for x in ls] for k in range(len(pairs))]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[case] = gloo_record(model, opt, losses)
    torch.save(out, os.path.join(DP_DIR, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def gloo_phase(dev):
    """(b) two ranks on the one card over gloo, spawned, each with half of
    a benchmark batch: the DP pretraining step, the DP fine-tuning step
    (BACE's recipe, ``bce_sum_count``) and a DP superbatch step of K = 2,
    eager, against the single-device eager steps on the union batches:
    losses within MODEL_RTOL; the gradients of the ranks and of the single
    step each within GRAD_RTOL of the single step's in float64 on the CPU
    (phases 4 and 8's gate: two float32 results can each be that far from
    float64, so they are not held to it against each other); weights under
    ``tests/test_torch_trainer.py``'s mask; the two ranks' states
    byte-equal."""
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    data = gloo_data()
    weights, keep, single, grads64 = {}, {}, {}, {}
    for case, (_, unions) in data.items():
        model = gloo_model(case)
        init_flax_style_(model, torch.Generator().manual_seed(21))
        weights[case] = model.state_dict()
        keep[case], single[case], grads64[case] = gloo_single(
            case, weights[case], unions, dev)
    torch.save({"weights": weights,
                "keep": {c: {n: k.cpu() for n, k in m.items()}
                         for c, m in keep.items()}},
               os.path.join(DP_DIR, "inputs.pt"))
    port = str(free_port())
    procs = [subprocess.Popen(rank_command(r, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(GLOO_RANKS)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"gloo rank {r} exited {p.returncode}:\n"
                                 f"{log[-6000:]}")
    ranks = [torch.load(os.path.join(DP_DIR, f"rank{r}.pt"))
             for r in range(GLOO_RANKS)]
    report = {}
    for case, want in single.items():
        lr = FT_LR if case == "finetune" else 1e-4
        got = ranks[0][case]
        loss_rel = max(abs(a - b) / abs(b) for ga, wa in zip(
            got["losses"], want["losses"]) for a, b in zip(ga, wa))
        grad_rel, worst = grad_gap(got["grads"], grads64[case])
        single_rel, single_worst = grad_gap(want["grads"], grads64[case])
        params = set(want["grads"])
        state_apart = [k for k, w in want["state"].items() if not np.allclose(
            got["state"][k].numpy(), w.numpy(), rtol=1e-4,
            atol=5e-2 * lr if k in params else 1e-6)]
        ranks_apart = bytes_apart(ranks[0][case]["bytes"],
                                  ranks[1][case]["bytes"])
        report[case] = {"losses": got["losses"],
                        "single_losses": want["losses"],
                        "loss_rel": loss_rel,
                        "grad_rel_float64": [grad_rel, worst],
                        "single_grad_rel_float64": [single_rel,
                                                    single_worst],
                        "grad_rel_single": grad_gap(got["grads"],
                                                    want["grads"]),
                        "state_apart": state_apart,
                        "ranks_apart": ranks_apart}
        if (loss_rel > MODEL_RTOL or max(grad_rel, single_rel) > GRAD_RTOL
                or state_apart or ranks_apart):
            raise AssertionError(f"gloo DP {case} disagrees with the union "
                                 f"batch's step: {report[case]}")
    shutil.rmtree(DP_DIR)
    print(f"phase 11 (b) two gloo ranks on the card: {json.dumps(report)}",
          flush=True)
    return report


def peptide_batch():
    """bench_peptides.py's batch at k = 3, packed to its capacities (sizes
    rounded up to 256 nodes and 512 edges)."""
    ds = GraphDataset(random_dataset(
        PEPTIDES["graphs"], seed=0, min_nodes=PEPTIDES["min_nodes"],
        max_nodes=PEPTIDES["max_nodes"]), k=PEPTIDES["k"])

    def up(x, m):
        return max(m, -(-x // m) * m)
    n, e, sn, se = loader._sizes(ds)
    caps = loader.Capacities(up(int(n.sum()), 256), up(int(e.sum()), 512),
                             PEPTIDES["graphs"], up(int(sn.sum()), 256),
                             up(int(se.sum()), 512))
    return pack_batch(ds, np.arange(PEPTIDES["graphs"]), caps,
                      use_flat=True), caps


def remat_run(dev, batch, remat, measured):
    """REMAT_STEPS captured steps from one start (PretrainModel(9, 64,
    32), seeded).  ``measured``: the peak memory from a reset and the
    median of further calls, outside deterministic algorithms (whose
    sort-based ``index_add_`` a run does not use); else the steps under
    them, for the byte comparison.  Returns (readings, losses as bytes,
    step_bytes, launch counts)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = PretrainModel(9, hidden=64, d_transfer=32)
    init_flax_style_(model, torch.Generator().manual_seed(11))
    model.to(dev)
    opt = adam_l2(model, 1e-4, 5e-5)
    gen = torch.Generator(device=dev).manual_seed(12)
    step = make_pretrain_step(model, opt, remat=remat)
    reset_launch_counts()
    counters.reset("encoder")
    with (contextlib.nullcontext() if measured else deterministic()):
        losses = [step(*batch, gen) for _ in range(REMAT_STEPS)]
    torch.cuda.synchronize()
    counts = {k: n for k, n in launch_counts().items() if n}
    rec = {"launches_a_step": {k: n / REMAT_STEPS for k, n in counts.items()},
           "branches_a_step": {k: n / REMAT_STEPS
                               for k, n in counters.of("encoder").items()}}
    if measured:
        rec["peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        rec["call_ms"] = call_median(step, batch, gen)
    as_bytes = {f"step {i} {name}": t.cpu().numpy().tobytes()
                for i, ls in enumerate(losses)
                for name, t in zip(("kl", "contrastive", "recon"), ls)}
    return rec, as_bytes, step_bytes(model, opt, gen), counts


def forward_memory(dev, batch, remat):
    """MB held once one eager forward has returned (what its backward
    keeps), and the eager step's peak, from a fresh model."""
    model = PretrainModel(9, hidden=64, d_transfer=32)
    init_flax_style_(model, torch.Generator().manual_seed(11))
    model.to(dev).train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rand = uniform_draws(torch.Generator(device=dev).manual_seed(12), dev)
    losses = (trainer.remat_forward(model, *batch, rand) if remat
              else model(*batch, rand=rand))
    torch.cuda.synchronize()
    held = (torch.cuda.memory_allocated() - base) / 2**20
    losses.total.backward()
    torch.cuda.synchronize()
    return {"forward_held_mb": held,
            "step_peak_mb": (torch.cuda.max_memory_allocated() - base) / 2**20}


def remat_phase(dev, g, sub):
    """(c) the captured remat step against the captured plain step, at
    bench_peptides.py's k = 3 shapes and on the benchmark batch, 3 steps
    from one start under deterministic algorithms: byte-equal; the launches
    a step, every forward launch twice under remat (the recomputation):
    gin_fwd, pool and the reconstruction's forward spmm once more; then,
    from fresh starts outside deterministic algorithms, the peak memory
    and call ms of each, and what an eager forward leaves held for its
    backward."""
    (pg, ps), pcaps = peptide_batch()
    report, runs = {}, {}
    for label, batch in (("peptides k=3", (pg.to(dev), ps.to(dev))),
                         ("benchmark batch", (g, sub))):
        plain, remat = (remat_run(dev, batch, r, False) for r in (False,
                                                                   True))
        rec = {"plain": {**remat_run(dev, batch, False, True)[0],
                         "eager": forward_memory(dev, batch, False)},
               "remat": {**remat_run(dev, batch, True, True)[0],
                         "eager": forward_memory(dev, batch, True)},
               "losses_apart": bytes_apart(plain[1], remat[1]),
               "state_apart": bytes_apart(plain[2], remat[2])}
        if label.startswith("peptides"):
            rec["caps"] = dataclasses.asdict(pcaps)
            rec["band"] = pg.band_col_off is not None
            rec["pool_fits"] = ps.pool_fits
        per = plain[0]["launches_a_step"]
        want = dict(per)
        for k, n in (("gin_fwd", per.get("gin_fwd", 0)),
                     ("pool", per.get("pool", 0)),
                     ("spmm", per.get("spmm", 0) / 2)):
            if n:
                want[k] = per[k] + n
        report[label] = rec
        runs[f"remat, {label}"] = remat[3]
        print(f"phase 11 (c) remat, {label}: {json.dumps(rec)}", flush=True)
        if rec["losses_apart"] or rec["state_apart"]:
            raise AssertionError(f"remat, {label}: not the plain step: {rec}")
        if remat[0]["launches_a_step"] != want:
            raise AssertionError(f"remat, {label}: launches "
                                 f"{remat[0]['launches_a_step']}, expected "
                                 f"{want}")
        if remat[0]["branches_a_step"] != {
                k: 2 * n for k, n in plain[0]["branches_a_step"].items()}:
            raise AssertionError(f"remat, {label}: the recomputation did "
                                 f"not rerun every conv: {rec}")
    if report["benchmark batch"]["plain"]["launches_a_step"] != \
            GIN_PER_STEP:
        raise AssertionError("the benchmark batch left the kernel path")
    return report, runs


def feed_phase(dev):
    """(d) the repaired feed: the captured fine-tuning step over two
    epochs of BACE's training batches, fed as ``run_finetune`` feeds it
    now (``prefetch_to_device`` of the native packer) and as it fed it
    before (the per-graph packers on the consumer thread, blocking
    copies), alternating; host ms a batch, from the first pack to the last
    loss read; then the ``finetune`` verb's seconds and mean step ms (its
    first step's eager run and capture included)."""
    ds = GraphDataset(random_dataset(BACE_N, seed=42, num_tasks=1), k=1)
    caps = plan_capacities(ds, 128)
    train = ds.split(900, 313)[0]
    model, opt = ft_model(dev, {})
    step = make_finetune_step(model, opt, "bce")
    gen = torch.Generator(device=dev).manual_seed(1)
    g, s = next(batch_iterator(train, 128, caps))
    float(step(g.to(dev), s.to(dev), gen))          # eager + capture
    out = collections.defaultdict(list)
    for epoch, how in enumerate(("prefetched", "consumer thread",
                                 "consumer thread", "prefetched")):
        batches = batch_iterator(train, 128, caps, seed=epoch,
                                 use_flat=how == "prefetched")
        t0 = time.perf_counter()
        if how == "prefetched":
            feed = loader.prefetch_to_device(loops._counted(batches),
                                             device=dev)
        else:
            feed = ((g.to(dev), s.to(dev), n, m) for g, s, n, m in
                    loops._counted(batches))
        n = 0
        for g, s, _, _ in feed:
            float(step(g, s, gen))
            n += 1
        out[how].append((time.perf_counter() - t0) * 1e3 / n)
    run, secs = verb_run("finetune BACE (the repaired feed)", [
        "finetune", "--dataset", "BACE", "--synthetic", str(BACE_N),
        "--epochs", "2"])
    tp = run["last"]["throughput"]
    rec = {"ms_a_batch": dict(out), "batches_an_epoch": n,
           "verb_s": secs, "verb_steps": tp["steps"],
           "verb_mean_step_ms": tp["wall_s"] * 1e3 / tp["steps"]}
    print(f"phase 11 (d) the supervised feed: {json.dumps(rec)}", flush=True)
    return rec


def dp_remat_phase(dev, ds, caps, g, sub):
    """Phase 11; returns its readings and the launch counts of its runs."""
    report, runs, secs = {}, {}, {}
    t0 = time.perf_counter()
    report["dp_world1"], dp_runs = dp_world1_phase(
        dev, bench_batches(dev, ds, caps))
    runs.update(dp_runs)
    secs["a"], t0 = time.perf_counter() - t0, time.perf_counter()
    report["gloo"] = gloo_phase(dev)
    secs["b"], t0 = time.perf_counter() - t0, time.perf_counter()
    report["remat"], remat_runs = remat_phase(dev, g, sub)
    runs.update(remat_runs)
    secs["c"], t0 = time.perf_counter() - t0, time.perf_counter()
    report["feed"] = feed_phase(dev)
    secs["d"] = time.perf_counter() - t0
    report["seconds"] = secs
    print(f"phase 11: {json.dumps(report)}", flush=True)
    return report, runs



# --- 12. node-sharded pretraining -------------------------------------------

SHARD_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_sharded")
SHARD_WORLDS = (2, 4)         # gloo ranks on the one card
SHARD_STEPS = 3               # timed eager steps a gloo rank takes
SPANNING = {"graphs": 2, "seed": 7, "min_nodes": 12, "max_nodes": 15,
            "caps": (32, 256, 4, 256, 1024)}


def unbanded(ds, caps, sel):
    """The graphs ``sel`` of ``ds`` packed as ``pack_batch`` packs them,
    with no band (the node-sharded path takes the ring plan instead)."""
    graphs = [ds.graphs[j] for j in sel]
    return (pack_graphs(graphs, caps.nodes, caps.edges, caps.graphs,
                        banded=False),
            pack_subgraphs(graphs, [ds.egonets[j] for j in sel],
                           caps.sub_nodes, caps.sub_edges, banded=False))


def spanning_batch():
    """2 graphs of 12-15 nodes in 32 node rows (``tests/sharded_cases.py``):
    at 4 ranks of 8 nodes each graph spans ranks and an edge joins ranks 2
    apart."""
    graphs = random_dataset(SPANNING["graphs"], seed=SPANNING["seed"],
                            min_nodes=SPANNING["min_nodes"],
                            max_nodes=SPANNING["max_nodes"])
    n, e, ng, sn, se = SPANNING["caps"]
    return (pack_graphs(graphs, n, e, ng, banded=False),
            pack_subgraphs(graphs, [extract_egonets(gr, 1) for gr in graphs],
                           sn, se, banded=False))


def shard_model(group, seed=31, **kw):
    """ShardedPretrainModel(9, 64, 32) with seeded weights, on the CPU."""
    model = ShardedPretrainModel(9, hidden=64, d_transfer=32, group=group,
                                 **kw)
    return init_flax_style_(model, torch.Generator().manual_seed(seed))


def resharded(g, sub, world, rank, dev, caps=None):
    """(rank ``rank``'s slice on ``dev``, the ring's radius).  ``caps``:
    the packer's capacities as the per-rank caps, so that every batch has
    one shape (the captured step's key)."""
    fixed = {} if caps is None else {"sub_node_cap": caps.sub_nodes,
                                     "sub_edge_cap": caps.sub_edges,
                                     "ring_edge_cap": caps.edges}
    b = shard_pretrain_batch(g, sub, world, **fixed)
    return local_slice(b, rank).to(dev), b.radius


def sharded_grads(model, b, group):
    """Forward and backward of this rank's losses: (the losses and the
    gradients, each summed over ``group``), on the host."""
    model.train()
    model.zero_grad(set_to_none=True)
    losses = model(b)
    losses.total.backward()
    summed = dp._summed(torch.stack(tuple(losses)), group)
    grads = {n: dp._summed(p.grad, group).cpu()
             for n, p in model.named_parameters()}
    return [float(x) for x in summed], grads


def float64_union(weights, g, sub):
    """The single-device model's deterministic losses and gradients on the
    union batch, in float64 on the CPU plain path."""
    model = PretrainModel(9, hidden=64, d_transfer=32, deterministic=True)
    model.load_state_dict(weights)
    model.to("cpu", torch.float64).train()
    g64, sub64 = g.to("cpu"), sub.to("cpu")
    g64.node_feat = g64.node_feat.double()
    losses = model(g64, sub64)
    losses.total.backward()
    return ([float(x.detach()) for x in losses],
            {n: p.grad.detach() for n, p in model.named_parameters()})


def against_float64(got, want, label):
    """Losses within MODEL_RTOL and gradients within GRAD_RTOL (phase 4's
    measure) of float64; returns the reading."""
    (losses, grads), (l64, g64) = got, want
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, l64))
    grad_rel, worst = grad_gap(grads, g64)
    rec = {"losses": losses, "float64_losses": l64, "loss_rel": loss_rel,
           "grad_rel_float64": [grad_rel, worst]}
    if not (loss_rel <= MODEL_RTOL and grad_rel <= GRAD_RTOL):
        raise AssertionError(f"{label}: the sharded model disagrees with "
                             f"float64 on the union batch: {rec}")
    return rec


@contextlib.contextmanager
def wrong_way_ring():
    """A planted fault: the ring's backward shifts the cotangent the same
    way as the forward shifted the block (at 2 ranks both ways reach the
    same rank, so it shows from 3)."""
    real = collectives._RingShift.backward

    def same_way(ctx, grad):
        return collectives._shift(grad, ctx.shift, ctx.group), None, None
    collectives._RingShift.backward = staticmethod(same_way)
    try:
        yield
    finally:
        collectives._RingShift.backward = real


def shard_run(dev, batches, group, how):
    """One node-sharded step a batch from one start (noise on, seeded
    weights, Adam, generator): the captured step, or the eager one.
    Returns (losses as bytes, step_bytes, launch counts, (step, gen))."""
    model = shard_model(group, seed=11).to(dev)
    opt = adam_l2(model, 1e-4, 5e-5)
    gen = torch.Generator(device=dev).manual_seed(12)
    step = (make_sharded_pretrain_step(model, opt, group)
            if how == "captured" else
            lambda b, gen: dp.dp_pretrain_step_eager(model, opt, group, b,
                                                     generator=gen))
    reset_launch_counts()
    losses = [step(b, gen) for b in batches]
    torch.cuda.synchronize()
    counts = launch_counts()
    as_bytes = {f"step {i} {name}": t.cpu().numpy().tobytes()
                for i, ls in enumerate(losses)
                for name, t in zip(("kl", "contrastive", "recon"), ls)}
    return as_bytes, step_bytes(model, opt, gen), counts, (step, gen)


def shard_world1_phase(dev, ds, caps):
    """(a) world size 1 over NCCL: the sharded model on the benchmark
    batch (banded=False, resharded) against the single-device model in
    float64 on the CPU; the captured sharded step against the eager one,
    6 steps from one start under deterministic algorithms, byte-equal, the
    stale-input fault breaking it; 0 launches of every hand-written
    kernel; the median of a captured sharded call against the captured
    single step's (the main path's banded batch)."""
    multihost.initialize_distributed(f"tcp://127.0.0.1:{free_port()}",
                                     world_size=1, rank=0)
    try:
        group = dp.make_mesh()
        g, sub = unbanded(ds, caps, np.arange(128))
        b, radius = resharded(g, sub, 1, 0, dev)
        model = shard_model(group, deterministic=True)
        want = float64_union(model.state_dict(), g, sub)
        rec = {"radius": radius, "float64": against_float64(
            sharded_grads(model.to(dev), b, group), want, "world 1")}
        batches = [resharded(*unbanded(ds, caps, np.arange(128 * k,
                                                           128 * (k + 1))),
                             1, 0, dev, caps)[0] for k in range(STEPS)]
        with deterministic():
            eager = shard_run(dev, batches, group, "eager")
            captured = shard_run(dev, batches, group, "captured")
            with stale_replays():
                fault = shard_run(dev, batches, group, "captured")
        rec.update({
            "losses_apart": bytes_apart(eager[0], captured[0]),
            "state_apart": bytes_apart(eager[1], captured[1]),
            "fault_losses_apart": len(bytes_apart(eager[0], fault[0])),
            "fault_state_apart": len(bytes_apart(eager[1], fault[1])),
            "graphs": len(captured[3][0].graphs)})
        launched = {k: n for run in (eager, captured)
                    for k, n in run[2].items() if n}
        rec["launches"] = launched
        bench = bench_batches(dev, ds, caps, 2)
        timed = {"single": (dp_run(dev, bench, None)[3], bench[1]),
                 "sharded": (shard_run(dev, batches[:2], group,
                                       "captured")[3], (batches[1],))}
        rec["call_ms"] = [(name, call_median(timed[name][0][0],
                                             timed[name][1],
                                             timed[name][0][1]))
                          for name in ("single", "sharded", "sharded",
                                       "single")]
        print(f"phase 12 (a) sharded, world 1 over NCCL: {json.dumps(rec)}",
              flush=True)
        if rec["losses_apart"] or rec["state_apart"]:
            raise AssertionError(f"the captured sharded step is not the "
                                 f"eager one: {rec}")
        if not rec["fault_state_apart"]:
            raise AssertionError("the stale inputs went unseen")
        if launched or rec["graphs"] != 1:
            raise AssertionError(f"the sharded step launched hand-written "
                                 f"kernels or captured more than one "
                                 f"graph: {rec}")
        return rec, {"sharded world 1 over NCCL, eager": eager[2],
                     "sharded world 1 over NCCL, captured": captured[2]}
    finally:
        dist.destroy_process_group()


def shard_rank_command(rank, world, port):
    return [sys.executable, os.path.abspath(__file__), "--shard-rank",
            str(rank), str(world), port]


def shard_rank(rank, world, port, device="cuda"):
    """One gloo rank of phase 12 (b), in a process of its own, on the card
    (``device``: a rehearsal's "cpu"): the sharded model's summed losses
    and gradients on each batch (and, at 4 ranks, with the ring's backward
    sent the wrong way), then SHARD_STEPS eager steps, timed."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)          # six ranks share the host's cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    multihost.initialize_distributed(f"tcp://127.0.0.1:{port}",
                                     world_size=world, rank=rank,
                                     device="cpu")
    group = dp.make_mesh()
    inputs = torch.load(os.path.join(SHARD_DIR, "inputs.pt"),
                        weights_only=False)
    model = shard_model(group, deterministic=True)
    model.load_state_dict(inputs["weights"])
    model.to(dev)
    reset_launch_counts()
    out = {}
    for name, sharded in inputs["batches"][world].items():
        b = local_slice(sharded, rank).to(dev)
        out[name] = sharded_grads(model, b, group)
        if world >= 3 and name == "benchmark":
            with wrong_way_ring():
                out["wrong way"] = sharded_grads(model, b, group)
    b = local_slice(inputs["batches"][world]["benchmark"], rank).to(dev)
    opt = adam_l2(model, 1e-4, 5e-5)
    step = make_sharded_pretrain_step(model, opt, group)
    times = []
    for _ in range(SHARD_STEPS):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(b).total)
        times.append(time.perf_counter() - t0)
    out["step_s"] = times
    out["launches"] = {k: n for k, n in launch_counts().items() if n}
    out["bytes"] = step_bytes(model, opt, torch.Generator())
    torch.save(out, os.path.join(SHARD_DIR, f"w{world}-rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def p2p_probe_command(rank, port):
    return [sys.executable, os.path.abspath(__file__), "--p2p-probe",
            str(rank), port]


def p2p_probe(rank, port):
    """How gloo's point-to-point treats a tensor on the card: rank 0
    ``dist.send``s a CUDA tensor, rank 1 ``dist.recv``s into one; each
    prints one JSON line of what happened."""
    import datetime

    rank = int(rank)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    sent = torch.arange(1, 9, dtype=torch.float32, device="cuda")
    rec = {"rank": rank}
    try:
        if rank == 0:
            dist.send(sent, 1)
            rec["outcome"] = "sent"
        else:
            got = torch.zeros(8, device="cuda")
            dist.recv(got, 0)
            torch.cuda.synchronize()
            rec["outcome"] = ("received the values sent"
                              if torch.equal(got, sent) else
                              f"received {got.tolist()}")
    except RuntimeError as e:
        rec["outcome"] = f"raised: {str(e)[:300]}"
    print(json.dumps(rec), flush=True)
    dist.destroy_process_group()


def run_ranks(commands, timeout=300):
    """Start every command at once; (exit codes, outputs) once all end or
    the timeout kills them."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in commands]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n[killed at the "
                            "timeout]")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [p.returncode for p in procs], logs


def shard_gloo_phase(dev, ds, caps):
    """(b) 2 and 4 gloo ranks on the one card, eager, spawned
    (``--shard-rank``), both worlds at once, beside the point-to-point
    probe (``--p2p-probe``): on the benchmark batch and the spanning batch
    each world's summed losses within MODEL_RTOL and gradients within
    GRAD_RTOL of the single-device model in float64 on the union batch;
    the ring's backward sent the wrong way breaking the 4-rank gradients;
    0 launches of the hand-written kernels; after the timed steps every
    rank's state byte-equal to rank 0's.  Seconds a step are printed; no
    scaling is read from them (one card)."""
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    os.makedirs(SHARD_DIR)
    unions = {"benchmark": unbanded(ds, caps, np.arange(128)),
              "spanning": spanning_batch()}
    weights = shard_model(None, deterministic=True).state_dict()
    batches = {w: {name: shard_pretrain_batch(*u, w)
                   for name, u in unions.items()} for w in SHARD_WORLDS}
    torch.save({"weights": weights, "batches": batches},
               os.path.join(SHARD_DIR, "inputs.pt"))
    want = {name: float64_union(weights, *u) for name, u in unions.items()}
    ports = {w: str(free_port()) for w in SHARD_WORLDS}
    probe_port = str(free_port())
    commands = ([shard_rank_command(r, w, ports[w]) for w in SHARD_WORLDS
                 for r in range(w)]
                + [p2p_probe_command(r, probe_port) for r in range(2)])
    codes, logs = run_ranks(commands)
    n_ranks = sum(SHARD_WORLDS)
    for code, log in zip(codes[:n_ranks], logs[:n_ranks]):
        if code != 0:
            raise AssertionError(f"a sharded gloo rank exited {code}:\n"
                                 f"{log[-6000:]}")
    report = {"p2p_probe": [{"exit": c, "output": log.strip()[-600:]}
                            for c, log in zip(codes[n_ranks:],
                                              logs[n_ranks:])]}
    print(f"phase 12 (b) gloo send/recv of a CUDA tensor: "
          f"{json.dumps(report['p2p_probe'])}", flush=True)
    runs = {}
    for w in SHARD_WORLDS:
        ranks = [torch.load(os.path.join(SHARD_DIR, f"w{w}-rank{r}.pt"))
                 for r in range(w)]
        rec = {"radius": {name: batches[w][name].radius for name in unions},
               "step_s": ranks[0]["step_s"],
               "launches": [r["launches"] for r in ranks],
               "ranks_apart": [bytes_apart(ranks[0]["bytes"], r["bytes"])
                               for r in ranks[1:]]}
        for name in unions:
            rec[name] = against_float64(ranks[0][name], want[name],
                                        f"{w} gloo ranks, {name}")
        if "wrong way" in ranks[0]:
            rec["wrong_way_grad_rel"] = grad_gap(
                ranks[0]["wrong way"][1], want["benchmark"][1])
        report[f"{w} ranks"] = rec
        runs[f"sharded {w} gloo ranks, rank 0"] = ranks[0]["launches"]
        print(f"phase 12 (b) {w} gloo ranks on the card: {json.dumps(rec)}",
              flush=True)
        if any(rec["launches"]) or any(rec["ranks_apart"]):
            raise AssertionError(f"{w} gloo ranks: {rec}")
        if w >= 3 and not rec["wrong_way_grad_rel"][0] > GRAD_RTOL:
            raise AssertionError("the ring's wrong-way backward went "
                                 "unseen")
    if report["4 ranks"]["radius"]["spanning"] < 2:
        raise AssertionError("the spanning batch takes one hop only")
    shutil.rmtree(SHARD_DIR)
    return report, runs


def shard_phase(dev, ds, caps):
    """Phase 12; returns its readings and the launch counts of its runs."""
    report, runs, secs = {}, {}, {}
    t0 = time.perf_counter()
    report["world1"], world1_runs = shard_world1_phase(dev, ds, caps)
    runs.update(world1_runs)
    secs["a"], t0 = time.perf_counter() - t0, time.perf_counter()
    report["gloo"], gloo_runs = shard_gloo_phase(dev, ds, caps)
    runs.update(gloo_runs)
    secs["b"], t0 = time.perf_counter() - t0, time.perf_counter()
    report["dryrun"] = dryrun_multichip(2, device="cuda", backend="gloo")
    print(f"phase 12 (c) {report['dryrun']['line']}", flush=True)
    secs["c"] = time.perf_counter() - t0
    report["seconds"] = secs
    print(f"phase 12: {json.dumps(report)}", flush=True)
    return report, runs

# --- 13. the bf16 compute modes ----------------------------------------------

BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
# Each gate sits between the sound readings and a control that must fail
# it, both taken in the same run.  A bf16 kernel against its plain version
# reads at most 3.0e-4, and the float32 kernel on the same inputs 2.5e-3
# and up from that plain version; the bf16 model's gradients against the
# bf16 mode in float64 read at most 1.2e-3, and 1.0e-2 and up from the
# float32 model in float64 (NVIDIA H100 80GB HBM3, 700.00 W).
BF16_RTOL = 1e-3              # bf16 kernels vs their plain bf16 versions
BF16_CPU_RTOL = 1e-3          # bf16 model losses, card vs the CPU plain path
BF16_F64_RTOL = 1e-2          # bf16 model losses vs the float32 model in
                              # float64
BF16_F64_GRAD = 5e-3          # bf16 model gradients vs the bf16 mode in
                              # float64, of the largest entry
GIN_BF16 = {"compute_dtype": "bfloat16"}
GT_BF16 = {"gt_bf16_dots": True, "gt_dtype": torch.bfloat16}
BF16_MODES = {"GIN": GIN_BF16, "Transformer": GT_BF16}
GIN_BF16_PER_STEP = {"gin_fwd_bf16": 8, "gin_bwd": 8, "spmm_self": 8,
                     "spmm": 2, "pool": 1}
GT_BF16_PER_STEP = {"gt_fwd_bf16": 10, "gt_bwd_rows_bf16": 10,
                    "gt_bwd_cols_bf16": 10, "spmm": 2, "pool": 1}
BF16_RUNS = {"GIN-bf16": (GIN_BF16, STEPS, GIN_BF16_PER_STEP),
             "Transformer-bf16": ({"encoder": "Transformer", **GT_BF16},
                                  STEPS, GT_BF16_PER_STEP)}


def gin_fwd_bf16_ptxas(din, hid=64, dout=64):
    """ptxas's registers and spills of the instantiation that
    ``gin_fwd_bf16`` launches at these widths (``kb.gin_route``'s, as
    csrc/banded.cu's plan_fwd_bf16 picks it)."""
    vec, mt, nt = re.search(r"<(\d+), (\d+), (\d+)>",
                            kb.gin_route(din, hid, dout)).groups()
    want = f"gin_fused_fwd_bf16_kernelILi{vec}ELi{mt}ELi{nt}EE"
    recs = [r for e, r in kbuild.ptxas_report("banded").items() if want in e]
    if len(recs) != 1:
        raise AssertionError(f"no single ptxas entry {want}: {len(recs)}")
    return {"ptxas_registers": recs[0]["registers"],
            **{k: recs[0][k] for k in ("spill_stores", "spill_loads")}}


def gin_controls(got, inputs):
    """``gin_rounding.controls`` at the bf16 gate; raises where the kernel
    lies within the gate of a separated control (it could have skipped
    that rounding and passed)."""
    records = gin_rounding.controls(got, inputs, BF16_RTOL)
    missed = gin_rounding.unseen(records, BF16_RTOL)
    if missed:
        raise AssertionError(f"gin_fwd_bf16: within {BF16_RTOL} of the "
                             f"control that skips {missed}: {records}")
    return {p: {"control_vs_plain": a, "kernel_vs_control": k,
                "separated": sep} for p, (a, k, sep) in records.items()}


def gin_crafted_controls(dev):
    """``gin_fwd_bf16`` at widths 9 and 64 into 64, on
    ``gin_rounding.separating_inputs`` (both controls 1/32 of the largest
    entry from the plain version): within the gate of the plain version
    and past it from each control; {shape: readings}."""
    out = {}
    for din in (9, 64):
        ins = [x.to(dev) for x in gin_rounding.separating_inputs(din, 64,
                                                                 64)]
        got = kb.gin_fwd_bf16(*ins)
        torch.cuda.synchronize()
        rec = {"rel_vs_plain": rel_err(got, kb.gin_fwd_bf16_plain(*ins))[1],
               **gin_controls(got, ins)}
        out[f"d={din}"] = rec
        if not (rec["rel_vs_plain"] <= BF16_RTOL and all(
                rec[p]["separated"] for p in gin_rounding.POINTS)):
            raise AssertionError(f"gin_fwd_bf16 on the crafted inputs, "
                                 f"{din}: {rec}")
    print(f"phase 13 (a) gin_fwd_bf16 crafted inputs: {json.dumps(out)}",
          flush=True)
    return out


def bf16_vs_f32(rec, plain_fn, resources, spills, f32_fn, allowed=(0, 0),
                extra=""):
    """A bf16 kernel's ``check`` record completed with its control: the
    float32 kernel on the same inputs (``f32_fn``) timed and required past
    the gate from the plain bf16 version, or the gate could not tell a
    kernel that skipped its rounding; its resources and ptxas spills (none
    past ``allowed``).  ``extra``: more of the line it prints."""
    rec["f32_kernel_ms"] = time_ms(f32_fn)
    got, want = f32_fn(), plain_fn()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rec["f32_kernel_rel_vs_plain"] = max(
        rel_err(a, b)[1] for a, b in zip(got, want))
    if not rec["f32_kernel_rel_vs_plain"] > BF16_RTOL:
        raise AssertionError(
            f"{rec['name']} {rec['shape']}: the float32 kernel is "
            f"{rec['f32_kernel_rel_vs_plain']:.3e} from the plain bf16 "
            f"version, within the gate {BF16_RTOL}")
    rec["resources"] = {**resources, **spills}
    rec["library_note"] = (GIN_NO_LIBRARY if rec["name"] == "gin_fwd_bf16"
                           else NO_LIBRARY)
    print(f"  {rec['name']} {rec['shape']}: f32 kernel "
          f"{rec['f32_kernel_ms']:.4f} ms, "
          f"{rec['f32_kernel_rel_vs_plain']:.3e} from the plain bf16 "
          f"version (control, past {BF16_RTOL}); {rec['resources']}{extra}",
          flush=True)
    if (spills["spill_stores"] > allowed[0]
            or spills["spill_loads"] > allowed[1]):
        raise AssertionError(f"{rec['name']} spills {spills}, past "
                             f"{allowed}")
    return rec


def bf16_kernel_phase(g, sub, dev):
    """Phase 13 (a): the four bf16 kernels against their plain bf16
    versions at the benchmark shapes, with the float32 kernel's time
    beside each, the bound at the bf16 tensor-core rate, and each
    kernel's resources and ptxas spills, and the route it took.  The
    control: the float32 kernel on the same inputs must sit past the gate
    from the plain bf16 version, or the gate could not tell a kernel that
    skipped its rounding; and the attention forward past the gate from
    the control of each of its rounding points (q, k, v, w before out;
    tests/gt_rounding.py) that lies at least twice the gate from the
    plain version (q, k and v here; w before out only on phase 14 (a)'s
    crafted inputs), ``gin_fwd_bf16`` from those of z0 and relu(z1)
    (tests/gin_rounding.py) here and on crafted inputs
    (``gin_crafted_controls``).  Returns the records and the crafted
    readings."""
    gen = torch.Generator(device=dev).manual_seed(13)
    bf, hid, records = torch.bfloat16, 64, []

    def add(*args, **kw):
        records.append(bf16_vs_f32(*args, **kw))

    for label, batch in (("N", g), ("S", sub)):
        blocks, col_off = _resolve_band(batch)
        n = blocks.shape[0] * blocks.shape[1]
        nnz = int((blocks != 0).sum())
        for d in (9, 32, hid):
            h = torch.randn(n, d, device=dev, generator=gen)
            w1 = torch.randn(d, hid, device=dev, generator=gen) / math.sqrt(d)
            b1 = torch.randn(hid, device=dev, generator=gen) * 0.1
            w2 = torch.randn(hid, hid, device=dev, generator=gen) / 8.0
            b2 = torch.randn(hid, device=dev, generator=gen) * 0.1
            args = (blocks, col_off, h.to(bf), w1.to(bf), b1, w2.to(bf), b2)
            plain = functools.partial(kb.gin_fwd_bf16_plain, *args)
            kernel = functools.partial(kb.gin_fwd_bf16, *args)
            rec = check("gin_fwd_bf16", f"{label}={n} d={d}", kernel, plain,
                        nbytes(*args) + n * hid * 4,
                        2 * nnz * d + n * d + 2 * n * (d * hid + hid * hid),
                        tol=BF16_RTOL, flops_per_s=BF16_FLOPS_PER_S)
            rec["rounding_controls"] = gin_controls(kernel(), args)
            add(rec, plain, kb.kernel_info("gin_fused_fwd_bf16", d, hid, hid),
                gin_fwd_bf16_ptxas(d),
                lambda: kb.gin_fwd(blocks, col_off, h, w1, b1, w2, b2),
                extra=f"; rounding controls "
                      f"{json.dumps(rec['rounding_controls'])}")
    crafted = gin_crafted_controls(dev)
    blocks, off = _resolve_band(sub, gt=True)
    n = blocks.shape[0] * blocks.shape[1]
    ptxas = kg.ptxas_report()
    for heads, hd in ((HEADS, HEAD_DIM), (1, 64)):
        edges = int((blocks != 0).sum()) * heads
        q, k, v, gr = (torch.randn(n, heads, hd, device=dev, generator=gen)
                       for _ in range(4))
        z = kg.gt_fwd_plain(blocks, off, q, k, v, bf16_dots=True)[1]
        rho = kg.gt_bwd_rows_plain(blocks, off, q, k, v, gr, z,
                                   bf16_dots=True)[1]
        shape = f"S={n} H={heads} hd={hd} blocks={tuple(blocks.shape)}"
        ins, feat, stat = nbytes(blocks, off, q, k, v), nbytes(q), nbytes(z)
        cases = (
            ("gt_fwd_bf16", (q, k, v), kg.gt_fwd, kg.gt_fwd_plain,
             ins + feat + stat, edges * (4 * hd + 5)),
            ("gt_bwd_rows_bf16", (q, k, v, gr, z), kg.gt_bwd_rows,
             kg.gt_bwd_rows_plain, ins + 2 * (feat + stat),
             edges * (6 * hd + 8)),
            ("gt_bwd_cols_bf16", (q, k, v, gr, z, rho), kg.gt_bwd_cols,
             kg.gt_bwd_cols_plain, ins + feat + 2 * stat + 2 * feat,
             edges * (8 * hd + 10)))
        for name, ts, wrapper, plain, nbyt, flops in cases:
            plain = functools.partial(plain, blocks, off, *ts, bf16_dots=True)
            kernel = functools.partial(wrapper, blocks, off, *ts,
                                       bf16_dots=True)
            rec = check(name, shape, kernel, plain, nbyt, flops,
                        tol=BF16_RTOL, flops_per_s=BF16_FLOPS_PER_S)
            rec["main"] = hd == HEAD_DIM
            info = kg.kernel_info(name, hd, heads)
            rec["kernel_route"] = info["route"]
            extra = ""
            if name == "gt_fwd_bf16":
                rec["rounding_controls"] = rounding_controls(
                    "fwd", kernel(), (blocks, off, q, k, v))
                extra = (f"; rounding controls "
                         f"{json.dumps(rec['rounding_controls'])}")
            key = kg.ptxas_key(name, info["route"])
            add(rec, plain, info,
                {x: ptxas[key, hd][x] for x in ("spill_stores",
                                                "spill_loads")},
                functools.partial(wrapper, blocks, off, *ts),
                GT_SPILLS.get((key, hd), (0, 0)), extra)
    return records, crafted


def bf16_models(encoder, mode, seed=3):
    """(model in ``mode``, float32 model) of the same weights at full
    width, deterministic, the transformer's dropout off."""
    models = []
    for kw in (mode, {}):
        model = PretrainModel(9, hidden=64, d_transfer=32, encoder=encoder,
                              num_heads=HEADS, deterministic=True, **kw)
        init_flax_style_(model, torch.Generator().manual_seed(seed))
        for m in model.modules():
            if isinstance(m, encoders.GraphTransformerLayer):
                m.dropout = 0.0
        models.append(model.train())
    return models


def losses_and_grads(model, g, sub):
    losses = model(g, sub)
    losses.total.backward()
    return ([float(v.detach()) for v in losses],
            {k: p.grad.detach().cpu().double()
             for k, p in model.named_parameters()})


def bf16_model_phase(g, sub, dev, modes=None, label="13 (b)",
                     grad_tol=BF16_F64_GRAD):
    """Phase 13 (b): the full model in each bf16 mode on the benchmark
    batch (``modes``: {name: (encoder, mode)}, by default each encoder's
    ``BF16_MODES``; phase 14 (b) the TPU-default Transformer's).  The
    card's losses against the CPU plain path at the same rounding points
    (float32) and against the float32 model in float64;
    its gradients against the bf16 mode in float64 (the same rounding
    points, float64 sums).  The control: the card's gradients must sit
    past that gate from the float32 model in float64, or the gate could
    not tell the bf16 mode from a float32 backward.  That distance is the
    mode's own and is not held to a bound (the bf16 GIN's encoder2 conv
    weights move 0.12 of the largest gradient there in float64 as in
    float32, on the CPU).  ``grad_tol``: the gradients' gate."""
    g_cpu, sub_cpu = g.to("cpu"), sub.to("cpu")
    g64 = g.to("cpu")
    g64.node_feat = g64.node_feat.double()
    out = {}
    modes = modes or {e: (e, m) for e, m in BF16_MODES.items()}
    for name, (encoder, mode) in modes.items():
        model, f32 = bf16_models(encoder, mode)
        cpu = copy.deepcopy(model)
        same_points = copy.deepcopy(model).to("cpu", torch.float64)
        card = losses_and_grads(model.to(dev), g, sub)
        with torch.no_grad():
            plain = [float(v) for v in cpu(g_cpu, sub_cpu)]
        bf64 = losses_and_grads(same_points, g64, sub_cpu)
        f64 = losses_and_grads(f32.to("cpu", torch.float64), g64, sub_cpu)

        def grad_gap(ref):
            top = max(float(v.abs().max()) for v in ref.values())
            return max(float((card[1][k] - ref[k]).abs().max())
                       for k in ref) / top

        rec = {"losses_card": card[0], "losses_cpu_plain": plain,
               "losses_float64": f64[0],
               "loss_rel_vs_cpu": max(abs(a - b) / abs(b)
                                      for a, b in zip(card[0], plain)),
               "loss_rel_vs_float64": max(abs(a - b) / abs(b)
                                          for a, b in zip(card[0], f64[0])),
               "grad_vs_bf16_float64_of_largest": grad_gap(bf64[1]),
               "grad_vs_float64_of_largest": grad_gap(f64[1]),
               "tol": [BF16_CPU_RTOL, BF16_F64_RTOL, grad_tol]}
        out[name] = rec
        print(f"phase {label} bf16 model ({name}): {json.dumps(rec)}",
              flush=True)
        if not (all(math.isfinite(x) for x in card[0])
                and rec["loss_rel_vs_cpu"] <= BF16_CPU_RTOL
                and rec["loss_rel_vs_float64"] <= BF16_F64_RTOL
                and rec["grad_vs_bf16_float64_of_largest"] <= grad_tol
                < rec["grad_vs_float64_of_largest"]):
            raise AssertionError(f"bf16 model ({name}): {rec}")
    return out


def step_medians(dev, batches, runs):
    """The median step (steps 1-5 of 6) of each of ``runs``, in their
    order: (key, PretrainModel arguments, "captured" or "eager"); returns
    {key: [medians]}."""
    out = {}
    for key, kwargs, path in runs:
        model = PretrainModel(9, hidden=64, d_transfer=32, num_heads=HEADS,
                              **kwargs)
        init_flax_style_(model, torch.Generator().manual_seed(11))
        model.to(dev)
        opt = adam_l2(model, LR, 5e-5)
        gen = torch.Generator(device=dev).manual_seed(12)
        step = (make_pretrain_step(model, opt) if path == "captured"
                else functools.partial(pretrain_step_eager, model, opt))
        times = []
        for g, s in batches:
            t0 = time.perf_counter()
            step(g, s, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out.setdefault(key, []).append(statistics.median(times[1:]))
    return out


def bf16_medians(dev, batches):
    """Phase 13 (d): the median step of each encoder, float32 against
    bf16, eager and captured, in the order f32, bf16, bf16, f32 within
    each path (then ``bf16_phase`` profiles each bf16 mode's captured
    step, as phase 7 the float32 ones).  Recorded only."""
    runs = [(f"{encoder} {path} {mode}",
             {**({"encoder": encoder} if encoder != "GIN" else {}),
              **(BF16_MODES[encoder] if mode == "bf16" else {})}, path)
            for encoder in BF16_MODES for path in ("captured", "eager")
            for mode in ("f32", "bf16", "bf16", "f32")]
    out = step_medians(dev, batches, runs)
    print(f"phase 13 (d) step medians, ms: {json.dumps(out)}", flush=True)
    return out


def bf16_phase(g, sub, dev, ds, caps):
    """Phase 13; returns its readings, its kernel records and the launch
    counts of its main-path runs."""
    report, secs = {}, {}
    t0 = time.perf_counter()
    records, report["gin_crafted_controls"] = bf16_kernel_phase(g, sub, dev)
    secs["a"], t0 = time.perf_counter() - t0, time.perf_counter()
    report["models"] = bf16_model_phase(g, sub, dev)
    secs["b"], t0 = time.perf_counter() - t0, time.perf_counter()
    runs = {name: main_path(name, *spec) for name, spec in BF16_RUNS.items()}
    batches = bench_batches(dev, ds, caps)
    with deterministic():
        report["captured_vs_eager"] = {
            name: captured_vs_eager(dev, batches, name, kwargs, per_step)
            for name, (kwargs, _, per_step) in BF16_RUNS.items()}
    report["main_paths"] = {k: {"step_ms": r["step_ms"],
                                "counts": {n: c for n, c in r["counts"].items()
                                           if c}}
                            for k, r in runs.items()}
    secs["c"], t0 = time.perf_counter() - t0, time.perf_counter()
    report["medians"] = bf16_medians(dev, batches)
    report["profiles"] = {f"{encoder} bf16 captured": profile_phase(
        encoder, False, **mode) for encoder, mode in BF16_MODES.items()}
    secs["d"] = time.perf_counter() - t0
    report["seconds"] = secs
    print(f"phase 13: {json.dumps(report)}", flush=True)
    return report, records, runs

# --- 14. the JAX package's TPU-default Transformer ----------------------------

# the JAX package's Transformer on a TPU: the merged backward (unless
# SCGIB_GT_BWD_TWOPASS=1) with bf16 dots (unless SCGIB_GT_BF16=0), the dense
# tail in float32 (SCGIB_GT_ACT_BF16 defaults to 0)
TPU_DEFAULT = {"gt_bwd": "merged", "gt_bf16_dots": True}
TPU_DEFAULT_FLAGS = ["--encoder", "Transformer", "--gt_bwd", "merged",
                     "--gt_bf16_dots"]
# 14 (b)'s gradient gate, of the largest entry: with the dense tail in
# float32 the float32 model's gradients lie only 8.0e-4 (the card) to
# 1.2e-3 (the CPU) from this mode's in float64, where phase 13's bf16 tail
# moves them 1.0e-2, so phase 13's 5e-3 could not fail a float32 backward;
# the mode's own reading is 1.9e-4 on the card and 1.8e-4 on the CPU
# (NVIDIA H100 80GB HBM3, 700.00 W; full width).  The gate sits between.
TPU_DEFAULT_GRAD = 4e-4
TPU_DEFAULT_PER_STEP = {"gt_fwd_bf16": 10, "gt_bwd_merged_bf16": 10,
                        "spmm": 2, "pool": 1}
TPU_DEFAULT_FT_PER_STEP = {"gt_fwd_bf16": 10, "gt_bwd_merged_bf16": 10,
                           "pool": 1}
TPU_DEFAULT_EVAL_PER_BATCH = {"gt_fwd_bf16": 10, "pool": 1}
# "merged" in the name: captured_vs_eager holds it step by step
TPU_DEFAULT_RUN = ("Transformer-merged-bf16",
                   ({"encoder": "Transformer", **TPU_DEFAULT}, STEPS,
                    TPU_DEFAULT_PER_STEP))
TPU_DEFAULT_HEADS = ((HEADS, HEAD_DIM), (1, 64), (1, 1024))
# phase 14 (a)'s shapes: those, and one head of each of WIDE_HDS
TPU_DEFAULT_SHAPES = tuple(dict.fromkeys(
    TPU_DEFAULT_HEADS + tuple((1, w) for w in WIDE_HDS)))
TPU_DEFAULT_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_tpu_default")
TPU_DEFAULT_N = 600           # molecules of the verbs' runs
# phase 14 (e)'s other splits of the staged kernels at 8 x 8 ({wrapper:
# (parts, threads a block)}), profiled beside gt_route's choice (4 parts,
# 128 threads for the forward and 256 for the merged pass): the readings
# that chose it
STAGED_ALTERNATIVES = {
    "staged 2 parts": {"gt_fwd_bf16": (2, 256),
                       "gt_bwd_merged_bf16": (2, 256)},
    "staged 1 part": {"gt_fwd_bf16": (1, 256), "gt_bwd_merged_bf16": (1, 512)}}
# step medians: (merged bf16, two-pass bf16, merged float32) in turns
TPU_MEDIAN_MODES = {"merged-bf16": TPU_DEFAULT,
                    "twopass-bf16": {"gt_bf16_dots": True},
                    "merged-f32": {"gt_bwd": "merged"}}


def rounding_controls(kernel, got, inputs, rho=None):
    """``gt_rounding.controls`` at the bf16 gate; raises where a kernel
    lies within the gate of a separated control (it could have skipped
    that rounding and passed)."""
    records = gt_rounding.controls(kernel, got, inputs, BF16_RTOL, rho=rho)
    missed = gt_rounding.unseen(records, BF16_RTOL)
    if missed:
        raise AssertionError(f"{kernel}: within {BF16_RTOL} of the control "
                             f"that skips {missed}: {records}")
    return {p: {"control_vs_plain": a, "kernel_vs_control": k,
                "separated": sep} for p, (a, k, sep) in records.items()}


@contextlib.contextmanager
def lane_group_route(staged=None):
    """Every wrapper on its lane-group kernel (the other route of rows 6b
    and 9b), to time and hold it beside the staged route at the same shapes;
    or, given ``staged`` {wrapper: (parts, threads)}, those wrappers on
    their staged kernels in that many parts and threads a block (the
    alternatives to ``gt_route``'s choice that phase 14 (e) times)."""
    real = kg.gt_route

    def route(kernel, heads, hd, tile=64, band=128):
        if staged is None or kernel not in staged:
            return kg.Route("lane_group")
        split, threads = staged[kernel]
        return kg.Route("staged", split, threads, kg.staged_smem(
            kernel, tile, band, heads * hd // split, heads // split))
    kg.gt_route = route
    try:
        yield
    finally:
        kg.gt_route = real


def crafted_controls(dev, heads, hd):
    """The controls that random inputs leave within twice the gate (v and w
    before out; dS before dk, w before dv), on
    ``gt_rounding.separating_inputs``: the kernels on their routes within
    the gate of the plain versions and past it from every control at least
    twice the gate away; {kernel: controls}."""
    out = {}
    ins = [x.to(dev) for x in gt_rounding.separating_inputs("fwd", heads,
                                                            hd)]
    got = kg.gt_fwd(*ins, bf16_dots=True)
    gap = gt_rounding.rel_gap(got, kg.gt_fwd_plain(*ins, bf16_dots=True))
    out["gt_fwd_bf16"] = {"rel_vs_plain": gap,
                          **rounding_controls("fwd", got, ins)}
    ins = [x.to(dev) for x in gt_rounding.separating_inputs("merged", heads,
                                                            hd)]
    ins.append(kg.gt_fwd_plain(*ins[:5], bf16_dots=True)[1])
    got = kg.gt_bwd_merged(*ins, bf16_dots=True)
    gap = gt_rounding.rel_gap(got,
                              kg.gt_bwd_merged_plain(*ins, bf16_dots=True))
    out["gt_bwd_merged_bf16"] = {"rel_vs_plain": gap,
                                 **rounding_controls("merged", got, ins)}
    dq, rho = kg.gt_bwd_rows(*ins, bf16_dots=True)
    out["gt_bwd_cols_bf16"] = rounding_controls(
        "cols", kg.gt_bwd_cols(*ins, rho, bf16_dots=True), ins, rho=rho)
    torch.cuda.synchronize()
    for name, rec in out.items():
        if rec.get("rel_vs_plain", 0.0) > BF16_RTOL:
            raise AssertionError(f"{name} on the crafted inputs: {rec}")
    return out


def tpu_default_kernel_phase(sub, dev):
    """Phase 14 (a): ``gt_fwd_bf16`` and ``gt_bwd_merged_bf16`` at S, at
    every shape of ``TPU_DEFAULT_SHAPES``, on the route ``gt_route`` picks
    and, where that is the staged one at a shape of ``TPU_DEFAULT_HEADS``,
    on the lane-group kernel too (the other route, timed beside it): each
    against its plain bf16 version (past the ties' steps,
    ``gt_rounding.tie_slack``), the float32 kernel on the same inputs as
    the control; the merged pass's distance from the two-pass bf16
    kernels; the controls of every single rounding point (q, k, v, g, dS
    before dq, dS before dk, W before dv; tests/gt_rounding.py) for it and
    the two-pass bf16 passes on random inputs, and of the points those
    leave unseparated on ``crafted_controls``' inputs; ms, bound,
    resources and ptxas spills of each route."""
    gen = torch.Generator(device=dev).manual_seed(14)
    blocks, off = _resolve_band(sub, gt=True)
    n = blocks.shape[0] * blocks.shape[1]
    ptxas = kg.ptxas_report()
    records, controls = [], {}
    for heads, hd in TPU_DEFAULT_SHAPES:
        edges = int((blocks != 0).sum()) * heads
        q, k, v, gr = (torch.randn(n, heads, hd, device=dev, generator=gen)
                       for _ in range(4))
        z = kg.gt_fwd_plain(blocks, off, q, k, v, bf16_dots=True)[1]
        shape = f"S={n} H={heads} hd={hd} blocks={tuple(blocks.shape)}"
        ins, feat, stat = nbytes(blocks, off, q, k, v), nbytes(q), nbytes(z)
        args = (blocks, off, q, k, v, gr, z)
        key_hd = hd if hd in kg.HEAD_WIDTHS else 0           # 0: WIDE
        cases = (("gt_fwd_bf16", kg.gt_fwd, kg.gt_fwd_plain, args[:5],
                  ins + feat + stat, edges * (4 * hd + 5)),
                 ("gt_bwd_merged_bf16", kg.gt_bwd_merged,
                  kg.gt_bwd_merged_plain, args, ins + feat + stat + 3 * feat,
                  edges * (10 * hd + 10)))
        for name, wrapper, plain_fn, ts, nbyt, flops in cases:
            route = kg.gt_route(name, heads, hd).name
            routes = [route] + (["lane_group"] if route == "staged" and (
                heads, hd) in TPU_DEFAULT_HEADS else [])
            plain = functools.partial(plain_fn, *ts, bf16_dots=True)
            for taken in routes:
                with (lane_group_route() if taken != route
                      else contextlib.nullcontext()):
                    kernel = functools.partial(wrapper, *ts, bf16_dots=True)
                    rec = check(name, f"{shape} route={taken}", kernel,
                                plain, nbyt, flops, tol=BF16_RTOL,
                                flops_per_s=BF16_FLOPS_PER_S,
                                ties=functools.partial(
                                    gt_rounding.tie_slack,
                                    "fwd" if name == "gt_fwd_bf16"
                                    else "merged", ts))
                    rec["main"] = hd == HEAD_DIM and taken == route
                    rec["kernel_route"] = taken
                    key = kg.ptxas_key(name, taken)
                    extra = ""
                    if name == "gt_bwd_merged_bf16" and (
                            heads, hd) in TPU_DEFAULT_HEADS:
                        got = kernel()
                        dq, rho = kg.gt_bwd_rows(*args, bf16_dots=True)
                        cols = kg.gt_bwd_cols(*args, rho, bf16_dots=True)
                        torch.cuda.synchronize()
                        rec["rel_vs_twopass_bf16"] = max(
                            rel_err(a, b)[1]
                            for a, b in zip(got, (dq,) + cols))
                        rec["rounding_controls"] = rounding_controls(
                            "merged", got, args)
                        if taken == route:
                            controls[shape] = {
                                "gt_bwd_merged_bf16":
                                    rec["rounding_controls"],
                                "gt_bwd_rows_bf16": rounding_controls(
                                    "rows", (dq, rho), args),
                                "gt_bwd_cols_bf16": rounding_controls(
                                    "cols", cols, args, rho=rho)}
                        extra = (f"; {rec['rel_vs_twopass_bf16']:.3e} from "
                                 f"the two-pass bf16 kernels; rounding "
                                 f"controls "
                                 f"{json.dumps(rec['rounding_controls'])}")
                    records.append(bf16_vs_f32(
                        rec, plain, kg.kernel_info(
                            name, hd, heads if taken == "staged" else None),
                        {x: ptxas[key, key_hd][x]
                         for x in ("spill_stores", "spill_loads")},
                        functools.partial(wrapper, *ts),
                        GT_SPILLS.get((key, key_hd), (0, 0)), extra))
    for heads, hd in TPU_DEFAULT_HEADS[:2]:
        for route in ("staged", "lane_group"):
            with (lane_group_route() if route == "lane_group"
                  else contextlib.nullcontext()):
                crafted = crafted_controls(dev, heads, hd)
            controls[f"crafted H={heads} hd={hd} route={route}"] = crafted
            print(f"phase 14 (a) crafted inputs, {heads} x {hd}, {route}: "
                  f"{json.dumps(crafted)}", flush=True)
    return records, controls


def tpu_default_verbs():
    """Phase 14 (d): ``pretrain`` (one epoch), ``finetune`` BACE from its
    checkpoint (one epoch, ``--out``), ``eval`` of that checkpoint on the
    test split and ``adapt`` (one epoch), each with the TPU-default flags
    at full width on ``TPU_DEFAULT_N`` molecules; each run's launches
    those of its steps and evaluation batches."""
    shutil.rmtree(TPU_DEFAULT_DIR, ignore_errors=True)
    os.makedirs(TPU_DEFAULT_DIR)
    pre, ft, ad = (os.path.join(TPU_DEFAULT_DIR, f) for f in
                   ("pre.msgpack", "ft.msgpack", "adapted.msgpack"))
    data = ["--synthetic", str(TPU_DEFAULT_N)]
    bace_data = ["--dataset", "BACE"] + data
    spec = cli.DATASETS["BACE"]
    want = split_batches(spec, TPU_DEFAULT_N, 9)
    report = {}
    info, secs = verb_run("pretrain (TPU default)", [
        "pretrain", "--epochs", "1", "--out", pre] + data + TPU_DEFAULT_FLAGS)
    steps = info["throughput"]["steps"]
    expect_exact("pretrain (TPU default)",
                 add_counts((TPU_DEFAULT_PER_STEP, steps)))
    report["pretrain"] = {"s": secs, "steps": steps,
                          "loss": info["best_loss"]}
    run, secs = verb_run("finetune (TPU default)", [
        "finetune", "--epochs", "1", "--pretrained", pre, "--out", ft]
        + bace_data + TPU_DEFAULT_FLAGS)
    steps = run["last"]["throughput"]["steps"]
    if steps != want["steps"]:
        raise AssertionError(f"finetune (TPU default): {steps} steps, "
                             f"expected {want['steps']}")
    expect_exact("finetune (TPU default)", add_counts(
        (TPU_DEFAULT_FT_PER_STEP, steps),
        (TPU_DEFAULT_EVAL_PER_BATCH, want["evals"])))
    hist = run["last"]["history"]
    report["finetune"] = {"s": secs, "steps": steps, "history": hist}
    out, secs = verb_run("eval (TPU default)", [
        "eval", "--checkpoint", ft, "--split", "all"] + bace_data
        + TPU_DEFAULT_FLAGS)
    expect_exact("eval (TPU default)", add_counts(
        (TPU_DEFAULT_EVAL_PER_BATCH, want["evals"] + want["train_evals"])))
    if not abs(out["test"] - hist[-1][2]) <= 1e-6:
        raise AssertionError(f"eval (TPU default): test {out['test']} is "
                             f"not the run's final {hist[-1][2]}")
    report["eval"] = {"s": secs, **out}
    info, secs = verb_run("adapt (TPU default)", [
        "adapt", "--epochs", "1", "--pretrained", pre, "--out", ad] + data
        + TPU_DEFAULT_FLAGS)
    expect_exact("adapt (TPU default)",
                 add_counts((TPU_DEFAULT_FT_PER_STEP, want["adapt"])))
    report["adapt"] = {"s": secs, "loss": info["best_loss"]}
    values = [report["pretrain"]["loss"], report["adapt"]["loss"]] + [
        x for row in hist for x in row]
    if not all(math.isfinite(x) for x in values):
        raise AssertionError(f"TPU-default verbs: not finite: {report}")
    shutil.rmtree(TPU_DEFAULT_DIR)
    print(f"phase 14 (d) verbs: {json.dumps(report)}", flush=True)
    return report


def tpu_default_medians(dev, batches):
    """Phase 14 (e): the median step (steps 1-5 of 6) of the Transformer,
    merged bf16, two-pass bf16 and merged float32 in turns (a, b, c, c, b,
    a), captured and eager; then the captured merged-bf16 step on the
    staged route, on the lane-group kernels and on the staged
    kernels in ``STAGED_ALTERNATIVES``' splits, and the merged-float32 step,
    in turns (a, b, ..., b, a), profiled as in phase 7, each attention
    kernel's in-step time read through ``PATH``.  Recorded only."""
    order = list(TPU_MEDIAN_MODES) + list(TPU_MEDIAN_MODES)[::-1]
    out = step_medians(dev, batches, [
        (f"{path} {mode}", {"encoder": "Transformer",
                            **TPU_MEDIAN_MODES[mode]}, path)
        for path in ("captured", "eager") for mode in order])
    print(f"phase 14 (e) step medians, ms: {json.dumps(out)}", flush=True)
    profiles = {}
    order = [("merged-bf16", "staged"), ("merged-bf16", "lane_group"),
             *(("merged-bf16", alt) for alt in STAGED_ALTERNATIVES),
             ("merged-f32", "lane_group")]
    for label, route in order + order[-2::-1]:
        key = (f"Transformer {label} captured"
               + (f" {route}" if label.endswith("bf16") else ""))
        with (contextlib.nullcontext() if route == "staged"
              else lane_group_route(STAGED_ALTERNATIVES.get(route))):
            prof = profile_phase("Transformer", False,
                                 **TPU_MEDIAN_MODES[label])
        profiles.setdefault(key, []).append(prof)
        dots = "_bf16" if label.endswith("bf16") else ""
        per_call = {}
        for wrapper in ("gt_fwd", "gt_bwd_merged"):
            for kernel in PATH[wrapper + dots][2].split():
                ms, calls = prof["port"][kernel]
                if calls:
                    per_call[kernel] = [ms / calls * 1e3, calls]
        prof["in_step_us"] = per_call
        print(f"phase 14 (e) {key}: in step (us a call, calls a step) "
              f"{json.dumps(per_call)}, device "
              f"{prof['device_ms_per_step']:.3f} ms a step", flush=True)
    return out, profiles


def tpu_default_phase(g, sub, dev, ds, caps):
    """Phase 14; returns its readings, its kernel records and the launch
    counts of its main-path run."""
    report, secs = {}, {}
    t0 = time.perf_counter()
    records, report["rounding_controls"] = tpu_default_kernel_phase(sub, dev)
    secs["a"], t0 = time.perf_counter() - t0, time.perf_counter()
    report["model"] = bf16_model_phase(
        g, sub, dev, {"Transformer-merged-bf16": ("Transformer",
                                                  TPU_DEFAULT)}, "14 (b)",
        TPU_DEFAULT_GRAD)
    secs["b"], t0 = time.perf_counter() - t0, time.perf_counter()
    name, spec = TPU_DEFAULT_RUN
    runs = {name: main_path(name, *spec)}
    batches = bench_batches(dev, ds, caps)
    with deterministic():
        report["captured_vs_eager"] = captured_vs_eager(
            dev, batches, name, spec[0], spec[2])
    report["main_path"] = {"step_ms": runs[name]["step_ms"],
                           "counts": {k: c for k, c in
                                      runs[name]["counts"].items() if c}}
    secs["c"], t0 = time.perf_counter() - t0, time.perf_counter()
    report["verbs"] = tpu_default_verbs()
    secs["d"], t0 = time.perf_counter() - t0, time.perf_counter()
    report["medians"], report["profiles"] = tpu_default_medians(dev, batches)
    secs["e"] = time.perf_counter() - t0
    report["seconds"] = secs
    print(f"phase 14: {json.dumps(report)}", flush=True)
    return report, records, runs


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_rank(*sys.argv[2:])
    elif sys.argv[1:2] == ["--shard-rank"]:
        shard_rank(*sys.argv[2:])
    elif sys.argv[1:2] == ["--p2p-probe"]:
        p2p_probe(*sys.argv[2:])
    elif "--wide-bands" in sys.argv:
        wide_bands_only()
    else:
        main()
