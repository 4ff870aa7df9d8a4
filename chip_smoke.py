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
     its expected per-step count times the steps, the pooling must take
     its kernel branch and the encoders their band branches.  Then:
     (a) captured against eager, 6 steps from one start on 6 batches,
     under torch's deterministic algorithms: losses every step, the final
     parameters, BatchNorm statistics, Adam state and generator state
     byte-equal for GIN and the transformer (the merged backward sums with
     atomics, so its run is held to tolerances, beside two eager runs'
     spread), and a planted fault (replays that stop copying their
     inputs) must break it; the scan step of 3 inner steps against 3 eager
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
  9. one JSON line of the kernels (with the launches of a fine-tuning step
     and an evaluation batch), the nvidia-smi line, and
     {"ok": true, "device": {...}} as the last line.
"""

import collections
import contextlib
import copy
import functools
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

# torch's deterministic algorithms (phase 6's resume check) refuse cuBLAS
# products unless its workspace is fixed before the first one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from scgib_tpu_torch import cli  # noqa: E402
from scgib_tpu_torch.cli import run_pretrain  # noqa: E402
from scgib_tpu_torch.data.loader import (GraphDataset,  # noqa: E402
                                         batch_iterator, plan_batches,
                                         plan_capacities)
from scgib_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from scgib_tpu_torch.models import encoders  # noqa: E402
from scgib_tpu_torch.models.scgib import (  # noqa: E402
    DomainAdaptModel, FinetuneModel, PretrainModel, _resolve_band)
from scgib_tpu_torch.ops import pool as pool_mod  # noqa: E402
from scgib_tpu_torch.ops.kernels import banded as kb  # noqa: E402
from scgib_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from scgib_tpu_torch.ops.kernels import gt_flash as kg  # noqa: E402
from scgib_tpu_torch.train import checkpoint, loops  # noqa: E402
from scgib_tpu_torch.graph.batching import (GraphData,  # noqa: E402
                                            pack_graphs, pack_subgraphs)
from scgib_tpu_torch.graph.egonet import extract_egonets  # noqa: E402
from scgib_tpu_torch.ops.spmm_banded import (  # noqa: E402
    gt_banded_attention)
from scgib_tpu_torch.train import trainer  # noqa: E402
from scgib_tpu_torch.train.trainer import (  # noqa: E402
    adam_l2, finetune_trainable_mask, make_domainadapt_step, make_eval_fn,
    make_finetune_step, make_pretrain_scan_step, make_pretrain_step,
    masked_adam, pretrain_step_eager)
from scgib_tpu_torch.utils.msgpack_codec import unpackb  # noqa: E402
from scgib_tpu_torch.utils.params import (from_jax_variables,  # noqa: E402
                                          init_flax_style_, sorted_leaves)

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
MERGED_STEPS = 2              # steps with the merged attention backward
SCAN_INNER = 3                # inner steps of the scan step
HEADS, HEAD_DIM = 8, 8        # the graph transformer's attention
WIDE_HDS = (64, 128, 256, 512, 1024)  # one head of each, checked at S
SERVED_HDS = (1024, 1100)     # through gt_flash_attention (1100 padded)
# wrapper -> (source, TPU kernel line, CUDA kernel)
PATH = {"gin_fwd": ("banded", 69, "gin_fused_fwd_kernel"),
        "gin_bwd": ("banded", 141, "gin_fused_bwd_kernel"),
        "spmm_self": ("banded", 177, "banded_spmm_kernel"),
        "spmm": ("banded", 266, "banded_spmm_kernel"),
        "pool": ("banded", 405, "banded_spmm_kernel"),
        "gt_fwd": ("gt_flash", 121, "gt_fwd_kernel"),
        "gt_bwd_rows": ("gt_flash", 146, "gt_row_pass_kernel"),
        "gt_bwd_cols": ("gt_flash", 248, "gt_bwd_cols_kernel"),
        "gt_bwd_merged": ("gt_flash", 181, "gt_row_pass_kernel")}
# main-path run -> (run_pretrain arguments, steps, launches per step; the
# wrappers not named launch 0 times)
RUNS = {"GIN": ({}, STEPS, GIN_PER_STEP),
        "Transformer": ({"encoder": "Transformer"}, STEPS, GT_PER_STEP),
        "Transformer-merged": ({"encoder": "Transformer",
                                "gt_bwd": "merged"}, MERGED_STEPS,
                               MERGED_PER_STEP)}
# which run's count each kernel reports
REPORT_RUN = {"gt_fwd": "Transformer", "gt_bwd_rows": "Transformer",
              "gt_bwd_cols": "Transformer",
              "gt_bwd_merged": "Transformer-merged"}
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
    return {**kb.launch_counts(), **kg.launch_counts()}


def reset_launch_counts():
    kb.reset_launch_counts()
    kg.reset_launch_counts()


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
          tf32x3=False):
    """Compare one kernel configuration with its plain version and time
    both; returns the record.  ``tf32x3``: the kernel runs its products in
    3xTF32, so its bound is taken at that rate, and the bound at the fp32
    SIMT rate is recorded beside it."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    max_abs = max(e[0] for e in errs)
    max_rel = max(e[1] for e in errs)
    rec = {"name": name, "shape": shape, "max_abs_err": max_abs,
           "max_rel_err": max_rel, "tol_rel": KERNEL_RTOL,
           "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
           "library_ms": time_ms(library_fn) if library_fn else None}
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        nbyt, flops, TF32X3_FLOPS_PER_S if tf32x3 else FP32_FLOPS_PER_S)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    extra = ""
    if tf32x3:
        rec["bound_fp32_ms"] = bound_ms(nbyt, flops)[0]
        extra = (f" at the 3xTF32 rate; at the fp32 SIMT rate "
                 f"{rec['bound_fp32_ms'] * 1e3:.3f} us (share "
                 f"{rec['bound_fp32_ms'] / rec['ms']:.3f})")
    print(f"kernel {name} {shape}: max_abs_err {max_abs:.3e} rel "
          f"{max_rel:.3e} (tol {KERNEL_RTOL}) | ms {rec['ms']:.4f} plain "
          f"{rec['plain_ms']:.4f} library {rec['library_ms']} bound "
          f"{rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']}, share "
          f"{rec['bound_share']:.3f}){extra}", flush=True)
    if not max_rel <= KERNEL_RTOL:
        raise AssertionError(f"{name} {shape} disagrees with its plain "
                             f"version: {max_rel:.3e} > {KERNEL_RTOL}")
    return rec


# The spills (bytes stored, loaded) ptxas gives the attention's
# instantiations up to hd 512 in the sources as they stand; the WIDE one
# (head widths past 512) has none.  Phase 2 fails on any other spill, or a
# larger one, in any instantiation.
GT_SPILLS = {("gt_fwd", 2): (4, 4), ("gt_fwd", 4): (4, 4),
             ("gt_bwd_rows", 4): (8, 16), ("gt_bwd_rows", 8): (4, 4),
             ("gt_bwd_rows", 64): (4, 4), ("gt_bwd_cols", 256): (16, 16)}


def attention_ptxas():
    """Registers and spill bytes of every instantiation of
    csrc/gt_flash.cu, from the ptxas report kept beside its library (built
    in this run or before it): every wrapper at every width of
    ``HEAD_WIDTHS`` and WIDE (0), none spilling past ``GT_SPILLS``."""
    report = kg.ptxas_report()
    want = {(k, hd) for k in kg.KERNELS for hd in kg.HEAD_WIDTHS + (0,)}
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
        blocks, col_off = _resolve_band(batch)
        n = blocks.shape[0] * blocks.shape[1]
        nnz = int((blocks != 0).sum())
        bf = blocks.float()
        for d in (32, 64):
            h = torch.randn(n, d, device=dev, generator=gen)
            w1 = torch.randn(d, hid, device=dev, generator=gen) / math.sqrt(d)
            b1 = torch.randn(hid, device=dev, generator=gen) * 0.1
            w2 = torch.randn(hid, hid, device=dev, generator=gen) / 8.0
            b2 = torch.randn(hid, device=dev, generator=gen) * 0.1
            gr = torch.randn(n, hid, device=dev, generator=gen)
            shape = f"{label}={n} d={d}"
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
        if label == "N":
            x = torch.randn(n, hid, device=dev, generator=gen)
            win = windows(blocks, col_off, x)
            records.append(check(
                "spmm", f"N={n} d={hid}",
                lambda: kb.spmm(blocks, col_off, x),
                lambda: kb.spmm_plain(blocks, col_off, x),
                nbytes(blocks, col_off, x) + n * hid * 4, 2 * nnz * hid,
                lambda: torch.bmm(bf, win)))

    # the candidate pooling: S ego-net rows onto N centers
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
    records.append(check(
        "pool", f"S={s_rows}->N={n_seg} W={window} d={hid}",
        lambda: kb.pool(pblocks, off, data),
        lambda: kb.spmm_plain(pblocks, off, data),
        nbytes(pblocks, off, data) + n_seg * hid * 4,
        2 * int((pblocks != 0).sum()) * hid,
        lambda: torch.bmm(pbf, pwin)))
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


def profile_phase(encoder="GIN", eager=False):
    """Device time by kernel over 3 steady steps of a main path (after
    2 unprofiled ones; the captured path's first is its eager warm-up and
    capture), the device's busy share of those steps' wall time (host
    clock, with the profiler's own overhead in it), and the host's launch
    and copy calls a step; ``port``: [ms, calls] per step of each of the
    port's CUDA kernels.  Where the profiler records no device time (a
    replay it does not break into kernels), the device ms come from CUDA
    events around each step instead, and ``device_ms_from`` says so."""
    from torch.profiler import ProfilerActivity, profile, schedule

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=1, warmup=1, active=3))
    with prof, (eager_steps() if eager else contextlib.nullcontext()):
        steps = run_pretrain(synthetic=1024, batch_size=128, steps=5,
                             lr=1e-4, weight_decay=5e-5, device="cuda",
                             encoder=encoder, log=lambda _: None,
                             profiler=prof)
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
                        for k in sorted({v[2].split()[0]
                                         for v in PATH.values()})}}
    if not busy_ms:
        summary["device_ms_per_step"] = event_device_ms(encoder, eager)
        summary["device_ms_from"] = "CUDA events around the step"
        summary["device_busy_share"] = (summary["device_ms_per_step"]
                                        / wall_ms)
    print(f"profile ({encoder}, {summary['path']}): {json.dumps(summary)}",
          flush=True)
    return summary


def event_device_ms(encoder, eager):
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
                     log=lambda _: None, profiler=Timed())
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

    def replay(self, entry, batches):
        if id(entry) not in seen:
            seen.add(id(entry))
            return real(self, entry, batches)
        graph, _, out, added = entry
        graph.replay()
        trainer._add_tally(added)
        return trainer._clone(out)
    return replay


COMPARED = {"GIN": ({}, GIN_PER_STEP),
            "Transformer": ({"encoder": "Transformer"}, GT_PER_STEP),
            "Transformer-merged": ({"encoder": "Transformer",
                                    "gt_bwd": "merged"}, MERGED_PER_STEP)}


def captured_phase(dev, ds, caps):
    """Phase 5 (a): the captured step against the eager one."""
    batches = [(g.to(dev), s.to(dev)) for g, s in itertools.islice(
        batch_iterator(ds, 128, caps, seed=7), STEPS)]
    report = {}
    with deterministic():
        for label, (kwargs, per_step) in COMPARED.items():
            eager = compared_run(dev, batches, kwargs, "eager")
            captured = compared_run(dev, batches, kwargs, "captured")
            real = trainer._CapturedSteps._replay
            trainer._CapturedSteps._replay = stale_inputs(real)
            try:
                fault = compared_run(dev, batches, kwargs, "captured")
            finally:
                trainer._CapturedSteps._replay = real
            rec = {"losses_apart": bytes_apart(eager[0], captured[0]),
                   "state_apart": bytes_apart(eager[1], captured[1]),
                   "fault_losses_apart": len(bytes_apart(eager[0],
                                                         fault[0])),
                   "fault_state_apart": len(bytes_apart(eager[1],
                                                        fault[1]))}
            for name, run in (("eager", eager), ("captured", captured)):
                want = {k: n * STEPS for k, n in per_step.items()}
                got = {k: n for k, n in run[2].items() if n}
                if got != want:
                    raise AssertionError(f"{label} {name}: launches {got}, "
                                         f"expected {want}")
            if "merged" in label:
                # dk and dv summed with atomics: held to tolerances, beside
                # the spread of a second eager run
                again = compared_run(dev, batches, kwargs, "eager")
                rec["eager_twice_state_apart"] = len(bytes_apart(eager[1],
                                                                 again[1]))
                rec.update(merged_apart(eager, captured))
                ok = (rec["loss_rel"] <= 1e-5
                      and rec["weights_lr"] <= 2 * STEPS)
            else:
                ok = not rec["losses_apart"] and not rec["state_apart"]
            print(f"captured vs eager ({label}), {STEPS} steps: "
                  f"{json.dumps(rec)}", flush=True)
            if not ok:
                raise AssertionError(f"{label}: the captured step is not "
                                     f"the eager one: {rec}")
            if not (rec["fault_losses_apart"] and rec["fault_state_apart"]):
                raise AssertionError(f"{label}: the planted fault went "
                                     "unseen")
            report[label] = rec
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
    weights = max(float((a - b).abs().max()) for a, b in
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
    pool_mod.branch_counts.clear()
    worst = 0.0
    for i in range(3):
        ref = copy.deepcopy(model).to("cpu", torch.float64).train()
        g64, sub64 = g.to("cpu"), sub.to("cpu")
        g64.node_feat = g64.node_feat.double()
        before = trainer._tally()
        with torch.no_grad():
            want = [float(v) for v in ref(g64, sub64)]
        after = trainer._tally()               # the reference's branches
        trainer._add_tally({k: n - before.get(k, 0)
                            for k, n in after.items()}, -1)
        got = [float(v) for v in step(g, sub)]
        if i:
            worst = max(worst, max(abs(a - b) / abs(b)
                                   for a, b in zip(got, want)))
    counts = launch_counts()
    branches = dict(pool_mod.branch_counts)
    rec = {"replay_loss_rel": worst, "pool_branches": branches,
           "pool_launches": counts["pool"], "graphs": len(step.graphs)}
    print(f"skewed batch, captured: {json.dumps(rec)} (tol {MODEL_RTOL})",
          flush=True)
    if not (worst <= MODEL_RTOL and branches == {"scatter": 3}
            and counts["pool"] == 0 and len(step.graphs) == 1):
        raise AssertionError(f"skewed batch: {rec}")
    return rec


def medians_phase():
    """Phase 5 (c): step medians (steps 1-5 of 6) of the eager and the
    captured step, eager / captured / captured / eager, for both
    encoders."""
    out = {}
    for encoder in ("GIN", "Transformer"):
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
    runs = {name: main_path(name, *spec) for name, spec in RUNS.items()}
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

    # 9. report
    kernels = []
    for name, (src, line, port_kernel) in PATH.items():
        recs = [r for r in records if r["name"] == name]
        widest = max((r for r in recs if r.get("main", True)),
                     key=lambda r: r["bound_ms"])
        run = REPORT_RUN.get(name, "GIN")
        sup = supervised["steps"]["GIN" if run == "GIN" else "Transformer"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"scgib_tpu_torch/csrc/{src}.cu",
            "replaces": f"scgib_tpu/ops/pallas/{src}.py:{line}",
            "status": "ported",
            "port_kernel": f"scgib_tpu_torch/csrc/{src}.cu::{port_kernel}",
            "launches": runs[run]["counts"][name], "launches_run": run,
            "finetune_step_launches": sup["finetune_step_launches"].get(
                name, 0),
            "eval_batch_launches": sup["eval_batch_launches"].get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": widest["ms"], "plain_ms": widest["plain_ms"],
            "bound_ms": widest["bound_ms"], "bound_by": widest["bound_by"],
            "library_ms": widest["library_ms"], "shape": widest["shape"],
            "configs": recs})
    print(json.dumps({"kernels": kernels,
                      "step_ms": {k: r["step_ms"] for k, r in runs.items()},
                      "steps": {k: r["steps"] for k, r in runs.items()},
                      "verb": verb, "compiled": compiled,
                      "supervised": supervised,
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
    the steps (0 for the wrappers not in ``per_step``), and every conv or
    attention must take the ``band`` branch (by default the fused GIN
    layer's, or the narrow attention's)."""
    reset_launch_counts()
    pool_mod.branch_counts.clear()
    encoders.branch_counts.clear()
    records = run_pretrain(synthetic=1024, batch_size=128, steps=steps,
                           lr=1e-4, weight_decay=5e-5, device="cuda",
                           **kwargs)
    torch.cuda.synchronize()
    counts = launch_counts()
    branches = (dict(pool_mod.branch_counts), dict(encoders.branch_counts))
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
    layers = 10 if "encoder" in kwargs else 8      # 2 encoders x layers
    band = band or ("gt_band_64x128" if "encoder" in kwargs else "band")
    if branches != ({"banded": steps}, {band: layers * steps}):
        raise AssertionError(f"{name} left the kernel branches: {branches}")
    return {"counts": counts, "step_ms": step_ms, "steps": records}


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
    pool_mod.branch_counts.clear()
    encoders.branch_counts.clear()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"verb {label}: {secs:.2f} s; launches {launch_counts()}; "
          f"branches {dict(pool_mod.branch_counts)} "
          f"{dict(encoders.branch_counts)}", flush=True)
    return out, secs


def check_verb_counts(label, steps):
    """The launch and branch counts of ``steps`` GIN steps, as
    ``main_path`` checks them."""
    expect_counts(label, GIN_PER_STEP, steps)
    branches = (dict(pool_mod.branch_counts), dict(encoders.branch_counts))
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
            real = trainer._CapturedSteps._replay
            trainer._CapturedSteps._replay = stale_inputs(real)
            try:
                fault = ft_compared_run(dev, batches, kwargs, accum,
                                        "captured")
            finally:
                trainer._CapturedSteps._replay = real
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
                        for k in sorted({v[2].split()[0]
                                         for v in PATH.values()})}}
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


if __name__ == "__main__":
    main()
