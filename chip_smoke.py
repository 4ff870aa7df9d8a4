#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``scgib_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero before the last line:
  1. environment: the card's name and power limit; TF32 off.
  2. build the CUDA kernels from scgib_tpu_torch/csrc/ (one nvcc per
     source, sm_90a, all started together).
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the benchmark batch (128 molecules of 10-30 atoms, k=1:
     N=3072 graph rows, S=9728 ego-net rows; the attention kernels in the
     narrow (64, 128) geometry, 8 heads of 8): error, kernel / plain /
     library time (median of 20 CUDA graph replays, each between CUDA
     events), the bound and its share of the kernel time (gin_fwd's and
     gin_bwd's at the 3xTF32 tensor-core rate they run at, with the fp32
     SIMT one beside it); the merged attention backward against the
     two-pass one; and the registers, shared memory and blocks per SM of
     banded_spmm, gin_fused_fwd, gin_fused_bwd, gt_fwd, gt_bwd_rows and
     gt_bwd_cols at the main path's widths.
  4. the full model on that batch, GIN and graph-transformer encoders,
     once on the card and once on the CPU plain path in float64
     (deterministic, dropout off): losses and gradients must agree.
  5. the main paths: ``cli.run_pretrain`` at full width (PretrainModel(9,
     64, 32), batch 128, lr 1e-4, wd 5e-5) for 6 optimizer steps with GIN
     encoders, then 6 with graph transformers (5 layers, 8 heads, dropout
     0.5, two-pass backward), then 2 with the merged backward; each run
     starts with every launch count at 0, and each kernel's count must be
     its expected per-step count times the steps, the pooling must take
     its kernel branch and the encoders their band branches.
  6. the pretrain verb and its options, at the same width, batch and
     optimizer: (a) the committed JAX checkpoint
     outputs/pre_training_PCQM4Mv2_GIN_64_4_1.msgpack, read by the port's
     own codec, gives on the card the float64 CPU losses on the benchmark
     batch; (b) ``cli.main(["pretrain", "--curriculum", ...])`` on 512
     synthetic molecules for 2 epochs with autosave: three stages, every
     loss finite, each stage's checkpoint written, the launch counts those
     of the steps taken, every stage skipped on a rerun; a run stopped
     after epoch 0 and resumed to epoch 1 against one never stopped, both
     under torch's deterministic algorithms: their final autosaves must be
     byte-equal, and must differ when the resume drops the Adam state or
     shuffles epoch 1 with seed + 1 (planted faults); (c) each new option
     (s2s readout, attention off, reference KL, logM reconstruction, dense
     reconstruction): card losses against float64 CPU, then one optimizer
     step; (d) the repaired widths,
     4 steps each of ``run_pretrain``: GIN at hidden 256 (banded SpMM
     branch) and 30 (fused kernels), the transformer at 1 head of 64 and
     at hidden 96 with 8 heads of 12 (zero-padded to 16), with their
     launch and branch counts and step times.
  7. where the step time goes: 3 steady steps of each encoder's main path
     under torch.profiler; device time by kernel and the device's busy
     share.
  8. one JSON line of the kernels, the nvidia-smi line, and
     {"ok": true, "device": {...}} as the last line.
"""

import contextlib
import copy
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
                                         batch_iterator, plan_capacities)
from scgib_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from scgib_tpu_torch.models import encoders  # noqa: E402
from scgib_tpu_torch.models.scgib import (PretrainModel,  # noqa: E402
                                          _resolve_band)
from scgib_tpu_torch.ops import pool as pool_mod  # noqa: E402
from scgib_tpu_torch.ops.kernels import banded as kb  # noqa: E402
from scgib_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from scgib_tpu_torch.ops.kernels import gt_flash as kg  # noqa: E402
from scgib_tpu_torch.train import checkpoint, loops  # noqa: E402
from scgib_tpu_torch.train.trainer import make_pretrain_step  # noqa: E402
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
MERGED_STEPS = 2              # steps with the merged attention backward
HEADS, HEAD_DIM = 8, 8        # the graph transformer's attention
# wrapper -> (source, TPU kernel line, CUDA kernel)
PATH = {"gin_fwd": ("banded", 69, "gin_fused_fwd_kernel"),
        "gin_bwd": ("banded", 141, "gin_fused_bwd_kernel"),
        "spmm_self": ("banded", 177, "banded_spmm_kernel"),
        "spmm": ("banded", 266, "banded_spmm_kernel"),
        "pool": ("banded", 405, "banded_spmm_kernel"),
        "gt_fwd": ("gt_flash", 121, "gt_fwd_kernel"),
        "gt_bwd_rows": ("gt_flash", 146, "gt_bwd_rows_kernel"),
        "gt_bwd_cols": ("gt_flash", 248, "gt_bwd_cols_kernel"),
        "gt_bwd_merged": ("gt_flash", 181, "gt_bwd_merged_kernel")}
# main-path run -> (run_pretrain arguments, steps, launches per step; the
# wrappers not named launch 0 times)
RUNS = {"GIN": ({}, STEPS, GIN_PER_STEP),
        "Transformer": ({"encoder": "Transformer"}, STEPS, GT_PER_STEP),
        "Transformer-merged": ({"encoder": "Transformer",
                                "gt_bwd": "merged"}, MERGED_STEPS,
                               {"gt_fwd": 10, "gt_bwd_merged": 10,
                                "spmm": 2, "pool": 1})}
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
    off, span = pool_mod.window_offsets(sub.node_center, sub.node_mask,
                                        n_seg, 128, window)
    if not bool(span <= window):
        raise AssertionError("benchmark batch does not fit the pool window")
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
    geometry the main path gives them; then the merged backward against
    the two-pass one.  Operations are counted per edge and head (the
    kernels skip zero gate entries): 2 hd per product of two hd-vectors,
    plus the clip, exponential, gate and sums."""
    records = []
    for label, batch in (("N", g), ("S", sub)):
        blocks, off = _resolve_band(batch, gt=True)
        n = blocks.shape[0] * blocks.shape[1]
        edges = int((blocks != 0).sum()) * HEADS
        q, k, v, gr = (torch.randn(n, HEADS, HEAD_DIM, device=dev,
                                   generator=gen) for _ in range(4))
        z = kg.gt_fwd_plain(blocks, off, q, k, v)[1]
        rho = kg.gt_bwd_rows_plain(blocks, off, q, k, v, gr, z)[1]
        shape = (f"{label}={n} H={HEADS} hd={HEAD_DIM} "
                 f"blocks={tuple(blocks.shape)}")
        ins = nbytes(blocks, off, q, k, v)
        feat, stat = nbytes(q), nbytes(z)
        hd = HEAD_DIM
        records.append(check(
            "gt_fwd", shape, lambda: kg.gt_fwd(blocks, off, q, k, v),
            lambda: kg.gt_fwd_plain(blocks, off, q, k, v),
            ins + feat + stat, edges * (4 * hd + 5)))
        records.append(check(
            "gt_bwd_rows", shape,
            lambda: kg.gt_bwd_rows(blocks, off, q, k, v, gr, z),
            lambda: kg.gt_bwd_rows_plain(blocks, off, q, k, v, gr, z),
            ins + feat + stat + feat + stat, edges * (6 * hd + 8)))
        records.append(check(
            "gt_bwd_cols", shape,
            lambda: kg.gt_bwd_cols(blocks, off, q, k, v, gr, z, rho),
            lambda: kg.gt_bwd_cols_plain(blocks, off, q, k, v, gr, z, rho),
            ins + feat + 2 * stat + 2 * feat, edges * (8 * hd + 10)))
        records.append(check(
            "gt_bwd_merged", shape,
            lambda: kg.gt_bwd_merged(blocks, off, q, k, v, gr, z),
            lambda: kg.gt_bwd_merged_plain(blocks, off, q, k, v, gr, z),
            ins + feat + stat + 3 * feat, edges * (10 * hd + 10)))
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
    for kernel in ("gt_fwd", "gt_bwd_rows", "gt_bwd_cols", "gt_bwd_merged"):
        info = kg.kernel_info(kernel, HEAD_DIM)
        print(f"resources {kernel}_kernel hd={HEAD_DIM}: {info}", flush=True)
        for rec in records:
            if rec["name"] == kernel:
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


def profile_phase(encoder="GIN"):
    """Device time by kernel over 3 steady steps of a main path (after
    2 unprofiled ones), and the device's busy share of those steps' wall
    time (host clock, with the profiler's own overhead in it); ``port``:
    [ms, calls] per step of each of the port's CUDA kernels."""
    from torch.profiler import ProfilerActivity, profile, schedule

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=1, warmup=1, active=3))
    with prof:
        steps = run_pretrain(synthetic=1024, batch_size=128, steps=5,
                             lr=1e-4, weight_decay=5e-5, device="cuda",
                             encoder=encoder, log=lambda _: None,
                             profiler=prof)
    wall_ms = sum(r["ms"] for r in steps[2:]) / 3
    # device-side events, less the user annotations (ProfilerStep*, the
    # optimizer's step), which span kernels rather than being one
    kernels = sorted(
        ((e.self_device_time_total / 1e3 / 3, e.count / 3, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and not e.key.startswith("ProfilerStep")),
        reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    summary = {"wall_ms_per_step": wall_ms, "device_ms_per_step": busy_ms,
               "device_busy_share": busy_ms / wall_ms if busy_ms else None,
               "device_kernels_per_step": sum(k[1] for k in kernels),
               "top": [{"kernel": name[:80], "ms_per_step": ms,
                        "calls_per_step": n}
                       for ms, n, name in kernels[:12]],
               "port": {k: [sum(ms for ms, _, name in kernels if k in name),
                            sum(n for _, n, name in kernels if k in name)]
                        for k in sorted({v[2].split()[0]
                                         for v in PATH.values()})}}
    print(f"profile ({encoder}): {json.dumps(summary)}", flush=True)
    if not busy_ms:
        print("profile: the profiler recorded no device time; device busy "
              "share not measured", flush=True)
    return summary


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

    # 2. build
    kbuild.load(*sorted({src for src, _, _ in PATH.values()}))
    kb.build()
    kg.build()
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
    lap("3 kernels")

    # 4. full model, card vs CPU
    for encoder in ("GIN", "Transformer"):
        model_phase(g, sub, dev, encoder)
    lap("4 model")

    # 5. main paths
    runs = {name: main_path(name, *spec) for name, spec in RUNS.items()}
    lap("5 main paths")

    # 6. the pretrain verb, its options and the repaired widths
    verb = verb_phase(g, sub, dev, ds, caps)
    lap("6 verb, options, widths")

    # 7. where the step time goes
    profiles = {encoder: profile_phase(encoder)
                for encoder in ("GIN", "Transformer")}
    lap("7 profile")

    # 8. report
    kernels = []
    for name, (src, line, port_kernel) in PATH.items():
        recs = [r for r in records if r["name"] == name]
        widest = max(recs, key=lambda r: r["bound_ms"])
        run = REPORT_RUN.get(name, "GIN")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"scgib_tpu_torch/csrc/{src}.cu",
            "replaces": f"scgib_tpu/ops/pallas/{src}.py:{line}",
            "status": "ported",
            "port_kernel": f"scgib_tpu_torch/csrc/{src}.cu::{port_kernel}",
            "launches": runs[run]["counts"][name], "launches_run": run,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": widest["ms"], "plain_ms": widest["plain_ms"],
            "bound_ms": widest["bound_ms"], "bound_by": widest["bound_by"],
            "library_ms": widest["library_ms"], "shape": widest["shape"],
            "configs": recs})
    print(json.dumps({"kernels": kernels,
                      "step_ms": {k: r["step_ms"] for k, r in runs.items()},
                      "steps": {k: r["steps"] for k, r in runs.items()},
                      "verb": verb, "profile": profiles,
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
    "Transformer hidden 96, 8 heads of 12": (
        {"encoder": "Transformer", "hidden": 96}, GT_PER_STEP,
        "gt_band_64x128")}


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
        step = make_pretrain_step(model, torch.optim.Adam(
            model.parameters(), lr=1e-4, weight_decay=5e-5))
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


if __name__ == "__main__":
    main()
