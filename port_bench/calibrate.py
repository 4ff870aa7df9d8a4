"""The readings the checks' limits are set from, for one cell.

    python3 port_bench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 [--out <file>]

For every seed, the program's sound run (its first steps, through the
cell's own loop and sizes, as ``run.py`` drives them) against the
reference; for each control seed also the control (the reference in
float32 with every product's operands rounded to TF32, put in the
program's place), the program in its bf16 modes, and each planted fault of
``faults.py``.  Prints one JSON line a reading and, last, each number's
lower reading (the largest of the sound runs) and the least of the
control's and the faults'.  Needs the cell's CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from port_bench import check, drivers, faults, run  # noqa: E402
from port_bench.reference import model as M  # noqa: E402
from port_bench.reference import steps  # noqa: E402

BF16 = {"GIN": {"compute_dtype": "bfloat16"},
        "Transformer": {"gt_bf16_dots": True, "gt_dtype": "bfloat16"}}


def _with_look(prog, ref, weights) -> dict:
    """The numbers compared, the worst cases beside them, and where the
    worst cases lie (the step and term, the leaves)."""
    out = check.gaps(prog, ref, weights)
    out.update({f"worst_{k}": v
                for k, v in check.worst(prog, ref, weights).items()})
    d = check.detail(prog, ref, weights)
    out["look"] = {
        "loss": [[float(f"{x:.3g}") for x in row] for row in d["loss"]],
        "grad": sorted(((float(f"{v:.3g}"), n) for n, v in
                        d["grad"].items()), reverse=True)[:3],
        "change": sorted(((float(f"{v:.3g}"), n) for n, v in
                          d["change"].items()), reverse=True)[:3]}
    return out


def program_numbers(d) -> dict:
    out = _with_look(check.program_record(d), check.reference_record(d),
                     d.weights)
    e = check.eval_gap(d)
    if e is not None:
        out["eval"] = e
    return out


def control_numbers(d) -> dict:
    out = _with_look(check.reference_record(d, M.TF32),
                     check.reference_record(d), d.weights)
    ev = getattr(d, "evaluator", None)
    if ev is not None:
        worst = 0.0
        for split in d.eval_plans:
            b = check._batches(d, split)
            lo = steps.evaluate(d.cfg, ev.state, b, 0, M.TF32)
            hi = steps.evaluate(d.cfg, ev.state, b, 0)
            worst = max([worst] + [float((x.double() - y).abs().max())
                                   for x, y in zip(lo, hi)])
        out["eval"] = worst
    return out


def readings(workload, seed, controls, device, config, traffic):
    data = drivers.Data(traffic, seed, config["model"]["k"],
                        "finetune" if traffic["loop"] == "finetune"
                        else "pretrain")

    def program(cfg=config, fault=None):
        d = drivers.make(cfg, traffic, seed, device, data)
        if fault:
            faults.PLANTED[fault](d)
        d.warm_up()
        d.release()
        return program_numbers(d)

    out = [("sound", program())]
    if controls:
        d = drivers.make(config, traffic, seed, device, data)
        d.warm_up()
        d.release()
        out.append(("control_tf32", control_numbers(d)))
        bf = {**config, "model": {**config["model"],
                                  **BF16[config["model"]["encoder"]]}}
        out.append(("program_bf16", program(bf)))
        for f in ("half_batch", "altered", "unchanged"):
            out.append((f"fault_{f}", program(fault=f)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    _, cell, config, traffic = run.cell_spec(args.workload)
    traffic = {**traffic, "warmup_epochs": 1, "warmup_cycles": 1}
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(run.power_line(), flush=True)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for s in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        for kind, nums in readings(args.workload, s, s in controls, device,
                                   config, traffic):
            row = {"workload": args.workload, "seed": s, "kind": kind,
                   **nums}
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(f"seed {s}: {time.perf_counter() - t0:.1f} s", flush=True)
    summary = {}
    for k in rows[0]:
        if k in ("workload", "seed", "kind", "look"):
            continue
        sound = [r[k] for r in rows if r["kind"] == "sound"]
        other = {r["kind"]: r[k] for r in rows if r["kind"] != "sound"}
        summary[k] = {"lower": max(sound),
                      "others": {kind: min(r[k] for r in rows
                                           if r["kind"] == kind)
                                 for kind in other}}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(
            "\n".join(json.dumps(r) for r in rows + [{"summary": summary}]))


if __name__ == "__main__":
    main()
