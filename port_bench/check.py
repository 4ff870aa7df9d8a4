"""The comparison that decides ``correct``.

The reference (``reference/``) follows the steps the program's timed path
ran first, on the same molecules (packed by the reference itself), from the
same seed-made weights and with the same noise draws, in float64.  Each
number compared is a gap:

``loss``   each checked step's loss terms: |program - reference| / |reference|;
           for each term its median over the steps, then the worst term.
``grad``   step 1's gradient as the optimizer took it (the program's: Adam's
           first moment after one step over 1 - beta1), leaf by leaf:
           | ||program|| - ||reference|| | over the larger of the
           reference's norm of that leaf and of the median leaf; the median
           leaf's gap.
``change`` the parameters' change over the checked steps, leaf by leaf, the
           same measure and the median trained leaf's gap (or a frozen
           leaf's, where larger), over the entries whose step-1 reference
           gradient is a thousandth or more of the median leaf's
           root-mean-square entry: an entry under it (a bias under a
           BatchNorm, a weight under a softmax, a unit whose ReLU never
           closes) has a gradient of round-off alone, which Adam turns into
           a whole step.  Frozen leaves are kept whole: their reference
           change is 0.
``eval``   (fine-tuning) the largest |program - reference| of the first
           evaluation's probabilities, val and test, the reference scoring
           with the program's parameters and running statistics at that
           point (its own run of the whole epoch would hand a bias under a
           BatchNorm Adam's round-off steps, which eval mode shows).

The worst case of each gap (every step's every term, the worst leaf)
swings from seed to seed with the float32 round-off that a BatchNorm over a
near-constant feature, or the KL's 1 / std, amplifies in the later steps;
the medians above are the steady numbers compared (``PERF.md``).  Each
number has its limit in ``limits/<workload>.json``.
"""

from __future__ import annotations

import json
import pathlib
import statistics
from typing import Dict, List, Optional

import torch

from .reference import model as M
from .reference import pack, steps

HERE = pathlib.Path(__file__).resolve().parent
BETA1 = 0.9


def limits(workload: str) -> Dict[str, float]:
    path = HERE / "limits" / f"{workload}.json"
    return {k: float(v) for k, v in json.loads(path.read_text())[
        "limits"].items()}


def _norms(ts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in ts.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]
              ) -> Dict[str, float]:
    """Each leaf's | ||program|| - ||reference|| | over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref.values())
    return {n: abs(prog.get(n, 0.0) - r) / max(r, med, 1e-30)
            for n, r in ref.items()}


def detail(program: dict, reference: dict, weights: Dict[str, torch.Tensor]
           ) -> dict:
    """Every gap the numbers are taken from: ``loss`` [step][term],
    ``grad`` and ``change`` by leaf."""
    loss = [[abs(p - r) / max(abs(r), 1e-30) for p, r in zip(ps, rs)]
            for ps, rs in zip(program["losses"], reference["losses"])]
    grad = leaf_gaps(_norms(program["first_grad"]),
                     _norms(reference["first_grad"]))
    # round-off alone moves an entry whose reference gradient is under a
    # thousandth of the median leaf's root-mean-square entry
    floor = 1e-3 * statistics.median(
        float(g.double().pow(2).mean().sqrt())
        for g in reference["first_grad"].values())
    dp, dr = {}, {}
    for n, w in weights.items():
        w = w.double()
        g = reference["first_grad"].get(n)
        keep = (torch.ones_like(w, dtype=torch.bool) if g is None
                else g.double().to(w.device).abs() >= floor)
        if not bool(keep.any()):
            continue
        for side, out in ((program, dp), (reference, dr)):
            step = side["params"][n].double().to(w.device) - w
            out[n] = float(step[keep].norm())
    return {"loss": loss, "grad": grad, "change": leaf_gaps(dp, dr)}


def gaps(program: dict, reference: dict, weights: Dict[str, torch.Tensor]
         ) -> Dict[str, float]:
    """The numbers compared, from two records of the same steps:
    ``losses`` (a list a step), ``first_grad`` (by trainable name) and
    ``params`` (after the last checked step, every name).  Each is steady
    from seed to seed (``PERF.md`` gives the look behind it): for each loss
    term the median of its gap over the checked steps, the worst term; the
    median leaf's gap of the first gradient and of the change."""
    d = detail(program, reference, weights)
    trained = [v for n, v in d["change"].items() if n in d["grad"]]
    frozen = [v for n, v in d["change"].items() if n not in d["grad"]]
    return {"loss": max(statistics.median(term) for term in zip(*d["loss"])),
            "grad": statistics.median(d["grad"].values()),
            "change": max([statistics.median(trained)] + frozen)}


def worst(program: dict, reference: dict, weights: Dict[str, torch.Tensor]
          ) -> Dict[str, float]:
    """The worst case of each gap: every step's every term, the worst
    leaf."""
    d = detail(program, reference, weights)
    return {"loss": max(max(row) for row in d["loss"]),
            "grad": max(d["grad"].values()),
            "change": max(d["change"].values())}


def program_record(driver) -> dict:
    """The program's side of ``gaps`` from a driver's recorder."""
    rec = driver.recorder
    if driver.head == "pretrain":
        losses = [[float(l.kl), float(l.contrastive),
                   float(l.reconstruction)] for l in rec.outputs]
    else:
        losses = [[float(l)] for l in rec.outputs]
    names = M.trainable(driver.cfg, driver.head,
                        driver.config.get(driver.head, {}).get("freeze",
                                                               "none"))
    grads = {n: rec.first_moments.get(n, torch.zeros_like(
        driver.weights[n])) / (1 - BETA1) for n in names}
    return {"losses": losses, "first_grad": grads,
            "params": rec.params_after}


def _batches(driver, plans, dtype=torch.float64):
    return [pack.pack([driver.mols[i] for i in sel], driver.k,
                      driver.caps.nodes, driver.caps.sub_nodes, dtype,
                      driver.device) for sel in plans]


def reference_record(driver, num: M.Numerics = M.FLOAT64) -> dict:
    opt = driver.config[driver.head]
    return steps.follow(driver.cfg, driver.head, driver.weights,
                        _batches(driver, driver.checked_plans),
                        driver.recorder.states, opt["lr"],
                        opt["weight_decay"], opt.get("freeze", "none"), num)


def eval_gap(driver, num: M.Numerics = M.FLOAT64) -> Optional[float]:
    ev = getattr(driver, "evaluator", None)
    if ev is None:
        return None
    plans = [sel for p in driver.eval_plans for sel in p]
    out: List[torch.Tensor] = []
    for split in driver.eval_plans:    # each split's call seeds its noise 0
        out += steps.evaluate(driver.cfg, ev.state, _batches(driver, split),
                              0, num)
    worst = 0.0
    for prog, ref, sel in zip(ev.scores, out, plans):
        p = prog.reshape(-1)[:len(sel)].double().to(ref.device)
        worst = max(worst, float((p - ref).abs().max()))
    return worst


def numbers(driver) -> Dict[str, float]:
    out = gaps(program_record(driver), reference_record(driver),
               driver.weights)
    e = eval_gap(driver)
    if e is not None:
        out["eval"] = e
    return out
