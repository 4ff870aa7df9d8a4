"""Faults planted under the timed path, for the checks' controls: each
takes a built driver and breaks its program's step before the first step.

``unchanged``: the optimizer never moves anything (a step that returns its
state unchanged).  ``half_batch``: each batch keeps its first half of real
graphs, the losses taken over those alone.  ``altered``: the answer is
altered where the step produces it: the last loss term by a relative 1e-3,
and in fine-tuning the first score of each evaluation batch by 1e-3.
"""

from __future__ import annotations

import dataclasses

import torch

ALTER = 1e-3


def unchanged(driver):
    driver.optimizer.step = lambda *args, **kwargs: None


def _halve(g, sub):
    real = g.graph_mask
    ids = torch.arange(real.shape[0], device=real.device)
    keep_g = real & (ids < (real.sum() + 1) // 2)
    node = g.node_mask & keep_g[g.node_graph]
    sub_node = sub.node_mask & node[sub.node_center]
    return (dataclasses.replace(g, graph_mask=keep_g, node_mask=node,
                                edge_mask=g.edge_mask & node[g.receivers]),
            dataclasses.replace(sub, node_mask=sub_node,
                                edge_mask=sub.edge_mask
                                & sub_node[sub.receivers]))


def half_batch(driver):
    step = driver.recorder.step

    def halved(g, sub, generator=None):
        return step(*_halve(g, sub), generator)
    driver.recorder.step = halved


def altered(driver):
    step = driver.recorder.step

    def alter(g, sub, generator=None):
        out = step(g, sub, generator)
        if isinstance(out, torch.Tensor):
            return out * (1 + ALTER)
        return type(out)(*out[:-1], out[-1] * (1 + ALTER))
    driver.recorder.step = alter
    ev = getattr(driver, "evaluator", None)
    if ev is not None:
        fn = ev.eval_fn

        def scores(g, sub, generator=None):
            out = fn(g, sub, generator).clone()
            out[0] += ALTER
            return out
        ev.eval_fn = scores


PLANTED = {"unchanged": unchanged, "half_batch": half_batch,
           "altered": altered}
