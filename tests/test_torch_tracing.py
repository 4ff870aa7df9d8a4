"""The program's spans (``scgib_tpu_torch/utils/profiling.py``): kept only
while a profiler session is open, on ``time.time_ns()``'s clock, nested by
step call, in a bounded buffer read without taking, and written by
``profile_trace`` into its Chrome trace on a track of their own.

The CPU tests step eagerly (no graph on the CPU) and drive a replay's parts
through ``_CapturedSteps._replay`` with a stand-in graph.  The test marked
``cuda`` replays a captured GIN pretraining step under a CUDA-only profiler
session, as the benchmark's traced stretch opens one, and skips without a
card.  This file imports neither JAX nor the JAX package, so on a machine
with a card:

    python -m pytest tests/test_torch_tracing.py -q --noconftest
"""

import dataclasses
import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph.batching import pack_graphs, pack_subgraphs
from scgib_tpu_torch.graph.egonet import extract_egonets
from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.train import trainer
from scgib_tpu_torch.utils import counters, profiling

PARTS = profiling.STEP_PARTS


def _batch(device="cpu"):
    graphs = random_dataset(16, seed=5, min_nodes=8, max_nodes=28)
    egos = [extract_egonets(g, 1) for g in graphs]
    g = pack_graphs(graphs, 512, 2048, 16).to(device)
    sub = pack_subgraphs(graphs, egos, 1536, 4096, num_centers=512).to(device)
    return g, sub


def _pretrain_step(device="cpu"):
    model = PretrainModel(9, hidden=16, d_transfer=8).to(device)
    return trainer.make_pretrain_step(model, trainer.adam_l2(model, 1e-4))


def _tensor_fields(*batches):
    return [getattr(b, f.name) for b in batches
            for f in dataclasses.fields(b)
            if isinstance(getattr(b, f.name), torch.Tensor)]


@pytest.fixture(scope="module")
def cpu_step():
    return _pretrain_step(), _batch()


def test_a_step_records_nothing_without_a_profiler_session(cpu_step):
    step, (g, sub) = cpu_step
    kept = list(profiling.SPANS.spans)
    start = time.time_ns()
    step(g, sub)
    assert profiling.spans_between(start, time.time_ns()) == []
    assert list(profiling.SPANS.spans) == kept


def test_an_eager_step_records_its_span_inside_the_clock_bracket(cpu_step):
    step, (g, sub) = cpu_step
    with profile(activities=[ProfilerActivity.CPU]):
        start = time.time_ns()
        step(g, sub)
        end = time.time_ns()
    got = profiling.spans_between(start, end)
    assert [(s.name, s.parent, s.args) for s in got] == [
        ("scgib.step", None, {"kind": "eager"})]
    assert start <= got[0].start < got[0].end <= end
    # after the session a step keeps nothing again
    step(g, sub)
    assert profiling.spans_between(start, time.time_ns()) == got


class _Graph:
    """Stands in for a captured graph: its replay takes 2 ms of the host."""

    def replay(self):
        time.sleep(0.002)


def test_a_replays_parts_nest_in_its_span_and_share_its_step(cpu_step):
    """``_replay``'s four parts after the key's, each ending where the
    next begins, all inside the call's span and of its step; the counts
    are the batches' tensor fields and the three losses."""
    step, (g, sub) = cpu_step
    buffers = (trainer._input_buffers(g), trainer._input_buffers(sub))
    out = trainer.PretrainLosses(*(torch.zeros(()) for _ in range(3)))
    entry = (_Graph(), buffers, out, {})
    buf = profiling.SpanBuffer()
    start = time.time_ns()
    spans = buf.step()
    spans.part(PARTS[0])                          # as _step ends the key's
    got = step._replay(entry, (g, sub), spans)
    spans.end("replay", trainer._replay_counts(entry))
    end = time.time_ns()
    assert isinstance(got, trainer.PretrainLosses)
    assert all(torch.equal(a, b) for a, b in
               zip(_tensor_fields(*buffers), _tensor_fields(g, sub)))
    top, *parts = buf.between(start, end)
    assert (top.name, top.parent, top.args) == ("scgib.step", None,
                                               {"kind": "replay"})
    assert [p.name for p in parts] == list(PARTS)
    assert all(p.parent == "scgib.step" and p.step == top.step
               for p in parts)
    assert start <= top.start and top.end <= end
    assert top.start <= parts[0].start and parts[-1].end <= top.end
    assert all(a.end == b.start for a, b in zip(parts, parts[1:]))
    fields = _tensor_fields(g, sub)
    by_name = {p.name: p for p in parts}
    assert by_name["scgib.step.inputs"].args == {
        "copies": len(fields), "bytes": sum(v.nbytes for v in fields)}
    assert by_name["scgib.step.outputs"].args == {"clones": 3}
    replay = by_name["scgib.step.replay"]
    assert replay.end - replay.start >= 2_000_000


def test_the_buffer_stays_bounded_and_keeps_the_newest():
    buf = profiling.SpanBuffer(capacity=8)
    for _ in range(10):
        spans = buf.step()
        for name in PARTS:
            spans.part(name)
        spans.end("replay")
    assert len(buf.spans) == 8
    assert buf.spans[-1].step == 10 and buf.spans[0].step == 9
    assert len(profiling.SPANS.spans) <= profiling.SPAN_CAPACITY


def test_the_interval_reader_keeps_what_it_reads():
    buf = profiling.SpanBuffer()
    for kind in ("capture", "replay", "replay"):
        spans = buf.step()
        spans.part(PARTS[0])
        spans.end(kind)
    everything = buf.between(0, time.time_ns())
    assert len(everything) == 6
    assert buf.between(0, time.time_ns()) == everything
    assert list(buf.spans) == everything
    second = everything[2]                      # the second call's span
    assert buf.between(second.start, second.end) == everything[2:4]


def test_profile_trace_writes_the_spans_on_their_own_track(cpu_step,
                                                          tmp_path):
    step, (g, sub) = cpu_step
    with profiling.profile_trace(str(tmp_path)):
        step(g, sub)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("tid") == profiling.SPAN_TRACK]
    spans = [e for e in ours if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["scgib.step"]
    assert spans[0]["args"]["kind"] == "eager"
    assert any(e["ph"] == "M" and e["args"]["name"] == profiling.SPAN_TRACK
               for e in ours)
    # the same clock: the step's operators fall inside its span
    a = spans[0]["ts"]
    b = a + spans[0]["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    inside = [e for e in ops if a <= e["ts"] and e["ts"] + e["dur"] <= b]
    assert ops and len(inside) >= 0.9 * len(ops)


def test_a_steps_tally_reads_the_registry(cpu_step):
    """One GIN pretraining step on a banded batch, between two snapshots of
    the counts: the tally a replay of it would carry holds its branches
    and each batch's band width, and no route; taking the difference back
    leaves the counts as they were."""
    step, (g, sub) = cpu_step
    before = counters.snapshot()
    step(g, sub)
    after = counters.snapshot()
    added = {k: after.get(k, 0) - before.get(k, 0)
             for k in set(after) | set(before)}
    added = {k: n for k, n in added.items() if n}
    tally = trainer._replay_counts((None, (g, sub), torch.zeros(()),
                                    added))[PARTS[3]]
    assert tally == {"encoder.band": 8, "pool.banded": 1, "recon.band": 1,
                     "band_widths": (256, 256)}
    assert not any(k.startswith("route.") for k in tally)
    counters.add(added, -1)
    assert counters.snapshot() == before


@pytest.mark.cuda
def test_a_captured_gin_replay_records_its_parts_on_the_card():
    """Under a profiler session of the device's activity alone, the first
    call of a key is a capture and the next ones replay, each with the key
    and the four parts after it; ``copies`` is the tensor fields of the
    two batches, ``clones`` the three losses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    step = _pretrain_step(dev)
    g, sub = _batch(dev)
    with profile(activities=[ProfilerActivity.CUDA], record_shapes=False,
                 with_stack=False):
        start = time.time_ns()
        for _ in range(3):
            step(g, sub)
        torch.cuda.synchronize(dev)
        end = time.time_ns()
    got = profiling.spans_between(start, end)
    tops = [s for s in got if s.name == "scgib.step"]
    assert [s.args["kind"] for s in tops] == ["capture", "replay", "replay"]
    for top in tops[1:]:
        parts = [s for s in got if s.step == top.step and s is not top]
        assert [p.name for p in parts] == list(PARTS)
        assert all(p.parent == "scgib.step" for p in parts)
        assert top.start <= parts[0].start and parts[-1].end <= top.end
        by_name = {p.name: p for p in parts}
        fields = _tensor_fields(g, sub)
        assert by_name["scgib.step.inputs"].args == {
            "copies": len(fields), "bytes": sum(v.nbytes for v in fields)}
        assert by_name["scgib.step.outputs"].args == {"clones": 3}
