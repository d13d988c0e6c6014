"""rnad_tpu_torch.utils.timing: ``trace`` records the block's operators and
writes a Chrome trace; ``span`` puts the trainer's layers on a profiler's
timeline, nested as the step runs them, and is a shared null context that
adds no operator while no profiler records."""

import collections
import contextlib
import json

import pytest
import torch

from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.learn import buffer as torch_buffer
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.utils import timing
from tests.torch_parity import torch_tree

A = 3
LEARNER = ["rnad.learn.forward", "rnad.learn.frozen", "rnad.learn.vtrace",
           "rnad.learn.backward", "rnad.learn.update"]


def test_trace_records_and_writes(tmp_path):
    with timing.trace(str(tmp_path)) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    keys = {e.key for e in prof.key_averages()}
    assert "aten::matmul" in keys or "aten::mm" in keys
    events = json.loads((tmp_path / "trace.json").read_text())
    assert events["traceEvents"]


MLP = torch_config.NetConfig(max_actions=A, width=16)
EQUINET = torch_config.NetConfig(type="EquiNet", max_actions=A, channels=4,
                                 depth=1, solver_iters=4, solver_prime=True)


def _run(small_tree, tmp_path, net=MLP, **kw):
    cfg = dict(batch_size=16, bounds=(2,), delta_m=(2,), lr=1e-3)
    cfg.update(kw)
    run = torch_rnad.RNaD(torch_tree(small_tree),
                          torch_config.RNaDConfig(**cfg), net,
                          directory_name="spans", runs_root=str(tmp_path),
                          device="cpu")
    run.initialize()
    return run


def _spans(tmp_path, block):
    """The ``rnad.*`` spans ``block`` records, as (start, end, name) in
    the order they open."""
    with timing.trace(str(tmp_path / "trace")):
        block()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                  for e in events["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("rnad."))


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _in_order(spans):
    """Each span ends before the next one opens."""
    return all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def _one(spans, name):
    found = [s for s in spans if s[2] == name]
    assert len(found) == 1, (name, spans)
    return found[0]


@pytest.mark.parametrize("fuse,net", [
    ("off", MLP), ("heads", MLP), ("frozen", MLP), ("all", MLP),
    ("off", EQUINET)], ids=["off", "heads", "frozen", "all", "equinet"])
def test_train_step_spans_nest(small_tree, tmp_path, fuse, net):
    """One fused step under a profiler: the step holds the rollout (which
    holds each generic turn's net forward; the MLP's turns are K1's), then
    the learner, which holds its passes in order; "all" has no frozen
    pass of its own."""
    run = _run(small_tree, tmp_path, net, fuse_net_passes=fuse)
    run.train_step(run.state, 0.5)
    spans = _spans(tmp_path, lambda: run.train_step(run.state, 0.5))
    learner = [n for n in LEARNER
               if fuse != "all" or n != "rnad.learn.frozen"]
    turns = ["rnad.rollout.forward"] * (
        run.tree.max_depth if net is EQUINET else 0)
    assert [s[2] for s in spans] == ["rnad.train_step", "rnad.rollout"
                                     ] + turns + ["rnad.learn"] + learner
    step, rollout, learn = (_one(spans, n) for n in
                            ("rnad.train_step", "rnad.rollout", "rnad.learn"))
    assert _within(rollout, step) and _within(learn, step)
    assert _in_order([rollout, learn])
    forwards = [s for s in spans if s[2] == "rnad.rollout.forward"]
    assert all(_within(f, rollout) for f in forwards) and _in_order(forwards)
    parts = [_one(spans, n) for n in learner]
    assert all(_within(p, learn) for p in parts) and _in_order(parts)


def test_buffered_step_samples_in_a_span(small_tree, tmp_path):
    run = _run(small_tree, tmp_path, n_batches_per_buffer=2, buffer_mod=2)
    buffer = torch_buffer.TrajectoryBuffer(2)
    run.buffered_step(buffer, 0.5)
    assert run.state.total_steps == 1  # the next step samples, no rollout
    spans = _spans(tmp_path, lambda: run.buffered_step(buffer, 0.5))
    assert [s[2] for s in spans] == ["rnad.buffer.sample",
                                     "rnad.learn"] + LEARNER
    assert _in_order([_one(spans, "rnad.buffer.sample"),
                      _one(spans, "rnad.learn")])


def test_run_spans_eval_and_checkpoint(small_tree, tmp_path):
    """Two update periods of two steps: a checkpoint before each period's
    first step, the eval at the second period's start, four steps."""
    run = _run(small_tree, tmp_path)
    spans = _spans(tmp_path, lambda: run.run(max_updates=2,
                                             checkpoint_mod=2))
    names = collections.Counter(s[2] for s in spans)
    assert names["rnad.checkpoint"] == 2 and names["rnad.eval"] == 1
    assert names["rnad.train_step"] == names["rnad.learn.update"] == 4
    steps = [s for s in spans if s[2] == "rnad.train_step"]
    assert _in_order(steps[:2] + [_one(spans, "rnad.eval")] + steps[2:])


def test_span_off_is_one_null_context():
    off = timing.span("rnad.a")
    assert isinstance(off, contextlib.nullcontext)
    assert timing.span("rnad.b") is off
    with torch.profiler.profile():
        assert timing.span("rnad.a") is not off
    assert timing.span("rnad.a") is off


def _op_counts(run):
    with timing.trace() as prof:
        run.train_step(run.state, 0.5)
    return {e.key: e.count for e in prof.key_averages()
            if not e.key.startswith("rnad.")}


def test_spans_add_no_operator(small_tree, tmp_path, monkeypatch):
    """The operators of a profiled step with the spans and with ``span``
    the null context everywhere are the same, and each as often."""
    run = _run(small_tree, tmp_path)
    run.train_step(run.state, 0.5)
    spanned = _op_counts(run)
    monkeypatch.setattr(timing, "span",
                        lambda name: contextlib.nullcontext())
    plain = _op_counts(run)
    assert spanned == plain
    assert any(k.startswith("aten::") for k in plain)
