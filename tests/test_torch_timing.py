"""rnad_tpu_torch.utils.timing against rnad_tpu.utils.timing: the same
phases, counts and summary keys; ``trace`` records the block's operators
and writes a Chrome trace."""

import json

import jax.numpy as jnp
import torch

from rnad_tpu.utils import timing as jax_timing
from rnad_tpu_torch.utils import timing


def _drive(mod, make):
    timer = mod.PhaseTimer()
    for _ in range(3):
        with timer.phase("a", sync=make()):
            pass
    assert timer.timed("b", make()) is not None
    return timer.summary()


def test_phase_timer_matches():
    want = _drive(jax_timing, lambda: jnp.ones(3))
    got = _drive(timing, lambda: torch.ones(3))
    assert got.keys() == want.keys() == {"a", "b"}
    for k in want:
        assert got[k].keys() == want[k].keys()
        assert got[k]["count"] == want[k]["count"]
        assert got[k]["total_s"] >= 0.0
    timer = timing.PhaseTimer()
    with timer.phase("cpu device", sync="cpu"):
        pass
    assert timer.counts["cpu device"] == 1


def test_trace_records_and_writes(tmp_path):
    with timing.trace(str(tmp_path)) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    keys = {e.key for e in prof.key_averages()}
    assert "aten::matmul" in keys or "aten::mm" in keys
    events = json.loads((tmp_path / "trace.json").read_text())
    assert events["traceEvents"]
