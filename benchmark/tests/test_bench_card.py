"""A traced run of the MLP cell on the card: its last line carries the
cell's six per-layer metrics and a breakdown, and ``correct`` is true.
Run on the card's machine with ``python -m pytest benchmark/tests -m
cuda``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_traced_run_on_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mlp256-demo.train-b262k", "--seed", "2147483650", "--seconds", "5",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {
        "device_idle_pct", "step_mfu", "launches_per_step", "rollout_ms",
        "learn_ms", "k1_roofline"}
    assert line["breakdown"]["device_ops"] and line["device"]["busy_s"] > 0
    assert list(line)[-1] == "checks"
