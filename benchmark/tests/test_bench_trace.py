"""The trace reader and the readers on a small hand-made trace."""

import json
import types

import pytest

from benchmark import cells, trace


def _trace(tmp_path):
    ev = []

    def op(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": args})

    # two steps: train_step spans, rollout and learn_step inside
    for s, t0 in enumerate((0.0, 1000.0)):
        op("user_annotation", "train_step", t0, 900)
        op("user_annotation", "rollout", t0 + 10, 100)
        op("user_annotation", "learn_step", t0 + 200, 600)
        op("cpu_op", "aten::mm", t0 + 300, 50)
        op("cuda_runtime", "cudaLaunchKernel", t0 + 20, 5, correlation=10 * s)
        op("cuda_runtime", "cudaLaunchKernel", t0 + 310, 5,
           correlation=10 * s + 1)
        op("kernel", "void fused_turn_kernel<3>(...)", t0 + 30, 40,
           correlation=10 * s)
        op("kernel", "sm80_gemm", t0 + 320, 100, correlation=10 * s + 1)
        op("gpu_memset", "Memset", t0 + 400, 10)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read(str(path), 2)


def test_read(tmp_path):
    t = _trace(tmp_path)
    assert t.kernels == 4
    assert t.busy_s == pytest.approx(2 * 140e-6)  # the fill overlaps
    assert t.span_s["rollout"] == pytest.approx(80e-6)
    assert t.span_s["learn_step"] == pytest.approx(200e-6)
    assert t.kernel_s("fused_turn") == pytest.approx(80e-6)
    assert t.kernel_launches("fused_turn") == 2
    # the longest gap ends at the second step's K1, launched in rollout
    where, gap = t.gaps[0]
    assert where.startswith("rollout") and gap == pytest.approx(610e-6)


def test_readers(tmp_path):
    from benchmark import run  # noqa: F401  (the module imports cleanly)

    cell = cells.find("mlp256-demo.train-b262k")
    ctx = types.SimpleNamespace(
        trace=_trace(tmp_path), config=cell.config, lanes=cell.lanes,
        levels=4, step_s=1e-3,
        window=types.SimpleNamespace(steps=10, seconds=0.01, peak_bytes=2**30,
                                     intervals_ms=[1.0] * 9 + [2.0]),
        setup_s=3.0, rollouts=[])
    read = lambda name: run.reader(name)(ctx)
    assert read("launches_per_step") == 2
    assert read("device_idle_pct") == pytest.approx(86.0)
    assert read("rollout_ms") == pytest.approx(0.04)
    assert read("k1_roofline") is None  # no rollouts to count
    assert read("k3_roofline") is None  # no K3 in the trace
    assert read("updates_per_s") == pytest.approx(1000.0)
    assert read("peak_mem_gib") == 1.0
