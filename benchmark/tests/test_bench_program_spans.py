"""The program's spans read from a small hand-made trace: device and idle
time by span, and the harness's own reading unmoved by them."""

import dataclasses
import json

import pytest

from benchmark import program_spans, trace

PROGRAM = ("rnad.",)


def _events(with_program: bool):
    """Two steps, each: the harness's spans, the program's inside them, K1
    launched in the rollout, a product in the learner's forward after an
    idle gap, an Adam kernel in its update and a fill with no launch."""
    ev = []

    def op(cat, name, ts, dur, **args):
        if with_program or not name.startswith(PROGRAM):
            ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                       "dur": dur, "args": args})

    for s, t0 in enumerate((0.0, 1000.0)):
        op("user_annotation", "train_step", t0, 900)
        op("user_annotation", "rnad.train_step", t0 + 5, 890)
        op("user_annotation", "rollout", t0 + 10, 100)
        op("user_annotation", "rnad.rollout", t0 + 12, 96)
        op("user_annotation", "learn_step", t0 + 200, 600)
        op("user_annotation", "rnad.learn", t0 + 205, 590)
        op("user_annotation", "rnad.learn.forward", t0 + 210, 150)
        op("user_annotation", "rnad.learn.update", t0 + 500, 100)
        op("cpu_op", "aten::mm", t0 + 300, 50)
        for k, launch in enumerate((20, 310, 510)):
            op("cuda_runtime", "cudaLaunchKernel", t0 + launch, 5,
               correlation=10 * s + k)
        op("kernel", "void fused_turn_kernel<3>(...)", t0 + 30, 40,
           correlation=10 * s)
        op("kernel", "sm80_gemm", t0 + 320, 100, correlation=10 * s + 1)
        op("kernel", "adam", t0 + 520, 30, correlation=10 * s + 2)
        op("gpu_memset", "Memset", t0 + 400, 10)
    return ev


def _write(tmp_path, with_program: bool):
    path = tmp_path / f"t{int(with_program)}.json"
    path.write_text(json.dumps({"traceEvents": _events(with_program)}))
    return str(path)


def test_program_and_idle_seconds(tmp_path):
    p = program_spans.read(_write(tmp_path, True), 2)
    us = 1e-6
    assert p.program_s == pytest.approx({
        "rnad.train_step": 2 * 170 * us, "rnad.rollout": 2 * 40 * us,
        "rnad.learn": 2 * 130 * us, "rnad.learn.forward": 2 * 100 * us,
        "rnad.learn.update": 2 * 30 * us})
    # gaps: 250 before each product, 100 before each Adam kernel, and 480
    # before the second step's K1 (the first K1 opens the window)
    assert p.idle_s == pytest.approx({
        "rnad.train_step": 1180 * us, "rnad.rollout": 480 * us,
        "rnad.learn": 700 * us, "rnad.learn.forward": 500 * us,
        "rnad.learn.update": 200 * us})
    assert p.idle_total_s == pytest.approx(1180 * us)
    assert p.by_name["rnad.learn"] == pytest.approx(
        {"sm80_gemm": 200 * us, "adam": 60 * us})


def test_without_program_spans_reads_empty(tmp_path):
    p = program_spans.read(_write(tmp_path, False), 2)
    assert p.program_s == p.idle_s == p.by_name == {}
    assert p.idle_total_s == pytest.approx(1180e-6)


def test_harness_reading_unmoved(tmp_path):
    """Every field of the harness's ``Trace``, the named gaps among them,
    reads the same with the program's spans in the trace as without."""
    with_spans = trace.read(_write(tmp_path, True), 2)
    without = trace.read(_write(tmp_path, False), 2)
    assert dataclasses.asdict(with_spans) == dataclasses.asdict(without)
    assert with_spans.span_s["learn_step"] == pytest.approx(260e-6)
    assert with_spans.gaps[0][0].startswith("rollout")
