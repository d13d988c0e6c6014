"""What a run loads and what it does without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_jax_loaded():
    """The harness, its reference and the program it drives load no JAX
    and not the JAX package, compared by whole top-level names (the port's
    name begins with the JAX package's)."""
    proc = _python(
        "import importlib.util, sys\n"
        "sys.path.insert(0, '.')\n"
        "spec = importlib.util.spec_from_file_location('bench_run', "
        "'benchmark/run.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import benchmark.calibrate, benchmark.reference.rnad\n"
        "import benchmark.system, benchmark.check, benchmark.trace\n"
        "import benchmark.drivers.train, benchmark.reference.families.mlp\n"
        "import benchmark.reference.families.equinet\n"
        "import benchmark.reference.families.convnet\n"
        "import benchmark.work.convnet\n"
        "import rnad_tpu_torch.learn.rnad\n"
        "from benchmark import system\n"
        "print(system.forbidden_loaded(sys.modules))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    assert proc.returncode == 0, proc.stderr
    loaded, tops = proc.stdout.splitlines()[:2]
    assert loaded == "[]"
    assert "rnad_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "rnad_tpu"} & set(eval(tops))


def test_forbidden_names_are_whole():
    from benchmark import system

    assert system.forbidden_loaded(["rnad_tpu_torch.learn", "jaxtyping",
                                    "flaxen"]) == []
    assert system.forbidden_loaded(["rnad_tpu.learn", "jax.numpy"]) == [
        "jax", "rnad_tpu"]


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mlp256-demo.train-b262k", "--seed", "3", "--seconds", "1", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    proc = _run(ROOT, "--trace", "1")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in bench["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
