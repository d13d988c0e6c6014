"""The curves of ``tools/validate_vs_reference.py``'s run, the port's half
(``rnad_tpu_torch/validate_curves.py``) against ``rnad_tpu``'s
(``docs/port_runs/curves/validate_vs_rnad_tpu.py``, which calls the JAX
tool's own ``run_ours``): one small run of both halves on the CPU, the
initial weights' round trip through flax's layout, the seed rule of
``compare`` on synthetic curves, and the two port modules' imports."""

import importlib.util
import json
import math
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig
from rnad_tpu.models import nets as jax_nets
from rnad_tpu_torch import validate_curves
from tests.test_torch_train_cli import _option_strings

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = ["--depth", "2", "--batch-size", "64", "--updates", "2",
         "--delta-m", "3", "--seed", "1"]


def _script():
    path = REPO / "docs" / "port_runs" / "curves" / "validate_vs_rnad_tpu.py"
    spec = importlib.util.spec_from_file_location("validate_vs_rnad_tpu",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    out = tmp_path_factory.mktemp("curves")
    assert _script().main(["both", "--cpu", *SMALL, "--out", str(out)]) == 0
    load = lambda half: json.loads((out / f"curves-s1.{half}.json")
                                   .read_text())
    return out, load("port"), load("rnad_tpu")


def test_both_halves_run_the_same_tree_from_the_same_weights(both):
    _, port, ref = both
    assert port["tree"] == ref["tree"] and port["tree"]["max_depth"] == 2
    assert port["options"] == ref["options"]
    assert len(port["curve"]) == len(ref["curve"]) == 3
    assert all(math.isfinite(v) for v in port["curve"] + ref["curve"])
    # same tree, same weights: the untrained target's NashConv agrees
    assert abs(port["curve"][0] - ref["curve"][0]) <= 1e-6
    assert port["device"] == "cpu" and port["steps"] == 6
    # the CPU runs the kernels' plain versions: no launch counts
    assert port["k1_per_step"] == port["k2_per_step"] == 0


def test_initial_weights_round_trip_through_flax(both):
    """rnad_tpu's MLP with the written params gives the port's logits and
    values on the same observations."""
    out, _, _ = both
    net = validate_curves.initial_net(3, 1)
    params = _script().load_params(out / "curves-s1.init.npz")
    flax_net = jax_nets.build_net(NetConfig(type="MLP", max_actions=3,
                                            width=validate_curves.WIDTH))
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(65, 2, 3, 3)).astype(np.float32)
    obs[:, 1] = rng.random((65, 3, 3)) < 0.7
    logits, values = flax_net.apply(
        {"params": {k: {l: jnp.asarray(a) for l, a in v.items()}
                    for k, v in params.items()}}, jnp.asarray(obs))
    with torch.no_grad():
        want_l, want_v = net(torch.from_numpy(obs))
    np.testing.assert_allclose(np.asarray(logits), want_l.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(values).reshape(-1),
                               want_v.numpy(), atol=1e-6, rtol=0)


def _pair(directory, seed, port_curve, ref_curve, **options):
    opts = {"updates": len(port_curve) - 1, "delta_m": 100, "seed": seed,
            **options}
    tree = {"hash": 1000 + seed, "size": 10, "max_depth": 3}
    port = {"name": f"curves-s{seed}", "tree": tree, "options": opts,
            "curve": port_curve, "wall_s": 1.0, "device": "card",
            "k1_per_step": 3.0, "k2_per_step": 1.0}
    ref = {"name": f"curves-s{seed}", "tree": tree, "options": opts,
           "curve": ref_curve, "wall_s": 2.0, "device": "cpu"}
    (directory / f"curves-s{seed}.port.json").write_text(json.dumps(port))
    (directory / f"curves-s{seed}.rnad_tpu.json").write_text(json.dumps(ref))


def _curve(level):
    return [1.0, 0.9, 0.8, 0.7, 0.6] + [level] * 4


def test_compare_applies_the_seed_rule(tmp_path, capsys):
    """F is the mean of the last 4 evals; the curves agree when |mean d|
    <= max(3 sd(d) / sqrt(n), 0.02)."""
    script = _script()
    agree, part, missing = (tmp_path / x for x in ("agree", "part", "miss"))
    for d in (agree, part, missing):
        d.mkdir()
    # d = +0.01, -0.01, +0.015: mean within the 0.02 floor
    for seed, dv in enumerate((0.01, -0.01, 0.015)):
        _pair(agree, seed, _curve(0.5 + dv), _curve(0.5))
    assert script.main(["compare", "--dir", str(agree)]) == 0
    out = capsys.readouterr().out
    assert "| 8 | 0.500000 | 0.515000 | 0.015000 |" in out
    assert ": agree" in out and "speedup" not in out
    # d = 0.1, 0.11, 0.12: mean 0.11 past max(3 x 0.01 / sqrt 3, 0.02)
    for seed, dv in enumerate((0.1, 0.11, 0.12)):
        _pair(part, seed, _curve(0.5 + dv), _curve(0.5))
    assert script.main(["compare", "--dir", str(part)]) == 1
    assert "DISAGREE" in capsys.readouterr().out
    rule = script.seed_rule(script.pairs(part))
    assert rule["mean_d"] == pytest.approx(0.11)
    assert rule["bound"] == pytest.approx(max(3 * 0.01 / math.sqrt(3), 0.02))
    # a seed whose rnad_tpu half is missing is not compared
    _pair(missing, 0, _curve(0.5), _curve(0.5))
    _pair(missing, 1, _curve(0.5), _curve(0.5))
    (missing / "curves-s1.rnad_tpu.json").unlink()
    with pytest.raises(SystemExit, match="curves-s1: no rnad_tpu half"):
        script.main(["compare", "--dir", str(missing)])
    # pairs that ran other options are not one rule's seeds
    _pair(missing, 1, _curve(0.5), _curve(0.5), eta=1.0)
    with pytest.raises(SystemExit, match="other options"):
        script.main(["compare", "--dir", str(missing)])


def test_options_are_the_jax_tools():
    want = _option_strings(
        (REPO / "tools" / "validate_vs_reference.py").read_text())
    got = {s for a in validate_curves.build_parser()._actions
           for s in a.option_strings if s not in ("-h", "--help")}
    assert want <= got and got - want == {"--out", "--name"}
    d = validate_curves.build_parser().parse_args([])
    assert (d.updates, d.delta_m, d.batch_size, d.eta, d.lr, d.gamma_avg,
            d.seed, d.depth) == (8, 100, 512, 0.2, 1e-3, 0.01, 7, 3)


def test_runs_on_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        validate_curves.main(SMALL)


def test_modules_import_no_jax():
    code = ("import sys\n"
            "import rnad_tpu_torch.roofline, rnad_tpu_torch.validate_curves\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'flax', 'rnad_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
