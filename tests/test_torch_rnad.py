"""rnad_tpu_torch.learn.rnad against rnad_tpu.learn.rnad, and the port's
independence from JAX.

From the same weights and the same rollout noise, one fused train step must
give the same new parameters (atol 1e-6: Adam with b1=0 moves each weight
by at most lr, so this is a tight bound on the update) and the same loss
scalars (rtol 1e-5); five steps with a regularization rotation must give
the same target-net NashConv within 1e-4.
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.models import nets as jax_nets
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.torch_parity import torch_mlp, torch_tree, train_step_noise

REPO = pathlib.Path(__file__).resolve().parent.parent
A, WIDTH, B = 3, 32, 256
CFG = dict(batch_size=B, eta=0.2, bounds=(2,), delta_m=(4,), lr=1e-3,
           gamma_averaging=0.01, logit_clip=2.0)


def _pair(small_tree, seed=0, **kw):
    cfg = RNaDConfig(**CFG, **kw)
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH))
    train_step, _, _, nashconv_fn = jax_rnad.make_rnad_fns(net, small_tree,
                                                           cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(seed), A, cfg)
    tree = torch_tree(small_tree)
    tcfg = torch_config.RNaDConfig(**CFG, **kw)
    tstate = torch_rnad.init_train_state(
        torch_mlp(state.variables["params"], A, WIDTH), torch.Generator())
    tstep = torch_rnad.make_train_step(
        tree, torch_stepping.make_packed_tables(tree), tcfg)
    return (train_step, nashconv_fn, state), (tstep, tree, tstate)


def _noise(small_tree, state):
    return train_step_noise(state.key, B, A, small_tree.max_transitions,
                            small_tree.max_depth)


def _assert_params_close(module, params, atol):
    got = torch_nets.params_to_flax(module)
    for layer in params:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][leaf],
                                       np.asarray(params[layer][leaf]),
                                       rtol=0, atol=atol,
                                       err_msg=f"{layer}/{leaf}")


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_one_fused_step_matches(small_tree, alpha):
    (step, _, state), (tstep, _, tstate) = _pair(small_tree)
    noise = _noise(small_tree, state)
    new, metrics = step(state, jnp.float32(alpha))
    _, tmetrics = tstep(tstate, alpha, noise)
    _assert_params_close(tstate.net, new.variables["params"], 1e-6)
    _assert_params_close(tstate.net_target, new.variables_target["params"],
                         1e-6)
    assert tstate.total_steps == int(new.total_steps) == 1
    for k in ("loss", "loss_v", "loss_nerd"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert set(tmetrics) == set(metrics)
    for k in ("traj_len", "logit_mean", "logit_max", "entropy",
              "entropy_target", "actor_learner_kld", "gradient_norm"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_five_steps_nashconv_matches(small_tree):
    (step, nashconv_fn, state), (tstep, tree, tstate) = _pair(small_tree, 1)
    for n in range(5):
        alpha = jax_rnad.alpha_schedule(n, 4)
        assert torch_rnad.alpha_schedule(n, 4) == alpha
        noise = _noise(small_tree, state)
        state, _ = step(state, jnp.float32(alpha))
        tstep(tstate, alpha, noise)
        if n == 2:  # an update boundary
            state = jax_rnad.rotate_regularization_nets(state)
            torch_rnad.rotate_regularization_nets(tstate)
    _assert_params_close(tstate.net_reg, state.variables_reg["params"], 1e-5)
    want = float(nashconv_fn(state.variables_target).nashconv())
    got = float(torch_rnad.nashconv(tree, tstate.net_target).nashconv())
    assert abs(got - want) < 1e-4


def test_rotation_copies_the_target(small_tree):
    _, (tstep, _, tstate) = _pair(small_tree)
    tstep(tstate, 0.5)
    reg = tstate.net_reg
    torch_rnad.rotate_regularization_nets(tstate)
    assert tstate.net_reg_ is reg
    before = [p.clone() for p in tstate.net_reg.parameters()]
    tstep(tstate, 0.5)  # the target moves; the new reg net must not
    for p, q in zip(tstate.net_reg.parameters(), before):
        assert torch.equal(p, q)


def test_rnad_loop_schedule_and_eval(small_tree, tmp_path):
    tree = torch_tree(small_tree)
    cfg = torch_config.RNaDConfig(batch_size=64, bounds=(2,), delta_m=(3,),
                                  lr=1e-3, gamma_averaging=0.01)
    run = torch_rnad.RNaD(tree, cfg, torch_config.NetConfig(
        max_actions=A, width=WIDTH), runs_root=str(tmp_path), device="cpu")
    run.run(log_mod=1)
    value = run.final_eval()
    assert run.state.total_steps == 6
    steps = [s for s, m in run.history if "loss" in m]
    evals = [m["nashconv"] for s, m in run.history if "nashconv" in m]
    assert steps == [1, 2, 3, 4, 5, 6] and len(evals) == 2
    assert all(np.isfinite(v) for _, m in run.history for v in m.values())
    assert evals[-1] == value


@pytest.mark.parametrize("field,value", [
    ("frozen_net_dtype", "float16"),
    # rnad_tpu's TPU layout and its packed fuse modes, which lost or tied
    # on the TPU and on the H100
    ("learner_layout", "amb"),
    ("fuse_net_passes", "frozen"),
    ("fuse_net_passes", "all"),
])
def test_unported_fields_raise(small_tree, field, value):
    tree = torch_tree(small_tree)
    cfg = torch_config.RNaDConfig(**{field: value})
    with pytest.raises(NotImplementedError, match=field):
        torch_rnad.RNaD(tree, cfg, device="cpu")


@pytest.mark.parametrize("field,value", [("learner_layout", "diagonal"),
                                         ("fuse_net_passes", "packed")])
def test_unknown_modes_raise_rnad_tpus_error(small_tree, field, value):
    """A layout or fuse mode that neither package knows raises
    rnad_tpu's ValueError, before the trainer starts."""
    cfg = RNaDConfig(**{field: value})
    with pytest.raises(ValueError) as want:
        if field == "learner_layout":
            jax_rnad.resolve_learner_layout(cfg, False, max_actions=A)
        else:
            jax_rnad.resolve_fuse_mode(jax_nets.build_net(NetConfig(
                type="MLP", max_actions=A, width=WIDTH)), cfg)
    with pytest.raises(ValueError) as got:
        torch_rnad.RNaD(torch_tree(small_tree),
                        torch_config.RNaDConfig(**{field: value}),
                        device="cpu")
    assert str(got.value) == str(want.value)


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rnad_tpu_torch\n"
        "for m in pkgutil.walk_packages(rnad_tpu_torch.__path__,\n"
        "                               'rnad_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import rnad_tpu_torch.learn.rnad\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'optax',\n"
        "                                    'rnad_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_import_in_sources():
    banned = {"jax", "flax", "optax", "rnad_tpu"}
    files = sorted((REPO / "rnad_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """chip_smoke.py must exit nonzero and print no result where there is
    no card, and where it stands alone without the package."""
    if alone:
        (tmp_path / "chip_smoke.py").write_text(
            (REPO / "chip_smoke.py").read_text())
        cwd = tmp_path
    else:
        cwd = REPO
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
