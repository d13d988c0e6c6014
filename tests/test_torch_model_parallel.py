"""The model axis (``rnad_tpu_torch/parallel/tensor_parallel.py`` on the
``mesh.make_grid`` grid) against one rank and against ``rnad_tpu``'s
model-parallel ``learn_jit``.

Every multi-rank case runs in spawned CPU processes over gloo, once per
module (``tests/torch_tp_worker.py``, a time limit on every cluster):
model 2 as 2 ranks and data 2 x model 2 as 4.  The families are
``dryrun_multichip``'s (``__graft_entry__.py:58-75``): the MLP at depth 1,
2 and 3, the ConvNet with BatchNorm under the lift (4 channels, sigma
0.1) and the EquiNet with ``solver_iters=2``.

* A learner update on a fixed trajectory and one fused train step are
  held against the port's one-rank step at the data axis's tolerances
  (tests/test_torch_parallel.py): metrics within rtol 2e-5 / atol 1e-6,
  weights within 2e-6, 2 lr where the one-rank gradient is below 1e-6
  (Adam with b1 = 0 turns a gradient that is 0 but for rounding into a
  step of up to lr); the weights are equal on every rank bitwise.  One learner case sets ``grad_clip`` so
  low that the clip binds and Adam's epsilon makes the step depend on the
  norm, so a wrong global norm shows in the weights; one has a width that
  does not divide over the model axis.
* The same learner update against ``rnad_tpu``'s
  ``make_sharded_rnad_fns(model_parallel_mlp=True)`` ``learn_jit`` on
  ``make_mesh(model_parallelism=2)`` over 2 and 4 of the conftest's
  virtual devices, from the same converted weights, at the same
  tolerances.  The EquiNet's learner cases read ``rnad_tpu``'s RM+ solves
  of the trajectory's games, in process and on the ranks: float32 RM+
  summed in another order parts on some games (``solver_device.
  agreement``); its fused step solves with the port's own RM+.
* A 1 x 1 grid (in this process) is the plain learner and train step
  bitwise.
* Each of the four operators, inside a small function, gives the
  one-rank gradients (7 columns in tensor_split's uneven shards over the
  model axis).
* The buffered step under the grid (``RNaD.buffered_step``), 4 steps,
  against the plain run: losses and the weights' checksum within rtol
  1e-4.
* A run saved under model 2 resumes under model 1 (the plain ``RNaD``)
  and one saved under model 1 resumes under model 2, its weights, target,
  regularization nets and Adam moments bitwise the checkpoint's.
"""

import concurrent.futures
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, ObsTransformConfig, RNaDConfig
from rnad_tpu.env import engine as jax_engine
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.parallel import mesh as jax_mesh
from rnad_tpu.parallel import runtime as jax_runtime
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch import multiprocess_check as mpc
from rnad_tpu_torch.learn import buffer as torch_buffer
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import obs_transform as torch_obs
from rnad_tpu_torch.ops import stepping as torch_stepping
from rnad_tpu_torch.parallel import dryrun
from rnad_tpu_torch.parallel import mesh as torch_mesh
from rnad_tpu_torch.parallel import runtime
from rnad_tpu_torch.parallel import tensor_parallel
from rnad_tpu_torch.utils import checkpoint
from tests import torch_tp_worker
from tests.test_torch_parallel import (ALPHA, LR, TIMEOUT, _assert_metrics,
                                       _assert_weights)
from tests.torch_parity import jax_solve, torch_convnet, torch_tree

A, B = 3, 32
CFG = dict(batch_size=B, eta=0.2, bounds=(1,), delta_m=(2,), lr=LR,
           gamma_averaging=0.01, logit_clip=2.0)
LIFT = dict(kind="lift", channels=4, sigma=0.1)
# name: (net, extra R-NaD fields); n_discrete: see
# tests/test_torch_rnad_equinet.py (equivariant ties)
FAMILIES = {
    "mlp1": (dict(type="MLP", max_actions=A, width=64, depth=1), {}),
    "mlp2": (dict(type="MLP", max_actions=A, width=64, depth=2), {}),
    "mlp3": (dict(type="MLP", max_actions=A, width=64, depth=3), {}),
    "convnet": (dict(type="ConvNet", max_actions=A, channels=8, depth=1,
                     batch_norm=True), {"obs_transform": LIFT}),
    "equinet": (dict(type="EquiNet", max_actions=A, channels=8, depth=2,
                     solver_iters=2), {"n_discrete": 2**16}),
}
# learner-only cases: an uneven split (33 = 17 + 16 over the model axis)
# and a clip that binds
EXTRA = {
    "mlp2_odd": (dict(type="MLP", max_actions=A, width=33, depth=2), {}),
    "mlp3_clip": (FAMILIES["mlp3"][0], {"grad_clip": 1e-6}),
}
LEARN = {**FAMILIES, **EXTRA}
WORLDS = {2: 2, 4: 2}  # ranks: model parallelism
BUFFERED, BUFFERED_STEPS = dict(n_batches_per_buffer=4, buffer_mod=2), 4
OP_SHAPE = (5, 7, 7)  # x (N, D), w (H, D): D and H split unevenly


def _configs(name):
    net_kw, extra = LEARN[name]
    extra = dict(extra)
    lift = extra.pop("obs_transform", None)
    jcfg = RNaDConfig(**CFG, **extra, **(
        {"obs_transform": ObsTransformConfig(**lift)} if lift else {}))
    tcfg = torch_config.RNaDConfig(**CFG, **extra, **(
        {"obs_transform": torch_config.ObsTransformConfig(**lift)}
        if lift else {}))
    return jcfg, tcfg, NetConfig(**net_kw), torch_config.NetConfig(**net_kw)


def _to_torch(net_cfg, variables, in_channels):
    if net_cfg.type == "ConvNet":
        return torch_convnet(variables, A, net_cfg.channels, net_cfg.depth,
                             in_channels=in_channels)
    net = torch_nets.build_net(torch_config.NetConfig(
        **{f: getattr(net_cfg, f) for f in ("type", "max_actions", "width",
                                            "depth", "channels",
                                            "solver_iters")}))
    net.load_state_dict(torch_nets.params_from_flax(
        jax.tree.map(np.asarray, variables["params"])))
    return net


def _to_flax(tnet):
    """The port's whole net as rnad_tpu's variables."""
    if isinstance(tnet, torch_nets.ConvNet):
        variables = torch_nets.convnet_to_flax(tnet)
    else:
        variables = {"params": torch_nets.params_to_flax(tnet)}
    return jax.tree.map(jnp.asarray, variables)


def _one_rank_learn(tnet, tree, tcfg, ttraj):
    """The port's one-rank learner update: (metrics, whole weights, mask
    of the weights whose gradient is numerically 0)."""
    packed = torch_stepping.make_packed_tables(tree)
    state = torch_rnad.init_train_state(copy.deepcopy(tnet),
                                        torch.Generator())
    loss, _ = torch_rnad.learn_loss(state, packed, ttraj, ALPHA, tcfg)
    grads = torch.autograd.grad(loss, list(state.net.parameters()))
    zero = {n: g.abs() < 1e-6 for (n, _), g in
            zip(state.net.named_parameters(), grads)}
    state = torch_rnad.init_train_state(copy.deepcopy(tnet),
                                        torch.Generator())
    metrics = torch_rnad.learn_step(state, packed, ttraj, ALPHA, tcfg)
    return ({k: float(v) for k, v in metrics.items()},
            state.net.state_dict(), zero)


def _seed_state(tcfg, net_cfg, seed=0):
    net = torch_nets.build_net(net_cfg, torch.Generator().manual_seed(seed),
                               torch_obs.out_channels(tcfg.obs_transform))
    return torch_rnad.init_train_state(
        net, torch.Generator().manual_seed(seed + 1))


def _one_rank_train(tree, tcfg, net_cfg):
    """The plain fused step from the seed's weights: (metrics, whole
    weights, the zero-gradient mask of its learner update)."""
    state = _seed_state(tcfg, net_cfg)
    packed = torch_stepping.make_packed_tables(tree)
    transform = torch_rnad.resolve_obs_transform(net_cfg, tree, tcfg)
    gen = state.generator.get_state()
    traj = torch_rnad.rollout(state, tree, packed, tcfg, None, transform)
    state.generator.set_state(gen)
    *_, zero = _one_rank_learn(state.net, tree, tcfg, traj)
    _, metrics = torch_rnad.make_train_step(tree, packed, tcfg, transform)(
        state, ALPHA)
    return ({k: float(v) for k, v in metrics.items()},
            state.net.state_dict(), zero)


def _op_inputs():
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    N, D, H = OP_SHAPE
    return {"x": f(N, D), "w": f(H, D), "g": f(N, H)}


def _op_want(name, inputs, rank, world):
    """One rank's gradients, cut to what rank ``rank`` of ``world`` holds
    of each input of ``name``'s function."""
    x = inputs["x"].clone().requires_grad_(True)
    w = inputs["w"].clone().requires_grad_(True)
    loss, _ = torch_tp_worker.op_function(name, x, w, inputs["g"], None)
    gx, gw = torch.autograd.grad(loss, [x, w])
    part = torch_mesh.ModelGroup(rank, world).part
    cut = lambda t, dim: t.narrow(dim, *part(t.shape[dim]))
    dims = {"copy": (None, 0), "reduce": (1, 1), "gather": (None, 0),
            "scatter": (None, 1)}[name]
    return [g if d is None else cut(g, d) for g, d in zip((gx, gw), dims)]


def _run_plain(tree, tcfg, net_cfg, run_dir, steps):
    """The plain ``RNaD`` (model 1) on ``run_dir``: a fresh run trains
    ``steps`` fused steps and checkpoints (0, steps); a stored run
    resumes.  Returns the trainer."""
    trainer = torch_rnad.RNaD(tree, tcfg, net_cfg, directory_name="run",
                              runs_root=run_dir, seed=0, device="cpu")
    trainer.initialize()
    for _ in range(steps):
        trainer.train_step(trainer.state, ALPHA)
    if steps:
        trainer.m, trainer.n = 0, trainer.state.total_steps
        trainer.save_checkpoint()
    return trainer


def _buffered_plain(tree, tcfg, net_cfg, run_dir):
    """The plain ``RNaD``'s buffered steps from an empty buffer: (losses,
    the learner's state dict)."""
    trainer = torch_rnad.RNaD(tree, tcfg, net_cfg, directory_name="run",
                              runs_root=run_dir, seed=0, device="cpu")
    trainer.initialize()
    buffer = torch_buffer.TrajectoryBuffer(tcfg.n_batches_per_buffer)
    losses = [float(trainer.buffered_step(buffer, ALPHA)["loss"])
              for _ in range(BUFFERED_STEPS)]
    return losses, trainer.state.net.state_dict()


def _stored(run_dir, n):
    """The payload of checkpoint (0, n) of ``run_dir``'s run."""
    path = checkpoint.RunStore("run", run_dir).checkpoint_path(0, n)
    return torch.load(path, weights_only=True)


def _one_by_one(tree, cases):
    """Every learn and train case on a 1 x 1 grid in this process."""
    out = {}
    grid = runtime.grid(1, "cpu")
    try:
        for name, case in cases.items():
            if case["kind"] in ("learn", "train"):
                out[name] = torch_tp_worker._case(case, grid)
    finally:
        runtime.shutdown()
    return out


def _jax_trajectory(traj):
    """The port's trajectory as rnad_tpu's (the same fields and layout)."""
    return jax_engine.Trajectory(**{
        f: v if v is None or isinstance(v, str) else jnp.asarray(v.numpy())
        for f, v in vars(traj).items()})


def _spawn_clusters(root, cases, out):
    """One spawned cluster a world size, every case, then
    ``dryrun_multichip`` on 4 ranks; fills ``out``."""
    for world, m in WORLDS.items():
        wdir = root / f"world{world}"
        wdir.mkdir()
        names = [n for n in cases if world == 2 or n not in
                 ("resume_m1", "save_m2")]
        mine = {n: cases[n] for n in names}
        mine["buffered"] = dict(mine["buffered"],
                                run_dir=str(wdir / "buffered"))
        torch.save(mine, wdir / "cases.pt")
        coords = mpc.spawn(world, ["--cases", str(wdir / "cases.pt"),
                                   "--out", str(wdir),
                                   "--model-parallelism", str(m)],
                           TIMEOUT, device="cpu",
                           module="tests.torch_tp_worker")
        out[world] = {"coords": coords,
                      "ranks": [torch.load(wdir / f"rank{r}.pt",
                                           weights_only=True)
                                for r in range(world)]}
    try:  # its checks fail test_dryrun_multichip alone
        out["dryrun"] = dryrun.dryrun_multichip(4, device="cpu",
                                                timeout=TIMEOUT)
    except AssertionError as e:
        out["dryrun"] = e


@pytest.fixture(scope="module")
def clusters(small_tree, tmp_path_factory):
    """The port's one-rank values in process, the spawned clusters (one a
    world size, every case), and meanwhile rnad_tpu's model-parallel
    learn_jit on 2 and 4 virtual devices.  Each learner case starts from
    the seed's net of its config (carried to rnad_tpu by the flax
    carrier) and reads a trajectory of the port's rollout, which
    rnad_tpu's learner reads too."""
    root = tmp_path_factory.mktemp("model_parallel")
    tree = torch_tree(small_tree)
    packed = torch_stepping.make_packed_tables(tree)
    tree_dir = checkpoint.save_tree(tree, "small", root=str(root / "trees"))
    found, cases, jax_inputs = {}, {}, {}
    for name in LEARN:
        jcfg, tcfg, jnet_cfg, tnet_cfg = _configs(name)
        tnet = _seed_state(tcfg, tnet_cfg).net
        ttraj = torch_rnad.rollout(
            _seed_state(tcfg, tnet_cfg, seed=5), tree, packed, tcfg,
            obs_transform=torch_rnad.resolve_obs_transform(tnet_cfg, tree,
                                                           tcfg))
        solves = []
        with pytest.MonkeyPatch.context() as mp:
            if jnet_cfg.solver_iters:  # rnad_tpu's solves (module docstring)
                mp.setattr(torch_nets.solver_device, "solve_zero_sum_rmplus",
                           lambda *a, **k: solves.append(jax_solve(*a, **k))
                           or solves[-1])
            found[name] = {"one_rank": _one_rank_learn(tnet, tree, tcfg,
                                                       ttraj)}
        cases[f"learn_{name}"] = {
            "kind": "learn", "tree_dir": tree_dir, "seed": 0,
            "cfg": tcfg.to_json(), "net": tnet_cfg.to_json(),
            "state_dict": tnet.state_dict(), "alpha": ALPHA,
            "traj": {f: v for f, v in vars(ttraj).items() if v is not None},
            **({"solves": solves[0]} if solves else {})}
        if name in FAMILIES:
            found[name]["train"] = _one_rank_train(tree, tcfg, tnet_cfg)
            cases[f"train_{name}"] = {
                "kind": "train", "tree_dir": tree_dir, "seed": 0, "steps": 1,
                "alpha": ALPHA, "cfg": tcfg.to_json(),
                "net": tnet_cfg.to_json()}
            jax_inputs[name] = (jnet_cfg, jcfg, tnet_cfg, tcfg, tnet, ttraj)
    inputs = _op_inputs()
    for op in torch_tp_worker.OPS:
        cases[f"op_{op}"] = {"kind": "op", "name": op, **inputs}
    found["one_by_one"] = _one_by_one(tree, cases)

    # resume across layouts: model 1 saves, model 2 resumes it and saves
    # its own run, which model 1 resumes after the clusters
    run_cfgs = _configs("mlp2")[1::2]
    runs = {k: str(root / k) for k in ("saved_m1", "saved_m2")}
    _run_plain(tree, *run_cfgs, runs["saved_m1"], 2)
    resume = {"tree_dir": tree_dir, "seed": 0, "cfg": run_cfgs[0].to_json(),
              "net": run_cfgs[1].to_json()}
    cases["resume_m1"] = dict(resume, kind="resume",
                              run_dir=runs["saved_m1"])
    cases["save_m2"] = dict(resume, kind="save", run_dir=runs["saved_m2"],
                            steps=2)
    # the buffered step under the grid: 4 steps from an empty buffer, a
    # rollout at steps 0 and 2, so the third learns on 2 slots
    buffered_cfg = dataclasses.replace(run_cfgs[0], **BUFFERED)
    found["buffered"] = _buffered_plain(tree, buffered_cfg, run_cfgs[1],
                                        str(root / "buffered_plain"))
    cases["buffered"] = dict(resume, kind="buffered", steps=BUFFERED_STEPS,
                             cfg=buffered_cfg.to_json())

    out = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(_spawn_clusters, root, cases, out)
        for name, (jnet_cfg, jcfg, tnet_cfg, tcfg, tnet, ttraj) in (
                jax_inputs.items()):
            jnet = jax_nets.build_net(jnet_cfg)
            state0 = jax_rnad.init_train_state(
                jnet, jax.random.PRNGKey(0), A, jcfg,
                init_variables=_to_flax(tnet))
            traj = _jax_trajectory(ttraj)
            for n, m in WORLDS.items():
                mesh = jax_mesh.make_mesh(jax.devices()[:n],
                                          model_parallelism=m)
                (_, _, learn_jit, _), _, place = (
                    jax_runtime.make_sharded_rnad_fns(
                        jnet, small_tree, jcfg, mesh=mesh,
                        model_parallel_mlp=True))
                new, metrics = learn_jit(place(state0), traj,
                                         jnp.float32(ALPHA))
                found[name][f"rnad_tpu{n}"] = (
                    {k: float(v) for k, v in metrics.items()},
                    _to_torch(tnet_cfg, new.variables,
                              torch_obs.out_channels(
                                  tcfg.obs_transform)).state_dict())
        spawned.result()
    resumed = _run_plain(tree, *run_cfgs, runs["saved_m2"], 0)
    found["resume"] = {"runs": runs, "resumed_m1": resumed.state}
    return found, out


def _assert_equal_on_ranks(ranks, name, world):
    """The whole state is bitwise equal on every rank, and each rank's
    shards equal those of the ranks of its model coordinate."""
    m = WORLDS[world]
    first = ranks[0][name]["whole"]
    for r, res in enumerate(ranks):
        got = res[name]["whole"]
        for net in tensor_parallel.NETS:
            for k, v in got["nets"][net].items():
                assert torch.equal(v, first["nets"][net][k]), (r, net, k)
        for a, b in zip(got["mu"] + got["nu"], first["mu"] + first["nu"]):
            assert torch.equal(a, b), r
        for k, v in res[name]["shards"].items():
            assert torch.equal(v, ranks[r % m][name]["shards"][k]), (r, k)


@pytest.mark.parametrize("world", list(WORLDS))
def test_grid_coordinates(clusters, world):
    """``make_grid``: world rank w has data coordinate w // m and model
    coordinate w % m (``make_mesh``'s order)."""
    _, out = clusters
    m = WORLDS[world]
    assert out[world]["coords"] == [{"rank": w, "data": w // m,
                                     "model": w % m} for w in range(world)]


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(LEARN))
def test_learn_step_matches_one_rank(clusters, name, world):
    """A learner update on a fixed trajectory under the grid equals the
    port's one-rank update; the clip case's norm lies above its clip."""
    found, out = clusters
    metrics1, weights1, zero = found[name]["one_rank"]
    ranks = out[world]["ranks"]
    _assert_equal_on_ranks(ranks, f"learn_{name}", world)
    got = ranks[0][f"learn_{name}"]
    _assert_metrics(got["metrics"], metrics1, "grid vs one rank")
    _assert_weights(got["whole"]["nets"]["net"], weights1, zero,
                    "grid vs one rank")
    if name == "mlp3_clip":
        assert metrics1["gradient_norm"] > 100 * EXTRA[name][1]["grad_clip"]


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_step_matches_one_rank(clusters, name, world):
    """One fused step under the grid (the gathered actor's rollout of the
    data coordinate's lanes, then the tensor-parallel update) equals the
    plain fused step from the same seed."""
    found, out = clusters
    metrics1, weights1, zero = found[name]["train"]
    ranks = out[world]["ranks"]
    _assert_equal_on_ranks(ranks, f"train_{name}", world)
    got = ranks[0][f"train_{name}"]
    _assert_metrics(got["metrics"], metrics1, "grid vs one rank")
    _assert_weights(got["whole"]["nets"]["net"], weights1, zero,
                    "grid vs one rank")


@pytest.mark.parametrize("devices", list(WORLDS))
@pytest.mark.parametrize("name", list(FAMILIES))
def test_learn_step_matches_rnad_tpu(clusters, name, devices):
    """The learner update under the grid equals rnad_tpu's
    ``learn_jit`` on ``make_mesh(model_parallelism=2)`` over as many
    virtual devices as the grid has ranks, from the same weights and
    trajectory."""
    found, out = clusters
    jmetrics, jweights = found[name][f"rnad_tpu{devices}"]
    _, _, zero = found[name]["one_rank"]
    got = out[devices]["ranks"][0][f"learn_{name}"]
    _assert_metrics(got["metrics"], jmetrics, "grid vs rnad_tpu")
    _assert_weights(got["whole"]["nets"]["net"], jweights, zero,
                    "grid vs rnad_tpu")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_one_by_one_grid_is_the_plain_run(clusters, name):
    """On a 1 x 1 grid the tensor-parallel learner update and fused step
    are the plain ones, bitwise: metrics, weights and Adam moments."""
    found, _ = clusters
    for kind, (metrics1, weights1, _) in (("learn", found[name]["one_rank"]),
                                          ("train", found[name]["train"])):
        got = found["one_by_one"][f"{kind}_{name}"]
        assert got["metrics"] == metrics1, kind
        for k, v in weights1.items():
            assert torch.equal(got["whole"]["nets"]["net"][k], v), (kind, k)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("op", torch_tp_worker.OPS)
def test_operator_gradients(clusters, op, world):
    """Each operator inside a small function gives every rank its part of
    the one-rank gradients (uneven shards of 7 over the model axis, on
    every data row)."""
    _, out = clusters
    inputs = _op_inputs()
    m = WORLDS[world]
    for r, res in enumerate(out[world]["ranks"]):
        got = res[f"op_{op}"]["grads"]
        for g, want in zip(got, _op_want(op, inputs, r % m, m)):
            torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6,
                                       msg=f"rank {r}")


def _assert_state_is(whole, payload, what):
    for net in tensor_parallel.NETS:
        for k, v in payload[net].items():
            assert torch.equal(whole["nets"][net][k], v), (what, net, k)
    for a, b in zip(whole["mu"] + whole["nu"],
                    payload["mu"] + payload["nu"]):
        assert torch.equal(a, b), what


@pytest.mark.parametrize("world", list(WORLDS))
def test_buffered_step_matches_one_rank(clusters, world):
    """``RNaD.buffered_step`` under the grid (the gathered actor's
    rollouts kept by data coordinate, the exchange of collated lanes,
    the tensor-parallel update): 4 steps from an empty buffer give the
    plain run's losses and weights' checksum within rtol 1e-4 (the
    multi-rank tolerance of tests/test_torch_parallel_buffered.py), the
    weights equal on every rank."""
    found, out = clusters
    losses, weights = found["buffered"]
    ranks = out[world]["ranks"]
    _assert_equal_on_ranks(ranks, "buffered", world)
    got = ranks[0]["buffered"]
    assert got["total_steps"] == BUFFERED_STEPS
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4, atol=1e-6)
    checksum = lambda sd: sum(float(v.abs().sum()) for v in sd.values())
    np.testing.assert_allclose(checksum(got["whole"]["nets"]["net"]),
                               checksum(weights), rtol=1e-4)


@pytest.mark.parametrize("direction", ["model1_to_model2",
                                       "model2_to_model1"])
def test_resume_across_layouts(clusters, direction):
    """A checkpoint holds whole tensors: a run saved under model 1 resumes
    under model 2 with every rank's gathered state bitwise the
    checkpoint's (and its shards the checkpoint's slices), and a run
    saved under model 2 resumes under model 1 bitwise."""
    found, out = clusters
    runs = found["resume"]["runs"]
    ranks = out[2]["ranks"]
    if direction == "model1_to_model2":
        payload = _stored(runs["saved_m1"], 2)
        for r, res in enumerate(ranks):
            got = res["resume_m1"]
            assert got["total_steps"] == 2
            _assert_state_is(got["whole"], payload, f"rank {r}")
            part = torch_mesh.ModelGroup(r, 2).part
            for k, v in got["shards"].items():
                dim = tensor_parallel.mlp_shard_dim(k)
                want = payload["net"][k]
                if dim is not None:
                    want = want.narrow(dim, *part(want.shape[dim]))
                assert torch.equal(v, want), (r, k)
        return
    payload = _stored(runs["saved_m2"], 2)
    _assert_state_is(ranks[0]["save_m2"]["whole"], payload, "saved")
    state = found["resume"]["resumed_m1"]
    assert state.total_steps == 2
    _assert_state_is({"nets": {n: getattr(state, n).state_dict()
                               for n in tensor_parallel.NETS},
                      "mu": state.opt.mu, "nu": state.opt.nu},
                     payload, "resumed under model 1")


# a step's all-reduces on each axis at data 2 x model 2 (chip_smoke.py's
# MP_COLLECTIVES at these depths): data, 7 (the losses' global counts, the
# metrics, the gradients) and 4 a BatchNorm; model, the actor's gather,
# the global norm and the layers': the depth-2 MLP's 2 row layers a head
# in 6 head passes and its scatter's gather in the learner's 2 heads; the
# ConvNet 8x1's 3 gathers in 4 forwards and its block's 2 input copies;
# the EquiNet 8x2's 2 gathers in 4 forwards and ex1's input copy
DRYRUN_COLLECTIVES = {"MLP": {"model": 16, "data": 7},
                      "ConvNet +obs_transform": {"model": 16, "data": 15},
                      "EquiNet": {"model": 11, "data": 7}}


def test_dryrun_multichip(clusters):
    """``parallel/dryrun.py``'s ``dryrun_multichip(4)`` on the CPU: a
    (2, 2) grid, a finite loss and equal learners on every rank for each
    family, and the all-reduces of its step on each axis."""
    _, out = clusters
    ranks = out["dryrun"]
    if isinstance(ranks, AssertionError):
        raise ranks
    assert [(r["data_world"], r["model_world"]) for r in ranks] == [(2, 2)] * 4
    for name, want in DRYRUN_COLLECTIVES.items():
        for r in ranks:
            run = r["runs"][name]
            assert run["collectives"] == [want], (name, r["rank"])
            assert np.isfinite(run["losses"]).all()
