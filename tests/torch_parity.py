"""Helpers of the parity tests between rnad_tpu and rnad_tpu_torch.

Inputs cross between the packages as numpy arrays: trees through their
array form, weights through the flax<->torch carrier, and rollout noise made
with ``jax.random`` under rnad_tpu's key discipline (torch cannot replay
``jax.random`` streams, so the port takes its noise as an argument).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rnad_tpu.env import tree as jax_tree_lib
from rnad_tpu_torch.env import tree as torch_tree_lib
from rnad_tpu_torch.models import nets as torch_nets


def torch_tree(tree) -> torch_tree_lib.GameTree:
    """An rnad_tpu GameTree as the port's, on the CPU."""
    return torch_tree_lib.tree_from_arrays(
        jax_tree_lib.tree_to_arrays(tree), jax_tree_lib.tree_meta(tree),
        device="cpu")


def torch_mlp(params, max_actions: int, width: int) -> torch_nets.MLP:
    """The port's MLP holding flax ``params``."""
    net = torch_nets.MLP(max_actions, width)
    net.load_state_dict(torch_nets.params_from_flax(
        jax.tree.map(np.asarray, params)))
    return net


def torch_equinet(params, max_actions: int, channels: int, depth: int,
                  solver_iters: int = 0,
                  solver_prime: bool = False) -> torch_nets.EquiNet:
    """The port's EquiNet holding flax ``params``."""
    net = torch_nets.EquiNet(max_actions, channels=channels, depth=depth,
                             solver_iters=solver_iters,
                             solver_prime=solver_prime)
    net.load_state_dict(torch_nets.params_from_flax(
        jax.tree.map(np.asarray, params)))
    return net


def obs_with_illegal_actions(seed: int, n: int, A: int) -> np.ndarray:
    """(n, 2, A, A) observations in the generator's convention: legality is
    the outer product of random row and column masks (at least one legal
    action a seat) and illegal cells hold value 0, so pooled features tie
    across illegal rows and columns."""
    rng = np.random.default_rng(seed)
    lr = (rng.random((n, A)) < 0.7).astype(np.float32)
    lc = (rng.random((n, A)) < 0.7).astype(np.float32)
    lr[:, 0] = 1.0
    lc[:, 0] = 1.0
    legal = lr[:, :, None] * lc[:, None, :]
    ev = rng.normal(size=(n, A, A)).astype(np.float32) * legal
    return np.stack([ev, legal], axis=1)


def diverged_solves(obs: np.ndarray, iters: int) -> np.ndarray:
    """(N,) True where the two packages' EquiNet solver features of the
    observed games ``obs`` (N, 2, A, A) differ by more than
    ``solver_device.ATOL``.  float32 RM+ runs whose sums are taken in
    another order part ways where a regret hovers at 0 (see
    ``solver_device.agreement``), and the log x channels magnify a small
    difference in a probability near 0."""
    from rnad_tpu.models import nets as jax_nets
    from rnad_tpu_torch.env import solver_device as torch_sd

    want = jax_nets._solver_features(
        jnp.asarray(obs).transpose(0, 2, 3, 1), iters)
    got = torch_nets._solver_features(
        torch.from_numpy(obs).permute(0, 2, 3, 1), iters)
    err = np.zeros(obs.shape[0], np.float32)
    for g, w in zip(got, want):
        d = np.abs(g.numpy() - np.asarray(w)).reshape(obs.shape[0], -1)
        err = np.maximum(err, d.max(-1))
    return err > torch_sd.ATOL


def rollout_noise(k_roll, batch_size: int, A: int, T: int, num_turns: int):
    """Per-turn (g_act (2B, A), g_chance (B, T)) exactly as
    ``rnad_tpu.env.engine.rollout_from`` draws them from ``k_roll``:
    split into per-turn keys, then (k_act, k_ch) per turn."""
    noise = []
    for key_t in jax.random.split(k_roll, num_turns):
        k_act, k_ch = jax.random.split(key_t)
        g_act = jax.random.gumbel(k_act, (2 * batch_size, A), jnp.float32)
        g_ch = jax.random.gumbel(k_ch, (T, batch_size), jnp.float32).T
        noise.append((torch.from_numpy(np.array(g_act)),
                      torch.from_numpy(np.array(g_ch))))
    return noise


def train_step_noise(state_key, batch_size: int, A: int, T: int,
                     num_turns: int, channels=None):
    """The rollout noise of one rnad_tpu train step from ``state.key``
    (under a lift of ``channels`` lifted channels where given)."""
    _, k_roll = jax.random.split(state_key)
    if channels is not None:
        return lift_rollout_noise(k_roll, batch_size, A, T, num_turns,
                                  channels)
    return rollout_noise(k_roll, batch_size, A, T, num_turns)


def lift_rollout_noise(k_roll, batch_size: int, A: int, T: int,
                       num_turns: int, channels: int):
    """Per-turn (g_act, g_chance, eps (2B, channels, A, A)) as rnad_tpu's
    rollout draws them under an observation transform: per-turn keys split
    three ways (k_act, k_ch, k_noise), the lift's noise a unit normal of
    the lifted observations' shape from k_noise."""
    noise = []
    for key_t in jax.random.split(k_roll, num_turns):
        k_act, k_ch, k_noise = jax.random.split(key_t, 3)
        g_act = jax.random.gumbel(k_act, (2 * batch_size, A), jnp.float32)
        g_ch = jax.random.gumbel(k_ch, (T, batch_size), jnp.float32).T
        eps = jax.random.normal(k_noise, (2 * batch_size, channels, A, A),
                                jnp.float32)
        noise.append(tuple(torch.from_numpy(np.array(x))
                           for x in (g_act, g_ch, eps)))
    return noise


def torch_convnet(variables, max_actions: int, channels: int, depth: int,
                  batch_norm: bool = True,
                  in_channels: int = 2) -> torch_nets.ConvNet:
    """The port's ConvNet holding a flax ConvNet's params and batch_stats."""
    net = torch_nets.ConvNet(max_actions, channels=channels, depth=depth,
                             batch_norm=batch_norm, in_channels=in_channels)
    net.load_state_dict(torch_nets.convnet_from_flax(
        jax.tree.map(np.asarray, dict(variables))))
    return net


def torch_trajectory(traj, keep_obs: bool = True):
    """An rnad_tpu Trajectory ("bma" layout) as the port's, on the CPU."""
    from rnad_tpu_torch.env import engine as torch_engine

    t = lambda x: torch.from_numpy(np.array(x))
    return torch_engine.Trajectory(
        indices=t(traj.indices), policy=t(traj.policy),
        actions=t(traj.actions), rewards=t(traj.rewards),
        values=t(traj.values),
        obs=t(traj.obs) if keep_obs and traj.obs is not None else None)


def jax_solve(payoffs, legal_rows, legal_cols, iters):
    """rnad_tpu's ``solve_zero_sum_rmplus`` in the port's signature, for
    monkeypatching ``solver_device.solve_zero_sum_rmplus`` where a test
    holds the port against rnad_tpu past the EquiNet's solve: float32 RM+
    runs summed in another order part ways on a few games
    (``solver_device.agreement``), and the port's own solve is held by
    tests/test_torch_rmplus.py and tests/test_torch_equinet.py."""
    from rnad_tpu.env import solver_device as jax_sd

    out = jax_sd.solve_zero_sum_rmplus(
        *(jnp.asarray(t.numpy()) for t in (payoffs, legal_rows, legal_cols)),
        iters=iters)
    return tuple(torch.from_numpy(np.array(o)) for o in out)
