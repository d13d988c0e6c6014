"""Every configuration of the train CLI under data parallelism: the buffered
(off-policy) MLP and the lifted ConvNet with its global BatchNorm, through
``RNaD`` on spawned gloo ranks (``multiprocess_check.run_cluster``, a time
limit on every cluster: a rank that skipped a collective would hang there)
and through ``rnad_tpu_torch.train --data-parallel`` at one rank; and the
device rule of the multi-process tools.

* Two ranks against one, 4 steps of each config: equal episodes (the
  collated lanes of every buffered step, the step-0 rollout of the
  on-policy ConvNet: indices, actions and rewards bitwise, the stored
  policy within 1e-6), losses and the weights' checksum within rtol 1e-4,
  and the weights and BatchNorm statistics equal on both ranks.
* One rank through the CLI: the run ends on the plain run's weights and
  BatchNorm statistics bitwise, with the same NashConv evals.
"""

import math

import numpy as np
import pytest
import torch

from rnad_tpu_torch import mp_worker
from rnad_tpu_torch import multiprocess_check as mpc
from rnad_tpu_torch import train

TIMEOUT = 240  # seconds a cluster may take
B, STEPS = 64, 4
CONFIGS = {
    "buffered_mlp": dict(n_batches_per_buffer=4, buffer_mod=2),
    "lifted_convnet": dict(net="ConvNet", channels=8, net_depth=2,
                           obs_lift=8, obs_noise_sigma=0.15),
}
CLI_CONFIGS = {
    "buffered_mlp": ["--n-batches-per-buffer", "4", "--buffer-mod", "2"],
    "lifted_convnet": ["--obs-lift", "8", "--obs-noise-sigma", "0.15",
                       "--net", "ConvNet", "--channels", "8", "--net-depth",
                       "2"],
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_ranks_equal_one_rank(tmp_path, name):
    kw = dict(CONFIGS[name], device="cpu", timeout=TIMEOUT)
    single = mpc.run_single(STEPS, B, 7, traj_out=str(tmp_path / "one"),
                            **kw)
    multi = mpc.run_cluster(2, STEPS, B, 7, traj_out=str(tmp_path / "two"),
                            **kw)
    assert multi["num_processes"] == 2 and multi["total_steps"] == STEPS
    whole = np.load(tmp_path / "one" / "rank0.npz")
    for r in range(2):
        part = np.load(tmp_path / "two" / f"rank{r}.npz")
        lanes = slice(r * B // 2, (r + 1) * B // 2)
        for field in ("indices", "actions", "rewards"):
            np.testing.assert_array_equal(part[field],
                                          whole[field][..., lanes],
                                          err_msg=f"rank {r} {field}")
        np.testing.assert_allclose(part["policy"],
                                   whole["policy"][..., lanes, :], rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(multi["losses"], single["losses"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(multi["param_checksum"],
                               single["param_checksum"], rtol=1e-4)
    assert len({r["param_digest"] for r in multi["ranks"]}) == 1


@pytest.mark.parametrize("name", list(CLI_CONFIGS))
def test_cli_one_rank_equals_the_plain_run(tmp_path, monkeypatch, name):
    """``--data-parallel`` alone on the buffered MLP and the lifted
    ConvNet: a one-rank group whose all-reduces (the exchange, the global
    BatchNorm's sums and their gradients) change nothing."""
    argv = ["--cpu", "--tree-depth", "3", "--batch-size", str(B),
            "--bounds", "2", "--delta-m", "4", "--log-mod", "1", "--name",
            name, *CLI_CONFIGS[name]]
    runs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test shares the machine with others
    try:
        for flag in ([], ["--data-parallel"]):
            cwd = tmp_path / ("dp" if flag else "plain")
            cwd.mkdir()
            monkeypatch.chdir(cwd)
            runs[bool(flag)] = train.main(argv + flag)
    finally:
        torch.set_num_threads(threads)
    dp, plain = runs[True], runs[False]
    assert dp.group is not None and dp.group.world == 1
    assert dp.state.total_steps == plain.state.total_steps == 8
    for net in ("net", "net_target"):
        for (key, a), b in zip(
                getattr(dp.state, net).state_dict().items(),
                getattr(plain.state, net).state_dict().values()):
            assert torch.equal(a, b), (net, key)
    evals = [[m["nashconv"] for _, m in r.history if "nashconv" in m]
             for r in (dp, plain)]
    assert len(evals[0]) == 2 and evals[0] == evals[1]
    assert all(math.isfinite(v) for v in evals[0])


@pytest.mark.parametrize("module", [mp_worker, mpc])
def test_tools_run_on_the_card_unless_cpu(module):
    """``mp_worker`` and ``multiprocess_check`` take the card unless
    ``--cpu`` is given, and leave the backend to the device's default
    (``runtime.default_backend``) unless ``--backend`` names one."""
    required = (["--process-id", "0", "--num-processes", "1", "--port", "1"]
                if module is mp_worker else [])
    p = module.build_parser()
    plain, cpu = p.parse_args(required), p.parse_args(required + ["--cpu"])
    assert (plain.device, cpu.device) == ("cuda", "cpu")
    assert plain.backend is None
    assert p.parse_args(required + ["--backend", "gloo"]).backend == "gloo"
