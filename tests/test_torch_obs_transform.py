"""rnad_tpu_torch.ops.obs_transform against rnad_tpu.ops.obs_transform.

The lift of the same (mix, bias) pair and the same noise equals rnad_tpu's
within 1e-6; without noise it is the noise-free lift.  The channel count
and the errors are rnad_tpu's.  The port's own (mix, bias) is drawn from the
config's seed by a CPU ``torch.Generator``, at rnad_tpu's shapes and
scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import ObsTransformConfig
from rnad_tpu.ops import obs_transform as jax_tf
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.ops import obs_transform as torch_tf
from tests.torch_parity import obs_with_illegal_actions

A = 3


def _pair(channels=8, sigma=0.15, bias_scale=1.0, seed=0):
    kw = dict(kind="lift", channels=channels, sigma=sigma,
              bias_scale=bias_scale, seed=seed)
    cfg = ObsTransformConfig(**kw)
    mix, bias = jax_tf.transform_params(cfg, A)
    tf = torch_tf.transform_from_arrays(
        torch_config.ObsTransformConfig(**kw), np.asarray(mix),
        np.asarray(bias))
    return jax_tf.make_obs_transform(cfg, A), tf


@pytest.mark.parametrize("channels,sigma,bias_scale", [
    (8, 0.15, 1.0), (1, 0.1, 0.5), (16, 0.0, 2.0)])
def test_lift_matches(channels, sigma, bias_scale):
    want_tf, tf = _pair(channels, sigma, bias_scale)
    obs = obs_with_illegal_actions(0, 64, A).reshape(2, 32, 2, A, A)
    key = jax.random.PRNGKey(5)
    want = want_tf(jnp.asarray(obs), key)
    eps = jax.random.normal(key, (2, 32, channels, A, A), jnp.float32)
    got = tf.apply(torch.from_numpy(obs), torch.from_numpy(np.array(eps)))
    assert got.shape == (2, 32, channels + 1, A, A)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # channel 1 is the raw legal matrix
    np.testing.assert_array_equal(got[..., 1, :, :].numpy(), obs[..., 1, :, :])


def test_noise_free_lift_matches():
    want_tf, tf = _pair()
    obs = obs_with_illegal_actions(1, 40, A)
    want = want_tf(jnp.asarray(obs), None)
    got = tf.apply(torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    noisy = tf.apply(torch.from_numpy(obs), torch.ones(40, 8, A, A))
    lifted = [0, 2, 3, 4, 5, 6, 7, 8]
    torch.testing.assert_close(noisy[:, lifted] - got[:, lifted],
                               torch.full((40, 8, A, A), 0.15), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("kind,channels", [("none", 8), ("lift", 8),
                                           ("lift", 1), ("lift", 32)])
def test_out_channels_match(kind, channels):
    kw = dict(kind=kind, channels=channels)
    assert (torch_tf.out_channels(torch_config.ObsTransformConfig(**kw))
            == jax_tf.out_channels(ObsTransformConfig(**kw)))


@pytest.mark.parametrize("kw", [dict(kind="blur"), dict(kind="lift",
                                                        channels=0)])
def test_config_errors_match(kw):
    with pytest.raises(ValueError) as want:
        jax_tf.make_obs_transform(ObsTransformConfig(**kw), A)
    with pytest.raises(ValueError) as got:
        torch_tf.make_obs_transform(torch_config.ObsTransformConfig(**kw), A)
    assert str(got.value) == str(want.value)


def test_shape_and_params_errors_match():
    want_tf, tf = _pair()
    bad = np.zeros((4, 2, A + 1, A + 1), np.float32)
    with pytest.raises(ValueError) as want:
        want_tf(jnp.asarray(bad), None)
    with pytest.raises(ValueError) as got:
        tf.apply(torch.from_numpy(bad))
    assert str(got.value) == str(want.value)
    none = dict(kind="none")
    with pytest.raises(ValueError) as want:
        jax_tf.transform_params(ObsTransformConfig(**none), A)
    with pytest.raises(ValueError) as got:
        torch_tf.transform_params(torch_config.ObsTransformConfig(**none), A)
    assert str(got.value) == str(want.value)
    assert torch_tf.make_obs_transform(torch_config.ObsTransformConfig(),
                                       A) is None


def test_port_params_are_seeded_at_rnad_tpu_scales():
    cfg = torch_config.ObsTransformConfig(kind="lift", channels=64,
                                          bias_scale=2.0, seed=3)
    mix, bias = torch_tf.transform_params(cfg, A)
    again = torch_tf.make_obs_transform(cfg, A)
    assert torch.equal(mix, again.mix) and torch.equal(bias, again.bias)
    assert mix.shape == (64, 2) and bias.shape == (64, A, A)
    assert mix.dtype == bias.dtype == torch.float32
    # N(0, 1/2) and N(0, 4): sample standard deviations near 0.707 and 2
    assert abs(float(mix.std()) - 0.5 ** 0.5) < 0.15
    assert abs(float(bias.std()) - 2.0) < 0.3
    other, _ = torch_tf.transform_params(
        torch_config.ObsTransformConfig(kind="lift", channels=64, seed=4), A)
    assert not torch.equal(mix, other)
