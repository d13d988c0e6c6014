"""rnad_tpu_torch.config against rnad_tpu.config: the same five dataclasses,
field for field, default for default, and the same JSON form."""

import dataclasses
import json

import pytest

from rnad_tpu import config as jax_config
from rnad_tpu_torch import config as torch_config

_CLASSES = ("ShapingRule", "TreeConfig", "ObsTransformConfig", "NetConfig",
            "RNaDConfig")


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", _CLASSES)
def test_fields_and_defaults_equal(name):
    jax_cls = getattr(jax_config, name)
    torch_cls = getattr(torch_config, name)
    want = _fields(jax_cls)
    got = _fields(torch_cls)
    assert [n for n, _ in got] == [n for n, _ in want]
    # nested dataclass defaults compare by value through their JSON form
    norm = lambda d: d.to_json() if hasattr(d, "to_json") else d
    assert [norm(d) for _, d in got] == [norm(d) for _, d in want]
    assert torch_cls().to_json() == jax_cls().to_json()


@pytest.mark.parametrize("name", ("TreeConfig", "RNaDConfig", "NetConfig"))
def test_json_round_trip_across_packages(name):
    kw = {
        "TreeConfig": dict(max_actions=4, max_transitions=2, depth_bound=5,
                           terminal_values=(-2.0, 0.5),
                           depth_bound_rule=jax_config.ShapingRule(
                               delta=-1, stochastic_delta=-2,
                               stochastic_prob=0.5)),
        "RNaDConfig": dict(batch_size=32768, bounds=(3, 5), delta_m=(10, 7),
                           lr=1e-3, reg_anchor="fixed"),
        "NetConfig": dict(width=64, max_actions=5),
    }[name]
    src = getattr(jax_config, name)(**kw)
    text = json.dumps(src.to_json(), sort_keys=True)
    ported = getattr(torch_config, name).from_json(json.loads(text))
    assert json.dumps(ported.to_json(), sort_keys=True) == text
    back = getattr(jax_config, name).from_json(ported.to_json())
    assert back == src
    assert getattr(torch_config, name).from_json(ported.to_json()) == ported
