"""Faults planted under the timed path, for the test that sees ``correct``
come out false and for the readings of ``calibrate.py``.  Each wraps a
module attribute of ``rnad_tpu_torch/learn/rnad.py`` that the train step
looks up at call time:

* ``unchanged``: the step returns its state unchanged (the clip, Adam and
  the EMA are skipped);
* ``half_batch``: the learner leaves out half of the lanes and takes its
  means over the rest;
* ``altered``: the rollout's answer is altered where it is produced (the
  rewards of one lane in sixteen are negated).

A training cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import dataclasses


def _lanes(traj, lanes: slice):
    out = {}
    for f in dataclasses.fields(traj):
        v = getattr(traj, f.name)
        if hasattr(v, "dim") and v.dim() >= 2:
            v = v[:, lanes]
        out[f.name] = v
    return dataclasses.replace(traj, **out)


def _altered(traj):
    B = traj.rewards.shape[1]
    rewards = traj.rewards.clone()
    rewards[:, :max(1, B // 16)] *= -1
    return dataclasses.replace(traj, rewards=rewards)


@contextlib.contextmanager
def planted(name: str):
    from rnad_tpu_torch.learn import rnad as rnad_lib

    if name == "unchanged":
        attr, fn = "apply_update", lambda *args, **kwargs: None
    elif name == "half_batch":
        orig = rnad_lib.learn_loss
        attr = "learn_loss"

        def fn(state, packed, traj, *args, **kwargs):
            half = _lanes(traj, slice(0, traj.rewards.shape[1] // 2))
            return orig(state, packed, half, *args, **kwargs)
    elif name == "altered":
        orig = rnad_lib.rollout
        attr = "rollout"

        def fn(*args, **kwargs):
            return _altered(orig(*args, **kwargs))
    else:
        raise ValueError(f"unknown fault {name!r}")
    saved = getattr(rnad_lib, attr)
    setattr(rnad_lib, attr, fn)
    try:
        yield
    finally:
        setattr(rnad_lib, attr, saved)


FAULTS = ("unchanged", "half_batch", "altered")
