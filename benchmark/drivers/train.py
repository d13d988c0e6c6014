"""The driver of traffic of kind "train": ``RNaD.train_step`` back to
back, the fused on-policy step that ``RNaD.run``'s inner loop calls
(rollout, learner and frozen passes, v-trace and the losses, the
backward, clip + Adam, the EMA), at the alpha of the configuration's
first update period.

A traffic file of this kind gives ``lanes``, ``checked_steps`` (set-up's
first steps, read for the check), ``warm_steps`` and ``trace_steps``.

Every driver, ``drivers/<kind>.py``, has the phases ``run.py`` and
``calibrate.py`` call, in this order: ``build(cell, seed, device)``, the
system under test; ``checked(system, cell)``, set-up's readings for the
check; ``warm(system, cell)``; ``window(system, seconds)``, the measured
window; ``traced(system, cell, path)``, the traced steps (their rollouts
and host seconds; the chrome trace to ``path``); and after the program
is freed, ``reference(cell, inputs, got, device, precision)`` and
``numbers(cell, got, want, device)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from .. import check
from .. import system as system_lib
from ..reference import rnad as ref
from ..reference.rnad import Readings, grad_norms, norms
from ..system import System


def build(cell, seed: int, device="cuda") -> System:
    return system_lib.build(cell.config, cell.lanes, seed, device)


def warm(system: System, cell) -> None:
    for _ in range(cell.traffic["warm_steps"]):
        system.step()


def reference(cell, inputs, got: Readings, device="cuda",
              precision: Optional[str] = None) -> Readings:
    """The plain reference's readings of the same checked steps from the
    same inputs, in the configuration's precision or ``precision``."""
    arrays, params0, noise_seed, lift = inputs
    sigma = cell.config["rnad"].get("obs_transform", {}).get("sigma", 0.0)
    return ref.run(ref.Game(arrays, device, lift, sigma), cell.config,
                   cell.lanes, params0, noise_seed,
                   cell.traffic["checked_steps"], precision, device=device,
                   solves=got.solves)


def numbers(cell, got: Readings, want: Readings, device="cuda"
            ) -> Dict[str, float]:
    return check.numbers(got, want, cell.config["net"].get("solver_iters", 0),
                         device)


def _named(net, tensors: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {name: t.detach().cpu().clone()
            for (name, _), t in zip(net.named_parameters(), tensors)}


def checked(system: System, cell) -> Readings:
    """The first ``checked_steps`` train steps, read as the reference reads
    its own: the losses, the first rollout, Adam's second moment after the
    first step and the weights, target and moments after the last, the
    learner's and the target's state after the last where the net keeps
    state (BatchNorm's running averages), and the RM+ solves the steps
    made.  These steps are the window's own call
    (``RNaD.train_step``) on the same state; what is read goes to the
    host."""
    solves = []
    with system_lib.recorded_solves(solves):
        readings = _checked_steps(system, cell.traffic["checked_steps"])
    readings.solves = solves or None
    return readings


def _buffers(net) -> Dict[str, torch.Tensor]:
    return {name: b.detach().cpu().clone() for name, b in net.named_buffers()
            if b.is_floating_point()}


def _checked_steps(system: System, steps: int) -> Readings:
    state = system.state
    b2 = system.trainer.cfg.b2_adam
    p0 = {k: v.cpu() for k, v in system.params0.items()}
    losses, first, nu1, later = [], None, None, []
    for n in range(steps):
        _, metrics, traj = system.step(with_trajectory=True)
        losses.append((float(metrics["loss_v"]), float(metrics["loss_nerd"])))
        record = {"indices": traj.indices.cpu(), "actions": traj.actions.cpu(),
                  "rewards": traj.rewards.cpu()}
        if n == 0:
            first = dict(record, policy=traj.policy.cpu(),
                         obs=None if traj.obs is None else traj.obs.cpu())
            nu1 = _named(state.net, state.opt.nu)
        else:
            later.append(record)
        del traj
    params = _named(state.net, list(state.net.parameters()))
    target = _named(state.net_target, list(state.net_target.parameters()))
    buffers = _buffers(state.net)
    return Readings(
        losses=losses, rollout=first, grad=grad_norms(nu1, b2),
        change=norms({k: params[k] - p0[k] for k in params}),
        target_change=norms({k: target[k] - p0[k] for k in target}),
        moment=norms(_named(state.net, state.opt.nu)), later=later,
        state=ref.state_changes(buffers, _buffers(state.net_target),
                                {k: p0[k] for k in buffers}))


@dataclasses.dataclass
class Window:
    """One measured window: steps, host seconds from a synchronize to a
    synchronize, each step's interval on the device timeline (from the
    CUDA event recorded as it was called to the next one's), the peak of
    allocated memory and the steps whose loss was not finite."""

    steps: int
    seconds: float
    intervals_ms: List[float]
    peak_bytes: int
    nonfinite: int


def window(system: System, seconds: float) -> Window:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, losses = [], []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(system.step()[1]["loss"])
    end_ev = torch.cuda.Event(enable_timing=True)
    end_ev.record()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    events.append(end_ev)
    intervals = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    nonfinite = int((~torch.isfinite(torch.stack(losses))).sum())
    return Window(len(losses), elapsed, intervals,
                  torch.cuda.max_memory_allocated(), nonfinite)


@contextlib.contextmanager
def spans():
    """``record_function`` spans around the rollout and the learner step:
    ``make_train_step`` looks both up in ``learn/rnad.py``'s module at
    each call, so wrapping the module attributes spans every step without
    an edit to the program."""
    from rnad_tpu_torch.learn import rnad as rnad_lib

    saved = {name: getattr(rnad_lib, name) for name in ("rollout",
                                                        "learn_step")}

    def wrap(name, fn):
        def spanned(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return spanned

    for name, fn in saved.items():
        setattr(rnad_lib, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(rnad_lib, name, fn)


def traced(system: System, cell, trace_path: str):
    """``trace_steps`` train steps under ``torch.profiler`` with the spans,
    each inside a ``train_step`` span; returns the (indices, actions) of
    each traced step's rollout and the traced window's host seconds.  The
    chrome trace goes to ``trace_path``."""
    steps = cell.traffic["trace_steps"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    trajs = []
    with spans(), torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(steps):
            with torch.profiler.record_function("train_step"):
                traj = system.step(with_trajectory=True)[2]
            trajs.append((traj.indices, traj.actions))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    prof.export_chrome_trace(trace_path)
    return [(i.cpu(), a.cpu()) for i, a in trajs], seconds
