"""Profiling helpers (the counterpart of ``rnad_tpu/utils/timing.py``).

- ``span``: a named range on the profiler's timeline while a
  ``torch.profiler`` session records, and nothing otherwise.  The trainer
  opens one at each of its layers' boundaries (``rnad.train_step``,
  ``rnad.rollout`` and its generic turns' ``rnad.rollout.forward``,
  ``rnad.learn`` and its passes, ``rnad.buffer.sample``, ``rnad.eval``,
  ``rnad.checkpoint``; ``.fused`` where kernel K4 runs a forward), so a
  trace ties each kernel and each idle gap of the card to the layer that
  launched it.
- ``trace``: a ``torch.profiler`` trace of the CPU and, where there is a
  card, of its kernels; written as a Chrome trace under ``log_dir`` where
  one is given.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.autograd.profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records;
    otherwise one shared null context, so that a span off costs a flag
    read: no allocation, no profiler call, no launch and no sync."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block, yielding the profiler (read its
    ``key_averages()``); records the card's kernels where CUDA is
    available, and writes ``<log_dir>/trace.json`` (open it in
    chrome://tracing or Perfetto) where ``log_dir`` is given."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
