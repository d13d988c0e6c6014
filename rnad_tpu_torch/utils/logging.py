"""Metric logging: JSONL always, wandb when available and requested.

Counterpart of ``rnad_tpu/utils/logging.py``.  The primary sink is an
append-only ``metrics.jsonl`` inside the run directory, one
``{"step": int, <metric>: float, ...}`` object a line; the wandb sink
attaches on top when the package is importable and the run asks for it
(resumable, keyed to the run name).  Where wandb is missing the logger warns
and writes the JSONL only.  A logger without a directory and without wandb
writes nothing: that is every data-parallel rank but rank 0's
(``learn/rnad.py::RNaD``), as only process 0 logs in ``rnad_tpu``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional


class MetricLogger:
    def __init__(self, directory: Optional[str] = None, use_wandb: bool = False,
                 run_name: Optional[str] = None, config: Optional[dict] = None,
                 resume: bool = False):
        self._file = None
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            self._file = open(os.path.join(directory, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                wandb.init(resume=resume, project="rnad_tpu", config=config)
                if run_name:
                    wandb.run.name = run_name
                self._wandb = wandb
            except Exception as e:  # wandb is optional
                logging.warning("wandb unavailable (%s); JSONL only", e)

    def log(self, metrics: dict, step: int) -> None:
        record = {"step": int(step)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "step"},
                            step=step)

    def finish(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
