"""Cells found by name: ``BENCHMARK.json`` lists them, and each file that
belongs to one configuration, traffic mix or metric is found from its
name.

* a configuration's ``file`` (``configs/<config>.json``): its ``tree``,
  ``net`` and ``rnad`` groups, as the program's config classes write them;
* a traffic mix, ``traffic/<traffic>.json``: its ``kind`` and the
  parameters that kind's driver reads;
* a traffic kind's driver, ``drivers/<kind>.py``: the phases of a run
  (``drivers/train.py`` lists them);
* a metric, ``metrics/<name>.py``: a ``read(ctx)`` that returns the value,
  or None where it finds nothing to read;
* a net family's work model, ``work/<family>.py`` (the configuration's net
  type in lower case): its ``step(config, lanes, levels)``;
* a cell's limits, ``limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from types import ModuleType
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    driver: ModuleType

    @property
    def lanes(self) -> int:
        return int(self.traffic["lanes"])


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"known: {', '.join(sorted(cells))}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in moved]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                driver(traffic.get("kind")))


def driver(kind) -> ModuleType:
    """The driver of traffic of ``kind``, ``drivers/<kind>.py``."""
    known = sorted(f.stem for f in (HERE / "drivers").glob("*.py")
                   if not f.stem.startswith("_"))
    if kind not in known:
        raise SystemExit(f"no driver of traffic kind {kind!r} "
                         f"(benchmark/drivers/<kind>.py); known: "
                         f"{', '.join(known)}")
    return importlib.import_module(f"benchmark.drivers.{kind}")


class Context:
    """What the metric readers read: the cell, its window, and with the
    trace the traced steps' trace and rollouts."""

    def __init__(self, cell: Cell, sut):
        self.config = cell.config
        self.lanes = cell.lanes
        self.levels = int(sut.arrays["depth"][1])
        self.tree_generated = sut.tree_generated
        self.tree_s = sut.tree_s
        self.work = importlib.import_module(
            f"benchmark.work.{cell.config['net']['type'].lower()}")
        self.setup_s = None
        self.window = None
        self.trace = None
        self.rollouts = []

    @property
    def step_s(self) -> float:
        """Seconds a step of the unprofiled window."""
        return self.window.seconds / self.window.steps

    def distinct(self):
        """Mean over the traced steps of the distinct states the rollout's
        turns read and the distinct (state, joint action) cells they
        played."""
        import torch

        A = self.config["tree"]["max_actions"]
        rows = cells = 0
        for indices, actions in self.rollouts:
            turns = indices[0::2].long()
            played = (turns * A * A + actions[0::2].long() * A
                      + actions[1::2].long())
            rows += torch.unique(turns).numel()
            cells += torch.unique(played).numel()
        n = len(self.rollouts)
        return rows / n, cells / n
