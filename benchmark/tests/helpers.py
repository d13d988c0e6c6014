"""Small configurations of the cells for the CPU tests, and one cell that
only the tests run: ``NOISYCONV``, the ``net`` and ``rnad`` groups of
``docs/runs/r5-noisy-conv.params.json`` (a lifted ConvNet 16 x 2 with
BatchNorm in float32) on ``mlp256-demo``'s tree, judged under
``mlp256-demo``'s float32 limits with ``STATE_GAP`` beside them."""

import copy
import dataclasses
import json

from benchmark import cells, check

MLP = "mlp256-demo.train-b262k"
FLAGSHIP = "flagship3.train-b65k"
NOISYCONV = "noisyconv-test"
LANES = 64
RUN = cells.ROOT / "docs" / "runs" / "r5-noisy-conv.params.json"

# the limit of ``state_gap``, set by ``calibrate.py``'s rule (lower^(1/3)
# upper^(2/3)) from this cell's readings on the CPU: sound runs read
# 1.5e-8 to 1.55e-5 over 12 seeds (both sides compute the same masked
# float32 statistics from weights that part by rounding), the TF32
# control 4.0e-4 to 4.5e-4 over 3 and the planted faults 1.1e-3 to 0.13
STATE_GAP = 1.4e-4


def small(name: str) -> cells.Cell:
    """The cell at 64 lanes, the flagship's tree cut to depth 3 (the whole
    one takes the CPU minutes)."""
    if name == NOISYCONV:
        cell = cells.find(MLP)
        run = json.loads(RUN.read_text())
        config = dict(copy.deepcopy(cell.config), net=run["net"],
                      rnad=run["rnad"])
        return dataclasses.replace(cell, name=NOISYCONV, config=config,
                                   traffic=dict(cell.traffic, lanes=LANES))
    cell = cells.find(name)
    config = copy.deepcopy(cell.config)
    if name == FLAGSHIP:
        config["tree"]["depth_bound"] = 3
    return dataclasses.replace(cell, config=config,
                               traffic=dict(cell.traffic, lanes=LANES))


def limits(name: str) -> dict:
    """The limits a cell's small run is judged under."""
    if name == NOISYCONV:
        return dict(check.limits(MLP), state_gap=STATE_GAP)
    return check.limits(name)
