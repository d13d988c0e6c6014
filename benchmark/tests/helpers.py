"""Small configurations of the cells for the CPU tests."""

import copy
import dataclasses

from benchmark import cells

MLP = "mlp256-demo.train-b262k"
FLAGSHIP = "flagship3.train-b65k"
LANES = 64


def small(name: str) -> cells.Cell:
    """The cell at 64 lanes, the flagship's tree cut to depth 3 (the whole
    one takes the CPU minutes)."""
    cell = cells.find(name)
    config = copy.deepcopy(cell.config)
    if name == FLAGSHIP:
        config["tree"]["depth_bound"] = 3
    return dataclasses.replace(cell, config=config,
                               traffic=dict(cell.traffic, lanes=LANES))
