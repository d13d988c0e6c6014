"""Peaks of the card and the work a step needs, as counted from shapes.

Frozen from ``rnad_tpu_torch/roofline.py`` (``Peaks``, ``H100_SXM``,
``Work``): NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
A product is charged at its operand type's rate; every other operation is
charged by the bytes it moves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Work:
    """Matmul products (FLOPs, an FMA counting two) by operand type, and
    the bytes that must cross HBM."""

    flops: Dict[str, float]
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        flops = dict(self.flops)
        for dtype, f in other.flops.items():
            flops[dtype] = flops.get(dtype, 0.0) + f
        return Work(flops, self.bytes + other.bytes)

    def scaled(self, k: float) -> "Work":
        return Work({d: k * f for d, f in self.flops.items()}, k * self.bytes)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    def ops_s(self) -> float:
        """The products' least time, each at its operand type's peak."""
        return sum(f / FLOPS[d] for d, f in self.flops.items())

    def bytes_s(self) -> float:
        return self.bytes / HBM_BYTES_PER_S

    def bound_s(self) -> float:
        return max(self.ops_s(), self.bytes_s())
