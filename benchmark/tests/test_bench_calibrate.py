"""Every cell's limits follow from its own readings by ``calibrate.py``'s
rule."""

import json
from pathlib import Path

import pytest

from benchmark.calibrate import derive

LIMITS = sorted((Path(__file__).resolve().parents[1] / "limits").glob("*.json"))


@pytest.mark.parametrize("path", LIMITS, ids=lambda p: p.stem)
def test_limits_follow_from_readings(path):
    doc = json.loads(path.read_text())
    summary = {k: dict(sound_max=r["lower"],
                       **{m: v for m, v in r.items() if m.endswith("_min")})
               for k, r in doc["readings"].items()}
    got = derive(summary, list(doc["readings"]))
    assert {k: r["limit"] for k, r in got.items() if "limit" in r} \
        == doc["limits"]
    assert {k: r.get("upper_from") for k, r in got.items()} \
        == {k: r.get("upper_from") for k, r in doc["readings"].items()}


def test_a_number_without_an_upper_reading_gets_no_limit():
    got = derive({"grad_gap": {"sound_max": 0.01, "control_min": 0.02,
                               "half_batch_min": 0.05}}, ["grad_gap"])
    assert "limit" not in got["grad_gap"]
