"""Readings for a cell's limits: the check's numbers for sound runs of the
program on many seeds, for the control (the reference computed in the
precision below the configuration's, put in the program's place) and for
each planted fault (``faults.py``), all at the cell's own sizes on the
card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out FILE]

One process reads them all: each seed builds the program afresh through
the traffic kind's driver (the same phases as a run) and frees it before
the reference follows.  Prints one JSON object: the card, every reading,
per number the largest sound reading, the smallest control reading and
the smallest reading of each fault, and the verdict of ``check.judge``
under the cell's limits (``limits/<cell>.json``) for every run: the
numbers that failed.  Without a CUDA card it exits with 3.

With ``--limits NAME,...`` it sets the limits of those numbers from the
readings, writes them to ``limits/<cell>.json`` and judges every run
under them (``derive`` gives the rule).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import cells, check, faults, system  # noqa: E402


def _ints(text: str):
    return [int(s) for s in text.split(",") if s]


FACTOR = {"control": 3, "unchanged": 3}  # other faults: 10
EXACT = {"obs_gap"}
RULE = ("lower: largest sound reading, upper: least control reading of 3x "
        "the lower or more, or fault reading of 10x (unchanged: 3x); limit "
        "lower^(1/3) upper^(2/3); where lower is 0 or below, upper/20; "
        "obs_gap is exact (0)")


def derive(summary, names):
    """{name: reading} by the rule of ``RULE``, each with its ``limit``
    rounded to three figures; a number whose readings give no upper end
    gets none."""
    out = {}
    for k in names:
        row = summary[k]
        lower = row["sound_max"]
        reading = {"lower": lower}
        if k in EXACT:
            reading["limit"] = 0.0
        else:
            ups = [(v, key[:-4]) for key, v in row.items()
                   if key.endswith("_min")
                   and v > lower and v >= FACTOR.get(key[:-4], 10) * lower]
            if ups:
                upper, frm = min(ups)
                limit = (upper / 20 if lower <= 0
                         else lower ** (1 / 3) * upper ** (2 / 3))
                reading.update(upper=upper, upper_from=frm,
                               limit=float(f"{limit:.3g}"))
        out[k] = dict(reading, **{key: v for key, v in row.items()
                                  if key.endswith("_min")})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_ints, required=True)
    parser.add_argument("--control-seeds", type=_ints, default=[])
    parser.add_argument("--fault-seeds", type=_ints, default=[])
    parser.add_argument("--faults", default=",".join(faults.FAULTS))
    parser.add_argument("--out", default=None)
    parser.add_argument("--limits", default="",
                        help="set these numbers' limits from the readings")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate.py reads on a CUDA card; found none", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = cells.find(args.workload)
    driver = cell.driver
    control = check.CONTROL[cell.config["net"]["compute_dtype"]]
    out = {"cell": cell.name, "lanes": cell.lanes, "control": control,
           "device": torch.cuda.get_device_name(0),
           "sound": {}, "control_runs": {}, "faults": {}, "verdicts": {}}
    refs = {}

    def noted(kind, seed, values):
        print(kind, seed, values, file=sys.stderr)
        return values

    def program(seed, fault=None):
        sut = driver.build(cell, seed)
        inputs = sut.inputs
        if fault is None:
            got = driver.checked(sut, cell)
        else:
            with faults.planted(fault):
                got = driver.checked(sut, cell)
        system.free(sut)
        return got, inputs

    for seed in args.seeds + [s for s in args.control_seeds
                              if s not in args.seeds]:
        t = time.perf_counter()
        got, inputs = program(seed)
        want = driver.reference(cell, inputs, got)
        if seed in args.control_seeds:
            refs[seed] = (want, inputs)
        if seed in args.seeds:
            out["sound"][seed] = noted(
                "sound", seed, driver.numbers(cell, got, want))
            print(f"{time.perf_counter() - t:.1f}s", file=sys.stderr)
        del got, want
    for seed in args.control_seeds:
        want, inputs = refs[seed]
        got = driver.reference(cell, inputs, want, precision=control)
        out["control_runs"][seed] = noted(
            "control", seed, driver.numbers(cell, got, want))
    for name in [f for f in args.faults.split(",") if f]:
        out["faults"][name] = {}
        for seed in args.fault_seeds:
            got, inputs = program(seed, name)
            want = driver.reference(cell, inputs, got)
            out["faults"][name][seed] = noted(
                name, seed, driver.numbers(cell, got, want))
    names = sorted(next(iter(out["sound"].values())))
    summary = {}
    for k in names:
        row = {"sound_max": max(r[k] for r in out["sound"].values())}
        if out["control_runs"]:
            row["control_min"] = min(r[k] for r in
                                     out["control_runs"].values())
        for name, runs in out["faults"].items():
            if runs:
                row[f"{name}_min"] = min(r[k] for r in runs.values())
        summary[k] = row
    out["summary"] = summary
    if args.limits:
        readings = derive(summary, args.limits.split(","))
        lims = {k: r["limit"] for k, r in readings.items() if "limit" in r}
        out["uncompared"] = sorted(set(readings) - set(lims))
        counts = (f"{len(args.seeds)} sound seeds, {len(args.control_seeds)} "
                  f"control seeds, {len(args.fault_seeds)} seeds of each fault")
        doc = {"from": f"benchmark/calibrate.py on one {out['device']}, "
               f"{counts}; {RULE}", "seeds": len(args.seeds), "limits": lims,
               "readings": readings}
        (check.HERE / "limits" / f"{cell.name}.json").write_text(
            json.dumps(doc, indent=1) + "\n")
    else:
        lims = check.limits(cell.name)
    runs = [("sound", out["sound"]), ("control", out["control_runs"])]
    runs += list(out["faults"].items())
    for kind, by_seed in runs:
        for seed, values in by_seed.items():
            _, table = check.judge(values, lims)
            out["verdicts"].setdefault(kind, {})[seed] = check.failed(table)
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(json.dumps({"device": out["device"], "summary": summary,
                      "limits": lims,
                      "uncompared": out.get("uncompared", []),
                      "verdicts": {k: v for k, v in out["verdicts"].items()
                                   if k != "sound"},
                      "sound_failed": {s: f for s, f in
                                       out["verdicts"].get("sound", {}).items()
                                       if f}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
