"""The eta sweep's seed rule: rnad_tpu_torch against rnad_tpu over seeds.

The series here are the NashConv evals of the reference schedule of
``examples/eta_sweep.py`` (64 update periods of 100 steps at 512 lanes: 63
boundary evals and the final eval) for etas 0, 0.2, 0.5 and 1 and seeds
0-4, run by both packages: ``rnad-eta-s<k>-eta=<eta>`` by rnad_tpu
(``python examples/eta_sweep.py --cpu --seed k --name rnad-eta-s<k>``) and
``eta-s<k>-eta=<eta>`` by the port (``python -m rnad_tpu_torch.eta_sweep
--seed k --name eta-s<k>``).

For each package, eta and seed, F is the mean of the last 8 of the 64
evals; d_k = F_port - F_rnad_tpu.  An eta agrees when |mean d| <= max(3 *
sd(d) / sqrt(5), 0.02), sd with ddof 1.  Reported beside it, not gated:
the share of the 64 evals at which the port's mean over seeds lies within
rnad_tpu's mean +- 2 sd.

    python docs/port_runs/eta_sweep/seed_rule.py collect RUNS_DIR...
    python docs/port_runs/eta_sweep/seed_rule.py

``collect`` copies each run's NashConv series (``metrics.jsonl`` lines
with a ``nashconv``) and its ``params.json`` out of run-store directories
(``saved_runs/``) into this directory; without arguments the script prints
the rule's table from the series here.
"""

import json
import math
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ETAS = (0.0, 0.2, 0.5, 1.0)
SEEDS = range(5)
EVALS, LAST = 64, 8


def collect(roots):
    for root in roots:
        for run in sorted(pathlib.Path(root).iterdir()):
            lines = [json.loads(x) for x in (run / "metrics.jsonl").open()]
            with open(HERE / f"{run.name}.nashconv.jsonl", "w") as f:
                for r in lines:
                    if "nashconv" in r:
                        f.write(json.dumps({"step": r["step"],
                                            "nashconv": r["nashconv"]})
                                + "\n")
            (HERE / f"{run.name}.params.json").write_text(
                (run / "params.json").read_text())
            print(f"collected {run.name}")


def series(name):
    with open(HERE / f"{name}.nashconv.jsonl") as f:
        out = np.array([json.loads(x)["nashconv"] for x in f])
    if out.shape != (EVALS,) or not np.isfinite(out).all():
        raise ValueError(f"{name}: {out.shape[0]} evals, want {EVALS}")
    return out


def table():
    print("| eta | F rnad_tpu (mean over seeds) | F port | mean d | sd(d) | "
          "bound max(3 sd/sqrt 5, 0.02) | agrees | in-band share |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    ok = True
    for eta in ETAS:
        ref = np.stack([series(f"rnad-eta-s{k}-eta={eta}") for k in SEEDS])
        port = np.stack([series(f"eta-s{k}-eta={eta}") for k in SEEDS])
        f_ref, f_port = ref[:, -LAST:].mean(1), port[:, -LAST:].mean(1)
        d = f_port - f_ref
        sd = float(d.std(ddof=1))
        bound = max(3 * sd / math.sqrt(len(d)), 0.02)
        agrees = abs(float(d.mean())) <= bound
        ok &= agrees
        mu, band = ref.mean(0), 2 * ref.std(0, ddof=1)
        share = float((np.abs(port.mean(0) - mu) <= band).mean())
        print(f"| {eta} | {f_ref.mean():.4f} | {f_port.mean():.4f} | "
              f"{d.mean():+.4f} | {sd:.4f} | {bound:.4f} | "
              f"{'yes' if agrees else 'no'} | {100 * share:.1f} % |")
        print(f"<!-- eta={eta}: d = {', '.join(f'{x:+.4f}' for x in d)} -->")
    return ok


if __name__ == "__main__":
    if sys.argv[1:2] == ["collect"]:
        collect(sys.argv[2:])
    else:
        sys.exit(0 if table() else 1)
