"""Shared set-up of the harness's tests: the harness's own directory on
the import path, the program's source tree behind it, and small mixes
that a CPU holds."""
import argparse
import io
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PLANBENCH = HERE.parent
ROOT = PLANBENCH.parent
for p in (str(PLANBENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {"classes": [{"cost": "max", "weight": 0.7, "n": [7, 8]},
                     {"cost": "cap", "weight": 0.15, "n": [7, 7]},
                     {"cost": "out", "weight": 0.15, "n": [7, 7]}]}
OVERRIDES = {
    "plansvc.fresh": dict(SMALL, clients=4),
    "plansvc.bigjoin": {"classes": [{"cost": "max", "weight": 1.0,
                                     "n": [8, 9]}], "block": 2},
}


def run_small(workload: str, seed: int = 2 ** 31 + 11, seconds: float = 1.5,
              trace: int = 0, bench=None, overrides=None):
    """One run of ``workload`` on the CPU at a small size: ``(exit code,
    result line as a dict or None, standard error)``."""
    from pbench import cli
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)
    out, err = io.StringIO(), io.StringIO()
    ov = OVERRIDES.get(workload, {}) if overrides is None else overrides
    rc = cli.run_cell(args, time.perf_counter(), bench=bench, device="cpu",
                      require_cuda=False, mix_overrides=ov,
                      preloaded=set(cli.forbidden_modules()), out=out,
                      err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
