"""Run a series of benchmark runs one after another, each in a process of
its own as the check runs them, and keep every result line.

    python3 planbench/tools/series.py --tag NAME --seconds S RUN [RUN ...]

Each RUN is ``<workload>:<seed>[:<trace>]``.  Results go to
``chiprun_out/<NAME>.jsonl`` (one object per run: the arguments, the
exit code, the wall time, the result line and the end of standard
error); a summary of each run is printed as it ends.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("runs", nargs="+")
    a = ap.parse_args(argv)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    dev = card()
    print(f"card: {dev}", flush=True)
    path = out_dir / f"{a.tag}.jsonl"
    worst = 0
    for spec in a.runs:
        parts = spec.split(":")
        wl, seed = parts[0], parts[1]
        trace = parts[2] if len(parts) > 2 else "0"
        cmd = [sys.executable, "planbench/run.py", "--workload", wl,
               "--seed", seed, "--seconds", f"{a.seconds:g}",
               "--trace", trace]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        result = None
        if lines:
            try:
                result = json.loads(lines[-1])
            except json.JSONDecodeError:
                result = None
        rec = {"workload": wl, "seed": int(seed), "trace": int(trace),
               "seconds": a.seconds, "rc": p.returncode,
               "wall_s": wall, "card": dev, "result": result,
               "stderr_tail": p.stderr[-3000:]}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        short = {} if result is None else {
            "correct": result.get("correct"),
            "attempted": result.get("attempted"),
            "metrics": {k: round(v["value"], 4)
                        for k, v in result.get("metrics", {}).items()},
            "busy_s": result.get("device", {}).get("busy_s"),
            "window_s": result.get("device", {}).get("window_s"),
            "mem": result.get("device", {}).get("memory_peak_bytes")}
        note = p.stderr.strip().splitlines()
        print(f"{spec} rc={p.returncode} wall={wall:.1f}s {json.dumps(short)}",
              flush=True)
        for ln in note[-5:]:
            print("    " + ln[:1500], flush=True)
        worst = max(worst, p.returncode)
    return worst


if __name__ == "__main__":
    sys.exit(main())
