"""Finds every piece of a cell by its name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and lists the metrics.  The pieces live in
files of their own under ``planbench/``, found by name:

* ``configs/<config>.json``      one deployment (its ``reference`` names
                                 ``references/<reference>.py``)
* ``traffic/<mix>.json``         one traffic mix (its ``generator`` names
                                 ``generators/<generator>.py``, its
                                 ``loop`` names ``drivers/<loop>.py``)
* ``metrics/<metric>.py``        one metric's reader, ``read(run)``

so a later change adds a cell, a mix, a configuration or a metric as new
files and new entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # planbench/
ROOT = HERE.parent                                 # the checkout


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(kind: str, name: str, base: Path = HERE):
    """The module ``<base>/<kind>/<name>.py``, loaded under a private
    name (file names may hold dots)."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    key = f"planbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    mod = sys.modules.get(key)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names, below ``base``."""

    def __init__(self, root: Path = ROOT, base: Path = HERE):
        self.root = Path(root)
        self.base = Path(base)
        self.spec = _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(self.base / "configs" / f"{name}.json")

    def mix(self, name: str) -> dict:
        return _json(self.base / "traffic" / f"{name}.json")

    def generator(self, name: str):
        return _module("generators", name, self.base)

    def driver(self, name: str):
        return _module("drivers", name, self.base)

    def reference(self, name: str):
        return _module("references", name, self.base)

    def reader(self, name: str):
        return _module("metrics", name, self.base)

    def metrics_for(self, cell: str, trace: bool) -> list:
        """The metric entries a run of ``cell`` reports: the end-to-end
        ones without the trace, the per-layer ones with it.  A metric
        without ``workloads`` is reported in every cell that reports the
        metric it moves (per-layer) or in every cell (end-to-end)."""
        e2e = self.spec["end_to_end"]
        mine = [m for m in e2e
                if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return mine
        mine_names = {m["name"] for m in mine}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in mine_names)]
