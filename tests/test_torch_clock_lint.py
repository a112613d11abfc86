"""The clock lint of ``scripts/lint_clock.py`` over the port.

The script's own scope is ``src/repro/``.  Here its ``lint_file`` runs
on the port's counterparts of that scope, one case per file: every
``.py`` under ``src/repro_torch/service/`` and ``src/repro_torch/obs/``,
and ``src/repro_torch/core/engine.py``.  Scheduling code reads time
through the runtime's ``Clock``; a wall read needs a ``# timing:``
marker.  ``src/repro_torch/service/faults.py`` is held to the script's
STRICT rule as the reference's ``faults.py`` is: no ``time.*`` call at
all, markers included.
"""
import importlib.util
import os
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
STRICT = "src/repro_torch/service/faults.py"
FILES = sorted(
    [p for d in ("service", "obs") for p in (PORT / d).glob("*.py")]
    + [PORT / "core" / "engine.py"])


@pytest.fixture(scope="module")
def lint():
    spec = importlib.util.spec_from_file_location(
        "lint_clock", ROOT / "scripts" / "lint_clock.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(PORT)) for p in FILES])
def test_port_file_reads_time_through_the_clock(lint, path):
    assert lint.lint_file(str(path)) == []


def test_port_faults_module_is_clock_only(lint, monkeypatch):
    monkeypatch.setattr(lint, "STRICT", lint.STRICT + (STRICT,))
    assert lint.lint_file(str(ROOT / STRICT)) == []


def test_lint_flags_wall_reads(lint, monkeypatch, tmp_path):
    """The lint as loaded here does flag what it forbids, so the cases
    above are not vacuous."""
    bad = tmp_path / "bad.py"
    bad.write_text("import time\n"
                   "a = time.time()\n"
                   "b = time.perf_counter()\n"
                   "# timing: measured-duration (allowed here)\n"
                   "c = time.perf_counter()\n")
    assert [e.split(": ", 1)[0].rsplit(":", 1)[1]
            for e in lint.lint_file(str(bad))] == ["2", "3"]
    strict = os.path.relpath(bad, lint.REPO).replace(os.sep, "/")
    monkeypatch.setattr(lint, "STRICT", lint.STRICT + (strict,))
    assert len(lint.lint_file(str(bad))) == 3     # the marker no longer helps
