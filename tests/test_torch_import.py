"""The PyTorch port stands alone: it imports neither ``jax`` nor anything
of ``repro``, its numpy copies equal the reference modules, and its entry
points refuse to run without a card unless asked for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks load here, as in every port test)
import numpy as np
import pytest
import torch

from repro.core import bitset as ref_bitset
from repro.core import jointree as ref_jointree
from repro.core import querygraph as ref_qg
from repro_torch import convert
from repro_torch.core import bitset, jointree
from repro_torch.core import querygraph as qg
from repro_torch.core.engine import fused_dpconv_max
from repro_torch.service.batch import BatchedSolver
from repro_torch.service.server import PlanServer

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in PORT.rglob("*.py"))
# the port's scripts beside the package: its examples and the chip smoke
SOURCE_FILES = PORT_FILES + sorted(
    p.relative_to(ROOT).as_posix()
    for p in [*ROOT.glob("examples/torch_*.py"), ROOT / "chip_smoke.py"])


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _module_name(rel: str) -> str:
    parts = list(Path(rel).with_suffix("").parts[1:])    # drop "src"
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def test_port_imports_without_jax_or_repro():
    mods = [_module_name(f) for f in PORT_FILES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("rel", SOURCE_FILES)
def test_port_source_has_no_jax_or_repro_import(rel):
    tree = ast.parse((ROOT / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{rel}:{node.lineno} imports {name}"


# ------------------------------------------------ numpy copies == reference
@pytest.mark.parametrize("n", [1, 4, 8])
def test_bitset_copy_matches_reference(n):
    assert np.array_equal(bitset.popcounts(n), ref_bitset.popcounts(n))
    for a, b in zip(bitset.layer_indices(n), ref_bitset.layer_indices(n)):
        assert np.array_equal(a, b)
    for k in range(1, n + 1):
        sets = bitset.layer_indices(n)[k]
        assert np.array_equal(bitset.submask_table(sets, k),
                              ref_bitset.submask_table(sets, k))


@pytest.mark.parametrize("maker", ["clique", "chain", "star", "cycle"])
def test_querygraph_copy_matches_reference(maker):
    for n, seed in [(5, 0), (9, 3)]:
        q = getattr(qg, maker)(n)
        rq = getattr(ref_qg, maker)(n)
        assert (q.n, q.edges, q.hyperedges) == (rq.n, rq.edges,
                                                 rq.hyperedges)
        a = qg.make_cardinalities(q, seed=seed)
        b = ref_qg.make_cardinalities(rq, seed=seed)
        assert a.tobytes() == b.tobytes()
        assert np.array_equal(q.connected_mask(), rq.connected_mask())
    q, c = qg.paper_clique_instance(8, seed=5)
    rq, rc = ref_qg.paper_clique_instance(8, seed=5)
    assert q.edges == rq.edges and c.tobytes() == rc.tobytes()


def test_jointree_copy_matches_reference():
    # ((R0 ⋈ R1) ⋈ R2) as extraction-scan split arrays
    nodes = np.array([7, 3, 4, 1, 2], np.int32)
    lidx = np.array([1, 3, 0, 0, 0], np.int32)
    t = jointree.tree_from_split_arrays(nodes, lidx)
    rt = ref_jointree.tree_from_split_arrays(nodes, lidx)
    assert str(t) == str(rt) and t.validate()
    card = ref_qg.make_cardinalities(ref_qg.chain(3), seed=1)
    assert t.cost_max(card) == rt.cost_max(card)
    dp = np.ones(8)
    assert str(jointree.extract_tree_feasibility(dp, card, 3)) == \
        str(ref_jointree.extract_tree_feasibility(dp, card, 3))


# ------------------------------------------------- no silent CPU fallback
def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    card = qg.make_cardinalities(qg.chain(4), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedSolver()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused_dpconv_max(card[None, :], 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_reference(4, qg.chain(4).edges, (), card)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanServer()
    assert BatchedSolver(device="cpu").device.type == "cpu"
    assert PlanServer(device="cpu").solver.device.type == "cpu"
