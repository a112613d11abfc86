"""The port's dry-run (``repro_torch.launch.{dryrun,specs,hlo_parse}``)
against the reference's contracts (``tests/test_dryrun_sharding.py``).

  * ``test_dryrun_cell_subprocess`` on the port: qwen3-0.6b ``train_4k``
    on the pod (256 cards) and mamba2-130m ``decode_32k`` on two pods
    (512), each ``python -m repro_torch.launch.dryrun`` in a subprocess
    (both at once, each under its own ``CELL_TIMEOUT``), on the ``meta``
    device under the fake process group: status "ok", ``n_chips``,
    ``hlo_flops`` > 0, a known bottleneck; ``hlo_flops`` equal to the
    reference's ``costmodel.roofline_terms(cfg, shape, n_chips,
    tp=8)["flops"]``; rank 0's traced FLOPs and collectives.
  * ``test_hlo_collective_parser``'s contract on both packages' parsers,
    and the port's collective record read in the parser's layout.
  * The production meshes' shapes, (32, 8) and (2, 32, 8), on the fake
    backend (a subprocess), and the package importing without
    ``torch.testing._internal``.
  * ``test_sweep_results_complete`` on the port's out directory (it
    skips where the 80 results are absent, as the reference's does).
  * ``accum_for`` and ``model_flops`` equal to the reference's for the
    ten architectures × four shapes, and ``act_sharding_for`` to the
    reference's on four meshes.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import costmodel as ref_costmodel
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun, hlo_parse, specs
from repro_torch.train.dp import CollectiveLog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
       "OMP_NUM_THREADS": "2"}
CELLS = [("qwen3-0.6b", "train_4k", "pod"),
         ("mamba2-130m", "decode_32k", "multipod")]
CELL_TIMEOUT = 300


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Both cells' subprocesses, started at once; per cell its completed
    process and its JSON path."""
    out = str(tmp_path_factory.mktemp("dryrun"))
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", cell[2], "--out", out],
        env=ENV, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for cell in CELLS}
    return {cell: (p, os.path.join(out, "__".join(cell) + ".json"))
            for cell, p in procs.items()}


@pytest.mark.parametrize("cell", CELLS, ids=["cell0", "cell1"])
def test_dryrun_cell_subprocess(cell, cells):
    arch, shape, mesh = cell
    proc, path = cells[cell]
    try:
        log, _ = proc.communicate(timeout=CELL_TIMEOUT)
    finally:
        proc.kill()
    assert proc.returncode == 0, log
    with open(path) as f:
        res = json.load(f)
    assert res["status"] == "ok", res
    n_chips = 512 if mesh == "multipod" else 256
    assert res["n_chips"] == n_chips
    assert res["hlo_flops"] > 0
    assert res["bottleneck"] in ("compute", "memory", "collective")
    want = ref_costmodel.roofline_terms(
        ref_get_config(arch), REF_SHAPES[shape], n_chips=n_chips,
        tp=8)["flops"]
    assert res["hlo_flops"] == want
    assert res["traced_flops"] > 0 and res["bytes_at_rest_per_device"] > 0
    kinds = res["collectives"]
    if shape == "train_4k":
        # 'data' gathers and reduce-scatters, 'model' sums
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(kinds)
        # the traced matrix FLOPs are the analytic model's within 5%
        assert abs(res["traced_flops"] / res["hlo_flops"] - 1) < 0.05
    else:
        assert "all-gather" in kinds and "load_collectives" in res
    assert res["link_traffic_bytes"] > 0 and res["avg_group"] >= 2
    for k in ("xla_flops_loops_once", "compile_s"):
        assert k not in res


HLO = """
  %ag = bf16[8,1024]{1,0} all-gather(%p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[256]{0} all-reduce(%x), replica_groups=[16,16]<=[256]
  %rs.1 = bf16[2,512]{1,0} reduce-scatter(%y), replica_groups={{0,1}}
  %cp = f32[4]{0} collective-permute(%z), source_target_pairs={{0,1}}
  %agd = bf16[8,8]{1,0} all-gather-done(%h)
"""


def _ref_parser():
    from repro.launch import hlo_parse as ref
    return ref


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_hlo_collective_parser(package):
    mod = _ref_parser() if package == "repro" else hlo_parse
    st = mod.parse_collectives(HLO)
    assert st["all-gather"]["count"] == 1
    assert st["all-gather"]["bytes"] == 8 * 1024 * 2
    assert st["all-reduce"]["bytes"] == 256 * 4
    assert st["reduce-scatter"]["bytes"] == 2 * 512 * 2
    assert st["collective-permute"]["count"] == 1
    assert "all-gather-done" not in st
    assert mod.link_traffic_bytes(st, 4) > 0
    assert st == _ref_parser().parse_collectives(HLO)


def test_collective_log_reads_as_parsed_hlo():
    """The port's record of the collectives that the HLO above lists
    (the collective-permute aside: the port runs none) reads as the
    parser reads the HLO, and ``link_traffic_bytes`` takes it alike."""
    import torch
    log = CollectiveLog()
    log.add("all-gather", torch.empty(8, 1024, dtype=torch.bfloat16,
                                      device="meta"), 4)
    log.add("all-reduce", torch.empty(256, device="meta"), 16)
    log.add("reduce-scatter", torch.empty(2, 512, dtype=torch.bfloat16,
                                          device="meta"), 2)
    hlo = "\n".join(line for line in HLO.splitlines()
                    if "collective-permute" not in line)
    want = hlo_parse.parse_collectives(hlo)
    assert log.stats() == want
    assert hlo_parse.link_traffic_bytes(log.stats(), 8) == \
        hlo_parse.link_traffic_bytes(want, 8)


def test_production_mesh_shapes_and_lazy_fake_backend():
    """The meshes on the fake backend, and the package (the dry-run
    included) importing no module of ``torch.testing._internal`` beyond
    those ``import torch`` loads."""
    code = (
        "import sys\n"
        "import torch\n"
        "bare = set(sys.modules)\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.specs\n"
        "import repro_torch.launch.serve, repro_torch.train.tp\n"
        "assert not [m for m in set(sys.modules) - bare\n"
        "            if m.startswith('torch.testing._internal')]\n"
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "for world, multi in ((256, False), (512, True)):\n"
        "    dist.init_process_group('fake', store=FakeStore(), rank=0,\n"
        "                            world_size=world)\n"
        "    m = make_production_mesh(multi_pod=multi, device_type='cpu')\n"
        "    shape = dict(zip(m.mesh_dim_names, m.shape))\n"
        "    want = ({'pod': 2, 'data': 32, 'model': 8} if multi\n"
        "            else {'data': 32, 'model': 8})\n"
        "    assert shape == want and m.size() == world, shape\n"
        "    dist.destroy_process_group()\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr


def test_sweep_results_complete():
    """The port's sweep results cover all 10 archs x 4 shapes x 2
    meshes with zero errors."""
    d = os.path.join(REPO, dryrun.OUT)
    if not os.path.isdir(d) or len(os.listdir(d)) < 80:
        pytest.skip("full sweep results not present")
    statuses = {}
    for f in os.listdir(d):
        with open(os.path.join(d, f)) as fh:
            statuses[f] = json.load(fh)["status"]
    assert len(statuses) == 80
    assert all(s in ("ok", "skipped") for s in statuses.values()), {
        k: v for k, v in statuses.items() if v == "error"}
    n_skip = sum(1 for s in statuses.values() if s == "skipped")
    assert n_skip == 10   # long_500k x 5 full-attention archs x 2 meshes


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, imported with this process's
    ``XLA_FLAGS`` kept: the module sets 512 host devices for its own
    runs, which would reach any later JAX start in this process."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_accum_and_model_flops_match_reference(arch, shape, ref_dryrun):
    from repro.launch import specs as ref_specs
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    assert specs.accum_for(cfg, SHAPES[shape]) == ref_specs.accum_for(
        rcfg, REF_SHAPES[shape])
    assert dryrun.model_flops(cfg, SHAPES[shape]) == \
        ref_dryrun.model_flops(rcfg, REF_SHAPES[shape])


ACT_MESHES = (((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model")),
              ((1, 8), ("data", "model")))


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_act_sharding_matches_reference(arch):
    """``act_sharding_for`` (``train.tp``'s boundary layout) against the
    reference's on ``AbstractMesh``es, for batches the data axes divide
    and do not."""
    from jax.sharding import AbstractMesh

    from repro.launch import specs as ref_specs
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    for shape, axes in ACT_MESHES:
        mesh = AbstractMesh(shape, axes)
        for batch in (512, 256, 3):
            want = ref_specs.act_sharding_for(rcfg, mesh, batch).spec
            assert specs.act_sharding_for(cfg, mesh, batch) == tuple(want)
