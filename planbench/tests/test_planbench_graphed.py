"""The readers of the share of program calls that replayed CUDA graphs
(``metrics/engine.graphed_call_pct.*.py``): their arithmetic on made-up
dispatch records, None where the records carry no ``graphed`` flag (a
program without CUDA graphs) or there are none, and a traced CPU run of
each cell, whose programs run eagerly (0%)."""
import types

import pytest

from _planbench_util import run_small

from pbench.registry import Bench

CELLS = {"plansvc.fresh": "engine.graphed_call_pct.svc",
         "plansvc.bigjoin": "engine.graphed_call_pct.large"}


def _run(records):
    log = None if records is None else types.SimpleNamespace(records=records)
    return types.SimpleNamespace(dispatches=log)


@pytest.mark.parametrize("name", sorted(CELLS.values()))
def test_graphed_share_of_made_up_records(name):
    read = Bench().reader(name).read
    recs = [types.SimpleNamespace(graphed=g) for g in (True, True, False,
                                                       True)]
    assert read(_run(recs)) == 75.0
    assert read(_run(recs[:2])) == 100.0
    assert read(_run([types.SimpleNamespace(queries=1)])) is None
    assert read(_run([])) is None
    assert read(_run(None)) is None


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_traced_cpu_run_reports_no_graphed_calls(workload):
    rc, res, err = run_small(workload, trace=1)
    assert rc == 0, err
    assert res["correct"] is True
    assert res["metrics"][CELLS[workload]]["value"] == 0.0
