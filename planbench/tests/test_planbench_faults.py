"""The comparison that decides ``correct`` fails what it must: the
control (the reference one precision below the configuration's, in the
program's place) and a run whose timed path is broken underneath, once
for each fault a cell can have: an answer altered where it is produced,
and half of the requests left out.  (A cell here has no exchange between
chips and no state carried from step to step.)"""
import dataclasses
import itertools

import pytest
import torch

from _planbench_util import OVERRIDES, run_small
from pbench import control
from pbench.registry import Bench

CELLS = ("plansvc.fresh", "plansvc.bigjoin")


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        res = control.control(Bench(), cell, seed, 48, torch.device("cpu"),
                              mix_overrides=OVERRIDES[cell])
        assert res["compared"] > 0
        assert res["correct"] is False
        assert res["checks"]["cost_gap"]["value"] > 0.0


@pytest.fixture
def altered(monkeypatch):
    """Every solved answer's cost moved by one part in a billion where
    the server produces it."""
    from repro_torch.service.server import PlanServer
    complete = PlanServer._complete

    def bad(self, *a, **kw):
        resp = complete(self, *a, **kw)
        return dataclasses.replace(resp, cost=resp.cost * (1 + 1e-9))
    monkeypatch.setattr(PlanServer, "_complete", bad)


@pytest.fixture
def half_left_out(monkeypatch):
    """Every second solve unit's answer is never delivered (the runtime),
    every second ``plan_one`` call comes back empty (the server)."""
    from repro_torch.service.runtime import ServingRuntime
    from repro_torch.service.server import PlanResponse, PlanServer
    tick = itertools.count()
    complete_entry = ServingRuntime._complete_entry

    def drop(self, entry, *a, **kw):
        if next(tick) % 2:
            self._by_key.pop(entry.key, None)
            return None
        return complete_entry(self, entry, *a, **kw)
    monkeypatch.setattr(ServingRuntime, "_complete_entry", drop)
    plan_one = PlanServer.plan_one

    def empty(self, q, card, cost="max", **kw):
        if next(tick) % 2:
            return PlanResponse(req_id=0, cost=float("inf"), tree=None,
                                meta={}, route=None, cache_hit=False,
                                status="error")
        return plan_one(self, q, card, cost=cost, **kw)
    monkeypatch.setattr(PlanServer, "plan_one", empty)
    monkeypatch.setattr(Bench().driver("clients"), "LATE_S", 1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(cell, altered):
    rc, res, err = run_small(cell)
    assert rc == 0, err
    assert res["correct"] is False
    assert res["checks"]["cost_gap"]["value"] > 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_half_left_out_is_not_correct(cell, half_left_out):
    rc, res, err = run_small(cell)
    assert rc == 0, err
    assert res["correct"] is False
    assert res["failed"] > 0
    assert res["checks"]["unanswered"]["value"] == res["failed"]


def test_sound_run_is_correct():
    rc, res, err = run_small("plansvc.fresh")
    assert rc == 0, err
    assert res["correct"] is True
    assert all(c["value"] == 0.0 for c in res["checks"].values())
