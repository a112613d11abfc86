"""The port's tenant quotas (``repro_torch.service.tenancy``) against
``repro.service.tenancy``.

The module is a copy with the reference's arithmetic unchanged, so the
same clock script gives the same decision stream and snapshots, and
``AdmissionCeilings`` admits exactly what the reference admits, the
reference's known fault included: ``update`` stores ``1.0 - deny_rate``,
so a caller that passes ``1 - f`` gets ``f`` back one ulp low for some
``f`` (0.08 comes back as 0.07999999999999996, and 25 requests pass 1,
not ``int(25 * 0.08)`` = 2).  The runtime integration runs both runtimes
on a ``VirtualClock`` with the same injected durations.  The cases mirror
``tests/test_tenancy.py``; its hypothesis properties run on fixed cases.
"""
import types

import jax  # noqa: F401
import pytest
import torch

import repro.service as R
import repro_torch.service as P
from repro.core import querygraph as RQ
from repro.service import tenancy as ref_tenancy
from repro_torch.core import querygraph as PQ
from repro_torch.service import tenancy
from repro_torch.service.batch import BatchPolicy
from repro_torch.service.tenancy import AdmissionCeilings, TenantQuota

REF = types.SimpleNamespace(svc=R, qg=RQ, ten=ref_tenancy, kw={},
                            policy=R.BatchPolicy)
PORT = types.SimpleNamespace(svc=P, qg=PQ, ten=tenancy,
                             kw={"device": "cpu"}, policy=BatchPolicy)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _same(fn):
    want, got = fn(REF), fn(PORT)
    assert got == want
    return got


# ------------------------------------------------------------- quotas
def test_quota_validation():
    q = TenantQuota("t", rate=2.0)
    assert q.burst == 8.0 and q.on_exceed == "shed" and q.aging_s is None
    for kw in ({"rate": 0.0}, {"rate": 1.0, "burst": 0.5},
               {"rate": 1.0, "on_exceed": "throttle"},
               {"rate": 1.0, "aging_s": 0.0}):
        with pytest.raises(ValueError):
            TenantQuota("t", **kw)


def _board_script(side, case):
    ten, clk = side.ten, side.svc.VirtualClock()
    if case == "burst":
        board = ten.QuotaBoard(clk, {"t": ten.TenantQuota("t", rate=1.0,
                                                          burst=3.0)})
        out = [board.admit("t") for _ in range(5)]
    elif case == "refill":
        board = ten.QuotaBoard(clk, {"t": ten.TenantQuota("t", rate=2.0,
                                                          burst=4.0)})
        out = [board.admit("t") for _ in range(5)]
        clk.advance(1.0)
        out += [board.admit("t") for _ in range(3)]
        clk.advance(1000.0)
        out += [board.admit("t") for _ in range(5)]
    elif case == "downgrade":
        board = ten.QuotaBoard(clk, {"t": ten.TenantQuota(
            "t", rate=1.0, burst=1.0, on_exceed="downgrade")})
        out = [board.admit("t"), board.admit("t")]
        out += [board.admit("free-rider") for _ in range(50)]
        out.append(board.deny_rate("free-rider"))
    elif case == "aging":
        board = ten.QuotaBoard(clk, {"t": ten.TenantQuota(
            "t", rate=0.01, burst=1.0, aging_s=5.0)})
        out = [board.admit("t"), board.admit("t")]
        for dt in (5.0, 0.0, 5.0, 200.0, 4.0, 4.0):
            clk.advance(dt)
            out.append(board.admit("t"))
    else:                                   # the deny-rate EWMA
        board = ten.QuotaBoard(clk, {"t": ten.TenantQuota(
            "t", rate=1.0, burst=1.0)}, ewma_alpha=0.2)
        out = []
        for _ in range(3):
            board.admit("t")
            out.append(board.deny_rate("t"))
        board.record_served("t")
    st = board.stats["t"]
    return out, (st.admitted, st.shed, st.downgraded, st.promoted,
                 st.decisions), board.snapshot()


@pytest.mark.parametrize("case", ["burst", "refill", "downgrade", "aging",
                                  "deny_ewma"])
def test_quota_board_matches_reference(case):
    out, counts, snap = _same(lambda side: _board_script(side, case))
    if case == "burst":
        assert out == ["admit"] * 3 + ["shed"] * 2
        assert counts[:2] == (3, 2) and counts[4] == 5
    elif case == "refill":
        assert out == ["admit"] * 4 + ["shed"] + ["admit", "admit",
                                                  "shed"] \
            + ["admit"] * 4 + ["shed"]
    elif case == "downgrade":
        assert out[:2] == ["admit", "downgrade"]
        assert set(out[2:52]) == {"admit"} and out[52] == 0.0
        assert counts[2] == 1
    elif case == "aging":
        assert out[:5] == ["admit", "shed", "promote", "shed", "promote"]
        assert out[5] == "admit" and out[7] != "promote"
    else:
        assert out[0] == 0.0 and out[1] == pytest.approx(0.2)
        assert out[2] == pytest.approx(0.36)
        assert snap["tenants"]["t"]["served"] == 1
        assert snap["quotas"]["t"]["rate"] == 1.0


REPLAYS = [(1, 1, 0), (2, 7, 12345), (3, 30, 2 ** 20), (4, 13, 777),
           (6, 25, 99991)]


@pytest.mark.parametrize("rate,n,salt", REPLAYS,
                         ids=[f"r{r}-n{n}" for r, n, _ in REPLAYS])
def test_quota_board_decisions_replay_bit_identical(rate, n, salt):
    """Same quota and clock script: the same decision stream, twice in
    the port and once in the reference."""
    def run(side):
        clk = side.svc.VirtualClock()
        board = side.ten.QuotaBoard(clk, {"t": side.ten.TenantQuota(
            "t", rate=float(rate), burst=2.0, aging_s=3.0)})
        out = []
        for i in range(n):
            clk.advance(((salt >> (i % 16)) & 3) * 0.25)
            out.append(board.admit("t"))
        return out, board.snapshot()
    assert run(PORT) == _same(run)


# ----------------------------------------------------------- ceilings
def test_ceiling_floor_validation_and_clamping():
    for floor in (0.0, 1.5):
        with pytest.raises(ValueError):
            AdmissionCeilings(floor=floor)

    def run(side):
        c = side.ten.AdmissionCeilings(floor=0.25)
        out = [c.ceiling("t")]
        for rate in (1.7, -0.3, 0.5):
            c.update("t", rate)
            out.append(c.ceiling("t"))
        return out
    assert _same(run) == [1.0, 0.25, 1.0, 0.5]


def test_ceiling_half_passes_every_other_request():
    def run(side):
        c = side.ten.AdmissionCeilings()
        c.update("t", 0.5)
        return [c.admit("t") for _ in range(8)], c.client_shed, \
            c.snapshot()
    got = _same(run)
    assert got == ([False, True] * 4, 4,
                   {"ceilings": {"t": 0.5}, "client_shed": 4})


def test_ceiling_none_and_full_open_consume_no_counters():
    c = AdmissionCeilings()
    assert all(c.admit(None) for _ in range(10))
    c.update("open", 0.0)
    assert all(c.admit("open") for _ in range(10))
    assert c.client_shed == 0 and c._seen == {}


CEILINGS = [(1, 1), (8, 25), (10, 100), (33, 200), (50, 7), (99, 150)]


@pytest.mark.parametrize("pct,n", CEILINGS,
                         ids=[f"pct{p}-n{n}" for p, n in CEILINGS])
def test_ceiling_pass_count_matches_reference(pct, n):
    """The counter-based limiter passes exactly what the reference
    passes for every (pct, n), and floor(n * f) of the first n requests
    where ``1 - (1 - f)`` is f exactly.  At pct = 8, n = 25 it is not:
    both pass 1 request, not 2 (the reference's fault, kept)."""
    f = pct / 100.0

    def run(side):
        c = side.ten.AdmissionCeilings(floor=0.01)
        c.update("t", 1.0 - f)
        return sum(c.admit("t") for _ in range(n)), c.ceiling("t")
    passed, ceiling = _same(run)
    if (pct, n) == (8, 25):
        assert ceiling == 0.07999999999999996 and passed == 1
    else:
        assert passed == int(n * max(0.01, ceiling))
        if ceiling == f:
            assert passed == int(n * max(0.01, f))


# ------------------------------------------------- runtime integration
def _plan_sync(side, rt, req):
    """One request through a VirtualClock runtime, drained to its end; a
    refusal becomes a typed error response (``serve``'s rule)."""
    ticket = rt.submit(req)
    while not ticket.done:
        nxt = rt.next_event_time()
        if nxt is not None:
            rt.clock.advance_to(nxt)
        if rt.poll() == 0 and nxt is None:
            raise AssertionError("runtime stalled")
    if ticket.response is not None:
        return ticket.response
    err = ticket.error if ticket.error is not None \
        else side.svc.faults.ShedError(ticket.refuse_reason)
    return side.svc.PlanResponse(
        req_id=req.req_id, cost=float("inf"), tree=None,
        meta={"shed": ticket.refuse_reason}, route=ticket.route,
        cache_hit=False, latency=ticket.latency, status="error",
        error=err)


def _tenant_runtime(side, quotas, slo_classes):
    clk = side.svc.VirtualClock()
    srv = side.svc.PlanServer(enable_batch=False,
                              batch_policy=side.policy(engine="host"),
                              **side.kw)
    rt = srv.make_runtime(
        clock=clk,
        config=side.svc.RuntimeConfig(max_batch=1, slo_classes=slo_classes,
                                      tenant_quotas=quotas),
        duration_fn=lambda kind, info: 1e-3)
    return clk, rt


def _resp(r):
    return (r.req_id, r.status, float(r.cost).hex(), repr(r.tree),
            None if r.error is None else type(r.error).__name__)


def test_runtime_isolates_in_quota_tenant_from_noisy_neighbors():
    """A shedding and a downgrading over-quota tenant hammer the runtime
    while a paid tenant's promised-deadline traffic loses nothing."""
    def run(side):
        S, ten = side.svc, side.ten
        quotas = {"free": ten.TenantQuota("free", rate=2.0, burst=2.0),
                  "trial": ten.TenantQuota("trial", rate=2.0, burst=2.0,
                                           on_exceed="downgrade")}
        clk, rt = _tenant_runtime(
            side, quotas, {"interactive": S.SLOClass("interactive", 1.0)})
        outcomes = {"free": [], "trial": [], "paid": []}
        for i in range(30):
            clk.advance(0.05)
            tenant = ("free", "trial", "paid")[i % 3]
            q = side.qg.chain(5)
            req = S.PlanRequest(
                q=q, card=side.qg.make_cardinalities(q, seed=100 + i),
                cost="max", req_id=i, tenant=tenant, arrival=clk.now(),
                slo="interactive" if tenant == "paid" else None)
            outcomes[tenant].append(_resp(_plan_sync(side, rt, req)))
        klass = rt.stats.per_class["interactive"]
        return (outcomes, rt.quotas.snapshot(), rt.stats.as_dict(),
                klass.served, klass.deadline_misses, klass.shed,
                rt.quotas.deny_rate("free"), rt.quotas.deny_rate("paid"))
    (outcomes, _, _, served, misses, shed, free_deny,
     paid_deny) = _same(run)
    assert any(r[1] == "error" for r in outcomes["free"])
    assert all(r[4] == "ShedError" for r in outcomes["free"]
               if r[1] == "error")
    assert any(r[1] == "degraded" for r in outcomes["trial"])
    assert all(r[1] != "error" for r in outcomes["trial"])
    assert all(r[1] == "exact" for r in outcomes["paid"])
    assert served == len(outcomes["paid"]) and misses == shed == 0
    assert free_deny > 0.0 and paid_deny == 0.0


def test_runtime_promotes_starved_tenant_via_aging():
    def run(side):
        S, ten = side.svc, side.ten
        quotas = {"slow": ten.TenantQuota("slow", rate=0.01, burst=1.0,
                                          aging_s=1.0)}
        clk, rt = _tenant_runtime(
            side, quotas, {"standard": S.SLOClass("standard", 10.0)})
        q = side.qg.chain(5)
        card = side.qg.make_cardinalities(q, seed=0)
        out = []
        for i, dt in enumerate((0.0, 0.01, 1.5, 0.01)):
            clk.advance(dt)
            out.append(_resp(_plan_sync(side, rt, S.PlanRequest(
                q=q, card=card, cost="max", req_id=i, tenant="slow",
                arrival=clk.now()))))
        return (out, rt.quotas.stats["slow"].promoted,
                rt.stats.deadline_misses, rt.quotas.snapshot())
    out, promoted, misses, _ = _same(run)
    assert [r[1] for r in out] == ["exact", "error", "exact", "error"]
    assert promoted == 1 and misses == 0
