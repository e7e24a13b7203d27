"""Admission control of the port (`repro_torch/core/admission.py`) and its
scheduler integration, on `device="cpu"`: the cases of the reference's
tests/test_admission.py run on the port.  Every pure-controller case
(policy validation, `admit_batch`, the token bucket on an injected clock,
queue caps, fair-share shedding, `select`'s WRR, strict priority and
share caps) also runs the same call sequence through the JAX package's
controller and requires the same grants, rejections (reason, tenant and
`retry_after_s`), counters and stats."""
import threading
import time

import pytest

from repro.core import admission as jadm
from repro.core.api import CompactRequest as JCompact
from repro.core.api import RetrieveRequest as JRetrieve
from repro_torch.core import (PRIORITY_HIGH, PRIORITY_LOW, AdmissionController,
                              AdmissionError, AdmissionPolicy, HashEmbedder,
                              MemoryScheduler, MemoryService, Message,
                              RetrieveRequest, TenantPolicy)
from repro_torch.core import admission as tadm
from repro_torch.core.admission import tenant_of
from repro_torch.core.api import CompactRequest, RecordRequest

EMB = HashEmbedder(device="cpu")


def _svc(**kw):
    kw.setdefault("budget", 800)
    return MemoryService(EMB, device="cpu", **kw)


def _fill(svc, tenants=("a", "b")):
    for t in tenants:
        svc.record(f"{t}/c0", "s0",
                   [Message("U", f"I live in City-{t}.", 1.0),
                    Message("U", "I work as a welder.", 2.0)])
    return svc


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _try(log, fn, *a, **kw):
    """Run one controller call, logging its result or its rejection."""
    try:
        out = fn(*a, **kw)
    except (jadm.AdmissionError, tadm.AdmissionError) as e:
        log.append(("rejected", e.reason, e.retry_after_s, e.tenant, str(e)))
        return e
    except ValueError as e:
        log.append(("invalid", str(e)))
        return e
    # a policy object compares by class: log its fields' repr instead
    log.append(("ok", out if out is None or isinstance(out, list)
                 else repr(out)))
    return out


def _both(scenario):
    """Run `scenario(mod, log)` against the JAX package's admission module
    and the port's; their logs must be equal.  Returns the port's log."""
    logs = []
    for mod in (jadm, tadm):
        log = []
        scenario(mod, log)
        logs.append(log)
    assert logs[1] == logs[0]
    return logs[1]


# -- policy validation ---------------------------------------------------------

def test_policy_validation():
    with pytest.raises(ValueError, match="weight"):
        TenantPolicy(weight=0)
    with pytest.raises(ValueError, match="rate"):
        TenantPolicy(rate=-1)
    with pytest.raises(ValueError, match="burst"):
        TenantPolicy(burst=0)
    with pytest.raises(ValueError, match="max_queued_global"):
        AdmissionPolicy(max_queued_global=0)

    def scenario(mod, log):
        _try(log, mod.TenantPolicy, weight=0)
        _try(log, mod.TenantPolicy, rate=-1)
        _try(log, mod.TenantPolicy, burst=0)
        _try(log, mod.TenantPolicy, max_queued=0)
        _try(log, mod.AdmissionPolicy, max_queued_global=0)
        _try(log, mod.AdmissionPolicy, share_window_s=-1)
        for obj in ({"default": {"wieght": 2}}, {"tenants": []},
                    {"default": {"rate": 5, "burst": 3},
                     "tenants": {"a": {"weight": 2, "priority": 0}},
                     "max_queued_global": 9, "share_window_s": 0.5}):
            p = _try(log, mod.admission_policy_from_json, obj)
            if not isinstance(p, ValueError):
                log.append(("policy", repr(p.default), sorted(
                    (k, repr(v)) for k, v in p.tenants.items()),
                    p.max_queued_global, p.share_window_s))

    log = _both(scenario)
    assert [e[0] for e in log] == ["invalid"] * 8 + ["ok", "policy"]


def test_tenant_of_is_namespace_prefix():
    assert tenant_of(RetrieveRequest("acme/conv7", "q")) == "acme"
    assert tenant_of(RetrieveRequest("solo", "q")) == "solo"
    assert tenant_of(CompactRequest()) == "__system__"
    for ns in ("acme/conv7", "solo", "a/b/c"):
        assert tenant_of(RetrieveRequest(ns, "q")) == \
            jadm.tenant_of(JRetrieve(ns, "q"))
    assert jadm.tenant_of(JCompact()) == tenant_of(CompactRequest())


# -- rate limiting (deterministic via injected clock) --------------------------

def test_rate_limit_rejects_flood_and_refills():
    def scenario(mod, log):
        clock = FakeClock()
        ctl = mod.AdmissionController(mod.AdmissionPolicy(
            default=mod.TenantPolicy(rate=10.0, burst=2)), clock=clock)
        _try(log, ctl.admit_batch, [("a", 2)])        # burst drained
        _try(log, ctl.admit_batch, [("a", 1)])
        clock.t += 0.1                                # one token refilled
        _try(log, ctl.admit_batch, [("a", 1)])
        clock.t += 0.05
        _try(log, ctl.admit_batch, [("a", 1)])
        log.append(("counters", dict(ctl.counters)))

    log = _both(scenario)
    assert log[0] == ("ok", None)
    _, reason, retry, tenant, _ = log[1]
    assert reason == "rate_limited" and tenant == "a"
    assert retry == pytest.approx(0.1)
    assert log[2] == ("ok", None)
    assert log[3][1] == "rate_limited"
    assert log[4][1]["admitted"] == 3
    assert log[4][1]["rate_limited"] == 2


def test_admit_batch_is_all_or_nothing():
    def scenario(mod, log):
        clock = FakeClock()
        ctl = mod.AdmissionController(mod.AdmissionPolicy(
            tenants={"limited": mod.TenantPolicy(rate=1.0, burst=1)}),
            clock=clock)
        # the block touches an unlimited tenant AND an over-limit one: the
        # rejection must consume nothing from anyone
        _try(log, ctl.admit_batch, [("limited", 1)])
        _try(log, ctl.admit_batch, [("free", 3), ("limited", 1)])
        log.append(("counters", dict(ctl.counters)))
        log.append(("stats", ctl.stats()))

    log = _both(scenario)
    assert log[1][0] == "rejected"
    assert log[2][1]["admitted"] == 1                 # only the first call


def test_tenant_queue_cap_sheds():
    def scenario(mod, log):
        ctl = mod.AdmissionController(mod.AdmissionPolicy(
            default=mod.TenantPolicy(max_queued=2), shed_retry_after_s=0.25))
        for i in range(2):
            _try(log, ctl.admit_batch, [("a", 1)])
            ctl.push("a", i)
        _try(log, ctl.admit_batch, [("a", 1)])
        log.append(("stats", ctl.stats()))

    log = _both(scenario)
    _, reason, retry, _, _ = log[2]
    assert reason == "tenant_queue_full"
    assert retry == 0.25


def test_global_cap_sheds_only_above_fair_share():
    def scenario(mod, log):
        ctl = mod.AdmissionController(mod.AdmissionPolicy(
            max_queued_global=8))
        for i in range(8):                            # flood fills the cap
            _try(log, ctl.admit_batch, [("flood", 1)])
            ctl.push("flood", i)
        _try(log, ctl.admit_batch, [("flood", 1)])
        # a light tenant is below its fair share: still admitted (soft
        # overflow), the flood cannot close the door on it
        _try(log, ctl.admit_batch, [("light", 1)])
        ctl.push("light", "x")
        log.append(("stats", ctl.stats()))

    log = _both(scenario)
    assert log[8][1] == "overloaded"
    assert log[9] == ("ok", None)
    assert log[10][1]["tenants"]["light"]["queued"] == 1


# -- selection: WRR + priority -------------------------------------------------

def test_select_splits_slots_by_weight():
    def scenario(mod, log):
        ctl = mod.AdmissionController(mod.AdmissionPolicy(
            tenants={"big": mod.TenantPolicy(weight=3.0)}))
        for i in range(40):
            ctl.push("big", ("big", i))
            ctl.push("small", ("small", i))
        for _ in range(3):
            _try(log, ctl.select, 16)

    got = _both(scenario)[0][1]
    by = {"big": 0, "small": 0}
    for t, _ in got:
        by[t] += 1
    assert by["big"] == 12 and by["small"] == 4
    # FIFO within each tenant
    assert [i for t, i in got if t == "big"] == list(range(12))


def test_select_priority_is_strict():
    def scenario(mod, log):
        ctl = mod.AdmissionController(mod.AdmissionPolicy(tenants={
            "hi": mod.TenantPolicy(priority=mod.PRIORITY_HIGH),
            "lo": mod.TenantPolicy(priority=mod.PRIORITY_LOW)}))
        for i in range(6):
            ctl.push("lo", ("lo", i))                 # low queued FIRST
        for i in range(4):
            ctl.push("hi", ("hi", i))
        _try(log, ctl.select, 6)
        _try(log, ctl.select, 6)

    got = _both(scenario)[0][1]
    assert [t for t, _ in got] == ["hi"] * 4 + ["lo"] * 2
    assert PRIORITY_HIGH == jadm.PRIORITY_HIGH
    assert PRIORITY_LOW == jadm.PRIORITY_LOW


def test_select_caps_flood_at_fair_share_but_not_solo_tenants():
    def scenario(mod, log):
        clock = FakeClock()
        ctl = mod.AdmissionController(
            mod.AdmissionPolicy(share_window_s=0.1), clock=clock)
        for i in range(100):
            ctl.push("flood", ("flood", i))
        for i in range(2):
            ctl.push("light", ("light", i))
        _try(log, ctl.select, 16)
        _try(log, ctl.select, 16)
        clock.t += 1.0
        _try(log, ctl.select, 16)

    log = _both(scenario)
    by = {"flood": 0, "light": 0}
    for t, _ in log[0][1]:
        by[t] += 1
    # flood is capped at its entry-time share (16/2 tenants = 8) even
    # though light used only 2 of its 8 — the spare slots would otherwise
    # grow the tick's batch (and its execution time) for everyone
    assert by == {"flood": 8, "light": 2}
    # drained-but-recent tenants keep their reservation for the share
    # window: flood is still capped at 8 of 16
    assert len(log[1][1]) == 8
    # ... and once the window passes, flood queues genuinely alone and
    # gets full ticks: the cap never costs a single-tenant deployment
    assert len(log[2][1]) == 16


def test_select_fractional_weights_make_progress():
    def scenario(mod, log):
        ctl = mod.AdmissionController(mod.AdmissionPolicy(
            default=mod.TenantPolicy(weight=0.25)))
        for i in range(4):
            ctl.push("a", i)
        _try(log, ctl.select, 4)
        _try(log, ctl.select, 4)

    log = _both(scenario)
    assert len(log[0][1]) == 4


# -- scheduler integration -----------------------------------------------------

def test_flooding_tenant_cannot_starve_another():
    """Under a FIFO drain, 100 queued requests from tenant A would push
    tenant B's single request 13 ticks out (max_batch=8).  With WRR B's
    request rides the FIRST tick."""
    svc = _fill(_svc())
    sched = MemoryScheduler(svc, start=False)
    sched.max_batch = 8
    flood = sched.submit_many(
        [RetrieveRequest("a/c0", "Which city?") for _ in range(100)])
    single = sched.submit(RetrieveRequest("b/c0", "Which city?"))
    sched.run_tick_once()
    assert single.done(), "WRR must grant the light tenant a slot in the " \
                          "first tick despite 100 queued ahead of it"
    # A is capped at its fair share of the tick (8/2 tenants = 4): it can
    # not absorb the slots B left unused and inflate the tick
    assert sum(f.done() for f in flood) == 4
    while sched.admission.total_queued:
        sched.run_tick_once()
    assert all(f.result().ok for f in flood)
    assert single.result().ok
    sched.close()


def test_scheduler_rate_limit_surfaces_as_admission_error():
    svc = _fill(_svc())
    sched = MemoryScheduler(svc, start=False, admission=AdmissionPolicy(
        tenants={"a": TenantPolicy(rate=0.001, burst=2)}))
    sched.submit_many([RetrieveRequest("a/c0", "q")] * 2)
    with pytest.raises(AdmissionError):
        sched.submit(RetrieveRequest("a/c0", "q"))
    # the other tenant is untouched by a's limit
    fut = sched.submit(RetrieveRequest("b/c0", "q"))
    while sched.admission.total_queued:
        sched.run_tick_once()
    assert fut.result().ok
    sched.close()


def test_default_policy_admits_everything_fifo():
    """No limits configured -> every request admitted, and read-your-writes
    across tenants still holds because execution re-sorts to submission
    order."""
    svc = _fill(_svc())
    sched = MemoryScheduler(svc, start=False)
    futs = sched.submit_many(
        [RetrieveRequest("a/c0", "q"), RetrieveRequest("b/c0", "q")] * 10)
    sched.run_tick_once()
    assert all(f.done() and f.result().ok for f in futs)
    st = sched.stats()
    assert st["admission"]["admitted"] == 20
    assert st["admission"]["shed"] == 0
    sched.close()


def test_stats_exposes_per_tenant_accounting():
    svc = _fill(_svc())
    sched = MemoryScheduler(svc, start=False, admission=AdmissionPolicy(
        tenants={"a": TenantPolicy(weight=2.0, max_queued=1)}))
    sched.submit(RetrieveRequest("a/c0", "q"))
    with pytest.raises(AdmissionError):
        sched.submit(RetrieveRequest("a/c0", "q"))
    adm = sched.stats()["admission"]
    assert adm["tenants"]["a"]["queued"] == 1
    assert adm["tenants"]["a"]["shed"] == 1
    assert adm["tenants"]["a"]["weight"] == 2.0
    sched.run_tick_once()
    sched.close()


# -- wedged-daemon close (no stranded futures) ---------------------------------

class _WedgingService:
    """A service whose execute() blocks until released — the stuck-device
    stand-in for close()'s wedged-daemon path."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.scheduler = None
        self.runtime = None

    def execute(self, requests):
        self.entered.set()
        self.release.wait(timeout=30)
        return [f"payload-{r.query}" for r in requests]


def test_close_resolves_stranded_futures_when_daemon_wedged():
    svc = _WedgingService()
    sched = MemoryScheduler(svc, tick_interval_s=0.001, max_batch=1)
    wedged = sched.submit(RetrieveRequest("a/c0", "in-flight"))
    assert svc.entered.wait(timeout=5)                # tick is now stuck
    stranded = [sched.submit(RetrieveRequest("a/c0", f"queued-{i}"))
                for i in range(3)]
    t0 = time.monotonic()
    sched.close(timeout=0.2)
    assert time.monotonic() - t0 < 5
    for f in stranded:
        resp = f.result(timeout=1)                    # must NOT hang
        assert resp.status == "error"
        assert "wedged" in resp.error
        assert resp.op == "retrieve"
    assert not wedged.done()                          # stayed with its tick
    svc.release.set()                                 # daemon recovers
    assert wedged.result(timeout=5).ok                # resolves normally
    # a recovered daemon's late set_result on error-resolved futures is
    # swallowed — close() already gave those callers their answer
    for f in stranded:
        assert f.result().status == "error"


def test_close_runs_queue_when_daemon_healthy():
    svc = _fill(_svc())
    sched = MemoryScheduler(svc, start=False)
    futs = sched.submit_many([RetrieveRequest("a/c0", "q")] * 5)
    sched.close()                                     # drains, no daemon
    assert all(f.result().ok for f in futs)


# -- counter consistency under concurrency -------------------------------------

def test_stats_snapshot_consistent_under_concurrent_ticks():
    svc = _fill(_svc())
    sched = MemoryScheduler(svc, tick_interval_s=0.0005, max_batch=8)
    stop = threading.Event()
    torn, reads = [], [0]

    def reader():
        while not stop.is_set():
            st = sched.stats()
            # requests is bumped in the same locked block as ticks: a
            # snapshot can never show requests without its tick
            if st["requests"] < st["max_tick_batch"]:
                torn.append(st)
            reads[0] += 1
            # hand the interpreter on between snapshots: a reader spinning
            # on the GIL would starve the tick thread it is checking
            time.sleep(0)

    t = threading.Thread(target=reader)
    t.start()
    for _ in range(30):
        fs = sched.submit_many([RetrieveRequest("a/c0", "q")] * 4)
        for f in fs:
            f.result(timeout=10)
    stop.set()
    t.join()
    sched.close()
    assert not torn
    assert reads[0] >= 30, "the reader must overlap the ticks"


def test_record_requests_share_tenant_accounting():
    svc = _svc()
    sched = MemoryScheduler(svc, start=False, admission=AdmissionPolicy(
        tenants={"a": TenantPolicy(max_queued=1)}))
    sched.submit(RecordRequest("a/c0", "s0",
                               (Message("U", "hello", 1.0),)))
    with pytest.raises(AdmissionError) as ei:
        sched.submit(RecordRequest("a/c1", "s1",
                                   (Message("U", "hi", 2.0),)))
    assert ei.value.reason == "tenant_queue_full"
    sched.run_tick_once()
    sched.close()


def test_port_controller_is_its_own_class():
    """The port's controller and error are its own (no reference import),
    with the reference's names."""
    assert AdmissionController.__module__ == "repro_torch.core.admission"
    assert AdmissionError.__module__ == "repro_torch.core.admission"
    assert not issubclass(AdmissionError, jadm.AdmissionError)
