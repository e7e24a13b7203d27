"""Admission control for the memory scheduler — per-tenant QoS.

A strictly FIFO scheduler queue lets one abusive client flooding
`submit()` push every other tenant's requests behind its own, so the
abuser dictates everyone's tail latency.  This module replaces the FIFO
drain with the slot/admission dataflow of the serving engine applied to
the memory layer: requests are *admitted* (or shed) at submit time, and
each tick *selects* its batch across per-tenant queues instead of popping
a shared deque.

Three mechanisms, all policy-driven (`AdmissionPolicy` / `TenantPolicy`):

* **weighted round-robin within a tick** — deficit round-robin over the
  tenants that have queued work: tenant i earns `weight_i` credits per
  round and spends one per granted request, so a tick's `max_batch` slots
  split proportionally to weight no matter how deep any one queue is —
  and each tenant is *capped* at its share, so a flood cannot absorb the
  slots lighter tenants left unused and inflate every tick's execution
  time (a tenant queueing alone still gets the whole tick).  A tenant's
  own requests stay FIFO (read-your-writes within a tenant is
  preserved); cross-tenant order inside a tick is irrelevant — namespaces
  are isolated, and every future in a tick resolves at the same tick end.
* **priority classes** — strict priority between classes (lower number
  wins): a tick grants no `PRIORITY_LOW` slot while any `PRIORITY_HIGH`
  tenant still has queued work.  WRR applies within each class.
* **rate limits + load shedding** — a per-tenant token bucket
  (`rate` req/s, `burst` capacity) rejects floods at submit time, a
  per-tenant queue cap (`max_queued`) bounds how much backlog any tenant
  can park, and a global cap (`max_queued_global`) sheds tenants sitting
  above their weight-proportional fair share while still admitting the
  tenants below it.  Every rejection raises `AdmissionError` carrying a
  `retry_after_s` hint — the HTTP frontend maps it to 429 + Retry-After.

The controller is deliberately lock-free: the scheduler calls it under
its own condition lock (`MemoryScheduler._cv`), which also makes the unit
deterministic — tests drive `admit` / `select` directly with an injected
clock.  Pure Python: nothing here touches a device.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2


class AdmissionError(RuntimeError):
    """A request was refused admission (rate limit / queue cap / overload).

    `reason` is one of "rate_limited" | "tenant_queue_full" | "overloaded";
    `retry_after_s` is the backoff hint the frontend puts on the wire
    (429 + Retry-After)."""

    def __init__(self, message: str, reason: str, retry_after_s: float,
                 tenant: str = ""):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.tenant = tenant


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """One tenant's QoS contract.

    `weight` is the tenant's WRR share within its priority class;
    `priority` its class (strict between classes); `rate`/`burst` the
    token bucket (None = unlimited); `max_queued` its backlog cap
    (None = unbounded)."""
    weight: float = 1.0
    priority: int = PRIORITY_NORMAL
    rate: Optional[float] = None
    burst: int = 32
    max_queued: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError("weight must be > 0")
        if self.rate is not None and self.rate <= 0:
            raise ValueError("rate must be > 0 (or None for unlimited)")
        if self.burst < 1:
            raise ValueError("burst must be >= 1")
        if self.max_queued is not None and self.max_queued < 1:
            raise ValueError("max_queued must be >= 1")


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """The scheduler-wide QoS policy: a default tenant contract, explicit
    per-tenant overrides, and the global shed threshold.  The default
    policy (all None) admits everything in arrival order — byte-for-byte
    the behavior a limit-free deployment expects."""
    default: TenantPolicy = TenantPolicy()
    tenants: Mapping[str, TenantPolicy] = \
        dataclasses.field(default_factory=dict)
    max_queued_global: Optional[int] = None
    shed_retry_after_s: float = 0.5
    # how long a tenant that admitted work keeps its fair-share
    # reservation after its queue momentarily empties (closed-loop clients
    # are queue-empty exactly while their previous tick executes — without
    # the window, a flood grabs the whole tick in that gap)
    share_window_s: float = 0.1

    def __post_init__(self):
        if self.max_queued_global is not None and self.max_queued_global < 1:
            raise ValueError("max_queued_global must be >= 1")
        if self.share_window_s < 0:
            raise ValueError("share_window_s must be >= 0")

    def for_tenant(self, tenant: str) -> TenantPolicy:
        return self.tenants.get(tenant, self.default)


class _TenantState:
    __slots__ = ("policy", "queue", "deficit", "tokens", "refilled_at",
                 "last_admit", "admitted", "rate_limited", "shed")

    def __init__(self, policy: TenantPolicy, now: float):
        self.policy = policy
        self.queue: deque = deque()
        self.deficit = 0.0
        self.tokens = float(policy.burst)
        self.refilled_at = now
        self.last_admit = now
        self.admitted = 0
        self.rate_limited = 0
        self.shed = 0

    def refill(self, now: float) -> None:
        if self.policy.rate is None:
            return
        # clamp: a caller's `now` captured just before this state was
        # created would otherwise refill by a NEGATIVE elapsed time and
        # drain tokens the tenant never spent
        elapsed = max(0.0, now - self.refilled_at)
        self.tokens = min(float(self.policy.burst),
                          self.tokens + elapsed * self.policy.rate)
        self.refilled_at = max(now, self.refilled_at)


class AdmissionController:
    """Per-tenant queues + the admit/select policy over them.

    NOT internally locked: the scheduler serializes every call under its
    condition lock.  `clock` is injectable so rate-limit tests are
    deterministic."""

    def __init__(self, policy: Optional[AdmissionPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy or AdmissionPolicy()
        self.clock = clock
        self._tenants: Dict[str, _TenantState] = {}   # insertion-ordered
        self._rr_offset = 0
        self._total = 0
        self.counters = {"admitted": 0, "rate_limited": 0, "shed": 0,
                         "policy_reloads": 0}

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = _TenantState(self.policy.for_tenant(tenant), self.clock())
            self._tenants[tenant] = st
        return st

    def set_policy(self, policy: AdmissionPolicy) -> None:
        """Swap the mounted policy in place — the dynamic-reload path (the
        frontend's authenticated admin endpoint, via
        `MemoryScheduler.set_admission_policy`).  Existing tenant states
        keep their queues and counters but re-bind to the new policy's
        contract: each bucket refills under the OLD rate first (tokens
        earned are kept), then clamps to the new burst so a shrunken limit
        takes effect immediately instead of after the old burst drains.
        Caller must hold whatever lock serializes admit/select (the
        scheduler's condition lock)."""
        if not isinstance(policy, AdmissionPolicy):
            raise TypeError(f"set_policy takes an AdmissionPolicy, got "
                            f"{type(policy).__name__}")
        now = self.clock()
        self.policy = policy
        for name, st in self._tenants.items():
            st.refill(now)               # settle earnings under the old rate
            st.policy = policy.for_tenant(name)
            st.tokens = min(st.tokens, float(st.policy.burst))
        self.counters["policy_reloads"] += 1

    # -- admit --------------------------------------------------------------
    def admit_batch(self, counts: Sequence[Tuple[str, int]]) -> None:
        """All-or-nothing admission of `n` requests per tenant: every
        check runs before any token is consumed or any counter moves, so a
        rejected submit_many leaves no half-admitted residue."""
        now = self.clock()
        states = []
        for tenant, n in counts:
            st = self._state(tenant)
            st.refill(now)
            p = st.policy
            if p.rate is not None and st.tokens < n:
                st.rate_limited += n
                self.counters["rate_limited"] += n
                raise AdmissionError(
                    f"tenant {tenant!r} over its rate limit "
                    f"({p.rate:g} req/s, burst {p.burst})",
                    reason="rate_limited",
                    retry_after_s=max(0.0, (n - st.tokens) / p.rate),
                    tenant=tenant)
            if p.max_queued is not None \
                    and len(st.queue) + n > p.max_queued:
                st.shed += n
                self.counters["shed"] += n
                raise AdmissionError(
                    f"tenant {tenant!r} backlog full "
                    f"({len(st.queue)}/{p.max_queued} queued)",
                    reason="tenant_queue_full",
                    retry_after_s=self.policy.shed_retry_after_s,
                    tenant=tenant)
            gcap = self.policy.max_queued_global
            if gcap is not None and self._total + n > gcap:
                # under global pressure, shed only the tenants sitting
                # above their weight-proportional fair share — the tenants
                # below it keep getting admitted (soft overflow), so one
                # flood cannot close the door on everyone
                if len(st.queue) + n > self._fair_share(st, gcap):
                    st.shed += n
                    self.counters["shed"] += n
                    raise AdmissionError(
                        f"queue overloaded ({self._total}/{gcap}) and "
                        f"tenant {tenant!r} is above its fair share",
                        reason="overloaded",
                        retry_after_s=self.policy.shed_retry_after_s,
                        tenant=tenant)
            states.append((st, n))
        for st, n in states:
            if st.policy.rate is not None:
                st.tokens -= n
            st.admitted += n
            st.last_admit = now
            self.counters["admitted"] += n

    def _fair_share(self, st: _TenantState, gcap: int) -> float:
        active = [s for s in self._tenants.values() if s.queue]
        if st not in active:
            active.append(st)
        total_w = sum(s.policy.weight for s in active)
        return max(1.0, gcap * st.policy.weight / total_w)

    # -- queues -------------------------------------------------------------
    def push(self, tenant: str, item) -> None:
        self._state(tenant).queue.append(item)
        self._total += 1

    @property
    def total_queued(self) -> int:
        return self._total

    def drain_all(self) -> List:
        """Empty every queue (tenant arrival order, FIFO within a tenant).
        Used by close() to resolve stranded futures."""
        out: List = []
        for st in self._tenants.values():
            out.extend(st.queue)
            st.queue.clear()
            st.deficit = 0.0
        self._total = 0
        return out

    # -- select (the tick's drain) ------------------------------------------
    def select(self, max_batch: int) -> List:
        """Pick up to `max_batch` queued items: strict priority between
        classes, deficit round-robin across the class's tenants, FIFO
        within each tenant.  Selection only decides WHO gets a slot — the
        scheduler re-sorts the selected batch into global submission order
        before executing it (intra-tick order is side-effect semantics,
        not fairness: every future in a tick resolves at the tick end).

        Slots are NOT work-conserving across tenants: each tenant is
        capped at its weight-proportional share of `max_batch`, frozen
        when its priority class first forms a ring this call.  A flooding
        tenant therefore cannot absorb the slots other tenants did not
        use — which would inflate the tick's batch (and its execution
        time, the thing every future in the tick waits on) far past what
        the well-behaved load alone needs.  A tenant queueing alone still
        gets the whole tick (its share of the ring is 1), so a
        single-tenant deployment keeps full batches."""
        out: List = []
        caps: Dict[int, int] = {}       # id(state) -> slot cap this call
        grants: Dict[int, int] = {}
        while len(out) < max_batch:
            active = [s for s in self._tenants.values() if s.queue
                      and grants.get(id(s), 0) < caps.get(id(s), max_batch)]
            if not active:
                break
            prio = min(s.policy.priority for s in active)
            ring = [s for s in active if s.policy.priority == prio]
            uncapped = [s for s in ring if id(s) not in caps]
            if uncapped:
                # entry-time fair share — computed over the class's queued
                # tenants PLUS its recently-admitting ones.  Closed-loop
                # clients are queue-empty exactly while their previous
                # tick executes; counting them for `share_window_s` after
                # their last admit stops a flood from claiming the whole
                # tick in that gap, while a tenant that is genuinely alone
                # (nobody else admitted within the window) still gets the
                # full batch
                now = self.clock()
                share = [s for s in self._tenants.values()
                         if s.policy.priority == prio
                         and (s.queue or now - s.last_admit
                              <= self.policy.share_window_s)]
                total_w = sum(s.policy.weight for s in share)
                for s in uncapped:
                    caps[id(s)] = max(1, math.ceil(
                        max_batch * s.policy.weight / total_w))
            # rotate the starting tenant across calls so equal-weight
            # tenants do not always drain in the same order
            start = self._rr_offset % len(ring)
            ring = ring[start:] + ring[:start]
            progressed = False
            for st in ring:
                if not st.queue or len(out) >= max_batch:
                    continue
                st.deficit += st.policy.weight
                take = min(int(st.deficit), len(st.queue),
                           max_batch - len(out),
                           caps[id(st)] - grants.get(id(st), 0))
                if take > 0:
                    for _ in range(take):
                        out.append(st.queue.popleft())
                    st.deficit -= take
                    self._total -= take
                    grants[id(st)] = grants.get(id(st), 0) + take
                    progressed = True
                if not st.queue:
                    # standard DRR: idle tenants bank no credit
                    st.deficit = 0.0
            if not progressed:
                # every below-cap deficit is still fractional (weights
                # < 1): loop — deficits grow by weight > 0 per round, so
                # progress is guaranteed (capped tenants left the active
                # set above)
                continue
        self._rr_offset += 1
        return out

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        per_tenant = {
            name: {"queued": len(st.queue), "admitted": st.admitted,
                   "rate_limited": st.rate_limited, "shed": st.shed,
                   "weight": st.policy.weight,
                   "priority": st.policy.priority}
            for name, st in self._tenants.items()}
        return dict(self.counters, queued=self._total, tenants=per_tenant)


# -- wire codec (the frontend's policy-reload endpoint) ----------------------
def tenant_policy_from_json(obj: dict) -> TenantPolicy:
    """One JSON object -> TenantPolicy, validated by the dataclass's own
    __post_init__ checks.  Unknown keys are rejected — a typo'd knob in an
    operator's reload payload must fail loudly, not silently no-op."""
    if not isinstance(obj, dict):
        raise ValueError("tenant policy must be a JSON object")
    known = {"weight", "priority", "rate", "burst", "max_queued"}
    unknown = sorted(set(obj) - known)
    if unknown:
        raise ValueError(f"unknown tenant policy keys {unknown}; "
                         f"known: {sorted(known)}")
    return TenantPolicy(
        weight=float(obj.get("weight", 1.0)),
        priority=int(obj.get("priority", PRIORITY_NORMAL)),
        rate=None if obj.get("rate") is None else float(obj["rate"]),
        burst=int(obj.get("burst", 32)),
        max_queued=(None if obj.get("max_queued") is None
                    else int(obj["max_queued"])))


def admission_policy_from_json(obj: dict) -> AdmissionPolicy:
    """The reload endpoint's body -> AdmissionPolicy."""
    if not isinstance(obj, dict):
        raise ValueError("admission policy must be a JSON object")
    known = {"default", "tenants", "max_queued_global", "shed_retry_after_s",
             "share_window_s"}
    unknown = sorted(set(obj) - known)
    if unknown:
        raise ValueError(f"unknown admission policy keys {unknown}; "
                         f"known: {sorted(known)}")
    tenants = obj.get("tenants", {})
    if not isinstance(tenants, dict):
        raise ValueError("'tenants' must be an object of per-tenant "
                         "policies")
    kw: dict = {
        "default": tenant_policy_from_json(obj.get("default", {})),
        "tenants": {str(k): tenant_policy_from_json(v)
                    for k, v in tenants.items()},
        "max_queued_global": (None if obj.get("max_queued_global") is None
                              else int(obj["max_queued_global"])),
    }
    if obj.get("shed_retry_after_s") is not None:
        kw["shed_retry_after_s"] = float(obj["shed_retry_after_s"])
    if obj.get("share_window_s") is not None:
        kw["share_window_s"] = float(obj["share_window_s"])
    return AdmissionPolicy(**kw)


def tenant_of(request) -> str:
    """Default tenant identity for in-process submissions: the namespace
    segment before the first '/' (the repo's `user/conversation` keying),
    or the whole namespace when it has no '/'.  Requests without a
    namespace (CompactRequest) belong to the system tenant.  The HTTP
    frontend overrides this with the api-key-derived tenant."""
    ns = getattr(request, "namespace", None)
    if ns is None:
        return "__system__"
    return ns.split("/", 1)[0] if "/" in ns else ns
