"""Per-tenant weighted round-robin admission + latency accounting (a copy of
``repro.serving.fairness``; the port imports nothing of the reference).

Production TM traffic is multi-tenant (ROADMAP: many small models, many
callers); a single FIFO lets one hot tenant monopolise every batch and
starve everyone else's tail latency. ``TenantQueues`` keeps one FIFO per
tenant and drains them weighted-round-robin: each pass over the tenant
ring lets tenant *t* contribute up to ``weight(t)`` rows, so a tenant
flooding the backlog gets at most its weighted share of each batch while
light tenants keep their rows flowing. The ring start rotates per ``take``
so no tenant owns the front of every batch.

Pure data structure — no threads, no clocks — so fairness is unit-testable
deterministically (tests/test_torch_serving.py drives a hot tenant against
cold ones and asserts interleaving). ``TenantStats`` is the per-tenant
ledger the server keeps next to it: admitted/rejected/served counts and
completion latencies, summarised per tenant by ``AsyncTMServer.stats``.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class TenantStats:
    """Admission and completion ledger for one tenant."""

    admitted: int = 0
    rejected: int = 0
    served: int = 0
    latency_s: list = dataclasses.field(default_factory=list)

    def record(self, latency_s: float) -> None:
        """Count one completed request and its arrival→completion latency."""
        self.served += 1
        self.latency_s.append(latency_s)

    def summary(self) -> dict:
        """JSON-ready record: counts + p50/p95/p99 latency (ms)."""
        out = {"admitted": self.admitted, "rejected": self.rejected,
               "served": self.served}
        if self.latency_s:
            lat = np.asarray(self.latency_s) * 1e3
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            out["latency_ms"] = {"p50": round(float(p50), 3),
                                 "p95": round(float(p95), 3),
                                 "p99": round(float(p99), 3),
                                 "mean": round(float(lat.mean()), 3)}
        return out


class TenantQueues:
    """Per-tenant FIFOs drained by weighted round-robin.

    ``weights`` maps tenant name → positive integer rows-per-pass
    (unlisted tenants get ``default_weight``). Not thread-safe by itself —
    the server serialises access under its own condition lock.
    """

    def __init__(self, weights: dict[str, int] | None = None,
                 default_weight: int = 1):
        if default_weight < 1:
            raise ValueError(f"default_weight must be >= 1, got "
                             f"{default_weight}")
        for t, w in (weights or {}).items():
            if w < 1:
                raise ValueError(f"weight for tenant {t!r} must be >= 1, "
                                 f"got {w}")
        self._weights = dict(weights or {})
        self._default = default_weight
        self._queues: dict[str, deque] = {}
        self._ring: list[str] = []  # tenant order, fixed at first push
        self._cursor = 0
        self._n = 0

    def weight(self, tenant: str) -> int:
        """Rows tenant may contribute per round-robin pass."""
        return self._weights.get(tenant, self._default)

    def push(self, tenant: str, item) -> None:
        """Append one item to the tenant's FIFO (admission already done)."""
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._ring.append(tenant)
        q.append(item)
        self._n += 1

    def __len__(self) -> int:
        """Total queued items across every tenant."""
        return self._n

    def tenants(self) -> tuple[str, ...]:
        """Every tenant seen so far, in ring order."""
        return tuple(self._ring)

    def take(self, max_items: int) -> list:
        """Drain up to ``max_items`` by weighted round-robin.

        Repeated passes over the tenant ring, each tenant contributing up
        to its weight per pass, until the batch is full or every queue is
        empty; FIFO order is preserved within a tenant. The starting
        tenant rotates across calls.
        """
        out: list = []
        if not self._ring:
            return out
        start = self._cursor
        self._cursor = (self._cursor + 1) % len(self._ring)
        while len(out) < max_items and self._n:
            took_any = False
            for off in range(len(self._ring)):
                tenant = self._ring[(start + off) % len(self._ring)]
                q = self._queues[tenant]
                k = min(self.weight(tenant), max_items - len(out), len(q))
                for _ in range(k):
                    out.append(q.popleft())
                self._n -= k
                took_any = took_any or k > 0
                if len(out) >= max_items:
                    break
            if not took_any:
                break
        return out
