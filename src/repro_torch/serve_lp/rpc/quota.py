"""Per-tenant token-bucket quotas for the RPC front end.

Every solve request carries a tenant identity (the ``X-Tenant`` header;
absent means the shared ``"anonymous"`` bucket).  Each tenant gets a
classic token bucket: tokens refill continuously at ``rate`` LPs/s up
to a ``burst`` cap, and admitting a request costs one token per LP in
it — so a tenant can burst up to ``burst`` LPs instantly but sustains
only ``rate``.  Rejections are *priced*: :meth:`TokenBucket.try_take`
returns the seconds until enough tokens will have refilled, which the
server surfaces as ``Retry-After`` so well-behaved clients back off by
exactly the right amount instead of hammering.

The clock is injectable (monotonic seconds) so tests drive refill
deterministically without sleeping.  All state is lock-guarded: the
asyncio handler awaits in one thread but the bench and metrics scrape
read counters from others.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, Optional, Tuple

DEFAULT_TENANT = "anonymous"


class TokenBucket:
    """One tenant's continuously-refilling token bucket."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if not rate > 0.0:
            raise ValueError(f"rate={rate} must be > 0 LPs/s")
        if not burst >= 1.0:
            raise ValueError(f"burst={burst} must be >= 1")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t_last = clock()

    def _refill(self, now: float) -> None:
        if now > self._t_last:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t_last)
                               * self.rate)
        self._t_last = now

    def try_take(self, cost: float = 1.0) -> float:
        """Admit a request costing ``cost`` tokens.

        Returns 0.0 on admission (tokens deducted).  Otherwise returns
        the seconds until the bucket will hold ``cost`` tokens — no
        deduction — which is the honest ``Retry-After``.  A cost above
        ``burst`` can never be admitted and returns ``inf`` (the caller
        should reject it as oversized rather than retryable).
        """
        if cost > self.burst:
            return math.inf
        self._refill(self._clock())
        if self._tokens >= cost:
            self._tokens -= cost
            return 0.0
        return (cost - self._tokens) / self.rate

    @property
    def tokens(self) -> float:
        self._refill(self._clock())
        return self._tokens


class QuotaManager:
    """Tenant -> bucket map with admission accounting.

    ``per_tenant`` optionally overrides ``(rate, burst)`` for named
    tenants (everyone else gets the defaults); buckets are created
    lazily on first sight of a tenant.  Counters (admitted / rejected
    LPs per tenant) feed the Prometheus exposition.
    """

    def __init__(self, rate: float = 10_000.0, burst: float = 2_000.0,
                 per_tenant: Optional[Dict[str, Tuple[float, float]]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._rate = float(rate)
        self._burst = float(burst)
        self._per_tenant = dict(per_tenant or {})
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self.admitted: Dict[str, int] = {}
        self.rejected: Dict[str, int] = {}

    def _bucket(self, tenant: str) -> TokenBucket:
        bucket = self._buckets.get(tenant)
        if bucket is None:
            rate, burst = self._per_tenant.get(
                tenant, (self._rate, self._burst))
            bucket = self._buckets[tenant] = TokenBucket(
                rate, burst, clock=self._clock)
        return bucket

    def admit(self, tenant: str, cost: float = 1.0) -> float:
        """0.0 = admitted (cost deducted); positive = rejected, retry
        after that many seconds; ``inf`` = never admissible (cost
        exceeds the tenant's burst)."""
        with self._lock:
            retry = self._bucket(tenant).try_take(cost)
            if retry == 0.0:
                self.admitted[tenant] = (self.admitted.get(tenant, 0)
                                         + int(cost))
            else:
                self.rejected[tenant] = (self.rejected.get(tenant, 0)
                                         + int(cost))
            return retry

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant accounting for /metrics."""
        with self._lock:
            tenants = (set(self._buckets) | set(self.admitted)
                       | set(self.rejected))
            return {
                t: {
                    "admitted": self.admitted.get(t, 0),
                    "rejected": self.rejected.get(t, 0),
                    "tokens": (self._buckets[t].tokens
                               if t in self._buckets else 0.0),
                }
                for t in sorted(tenants)
            }
