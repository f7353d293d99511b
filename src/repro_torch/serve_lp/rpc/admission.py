"""Admission control: everything that happens to a request *before* it
may touch the scheduler.

The layers run in a fixed order, cheapest first, and every rejection is
a typed 4xx (:class:`RpcError` carries the HTTP status, a stable
machine-readable ``code``, and — for retryable rejections — a
``Retry-After`` hint):

1. **validation** — the JSON body is parsed into ``(A (m,2), b (m,),
   c (2,))`` problems with shape/dtype/m-bounds/finiteness checked
   eagerly (400/413/422 before any scheduler state is touched);
2. **deadline** — requests carry a latency budget (``X-Deadline-Ms``
   header or ``deadline_ms`` body field); one that arrives already
   expired is rejected with 504 instead of solved, and the server
   cancels still-queued work when the budget runs out mid-flight;
3. **quota** — per-tenant token buckets (:mod:`.quota`), 429 +
   ``Retry-After`` on exhaustion;
4. **backpressure** — load is shed with 429 when the scheduler is
   demonstrably behind: the in-flight flush depth has hit the scheduler's
   ``max_inflight`` backpressure bound *and* the submit queues are deep,
   or the oldest queued request has aged past ``max_queue_age_s``
   (flushes not keeping up with arrivals).  Shedding keeps the queue
   bounded — overload turns into fast 429s, never an unbounded queue.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

DEADLINE_HEADER = "x-deadline-ms"
TENANT_HEADER = "x-tenant"


class RpcError(Exception):
    """A typed request rejection: HTTP status + stable error code.

    ``retry_after_s`` (when set) becomes a ``Retry-After`` response
    header — present on retryable 429s, absent on malformed-request
    4xxs that retrying cannot fix.
    """

    def __init__(self, status: int, code: str, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.status = int(status)
        self.code = str(code)
        self.message = str(message)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Bounds the admission layer enforces before the scheduler."""

    m_max: int = 4096             # per-problem constraint-count cap
    batch_max: int = 1024         # LPs per request cap
    body_max_bytes: int = 8 << 20
    max_pending: int = 4096       # shed when queues this deep and
                                  # in-flight depth is at its bound
    max_queue_age_s: float = 0.5  # shed when the oldest queued request
                                  # has waited this long
    shed_retry_after_s: float = 0.05
    default_deadline_s: Optional[float] = None  # None = no deadline

    def __post_init__(self):
        if self.m_max < 1:
            raise ValueError(f"m_max={self.m_max} < 1")
        if self.batch_max < 1:
            raise ValueError(f"batch_max={self.batch_max} < 1")


# -- validation ------------------------------------------------------------

Problem = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _as_problem(obj: Any, dtype: np.dtype, policy: AdmissionPolicy,
                where: str) -> Problem:
    if not isinstance(obj, dict):
        raise RpcError(422, "bad_problem",
                       f"{where}: each problem must be an object with "
                       "A, b, c")
    missing = [k for k in ("A", "b", "c") if k not in obj]
    if missing:
        raise RpcError(422, "missing_field",
                       f"{where}: missing {', '.join(missing)}")
    try:
        A = np.asarray(obj["A"], dtype)
        b = np.asarray(obj["b"], dtype)
        c = np.asarray(obj["c"], dtype)
    except (TypeError, ValueError) as e:
        raise RpcError(422, "bad_dtype",
                       f"{where}: A/b/c must be numeric arrays ({e})")
    if A.ndim != 2 or A.shape[1] != 2:
        raise RpcError(422, "bad_shape",
                       f"{where}: A must be (m, 2), got {A.shape}")
    m = A.shape[0]
    if m < 1:
        raise RpcError(422, "m_out_of_bounds",
                       f"{where}: need at least 1 constraint")
    if m > policy.m_max:
        raise RpcError(422, "m_out_of_bounds",
                       f"{where}: m={m} exceeds the server bound "
                       f"m_max={policy.m_max}")
    if b.shape != (m,):
        raise RpcError(422, "bad_shape",
                       f"{where}: b must be ({m},) to match A, got "
                       f"{b.shape}")
    if c.shape != (2,):
        raise RpcError(422, "bad_shape",
                       f"{where}: c must be (2,), got {c.shape}")
    if not (np.isfinite(A).all() and np.isfinite(b).all()
            and np.isfinite(c).all()):
        raise RpcError(422, "nonfinite",
                       f"{where}: A/b/c must be finite (no NaN/inf)")
    return A, b, c


def parse_solve_payload(body: bytes, dtype: np.dtype,
                        policy: AdmissionPolicy
                        ) -> Tuple[List[Problem], bool]:
    """Parse a ``POST /v1/solve`` body into validated problems.

    Accepts the single form ``{"A": ..., "b": ..., "c": ...}`` and the
    batch form ``{"problems": [{...}, ...]}``.  Returns ``(problems,
    is_batch)``; every rejection is a typed :class:`RpcError` raised
    before any scheduler state is touched.
    """
    if len(body) > policy.body_max_bytes:
        raise RpcError(413, "body_too_large",
                       f"request body {len(body)}B exceeds "
                       f"{policy.body_max_bytes}B")
    try:
        payload = json.loads(body)
    except (ValueError, UnicodeDecodeError) as e:
        raise RpcError(400, "bad_json", f"request body is not JSON ({e})")
    if not isinstance(payload, dict):
        raise RpcError(400, "bad_request",
                       "request body must be a JSON object")
    if "problems" in payload:
        probs = payload["problems"]
        if not isinstance(probs, list) or not probs:
            raise RpcError(422, "bad_request",
                           "problems must be a non-empty array")
        if len(probs) > policy.batch_max:
            raise RpcError(413, "batch_too_large",
                           f"{len(probs)} problems exceeds the server "
                           f"bound batch_max={policy.batch_max}")
        return ([_as_problem(p, dtype, policy, f"problems[{i}]")
                 for i, p in enumerate(probs)], True)
    return [_as_problem(payload, dtype, policy, "body")], False


# -- deadlines -------------------------------------------------------------

def deadline_budget_s(headers: Dict[str, str], payload_deadline_ms: Any,
                      policy: AdmissionPolicy) -> Optional[float]:
    """The request's latency budget in seconds (relative — a budget,
    not a wall-clock instant, so client/server clock skew is
    irrelevant).  Header wins over body field wins over the policy
    default; ``None`` means no deadline."""
    raw = headers.get(DEADLINE_HEADER, payload_deadline_ms)
    if raw is None:
        return policy.default_deadline_s
    try:
        ms = float(raw)
    except (TypeError, ValueError):
        raise RpcError(400, "bad_deadline",
                       f"deadline must be a number of milliseconds, "
                       f"got {raw!r}")
    if not math.isfinite(ms) or ms <= 0.0:
        raise RpcError(400, "bad_deadline",
                       f"deadline_ms={ms} must be finite and > 0")
    return ms / 1e3


# -- backpressure ----------------------------------------------------------

def check_backpressure(scheduler, policy: AdmissionPolicy,
                       now: Optional[float] = None) -> None:
    """Shed load (429) when the scheduler is measurably behind.

    Two independent signals, either sheds:

    * *depth*: the in-flight flush gauge has hit the scheduler's
      ``max_inflight`` backpressure bound (dispatch would block) **and**
      the submit queues already hold ``max_pending`` requests — the
      device is saturated and a backlog is forming;
    * *age*: the oldest queued request has waited longer than
      ``max_queue_age_s`` — flushes are not keeping up with arrivals,
      so admitting more work can only grow the queue.
    """
    pending = scheduler.pending()
    if (pending >= policy.max_pending
            and scheduler.inflight >= scheduler.max_inflight):
        raise RpcError(
            429, "overloaded",
            f"server overloaded: {pending} LPs queued with the "
            f"in-flight flush depth at its bound "
            f"({scheduler.max_inflight})",
            retry_after_s=policy.shed_retry_after_s)
    age = scheduler.queue_age_s(now if now is not None
                                else time.perf_counter())
    if age > policy.max_queue_age_s:
        raise RpcError(
            429, "overloaded",
            f"server overloaded: oldest queued request has waited "
            f"{age * 1e3:.0f}ms (> {policy.max_queue_age_s * 1e3:.0f}ms)",
            retry_after_s=policy.shed_retry_after_s)
