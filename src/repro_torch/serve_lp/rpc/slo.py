"""SLO-driven batching: derive ``max_batch``/``max_wait_s`` per bucket
from *measured* flush latency instead of a guessed timer.

A request's worst-case latency through the scheduler decomposes as::

    wait-trigger timer  +  flush ahead of it  +  its own flush
    (max_wait_s)           (~est_flush_s)        (~est_flush_s)

The tuning table (:mod:`repro_torch.tune`) already records the measured
µs/LP for every (backend, dtype, m-bucket, batch-bucket) shape class —
that is exactly an estimate of flush service time:
``est_flush_s(b) = us_per_lp * b_pad / n_devices``.  Given a stated p99
target, the controller solves the decomposition per m-bucket:

* cap ``max_batch`` so one flush's service time stays within
  ``service_fraction`` of the target (big-m buckets batch less);
* spend the *rest* of the budget on the wait trigger:
  ``max_wait_s = target - 2 * est_flush_s`` (clamped) — measured-slow
  buckets flush sooner, measured-fast buckets are allowed to
  accumulate bigger, more device-efficient batches.

Only ``source == "measured"`` table entries participate (a
heuristic-seeded row carries a sentinel timing that would produce
nonsense waits); buckets without a measured entry keep the
scheduler-wide defaults, so the controller degrades to exactly the
pre-SLO behaviour when no measurements exist.

:meth:`SLOController.install` wires the plans into the scheduler's
per-bucket limits hook (:meth:`BatchScheduler.set_bucket_policy`) and
tightens the scheduler-wide ``max_wait_s`` to the tightest planned
wait so the timer tick is fine-grained enough to honour it.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

from repro_torch.serve_lp.buckets import bucket_batch

# Never plan a wait below this: a sub-millisecond timer burns a CPU on
# tick overhead for no batching benefit.
MIN_WAIT_S = 1e-3

# Never spend more than half the p99 target waiting: the other half
# must cover the two flush service times in the decomposition.
MAX_WAIT_FRACTION = 0.5


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The derived batching limits for one m-bucket.

    ``allow_fuse`` is the fused-flush policy: whether this bucket may
    be folded into a cross-bucket fused flush unit.  Fusing solves the
    bucket's requests at a *larger* ``m_pad`` (the biggest member's),
    so the controller vetoes it when the measured timing at the next
    ladder rung would blow the flush-service budget."""

    bucket_m: int
    max_batch: int
    max_wait_s: float
    est_flush_s: Optional[float]   # None when no measured entry
    source: str                    # "measured" | "default"
    allow_fuse: bool = True


class SLOController:
    """Derives and installs per-bucket batching limits for a p99 target.

    ``table`` overrides the process-wide active tuning table (tests);
    ``device_kind`` overrides the measured-device key.  Plans are
    computed lazily per bucket and cached — the scheduler's submit path
    consults the installed policy on every request.
    """

    def __init__(self, target_p99_s: float, *,
                 service_fraction: float = 0.5,
                 min_batch: int = 8,
                 table=None,
                 device_kind: Optional[str] = None):
        if not target_p99_s > 0.0:
            raise ValueError(f"target_p99_s={target_p99_s} must be > 0")
        if not 0.0 < service_fraction < 1.0:
            raise ValueError(
                f"service_fraction={service_fraction} must be in (0, 1)")
        self.target_p99_s = float(target_p99_s)
        self.service_fraction = float(service_fraction)
        self.min_batch = int(min_batch)
        self._table = table
        self._device_kind = device_kind
        self._plans: Dict[int, BucketPlan] = {}
        self._lock = threading.Lock()
        self._scheduler = None

    # -- the planning model ----------------------------------------------

    def _active_table(self):
        if self._table is not None:
            return self._table
        try:
            from repro_torch.tune.table import active_table
            return active_table()
        except Exception:   # tuning must never take serving down
            return None

    def _measured_us_per_lp(self, scheduler, spec, bm: int,
                            batch: int) -> Optional[float]:
        """Measured µs/LP for this bucket's resolved backend, or None.
        Heuristic-seeded entries are ignored — the controller only
        trusts timings that were actually run.  Rows are looked up for
        the scheduler's devices: ``"cpu"`` for a CPU scheduler, the
        card's name otherwise (unless ``device_kind`` overrides)."""
        table = self._active_table()
        if table is None:
            return None
        kind = self._device_kind
        if kind is None and scheduler._platform == "cpu":
            kind = "cpu"
        try:
            entry = table.lookup(backend=spec.backend, dtype=spec.dtype,
                                 m=bm, batch=batch, device_kind=kind)
        except Exception:
            return None
        if entry is None or entry.source != "measured":
            return None
        return float(entry.us_per_lp)

    def plan_for(self, scheduler, bm: int) -> BucketPlan:
        """The (cached) plan for one m-bucket of one scheduler."""
        with self._lock:
            hit = self._plans.get(bm)
            if hit is not None:
                return hit
        default = BucketPlan(
            bucket_m=bm, max_batch=scheduler.max_batch,
            max_wait_s=scheduler.max_wait_s, est_flush_s=None,
            source="default")
        try:
            plan = self._derive(scheduler, bm) or default
        except Exception as e:
            scheduler.metrics.record_error(
                "slo_plan",
                warn=f"serve_lp.rpc: SLO planning failed for "
                     f"bucket_m={bm} ({e!r}); using scheduler defaults")
            plan = default
        with self._lock:
            self._plans[bm] = plan
        return plan

    def _derive(self, scheduler, bm: int) -> Optional[BucketPlan]:
        spec = scheduler._pin_for_bucket(bm, scheduler.max_batch)
        us = self._measured_us_per_lp(scheduler, spec, bm,
                                      scheduler.max_batch)
        if us is None:
            return None
        n_dev = max(1, scheduler.n_devices)
        # Mesh sharding (the port's only mode) pads a flush to whole
        # tiles: the padding unit is the pinned tile itself.
        tile = spec.tile or 1

        def est_flush_s(batch: int) -> float:
            # One flush solves b_pad (batch rounded up the padding
            # ladder) problems split across the devices the layout
            # actually uses — under mesh sharding an underfull flush
            # occupies fewer than n_dev devices, so its service time
            # does not shrink with devices it never touched.
            b_pad = bucket_batch(batch, tile)
            used = max(1, min(n_dev, -(-b_pad // tile)))
            return us * b_pad * 1e-6 / used

        target = self.target_p99_s
        max_batch = scheduler.max_batch
        while (max_batch > self.min_batch
               and est_flush_s(max_batch) > self.service_fraction * target):
            max_batch = max(self.min_batch, max_batch // 2)
        est = est_flush_s(max_batch)
        wait = target - 2.0 * est
        wait = min(max(wait, MIN_WAIT_S), MAX_WAIT_FRACTION * target)
        # Fused-flush policy: fusing solves this bucket at a larger
        # m_pad.  If the next ladder rung has a measured timing and a
        # same-size flush there would blow the service budget, keep the
        # bucket out of fused units; an unmeasured rung stays fusable
        # (the scheduler's fuse_max_m_ratio still bounds the blowup).
        allow_fuse = True
        spec2 = scheduler._pin_for_bucket(2 * bm, scheduler.max_batch)
        us2 = self._measured_us_per_lp(scheduler, spec2, 2 * bm,
                                       scheduler.max_batch)
        if us2 is not None:
            tile2 = spec2.tile or 1
            b2 = bucket_batch(max_batch, tile2)
            used2 = max(1, min(n_dev, -(-b2 // tile2)))
            est2 = us2 * b2 * 1e-6 / used2
            allow_fuse = est2 <= self.service_fraction * target
        return BucketPlan(bucket_m=bm, max_batch=max_batch,
                          max_wait_s=wait, est_flush_s=est,
                          source="measured", allow_fuse=allow_fuse)

    # -- wiring -----------------------------------------------------------

    def install(self, scheduler, *, m_max: int = 1024) -> None:
        """Point the scheduler's per-bucket limits hook at this
        controller and pre-plan the bucket ladder up to ``m_max`` so
        the scheduler-wide ``max_wait_s`` (the timer tick source) can
        be tightened to the tightest planned wait before the timer
        thread starts."""
        self._scheduler = scheduler
        # The same geometric ladder bucket_m() walks, from the
        # scheduler's own base (8 dense / LANE kernel).
        ladder, m = [], scheduler.bucket_base
        while m <= max(m_max, scheduler.bucket_base):
            ladder.append(m)
            m *= 2
        waits = [self.plan_for(scheduler, bm).max_wait_s
                 for bm in ladder]
        scheduler.max_wait_s = min(waits + [scheduler.max_wait_s])

        def policy(bm: int):
            plan = self.plan_for(scheduler, bm)
            return plan.max_batch, plan.max_wait_s, plan.allow_fuse

        scheduler.set_bucket_policy(policy)

    def plans(self) -> Dict[int, BucketPlan]:
        """Plans derived so far (for reporting/metrics)."""
        with self._lock:
            return dict(self._plans)
