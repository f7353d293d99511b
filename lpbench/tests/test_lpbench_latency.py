"""Latency is taken from the due time; every seed gets the same work."""
from __future__ import annotations

import math

import numpy as np
import pytest

from lpbench import drivers, loadgen, readers, spec


def _run(lat):
    r = drivers.Run("c", {}, {})
    r.latency_s = np.asarray(lat, dtype=float)
    return r


def test_percentiles_from_due_time():
    # Due at 0, 1, 2, ... ms; each answered 5 ms after it was due, but the
    # tenth answered 100 ms late: the tail is counted from the due time.
    due = np.arange(100) * 1e-3
    done = due + 5e-3
    done[9] = due[9] + 0.1
    r = _run(done - due)
    assert readers.latency_ms(r, 50.0) == pytest.approx(5.0)
    assert readers.latency_ms(r, 99.0) == pytest.approx(
        np.percentile(done - due, 99) * 1e3)
    assert readers.latency_ms(r, 100.0) == pytest.approx(100.0)


def test_a_request_never_answered_is_infinitely_late():
    r = _run([0.001] * 98 + [math.inf] * 2)
    assert readers.latency_ms(r, 50.0) == pytest.approx(1.0)
    assert readers.latency_ms(r, 99.0) is None


def test_arrivals_same_gaps_every_seed():
    a = loadgen.arrivals(1000.0, 5000, 1)
    b = loadgen.arrivals(1000.0, 5000, 2**31 + 7)
    assert a[0] == b[0] == 0.0
    assert not np.array_equal(a, b)
    ga = np.sort(np.diff(np.append(a, a[-1])))
    gb = np.sort(np.diff(np.append(b, b[-1])))
    # the same multiset of gaps, less the last one each drew
    assert abs(np.sum(np.diff(a)) - np.sum(np.diff(b))) < 0.05
    assert np.abs(ga[1:-1] - gb[1:-1]).max() < 5e-3
    assert a[-1] == pytest.approx(5.0, rel=0.02)


def test_pool_same_sizes_and_kinds_every_seed():
    cfg = {"sizes": [8, 16, 32],
           "problem": {"kind": "request_mix", "kind_mix": [0.8, 0.1, 0.1]}}
    kind = spec.module("problems", "request_mix")
    p1 = loadgen.request_pool(cfg, {"pool": 300}, 3, kind)
    p2 = loadgen.request_pool(cfg, {"pool": 300}, 4, kind)
    assert p1.per == p2.per == 100
    for k1, k2 in zip(p1.kind, p2.kind):
        assert np.array_equal(np.bincount(k1), [80, 10, 10])
        assert np.array_equal(k1, k2)
    assert not np.array_equal(p1.order, p2.order)
    A, b, c = p1.request(5)
    assert A.shape[1] == 2 and A.shape[0] == b.shape[0]
    assert A.dtype == b.dtype == c.dtype == np.float32
