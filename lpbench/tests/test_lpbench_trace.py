"""The reading of a profiler trace: busy time is the union of the device's
intervals within the slice; each idle gap is named by the host."""
from __future__ import annotations

import pytest

from lpbench import trace as tr


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def _trace():
    return {"traceEvents": [
        _x(tr.SLICE, "user_annotation", 100.0, 100.0),
        _x("lpbench.solve", "user_annotation", 100.0, 40.0),
        _x("aten::mul", "cpu_op", 110.0, 20.0),
        _x("lpbench.sync", "user_annotation", 140.0, 60.0),
        # device: overlapping kernels, a copy, one event before the slice
        _x("k1", "kernel", 105.0, 20.0, tid=7),
        _x("k2", "kernel", 115.0, 20.0, tid=8),
        _x("Memcpy HtoD", "gpu_memcpy", 150.0, 10.0, tid=7),
        _x("rgb_kernel<float>", "kernel", 170.0, 10.0, tid=7),
        _x("early", "kernel", 50.0, 55.0, tid=7),
        {"ph": "i", "name": "marker", "ts": 120.0},
    ]}


def test_union_of_device_intervals():
    sl = tr.parse(_trace())
    assert sl.length_s == pytest.approx(100e-6)
    # [100,105) early (clipped), [105,135) k1+k2, [150,160) copy, [170,180)
    assert sl.busy_intervals() == [(100.0, 135.0), (150.0, 160.0),
                                   (170.0, 180.0)]
    assert sl.busy_s == pytest.approx(55e-6)
    assert sl.device_s("rgb_kernel") == pytest.approx(10e-6)
    assert sl.device_s() == pytest.approx((5 + 20 + 20 + 10 + 10) * 1e-6)


def test_gaps_named_by_the_host():
    sl = tr.parse(_trace())
    assert sl.gaps() == [(135.0, 150.0), (160.0, 170.0), (180.0, 200.0)]
    idle = dict((n, t) for n, t in sl.idle_by_host())
    assert idle == {"lpbench.sync": pytest.approx(45e-6)}


def test_top_ops():
    top = tr.parse(_trace()).top_ops(2)
    assert [n for n, _ in top] == ["k1", "k2"]


def test_no_slice_no_reading():
    assert tr.parse({"traceEvents": [_x("k", "kernel", 0.0, 1.0)]}) is None


def test_profile_on_the_cpu_gives_a_slice():
    sl = tr.profile(lambda: 3, lambda: None)
    assert sl is not None and sl.calls == 3 and sl.length_s > 0
