"""The per-layer metrics' arithmetic on synthetic profiler events."""

import types

import pytest
import torch

from portbench.harness import trace
from portbench.harness.work import Work

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(kind, name, s, e):
    return types.SimpleNamespace(device_type=kind, name=name,
                                 time_range=types.SimpleNamespace(start=s,
                                                                  end=e))


def window():
    """Two requests of 100 us: host spans, and device events of which one
    is the library's kernel, two are glue, one overlaps and one is the
    profiler's device-side copy of a host span."""
    return [
        ev(CPU, "request", 0, 100), ev(CPU, "issue.mul", 0, 60),
        ev(CPU, "sync", 60, 100), ev(CPU, "next_slice", 100, 110),
        ev(CPU, "request", 110, 210), ev(CPU, "issue.mul", 110, 150),
        ev(CPU, "sync", 150, 210),
        ev(CUDA, "issue.mul", 0, 60),
        ev(CUDA, "void k_stage_fwd_block<3, 2>(StageIO, Twiddles)", 10, 50),
        ev(CUDA, "void at::native::elementwise_kernel<add>", 40, 70),
        ev(CUDA, "void k_behz<8, 3, false>(BehzIO)", 120, 180),
        ev(CUDA, "Memcpy HtoD (Pageable -> Device)", 190, 200),
        ev(CUDA, "void late_kernel", 300, 310),
    ]


def test_union_and_merge():
    iv = [(0, 10, "a"), (5, 20, "b"), (30, 40, "c")]
    assert trace.union_us(iv) == 30
    assert trace.merged(iv) == [(0, 20), (30, 40)]


def test_summary_metrics():
    tr = trace.TraceSummary(window(), items_per_request=8, least_s=20e-6)
    assert tr.requests == 2 and tr.items == 16
    assert tr.window_s == pytest.approx(210e-6)
    assert len(tr.device) == 4                   # no annotation, not late
    assert tr.busy_s == pytest.approx(130e-6)    # 10-70, 120-180, 190-200
    assert trace.launches_per_item(tr) == pytest.approx(4 / 16)
    glue, total = tr.glue_s()
    assert glue == pytest.approx(40e-6) and total == pytest.approx(140e-6)
    assert trace.glue_share(tr) == pytest.approx(100 * 40 / 140)
    assert trace.roofline_share(tr) == pytest.approx(100 * 40 / 130)
    assert trace.idle_share(tr) == pytest.approx(100 * (1 - 130 / 210))
    gaps = dict(tr.idle_gaps())
    # gaps 0-10 (issue.mul), 70-120 (sync 30, next_slice 10, issue.mul
    # 10: sync's), 180-190 and 200-210 (sync)
    assert gaps == pytest.approx({"issue.mul": 10e-6, "sync": 70e-6})
    ops = dict(tr.device_ops())
    assert ops["void k_behz<8, 3, false>(BehzIO)"] == pytest.approx(60e-6)


def test_nothing_to_read_gives_nothing():
    tr = trace.TraceSummary([], items_per_request=8, least_s=1e-6)
    assert trace.launches_per_item(tr) is None
    assert trace.glue_share(tr) is None
    assert trace.roofline_share(tr) is None
    assert trace.idle_share(tr) is None


def test_work_terms():
    w = Work(3.35e6, shoup=132 * 64 * 1980) + Work(0, mont=1)
    t = w.terms()
    assert t["bytes_s"] == pytest.approx(1e-6)
    assert t["fma"] == 10 * 132 * 64 * 1980 + 15
    assert w.least_s() == pytest.approx(t["ops_s"])
    assert Work(0, salsa20_block=64).terms()["alu"] == 675 * 64
