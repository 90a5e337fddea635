"""The readers of one kernel family's share of the device time
(harness/families.py, metrics/keyswitch_share.server and
behz_share.server) on a synthetic traced window, and None where there is
nothing to read."""

import types

import pytest
import torch

from ntt_cuda_tpu_torch.utils import tracing
from portbench.harness import manifest, program, trace
from portbench.harness.manifest import BENCH

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(kind, name, s, e):
    return types.SimpleNamespace(device_type=kind, name=name,
                                 time_range=types.SimpleNamespace(start=s,
                                                                  end=e))


def reader(name):
    return manifest.load_module(BENCH / "metrics" / f"{name}.py", name).read


def server_window():
    """One request of 200 us: 200 us of device events, of which the key
    switch's two launches take 50 + 30, the conversions 40, the tensor
    product's transform 60 and glue 20 (the device-side copy of a host
    span is no device work)."""
    return [
        ev(CPU, "request", 0, 200), ev(CPU, "issue.mul", 0, 190),
        ev(CPU, "sync", 190, 200),
        ev(CUDA, "issue.mul", 0, 190),
        ev(CUDA, "void k_behz<15, 0, false>(BehzIO)", 0, 20),
        ev(CUDA, "void k_stage_fwd_block<3, 2>(StageIO, Twiddles)", 20, 80),
        ev(CUDA, "void k_behz<15, 3, false>(BehzIO)", 80, 100),
        ev(CUDA, "void at::native::CatArrayBatchedCopy<long>", 100, 120),
        ev(CUDA, "void k_stage_fwd_block_ks<3, 2>(StageIO, Twiddles)",
           120, 170),
        ev(CUDA, "void k_stage_inv_block_ks<3, 1>(StageIO, Twiddles)",
           170, 200),
    ]


def rec(events):
    return types.SimpleNamespace(
        trace=trace.TraceSummary(events, items_per_request=4, least_s=1e-6))


def test_family_shares_of_a_server_window():
    r = rec(server_window())
    assert reader("keyswitch_share.server")(r) == pytest.approx(40.0)
    assert reader("behz_share.server")(r) == pytest.approx(20.0)
    # the key switch's launches are the library's kernels, not glue
    assert trace.glue_share(r.trace) == pytest.approx(10.0)
    assert program.glue_share_reg(r) == pytest.approx(10.0)


def test_nothing_to_read_gives_none():
    for name in ("keyswitch_share.server", "behz_share.server"):
        assert reader(name)(types.SimpleNamespace(trace=None)) is None
        assert reader(name)(rec([])) is None


def test_a_library_without_the_family_gives_none(monkeypatch):
    """A library whose registry runs the key switch as plain transforms
    (no `keyswitch` family) reports no key-switch share, and still its
    BEHZ share."""
    old = {k: v for k, v in tracing.FAMILIES.items() if v != "keyswitch"}
    lib = types.SimpleNamespace(
        FAMILIES=old, family_of=lambda n: next(
            (f for k, f in old.items() if f"{k}<" in n), None))
    monkeypatch.setattr(program, "library_tracing", lambda: lib)
    r = rec(server_window())
    assert reader("keyswitch_share.server")(r) is None
    assert reader("behz_share.server")(r) == pytest.approx(20.0)
    monkeypatch.setattr(program, "library_tracing", lambda: None)
    assert reader("behz_share.server")(r) is None
