"""The readers of the library's own spans and kernel names
(harness/program.py and metrics/host_issue_ms.*, host_glue_share.*,
glue_share_reg.*): their arithmetic on a made-up snapshot, None where the
window and the snapshot disagree or the library records nothing, and one
traced window on the CPU through torch.profiler."""

import types

import pytest
import torch

from ntt_cuda_tpu_torch.utils import tracing
from portbench.harness import manifest, program, trace
from portbench.harness.manifest import BENCH
from portbench.tests.test_pb_trace import window

T = tracing.Totals
MS = 1_000_000          # ns


def reader(name):
    return manifest.load_module(BENCH / "metrics" / f"{name}.py", name).read


def rec(requests, device=()):
    return types.SimpleNamespace(trace=types.SimpleNamespace(
        requests=requests, device=list(device)))


def client_snapshot():
    """Three client requests: 4.5 ms in the outer ops, 1.2 ms of it in
    kernel wrappers, the draws and a nested op beside them."""
    return {"ntt.encrypt_batch": T(3, 3 * MS, 3, 3 * MS),
            "ntt.decrypt_batch": T(3, MS + MS // 2, 3, MS + MS // 2),
            "ntt.draws": T(3, 2 * MS, 3, 2 * MS),
            "ntt.launch.fused_ops.encrypt_fused": T(3, 9 * MS // 10, 3,
                                                    9 * MS // 10),
            "ntt.launch.bfv_tail.decrypt_tail": T(3, 3 * MS // 10, 3,
                                                  3 * MS // 10)}


def server_snapshot():
    """Two products: mul 8 ms outer, relinearize nested inside it."""
    return {"ntt.mul": T(2, 8 * MS, 2, 8 * MS),
            "ntt.relinearize": T(2, 3 * MS, 0, 0),
            "ntt.launch.behz_kernels.rns_to_bsk": T(2, MS, 2, MS),
            "ntt.launch.ntt_stage.ntt_forward": T(4, MS, 4, MS)}


def test_arithmetic_on_a_snapshot(monkeypatch):
    monkeypatch.setattr(tracing, "snapshot", client_snapshot)
    assert program.host_issue_ms(rec(3), 2) == pytest.approx(1.5)
    assert program.host_glue_share(rec(3), 2) == \
        pytest.approx(100 * (4.5 - 1.2) / 4.5)
    monkeypatch.setattr(tracing, "snapshot", server_snapshot)
    assert program.host_issue_ms(rec(2), 1) == pytest.approx(4.0)
    assert program.host_glue_share(rec(2), 1) == pytest.approx(75.0)


@pytest.mark.parametrize("requests", [2, 4])
def test_a_count_mismatch_gives_none(monkeypatch, requests):
    monkeypatch.setattr(tracing, "snapshot", client_snapshot)
    assert program.host_issue_ms(rec(requests), 2) is None
    assert program.host_glue_share(rec(requests), 2) is None


def test_no_trace_or_no_spans_gives_none(monkeypatch):
    monkeypatch.setattr(tracing, "snapshot", server_snapshot)
    assert program.host_issue_ms(types.SimpleNamespace(trace=None), 1) is None
    assert program.host_issue_ms(rec(0), 1) is None
    monkeypatch.setattr(tracing, "snapshot", dict)
    assert program.host_issue_ms(rec(2), 1) is None
    assert program.glue_share_reg(types.SimpleNamespace(trace=None)) is None
    assert program.glue_share_reg(rec(1)) is None


@pytest.mark.parametrize("name,snap,requests,want", [
    ("host_issue_ms.client", client_snapshot, 3, 1.5),
    ("host_issue_ms.server", server_snapshot, 2, 4.0),
    ("host_glue_share.client", client_snapshot, 3, 100 * 3.3 / 4.5),
    ("host_glue_share.server", server_snapshot, 2, 75.0),
])
def test_metric_files_read_the_library(monkeypatch, name, snap, requests,
                                       want):
    monkeypatch.setattr(tracing, "snapshot", snap)
    assert reader(name)(rec(requests)) == pytest.approx(want)
    assert reader(name)(rec(requests + 1)) is None


@pytest.mark.parametrize("name", [
    "host_issue_ms.client", "host_issue_ms.server", "host_glue_share.client",
    "host_glue_share.server", "glue_share_reg.client",
    "glue_share_reg.server"])
def test_a_library_without_tracing_gives_none(monkeypatch, name):
    """The parent's library has no tracing module: every reader returns
    None and raises nothing."""
    monkeypatch.setattr(program, "library_tracing", lambda: None)
    tr = trace.TraceSummary(window(), items_per_request=8, least_s=20e-6)
    assert reader(name)(types.SimpleNamespace(trace=tr)) is None


@pytest.mark.parametrize("side", ["client", "server"])
def test_glue_share_reg_equals_glue_share(side):
    """On today's kernels the registry's names are the frozen regex's."""
    tr = trace.TraceSummary(window(), items_per_request=8, least_s=20e-6)
    r = types.SimpleNamespace(trace=tr)
    assert reader(f"glue_share_reg.{side}")(r) == \
        pytest.approx(trace.glue_share(tr))


def test_registry_kernels_are_the_frozen_regex_kernels():
    """Every kernel the registry names matches PORT_KERNEL, and each of the
    regex's names is a registry kernel."""
    frozen = set(trace.PORT_KERNEL.pattern.split("(")[1].split(")")[0]
                 .split("|"))
    assert all(trace.PORT_KERNEL.fullmatch(k) for k in tracing.FAMILIES)
    assert {"k_" + k for k in frozen} <= set(tracing.FAMILIES)


def test_a_traced_window_on_the_cpu():
    """Spans opened as the library opens them, inside the harness's
    request spans under torch.profiler: the snapshot covers exactly the
    traced requests."""
    with tracing.span("ntt.mul"):          # before the profiler: not counted
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with torch.profiler.record_function("request"):
                for op in ("ntt.encrypt_batch", "ntt.decrypt_batch"):
                    with tracing.span(op):
                        with tracing.launch("fused_ops.encrypt_fused"):
                            torch.ones(64).sum()
    tr = trace.TraceSummary(prof.events(), items_per_request=2, least_s=0)
    r = types.SimpleNamespace(trace=tr)
    assert tr.requests == 3
    assert reader("host_issue_ms.client")(r) > 0
    assert 0 <= reader("host_glue_share.client")(r) < 100
    assert reader("host_issue_ms.server")(r) is None     # 6 ops, not 3
