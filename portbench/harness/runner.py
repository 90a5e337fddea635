"""One run of one cell: set-up, warm-up, the measured window, the traced
sub-window, the metrics, and the check against the plain reference.

The window is a closed loop: one request in flight, each timed on the host
clock from its issue to a torch.cuda.synchronize() after its last call.
With tracing on, torch.profiler records the last TRACE_SECONDS of the
window (CPU and CUDA activity, and the harness's own host spans around
its calls into the library), and the per-layer metrics are read there.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import sys
import time

import torch

from ..reference.bfv_ref import RefContext
from .systems import Program
from .trace import TraceSummary

TRACE_SECONDS = 2.0
WARMUP = 3            # requests of the cell's own shape before the window
BANNED = ("jax", "jaxlib", "flax", "ntt_cuda_tpu")


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not load,
    compared whole (ntt_cuda_tpu_torch is not ntt_cuda_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RunRecord:
    """What the metric readers read: set-up, the window's requests and
    items, its latencies, the memory peak and the traced sub-window."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             t0: float, device, make_system=Program):
    """-> (result dict, lines for stderr).  `t0` is the process's start on
    the host clock; `make_system(config, device)` the system under test.
    setup_s runs from t0 to the window's start, less build_s: the nvcc
    build of a checkout's first run (a look for the cached build on every
    later run), recorded apart; loading the built library stays in."""
    config, traffic, op = spec["config"], spec["traffic"], spec["op"]
    log = []
    build_s = 0.0
    if device.type == "cuda" and make_system is Program:
        from ntt_cuda_tpu_torch import cuda as port_cuda
        tb = time.perf_counter()
        port_cuda.build()
        build_s = time.perf_counter() - tb
        port_cuda.library()
    cell = op.Cell(make_system(config, device), config, traffic, seed,
                   device)
    for w in range(WARMUP):
        cell.issue(w, warm=True)
    _sync(device)
    setup_s = time.perf_counter() - t0 - build_s

    span = (torch.profiler.record_function if trace
            else lambda name: contextlib.nullcontext())
    cell.span = span
    prof, tracing = None, False
    if trace:
        # the profiler's own start-up (CUPTI) before the window: it takes
        # seconds, and the window's traced part would start that late
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        tp = time.perf_counter()
        prof.prepare_trace()
        log.append(f"profiler prepared in {time.perf_counter() - tp} s")
    lat, failed, i = [], 0, 0
    gc.collect()
    gc.disable()          # no collector pauses inside the window
    t_start = time.perf_counter()
    t_end = t_start + seconds
    trace_from = t_end - min(TRACE_SECONDS, seconds)
    while True:
        if trace and not tracing and time.perf_counter() >= trace_from:
            tp = time.perf_counter()
            prof.start_trace()
            tracing = True
            log.append(f"profiler started in {time.perf_counter() - tp} s")
        out = None
        with span("request"):
            ta = time.perf_counter()
            try:
                out = cell.issue(i)
            except Exception as e:        # counted, reported, and the run
                failed += 1               # goes on: a failed request is
                log.append(f"request {i} failed: {e!r}")   # not correct
            with span("sync"):
                _sync(device)
            tz = time.perf_counter()
        lat.append(tz - ta)
        with span("next_slice"):
            if out is not None:
                cell.keep(i, out)
            del out
        i += 1
        if tz >= t_end:
            break
    elapsed = tz - t_start
    gc.enable()
    if prof is not None:
        prof.stop_trace()
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    found = banned_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark may load "
                         f"neither JAX nor the JAX package")

    tr = None
    if prof is not None:
        tr = TraceSummary(prof.events(), cell.items, cell.work().least_s())
        del prof
    rec = RunRecord(setup_s=setup_s, build_s=build_s, latencies=lat,
                    requests=i, items=i * cell.items, elapsed=elapsed,
                    peak_bytes=peak, trace=tr)
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        v = m["reader"].read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    qs = statistics.quantiles(lat, n=100) if len(lat) > 1 else lat * 99
    log += [f"build_s {build_s}", f"setup_s {setup_s}",
            f"requests {i} in {elapsed} s, {cell.items} items each; "
            f"latency samples {len(lat)}, median {statistics.median(lat) * 1e3}"
            f" ms, p95 {qs[94] * 1e3} ms, p99 {qs[98] * 1e3} ms"]
    if tr is not None:
        log.append(f"traced {tr.requests} requests over {tr.window_s} s, "
                   f"busy {tr.busy_s} s, {len(tr.device)} device events")

    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    checks = cell.check(RefContext(config, device))
    log.append(f"reference check {time.perf_counter() - tc} s")
    compared = {k: v for k, v in checks.items() if v[1] is not None}
    correct = (failed == 0 and checks["requests_checked"][0] > 0
               and all(v <= lim for v, lim in compared.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": correct, "attempted": i, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in compared.items()}
    log.append(f"requests checked {checks['requests_checked'][0]}, "
               f"failed requests {failed} (limit 0)")
    log += [f"check {k} {v} (limit {lim})" for k, (v, lim) in
            compared.items()]
    return result, log
