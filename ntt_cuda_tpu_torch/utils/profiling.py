"""Timing and tracing: CUDA graphs of the op programs, chained-slope times,
the median time of one call and a profiler trace.

Counterpart of `ntt_cuda_tpu/utils/profiling.py`.  The JAX package chains
`inner` applications of an op inside one jit (`lax.fori_loop`) and takes
the slope between two chain lengths, so that a remote TPU's dispatch
latency drops out.  In PyTorch the counterpart of that outer jit is a
`torch.cuda.CUDAGraph`: `graphed` captures one call of a function of
device tensors (`BFVContext.op_programs` / `mult_program`) and replays it
with no host work between its kernels, and `time_chained` captures a chain
of k data-dependent steps at two lengths and reads the slope between their
replays with CUDA events.

On a CUDA device a capture that fails raises; nothing falls back to eager
calls.  On the CPU, which a caller picks by giving CPU tensors, the same
functions run eagerly under the host clock: the plain versions' time,
never a device number.  `median_ms` times one eager call as it is, and
`busy_idle` reads a function's device events under torch.profiler: its
kernels a call, busy time and the device's idle share.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile


def _tensors(x) -> list[torch.Tensor]:
    """The tensors of x: a tensor, or nested tuples, lists, dicts and
    dataclasses (the context's tables and constants in a bundle)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _sync(*xs) -> None:
    """Wait for the card where any tensor of xs lives there."""
    for t in _tensors(xs):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class Graphed:
    """One captured call of fn(*args): `inputs` are the args (their tensors
    are the graph's static inputs: copy_ new values into them), `outputs`
    what the captured call returned (static too: the replay writes them in
    place, so clone what must outlive the next replay); calling the object
    replays the graph and returns `outputs`.  On the CPU (`graph` None) a
    call runs fn eagerly and copies its result into `outputs`."""

    def __init__(self, fn, args, graph, outputs):
        self.fn = fn
        self.inputs = args
        self.graph = graph
        self.outputs = outputs

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
        else:
            for dst, src in zip(_tensors(self.outputs),
                                _tensors(self.fn(*self.inputs))):
                dst.copy_(src)
        return self.outputs


def graphed(fn, *args) -> Graphed:
    """Capture one call of fn(*args) into a torch.cuda.CUDAGraph.

    fn runs twice on a side stream first (each kernel's one-time
    set-up, the library's load and the constants cached per device happen
    there, outside the capture), then once under capture on the same
    stream.  The capture raises where fn does what a graph cannot hold (a
    host read of a device value, a pageable copy from the host, a
    synchronisation); nothing falls back to eager calls.  The device is
    the one of every tensor that args reach, through bundles' tables and
    constants too: tensors on both the card and the CPU raise.  With every
    tensor on the CPU, fn runs once eagerly and the returned object runs
    it again at each call (the plain versions' path); a result on the card
    then raises, as its work would run there uncaptured."""
    kinds = {t.device.type for t in _tensors(args)}
    if "cuda" in kinds and kinds != {"cuda"}:
        raise ValueError(f"graphed: args hold tensors on {sorted(kinds)}; "
                         f"a capture needs them all on the card")
    if "cuda" not in kinds:
        out = fn(*args)
        if any(t.is_cuda for t in _tensors(out)):
            raise ValueError("graphed: fn computes on the card but no "
                             "tensor of args is there: pass them there")
        return Graphed(fn, args, None, out)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    return Graphed(fn, args, graph, out)


def _seconds_per_call(g: Graphed, reps: int) -> float:
    """Seconds a call of g, over `reps` calls after one warm-up call:
    CUDA events around the replays of a graph, the host clock around the
    eager calls on the CPU."""
    g()
    if g.graph is None:
        t0 = time.perf_counter()
        for _ in range(reps):
            g()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def time_chained(make_step, x, inner_lo: int = 4, inner_hi: int = 16,
                 reps: int = 3) -> float:
    """Seconds per step of a chain, the host's dispatch removed.

    `make_step(k)` returns a function of x that chains k data-dependent
    applications of the target (each step's input computed from the one
    before).  With x on the card each chain length is captured once
    (`graphed`) and its replays timed by CUDA events; on the CPU the
    chain runs eagerly (graphed's CPU path) under the host clock.  The
    result is the slope (t_hi - t_lo) / (inner_hi - inner_lo), each t
    the mean of `reps` calls after one warm-up call, and never below 0."""
    t_lo = _seconds_per_call(graphed(make_step(inner_lo), x), reps)
    t_hi = _seconds_per_call(graphed(make_step(inner_hi), x), reps)
    return max((t_hi - t_lo) / (inner_hi - inner_lo), 0.0)


def time_chained_dynamic(step, x, *extra, inner_lo: int = 4,
                         inner_hi: int = 16, reps: int = 3,
                         epochs: int = 3) -> float:
    """time_chained for `step(x, inner, *extra)`, which takes the chain
    length as an argument (the JAX package's one compilation for both
    lengths, a traced trip count).  A graph's trip count is fixed, so
    each length is captured once and replayed in every epoch; `extra`
    (loop-invariant bundles) passes through as it is.  The estimator is
    the JAX package's: the minimum per length over `epochs` (timing noise
    only adds), then one slope of the two minima, never below 0."""
    g_lo = graphed(step, x, inner_lo, *extra)
    g_hi = graphed(step, x, inner_hi, *extra)
    t_lo = min(_seconds_per_call(g_lo, reps) for _ in range(epochs))
    t_hi = min(_seconds_per_call(g_hi, reps) for _ in range(epochs))
    return max((t_hi - t_lo) / (inner_hi - inner_lo), 0.0)


def time_once(fn, *args, reps: int = 5) -> float:
    """Plain amortized seconds of one eager call of fn(*args) after one
    warm-up call: the host clock around `reps` calls, ending in a
    synchronisation where the result is on the card (the host's dispatch
    included)."""
    out = fn(*args)
    _sync(out, args)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(out, args)
    return (time.perf_counter() - t0) / reps


def median_ms(fn, reps: int = 15, warmup: int = 3, device=None) -> float:
    """Median ms of one call of fn() over `reps` calls after `warmup`
    calls: CUDA events on a CUDA `device` (None: the current CUDA device
    where there is one), else wall time ending after the call."""
    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_intervals(prof) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of every device event (kernels and copies)
    of a torch.profiler profile."""
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def union_us(iv) -> float:
    """The length of the union of (start, end, name) intervals."""
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(iv):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def wall_ms(fn, reps: int) -> float:
    """Median host ms of one call of fn ending in torch.cuda.synchronize()."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def busy_idle(fn, reps: int, record_shapes: bool = False):
    """Where the time of a call of fn goes on the card, fn warm: (row,
    prof).  row: `sync_wall_ms` (wall_ms over `reps` calls, no profiler
    running), then under torch.profiler over `reps` more calls
    `kernels_per_call` (device events: kernels and copies), `busy_us` (the
    union of their device intervals, per call) and `idle_share` = 1 -
    busy / sync wall; where the profiler saw no device event, `profiler`
    says so and none of the three is given.  prof is the profile, for the
    caller's own reading of it (record_shapes keeps the ops' shapes)."""
    row = {"sync_wall_ms": wall_ms(fn, reps)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    iv = device_intervals(prof)
    if not iv:
        row["profiler"] = "no device events: not measured"
        return row, prof
    busy = union_us(iv) / reps
    row.update(kernels_per_call=len(iv) / reps, busy_us=busy,
               idle_share=1 - busy / (row["sync_wall_ms"] * 1e3))
    return row, prof


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (the host, and the card where there is
    one), written on exit as a Chrome trace `trace_<pid>_<ns>.json` in
    `logdir` (view it in chrome://tracing or Perfetto).  Yields the
    profiler, whose key_averages() sum the kernels by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_"
                                       f"{time.time_ns()}.json"))
