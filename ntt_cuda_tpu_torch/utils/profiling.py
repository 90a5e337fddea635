"""Per-call latency: the median time of one call of a function.

Stands in for the JAX package's chained-slope timing
(`ntt_cuda_tpu/utils/profiling.py`, driven from its cli.py:32-87), which
chains iterations inside one jit to see past a remote TPU's dispatch
latency.  PyTorch runs eagerly on a local card, so one call is timed as
it is: on a CUDA device between two CUDA events (the host's dispatch
included, since the events are recorded on the stream around it), on the
CPU by the host clock.  A CPU time is the plain versions' time, never a
device number.
"""

from __future__ import annotations

import statistics
import time

import torch


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
