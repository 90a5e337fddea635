"""The host cost of the port's tracing (ntt_cuda_tpu_torch/utils/tracing.py),
off and on: ns a call of a bare function, `with tracing.span(...)`,
`with tracing.launch(...)` and a `tracing.traced` function, each the best
of 5 loops; "on" under torch.profiler (CPU, and CUDA where there is a
card).  Prints one JSON line.

    python3 tools/trace_cost.py        # from the root of a checkout
"""

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from ntt_cuda_tpu_torch.utils import tracing  # noqa: E402

LOOPS = {"off": 200_000, "on": 20_000}


def per_call(fn, n: int) -> float:
    fn()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def bare():
    pass


def span():
    with tracing.span("ntt.mul"):
        pass


def launch():
    with tracing.launch("ntt_stage.ntt_forward"):
        pass


@tracing.traced("ntt.mul")
def traced_call():
    pass


def costs(n: int) -> dict:
    return {f.__name__: per_call(f, n)
            for f in (bare, span, launch, traced_call)}


def main() -> None:
    out = {"torch": torch.__version__,
           "device": (torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else "cpu"),
           "off_ns": costs(LOOPS["off"])}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out["on_ns"] = costs(LOOPS["on"])
    tracing.reset()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
