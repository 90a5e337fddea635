"""Reading the traced window: device intervals from torch.profiler, the
harness's own host spans, and the arithmetic the per-layer metrics share.

`union_us` is a frozen copy of `ntt_cuda_tpu_torch/utils/profiling.py`
`union_us` at commit a9c3f5d (the device's busy time is the union of its
events' intervals), `device_intervals` of its `device_intervals`.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch

# The host spans the harness records around its calls into each layer.
SPANS = ("request", "issue.encrypt_batch", "issue.decrypt_batch",
         "issue.mul", "sync", "next_slice")

# The library's own CUDA kernels (its csrc/ at a9c3f5d), by name; every
# other device event is plain glue (PyTorch's kernels and copies).
PORT_KERNEL = re.compile(
    r"\bk_(salsa20|decrypt_tail|op_cluster|encrypt_tail|stage_fwd_block|"
    r"stage_inv_block|behz|decrypt_cluster|ntt30_cluster|cross_stage)\w*")


def device_intervals(events) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of every device event (kernels and copies)
    of a torch.profiler event list; the profiler's device-side copies of
    the host spans (user annotations) are not device work."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in SPANS]


def union_us(iv) -> float:
    """The length of the union of (start, end, name) intervals."""
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(iv):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def merged(iv) -> list[tuple[float, float]]:
    """The union of intervals as disjoint (start, end) pairs, in order."""
    out: list[list[float]] = []
    for s, e, _ in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class TraceSummary:
    """One traced window, from the first traced request's start to the last
    one's end: its device events and host spans, the requests and items it
    holds, and the least time of one request (harness.work)."""

    def __init__(self, events, items_per_request: int, least_s: float):
        spans = [(e.time_range.start, e.time_range.end, e.name)
                 for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and e.name in SPANS]
        reqs = [s for s in spans if s[2] == "request"]
        self.w0 = min(s[0] for s in reqs) if reqs else 0.0
        self.w1 = max(s[1] for s in reqs) if reqs else 0.0
        self.device = [d for d in device_intervals(events)
                       if self.w0 <= d[0] < self.w1]
        self.host = sorted(s for s in spans if s[2] != "request")
        self.requests = len(reqs)
        self.items = self.requests * items_per_request
        self.least_s = least_s

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_us(self.device) * 1e-6

    def glue_s(self) -> tuple[float, float]:
        """(seconds in plain glue, seconds in every device event)."""
        glue = sum(e - s for s, e, n in self.device
                   if not PORT_KERNEL.search(n))
        return glue * 1e-6, sum(e - s for s, e, _ in self.device) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by = defaultdict(float)
        for s, e, n in self.device:
            by[n[:160]] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[host span, seconds]: the device's idle time in the window, each
        gap given to the host span that overlaps it most ("request" where
        only the request's own span does)."""
        busy = merged(self.device)
        edges = [self.w0] + [x for s, e in busy for x in (s, e)] + [self.w1]
        starts = [s[0] for s in self.host]
        by = defaultdict(float)
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            best, label = 0.0, "request"
            i = max(bisect.bisect_right(starts, g0) - 1, 0)
            while i < len(self.host) and self.host[i][0] < g1:
                s, e, name = self.host[i]
                ov = min(e, g1) - max(s, g0)
                if ov > best:
                    best, label = ov, name
                i += 1
            by[label] += (g1 - g0) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]


# --- the per-layer metrics' arithmetic (each metrics/<name>.py reads one) ---

def launches_per_item(tr: TraceSummary):
    return len(tr.device) / tr.items if tr.device and tr.items else None


def glue_share(tr: TraceSummary):
    glue, total = tr.glue_s()
    return 100.0 * glue / total if total > 0 else None


def roofline_share(tr: TraceSummary):
    busy = tr.busy_s
    return 100.0 * tr.requests * tr.least_s / busy if busy > 0 else None


def idle_share(tr: TraceSummary):
    w = tr.window_s
    return 100.0 * (1.0 - tr.busy_s / w) if w > 0 and tr.device else None
