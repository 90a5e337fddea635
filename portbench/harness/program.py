"""What the library records of itself in the traced window, and the
arithmetic of the per-layer metrics that read it.

While torch.profiler records, `ntt_cuda_tpu_torch.utils.tracing` keeps the
totals of the library's own host spans: `ntt.<op>` around each public
`BFVContext` op, `ntt.draws` around the draws, `ntt.launch.<wrapper>`
around each kernel wrapper's host work (`snapshot()`), and names the
kernels of its `csrc/` (`family_of`).  A checkout whose library has no
such module gives every reader here None.
"""

from __future__ import annotations

LAUNCH, DRAWS = "ntt.launch.", "ntt.draws"


def library_tracing():
    """The library's tracing module, or None where it has none."""
    try:
        from ntt_cuda_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def is_op(name: str) -> bool:
    """An `ntt.<op>` span: the library's, neither a launch nor the draws."""
    return (name.startswith("ntt.") and not name.startswith(LAUNCH)
            and name != DRAWS)


def op_and_launch_ns(rec, ops_per_request: int):
    """(ns in the outer `ntt.<op>` spans, ns in the outer launch spans) of
    the traced window, or None: no trace, no library spans, or a count of
    outer op spans other than ops_per_request for each traced request (a
    window the snapshot does not cover exactly)."""
    tracing = library_tracing()
    if tracing is None or rec.trace is None or not rec.trace.requests:
        return None
    snap = tracing.snapshot()
    ops = [v for k, v in snap.items() if is_op(k)]
    if sum(v.outer_count for v in ops) != ops_per_request * rec.trace.requests:
        return None
    return (sum(v.outer_ns for v in ops),
            sum(v.outer_ns for k, v in snap.items() if k.startswith(LAUNCH)))


def host_issue_ms(rec, ops_per_request: int):
    """Host ms per traced request inside the library's public ops."""
    got = op_and_launch_ns(rec, ops_per_request)
    if got is None:
        return None
    return got[0] / rec.trace.requests * 1e-6


def host_glue_share(rec, ops_per_request: int):
    """Share (%) of that host time outside the kernel wrappers' spans."""
    got = op_and_launch_ns(rec, ops_per_request)
    if got is None or got[0] <= 0:
        return None
    return 100.0 * (got[0] - got[1]) / got[0]


def glue_share_reg(rec):
    """Share (%) of the traced window's device time in events that the
    library's registry names no kernel of (`family_of` is None)."""
    tracing = library_tracing()
    if tracing is None or rec.trace is None:
        return None
    dev = rec.trace.device
    total = sum(e - s for s, e, _ in dev)
    if total <= 0:
        return None
    return 100.0 * sum(e - s for s, e, n in dev
                       if tracing.family_of(n) is None) / total
