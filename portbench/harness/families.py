"""Share of the traced window's device time in one kernel family, as the
library's launch registry names it (`ntt_cuda_tpu_torch.utils.tracing`:
`FAMILIES`, `family_of`)."""

from __future__ import annotations

from portbench.harness import program


def family_share(rec, family: str):
    """% of the traced window's device time (the sum of its events, as
    glue_share_reg counts it) in events that `family_of` names `family`;
    None without a trace or device time, or where the library's registry
    has no such family."""
    tracing = program.library_tracing()
    if tracing is None or rec.trace is None:
        return None
    if family not in set(getattr(tracing, "FAMILIES", {}).values()):
        return None
    dev = rec.trace.device
    total = sum(e - s for s, e, _ in dev)
    if total <= 0:
        return None
    return 100.0 * sum(e - s for s, e, n in dev
                       if tracing.family_of(n) == family) / total
