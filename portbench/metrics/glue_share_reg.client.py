"""glue_share with the library's own kernel names: share (%) of the traced
window's device time in events that its launch registry
(`ntt_cuda_tpu_torch.utils.tracing.family_of`) names no kernel of."""

from portbench.harness.program import glue_share_reg


def read(rec):
    return glue_share_reg(rec)
