"""Share (%) of the traced window's device time in kernels that are not
the library's own csrc/ kernels (harness.trace.PORT_KERNEL): the plain
glue of the draws and the tensor ops."""

from portbench.harness.trace import glue_share


def read(rec):
    return glue_share(rec.trace) if rec.trace else None
