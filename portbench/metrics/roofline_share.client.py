"""Share (%) of the device's busy time that the traced requests' least
time (harness.work, the op's work()) would take."""

from portbench.harness.trace import roofline_share


def read(rec):
    return roofline_share(rec.trace) if rec.trace else None
