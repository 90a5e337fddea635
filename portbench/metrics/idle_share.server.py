"""Share (%) of the traced window in which no device event ran."""

from portbench.harness.trace import idle_share


def read(rec):
    return idle_share(rec.trace) if rec.trace else None
