"""Device events (kernels and copies) in the traced window per message encrypted or answer decrypted."""

from portbench.harness.trace import launches_per_item


def read(rec):
    return launches_per_item(rec.trace) if rec.trace else None
