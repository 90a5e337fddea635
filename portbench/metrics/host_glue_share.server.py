"""Share (%) of the host time in the library's public ops (host_issue_ms)
spent outside its kernel wrappers' `ntt.launch.*` spans: argument checks,
stacks, reshapes and copies."""

from portbench.harness.program import host_glue_share


def read(rec):
    return host_glue_share(rec, 1)
