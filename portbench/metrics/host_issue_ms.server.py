"""Host ms per traced request inside the library's public ops: its outer
`ntt.<op>` span (mul, relinearize inside it), None unless there is one for
each traced request."""

from portbench.harness.program import host_issue_ms


def read(rec):
    return host_issue_ms(rec, 1)
