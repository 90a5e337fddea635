"""Host ms per traced request inside the library's public ops: its outer
`ntt.<op>` spans (encrypt_batch, decrypt_batch), None unless there are
two for each traced request."""

from portbench.harness.program import host_issue_ms


def read(rec):
    return host_issue_ms(rec, 2)
