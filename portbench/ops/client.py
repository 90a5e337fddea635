"""Client traffic: each request encrypts J seeded messages (encrypt_batch)
and decrypts J answers (decrypt_batch), one request in flight.

Traffic keys: J, msg_pool (messages encrypted in the window, contiguous
J-slices at seeded starts), answer_pool (ciphertexts made in set-up,
decrypted in the window the same way), check_requests (the seeded sample
of window requests the reference redoes).  An item is a message encrypted or an answer decrypted.
"""

from __future__ import annotations

from portbench.harness.cells import (NONCE_KEYGEN, NONCE_POOL, CellBase,
                                     Reservoir)
from portbench.harness.work import Work, table_bytes, transforms


class Cell(CellBase):
    def __init__(self, system, config, traffic, seed, device):
        super().__init__(system, config, traffic, seed, device)
        self.items = 2 * self.J
        self.sk, self.pk = system.keygen(self.nonce(NONCE_KEYGEN))
        self.msgs = self.messages(int(traffic["msg_pool"]))
        self.ans_msgs = self.messages(int(traffic["answer_pool"]))
        self.answers = self.encrypt_pool(self.pk, self.ans_msgs)
        self.enc_starts = self.starts(self.msgs.shape[0])
        self.dec_starts = self.starts(self.answers.shape[0])
        S = int(traffic["check_requests"])
        self.sample = Reservoir(S, seed)
        self.kept_ct = self.kept(S, self.J, 2, self.k, self.n)
        self.kept_m = self.kept(S, self.J, self.n)

    def plan(self, i: int) -> tuple[int, int]:
        return (self.enc_starts[i % len(self.enc_starts)],
                self.dec_starts[i % len(self.dec_starts)])

    def issue(self, i: int, warm: bool = False):
        se, sd = self.plan(i)
        nonces = self.request_nonces(i, warm)
        J = self.J
        with self.span("issue.encrypt_batch"):
            ct = self.system.encrypt_batch(self.pk, self.msgs[se:se + J],
                                           nonces)
        with self.span("issue.decrypt_batch"):
            m = self.system.decrypt_batch(self.sk, self.answers[sd:sd + J])
        return ct, m

    def keep(self, i: int, out) -> None:
        slot = self.sample.slot(i)
        if slot is not None:
            self.kept_ct[slot].copy_(out[0])
            self.kept_m[slot].copy_(out[1])

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        del self.system, self.sk, self.pk, self.answers

    def check(self, ref) -> dict:
        """Each sampled request redone by the reference: its J ciphertexts
        word for word, its J decryptions coefficient for coefficient (the
        answers re-encrypted by the reference from their messages and pool
        nonces), and the reference's own round trip."""
        sk, pk = ref.keygen(self.nonce(NONCE_KEYGEN))
        J, enc, dec, own = self.J, 0, 0, 0
        for slot, i in enumerate(self.sample.index):
            if i is None:
                continue
            se, sd = self.plan(i)
            ct = ref.encrypt(pk, self.msgs[se:se + J],
                             self.request_nonces(i, False))
            enc += int((ct != self.kept_ct[slot].to(ct.device)).sum())
            ans = self.ans_msgs[sd:sd + J]
            m = ref.decrypt(sk, ref.encrypt(pk, ans,
                                            self.nonces(NONCE_POOL + sd, J)))
            dec += int((m != self.kept_m[slot].to(m.device)).sum())
            own += int((m != ans).sum())
        checked = sum(i is not None for i in self.sample.index)
        return {"requests_checked": (checked, None),
                "ct_words_wrong": (enc, 0),
                "dec_coeffs_wrong": (dec, 0),
                "ref_roundtrip_wrong": (own, 0)}

    def work(self) -> Work:
        """A request's compulsory bytes and instructions: encryption
        (keystream blocks, NTT(u), two products, two inverses, the drop and
        Delta m) of J messages and decryption (NTT(c1), the product with s,
        the inverse, the scalings and the conversion to t and gamma) of J
        answers."""
        n, r, k, J = self.n, self.r, self.k, self.J
        nbytes = (J * n * 8 + 2 * r * n * 8 + table_bytes(r, n)
                  + 2 * J * 2 * k * n * 8 + k * n * 8 + J * n * 8)
        enc = (Work(nbytes, salsa20_block=J * -(-9 * n // 64))
               + transforms(J * r, n) + Work(0, mont=2 * J * r * n)
               + transforms(2 * J * r, n, inverse=True)
               + Work(0, mod_nu=3 * J * k * n, shoup=2 * J * k * n,
                      mullo=J * k * n))
        dec = (transforms(J * k, n) + Work(0, mont=J * k * n)
               + transforms(J * k, n, inverse=True)
               + Work(0, shoup=2 * J * k * n, mullo=J * k * n))
        return enc + dec
