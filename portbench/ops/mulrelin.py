"""Server traffic: each request is one relinearized product,
mul(a, b, rlk=rlk), of J ciphertext pairs, one request in flight.

Traffic keys: J, ct_pool (ciphertexts made in set-up from seeded messages;
a and b are contiguous J-slices of it at two seeded orders of starts),
check_requests.  An item is one relinearized product.
"""

from __future__ import annotations

from portbench.harness.cells import (NONCE_KEYGEN, NONCE_POOL, NONCE_RELIN,
                                     CellBase, Reservoir)
from portbench.harness.work import Work, table_bytes, transforms


class Cell(CellBase):
    def __init__(self, system, config, traffic, seed, device):
        super().__init__(system, config, traffic, seed, device)
        self.items = self.J
        self.sk, self.pk = system.keygen(self.nonce(NONCE_KEYGEN))
        self.rlk = system.relin_keygen(self.sk, self.nonce(NONCE_RELIN))
        self.pool_msgs = self.messages(int(traffic["ct_pool"]))
        self.pool = self.encrypt_pool(self.pk, self.pool_msgs)
        self.a_starts = self.starts(self.pool.shape[0])
        self.b_starts = self.starts(self.pool.shape[0])
        S = int(traffic["check_requests"])
        self.sample = Reservoir(S, seed)
        self.kept_out = self.kept(S, self.J, 2, self.k, self.n)

    def plan(self, i: int) -> tuple[int, int]:
        return (self.a_starts[i % len(self.a_starts)],
                self.b_starts[i % len(self.b_starts)])

    def issue(self, i: int, warm: bool = False):
        sa, sb = self.plan(i)
        J = self.J
        with self.span("issue.mul"):
            return self.system.mul(self.pool[sa:sa + J],
                                   self.pool[sb:sb + J], self.rlk)

    def keep(self, i: int, out) -> None:
        slot = self.sample.slot(i)
        if slot is not None:
            self.kept_out[slot].copy_(out)

    def release(self) -> None:
        del self.system, self.sk, self.pk, self.rlk, self.pool

    def check(self, ref) -> dict:
        """Each sampled request's J products redone by the reference, word
        for word: its keys, relinearization keys and operand ciphertexts
        made again from the seed's messages and nonces."""
        sk, pk = ref.keygen(self.nonce(NONCE_KEYGEN))
        rlk = ref.relin_keygen(sk, self.nonce(NONCE_RELIN))
        J, wrong = self.J, 0
        for slot, i in enumerate(self.sample.index):
            if i is None:
                continue
            ops = [ref.encrypt(pk, self.pool_msgs[s:s + J],
                               self.nonces(NONCE_POOL + s, J))
                   for s in self.plan(i)]
            out = ref.relinearize(ref.mul(*ops), rlk)
            wrong += int((out != self.kept_out[slot].to(out.device)).sum())
        checked = sum(i is not None for i in self.sample.index)
        return {"requests_checked": (checked, None),
                "mul_words_wrong": (wrong, 0)}

    def work(self) -> Work:
        """A request's compulsory bytes and instructions: per pair, q ->
        Bsk of four polynomials, the transforms over q and Bsk, the tensor
        product, floor(t x / q) and Shenoy-Kumaresan of three, then the key
        switch of c2 (digits over the full base, their transforms, the
        products with rlk, two inverses and the drop of P)."""
        n, r, k, J = self.n, self.r, self.k, self.J
        K = k + 1
        nbytes = (2 * J * 2 * k * n * 8 + 2 * k * r * n * 8
                  + table_bytes(r, n) + table_bytes(K, n) + J * 2 * k * n * 8)
        pair = (Work(0, shoup=4 * n * (2 * k + 2 * K), mul128=4 * n * k * K,
                     mont=4 * n * K, mul32=4 * n * k)
                + transforms(4 * (k + K), n)
                + Work(0, mont=4 * (k + K) * n)
                + transforms(4 * (k + K), n, inverse=True)
                + Work(0, shoup=3 * n * (2 * k + 2 * K), mul128=3 * n * k * K,
                       mont=3 * n * K)
                + Work(0, shoup=3 * n * (2 * k + 1),
                       mul128=3 * n * (k * k + k), mont=3 * n * (k + 1))
                + Work(0, mod_nu=k * r * n) + transforms(k * r, n)
                + Work(0, mont=2 * k * r * n)
                + transforms(2 * r, n, inverse=True)
                + Work(0, mod_nu=2 * k * n, shoup=2 * k * n))
        return Work(nbytes, **{k: v * J for k, v in pair.prims.items()})
