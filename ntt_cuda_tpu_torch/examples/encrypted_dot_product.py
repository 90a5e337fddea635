"""Encrypted dot product: batching, EvalMult and Galois rotations.

The port's counterpart of `examples/encrypted_dot_product.py`: packs two
integer vectors into ciphertext slots, multiplies slotwise (one EvalMult
with relinearization), then folds the row sum with log2(n/2)
rotate-and-adds and one column swap, so that every slot of the result
holds the dot product.  Run it on the card:

    python -m ntt_cuda_tpu_torch.examples.encrypted_dot_product

It exits 0 when the decrypted result is the dot product and the noise
budget is still positive.
"""

from __future__ import annotations

import numpy as np


def encrypted_dot_product(n: int = 2048, length: int = 256, seed: int = 0,
                          verbose: bool = True, device=None,
                          r: int = 3) -> dict:
    """Run the workload on `device` (None: the CUDA card, raising where
    there is none) over r generated 45-bit moduli.  EvalMult's auxiliary
    base (ops/behz.py AuxBase.validate, as in the JAX package) needs
    r >= 4 at n = 32768 with t = 65537.  Returns the keys, ciphertexts
    and decrypted slots with the result, the expected value and the noise
    budget."""
    from ntt_cuda_tpu_torch import BFVContext
    from ntt_cuda_tpu_torch.models import encoder
    from ntt_cuda_tpu_torch.utils import primegen

    t = primegen.find_plain_modulus(n, 17)
    params = primegen.make_bfv_params(n, 45, r, t=t)
    ctx = BFVContext.build(params, device=device)
    enc = encoder.BatchEncoder(params, device=ctx.device)

    rng = np.random.default_rng(seed)
    bound = int((t / length) ** 0.5)         # the sum of products stays < t
    x = rng.integers(0, bound, length, dtype=np.uint64)
    y = rng.integers(0, bound, length, dtype=np.uint64)
    expected = int(np.dot(x.astype(object), y.astype(object))) % t
    vx = np.zeros(n, dtype=np.int64)
    vy = np.zeros(n, dtype=np.int64)
    vx[:length] = x
    vy[:length] = y

    sk, pk = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    steps = [1 << i for i in range((n // 2).bit_length() - 1)]
    elts = [encoder.rotation_element(n, s) for s in steps]
    elts.append(encoder.column_element(n))
    gks = ctx.galois_keygen(sk, elts)

    cts = [ctx.encrypt(pk, enc.encode(vx), nonce=1),
           ctx.encrypt(pk, enc.encode(vy), nonce=2)]
    ct = ctx.mul(cts[0], cts[1], rlk=rlk)
    for s in steps:                           # fold each row onto itself
        ct = ctx.add(ct, ctx.rotate_rows(ct, s, gks))
    ct = ctx.add(ct, ctx.rotate_columns(ct, gks))

    slots = enc.decode(ctx.decrypt(sk, ct))
    result = int(slots[0])
    budget = ctx.noise_budget(sk, ct)
    if verbose:
        print(f"[dot] device={ctx.device} n={n} t={t} length={length} "
              f"rotations={len(steps) + 1}")
        print(f"[dot] encrypted result: {result}  expected: {expected}  "
              f"match: {result == expected}")
        print(f"[dot] remaining noise budget: {budget} bits")
    return dict(result=result, expected=expected, budget=budget, t=t,
                slots=slots,
                sk=sk, pk=pk, rlk=rlk, gks=gks, cts=cts, ct=ct)


def main() -> int:
    out = encrypted_dot_product()
    return 0 if out["result"] == out["expected"] and out["budget"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
