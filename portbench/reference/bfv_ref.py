"""Plain BFV reference: the benchmark's judge of what the timed path made.

A straightforward implementation, in plain PyTorch integer and float64
tensor ops, of the semantics the library under test states (the
reference CUDA implementation's BFV, RNS form, SEAL 3.5 evaluator):

* Salsa20/20 keystream (key = 32 copies of one byte, the nonce in state
  words 6-7, a 64-bit block counter in words 8-9), read as little-endian
  bytes, u32 words and u64 lanes;
* the samplers: ternary b = byte // 85 - 1, uniform floor(u (q-1) / 2^64)
  from a u64 lane, and the pinned 38-threshold discrete Gaussian;
* the negacyclic NTT (Cooley-Tukey, natural order in, bit-reversed order
  out, powers psi^brv(i)) and its inverse;
* keygen, encryption (the last modulus dropped with rounding, then
  c0 += m * floor(q_i / t) + [m >= t - (t+1)//2]), textbook decryption
  round(t x / Q) mod t, relinearization keys, and the BEHZ product
  (q -> Bsk with the m_tilde = 2^32 correction, the tensor product,
  floor(t x / q) in Bsk, Shenoy-Kumaresan back to q) followed by the key
  switch through the relinearization keys and the drop of P = q_last.

It imports nothing of the library under test and takes none of its
tables: every constant is worked out here from the configuration's n,
moduli, roots, t and gamma.  Residues are int64 values below 2^62.

`Arith(fp64=True)` is the control: every modular product is taken through
float64 (53 bits) instead of exactly, the step a faster but inexact port
would take; run in the program's place it has to come out not correct.
"""

from __future__ import annotations

import torch

I64 = torch.int64
M32 = (1 << 32) - 1
LO31 = (1 << 31) - 1
M_TILDE = 1 << 32
AUX_BITS = 60

# Salsa20 constants "expand 32-byte k" and the key bytes of the streams
SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
KEY_BYTE_MAIN = 0x01     # keygen and encryption
KEY_BYTE_RELIN = 0x02    # relinearization keys
NONCE_HIGH = 1 << 63

# The pinned discrete Gaussian (the samplers' stated spec): for a u32 word u
# in [1, 2^32 - 129], d(u) = -19 + #{b : u >= b}; u == 0 -> -16 and
# u >= 2^32 - 128 -> +16.
GAUSS_BOUNDS = (
    7, 40, 233, 1232, 5940, 26078, 104261, 379750, 1260811, 3818335,
    10556606, 26670310, 61645758, 130551381, 253768664, 453762321,
    748401120, 1142399168, 1620621248, 2674346113, 3152568192, 3546566273,
    3841204865, 4041198721, 4164415872, 4233321601, 4268297088, 4284410752,
    4291148929, 4293706369, 4294587521, 4294862977, 4294941313, 4294961281,
    4294966144, 4294967168, 4294967168, 4294967168,
)


# --- modular arithmetic ------------------------------------------------------

def _mul_small(a, b, q):
    """(a * b mod q, floor(a * b / q)) for 0 <= a < 2^31, 0 <= b < 2^62,
    q < 2^62: the float64 quotient is within one of the true one, and the
    remainder, taken in wrapping int64, lies in [-q, 2q) before the fix."""
    est = torch.floor(a.double() * b.double() / q.double()).to(I64)
    r = a * b - est * q
    lo = r < 0
    r = torch.where(lo, r + q, r)
    est = est - lo.to(I64)
    hi = r >= q
    return torch.where(hi, r - q, r), est + hi.to(I64)


class Arith:
    """Exact modular arithmetic on int64 residues (moduli below 2^62), or,
    with fp64, the control whose products go through float64."""

    def __init__(self, fp64: bool = False):
        self.fp64 = fp64

    def mul(self, a, b, q):
        """a * b mod q, for 0 <= a < 2^62 and 0 <= b < q; q broadcasts."""
        b, q = (torch.as_tensor(v, dtype=I64, device=a.device)
                for v in (b, q))
        if self.fp64:
            return torch.remainder(torch.fmod(a.double() * b.double(),
                                              q.double()).to(I64), q)
        hi, _ = _mul_small(a >> 31, b, q)
        hi, _ = _mul_small(torch.full_like(hi, 1 << 31), hi, q)
        lo, _ = _mul_small(a & LO31, b, q)
        return add(hi, lo, q)


def add(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub(a, b, q):
    return torch.where(a >= b, a - b, a - b + q)


def neg(a, q):
    return torch.where(a == 0, a, q - a)


def col(vals, device) -> torch.Tensor:
    """Python ints as an int64 column (r, 1)."""
    return torch.tensor([int(v) for v in vals], dtype=I64,
                        device=device).reshape(-1, 1)


# --- primes and roots (the auxiliary base of the BEHZ product) ---------------

def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    wit = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    for p in wit:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in wit:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def ntt_primes(n: int, bits: int, count: int, exclude) -> list[int]:
    """`count` primes === 1 mod 2n below 2^bits, scanning downward."""
    step = 2 * n
    p = ((1 << bits) - 1) // step * step + 1
    out = []
    while len(out) < count:
        if p not in exclude and is_prime(p):
            out.append(p)
        p -= step
    return out


def root_2n(q: int, n: int) -> int:
    """A primitive 2n-th root of unity mod the prime q."""
    g = 2
    while True:
        psi = pow(g, (q - 1) // (2 * n), q)
        if pow(psi, n, q) == q - 1:
            return psi
        g += 1


# --- the NTT ---------------------------------------------------------------

class Base:
    """An RNS base of moduli qs with 2n-th roots psis: the moduli as a
    column and the bit-reversed power tables of psi and psi^-1."""

    def __init__(self, qs, psis, n: int, ar: Arith, device):
        self.qs, self.n, self.ar = [int(q) for q in qs], n, ar
        self.r, self.logn = len(self.qs), n.bit_length() - 1
        self.q = col(self.qs, device)                        # (r, 1)
        self.q3 = self.q.reshape(-1, 1, 1)
        exact = Arith()
        brv = torch.tensor([int(format(i, f"0{self.logn}b")[::-1], 2)
                            for i in range(n)], device=device)

        def table(roots):
            pw = torch.ones((self.r, n), dtype=I64, device=device)
            base = col(roots, device)                          # psi^m
            m = 1
            while m < n:
                pw[:, m:2 * m] = exact.mul(pw[:, :m], base, self.q)
                base = exact.mul(base, base, self.q)
                m *= 2
            return pw[:, brv]

        self.psi = table(psis)
        self.psiinv = table([pow(int(p), -1, q) for p, q in zip(psis,
                                                                self.qs)])
        self.ninv = col([pow(n, -1, q) for q in self.qs], device)

    def forward(self, x):
        """NTT of x (..., r, n) on the last axis, bit-reversed order out."""
        n, shape = self.n, x.shape
        lead = shape[:-1]
        for s in range(self.logn):
            m, step = 1 << s, n >> (s + 1)
            xr = x.reshape(lead + (m, 2, step))
            u, v = xr[..., 0, :], xr[..., 1, :]
            w = self.psi[:, m:2 * m, None]
            t = self.ar.mul(v, w, self.q3)
            x = torch.stack([add(u, t, self.q3), sub(u, t, self.q3)],
                            dim=-2).reshape(shape)
        return x

    def inverse(self, x):
        """Inverse NTT of x (..., r, n): bit-reversed order in, natural
        order out, n^-1 included."""
        n, shape = self.n, x.shape
        lead = shape[:-1]
        for s in reversed(range(self.logn)):
            m, step = 1 << s, n >> (s + 1)
            xr = x.reshape(lead + (m, 2, step))
            u, v = xr[..., 0, :], xr[..., 1, :]
            w = self.psiinv[:, m:2 * m, None]
            x = torch.stack([add(u, v, self.q3),
                             self.ar.mul(sub(u, v, self.q3), w, self.q3)],
                            dim=-2).reshape(shape)
        return self.ar.mul(x, self.ninv, self.q)

    def small(self, d):
        """Small signed values d (..., n) as residues (..., r, n)."""
        d = d.to(I64)[..., None, :]
        return torch.where(d < 0, d + self.q, d.expand(
            d.shape[:-2] + (self.r, self.n)))


# --- the keystream and the samplers ------------------------------------------

def _rotl(x, c: int):
    return ((x << c) | (x >> (32 - c))) & M32


def keystream(nblocks: int, key_byte: int, nonces, device,
              counter0: int = 0) -> torch.Tensor:
    """Salsa20/20 keystream of each nonce (Python ints below 2^64): (J,
    nblocks * 16) u32 words as int64, word w holding bytes 4w..4w+3."""
    nv = torch.tensor([[int(v) & M32, int(v) >> 32] for v in nonces],
                      dtype=I64, device=device)
    ctr = torch.arange(nblocks, dtype=I64, device=device) + counter0
    shape = (len(nonces), nblocks)
    kw = key_byte * 0x01010101
    full = lambda v: torch.full(shape, v, dtype=I64, device=device)
    j = [full(SIGMA[0]), full(kw), full(kw), full(kw), full(kw),
         full(SIGMA[1]), nv[:, :1].expand(shape), nv[:, 1:].expand(shape),
         (ctr & M32).expand(shape), (ctr >> 32).expand(shape),
         full(SIGMA[2]), full(kw), full(kw), full(kw), full(kw),
         full(SIGMA[3])]
    x = list(j)
    quarters = ((0, 4, 8, 12), (5, 9, 13, 1), (10, 14, 2, 6), (15, 3, 7, 11),
                (0, 1, 2, 3), (5, 6, 7, 4), (10, 11, 8, 9), (15, 12, 13, 14))
    for _ in range(10):
        for a, b, c, d in quarters:
            x[b] = x[b] ^ _rotl((x[a] + x[d]) & M32, 7)
            x[c] = x[c] ^ _rotl((x[b] + x[a]) & M32, 9)
            x[d] = x[d] ^ _rotl((x[c] + x[b]) & M32, 13)
            x[a] = x[a] ^ _rotl((x[d] + x[c]) & M32, 18)
    words = torch.stack([(x[i] + j[i]) & M32 for i in range(16)], dim=-1)
    return words.reshape(len(nonces), nblocks * 16)


def stream_bytes(words, start: int, count: int):
    """`count` stream bytes from byte `start` (a multiple of 4)."""
    w = words[..., start // 4:(start + count + 3) // 4]
    b = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    return b.reshape(w.shape[:-1] + (-1,))[..., :count]


def stream_u32(words, start: int, count: int):
    return words[..., start // 4:start // 4 + count]


def ternary(byts):
    return torch.div(byts, 85, rounding_mode="floor") - 1


def gaussian(u32):
    bounds = torch.tensor(GAUSS_BOUNDS, dtype=I64, device=u32.device)
    d = (u32[..., None] >= bounds).sum(dim=-1) - 19
    d = torch.where(u32 == 0, -16, d)
    return torch.where(u32 >= (1 << 32) - 128, 16, d)


def uniform(words, start: int, count: int, q):
    """floor(u (q - 1) / 2^64) of the `count` u64 lanes from byte `start`
    (a multiple of 8); q broadcasts against the lanes."""
    w = stream_u32(words, start, 2 * count)
    lo, hi = w[..., 0::2], w[..., 1::2]
    b = q - 1
    b_lo, b_hi = b & M32, b >> 32
    p_ll, p_lh, p_hl, p_hh = lo * b_lo, lo * b_hi, hi * b_lo, hi * b_hi
    mid = ((p_ll >> 32) & M32) + (p_lh & M32) + (p_hl & M32)
    return p_hh + ((p_lh >> 32) & M32) + ((p_hl >> 32) & M32) + (mid >> 32)


def encrypt_nonce(v: int) -> int:
    return v if v == 0 else v | NONCE_HIGH


def keygen_nonce(v: int) -> int:
    return v & (NONCE_HIGH - 1)


# --- BFV ----------------------------------------------------------------------

class RefContext:
    """The reference over one configuration: n, moduli q (the last is
    dropped after encryption), their 2n-th roots psi, t and gamma."""

    def __init__(self, cfg: dict, device, fp64: bool = False):
        self.ar = ar = Arith(fp64)
        self.device = device
        self.n, self.t = int(cfg["n"]), int(cfg["t"])
        self.qs = [int(q) for q in cfg["q"]]
        self.gamma = int(cfg["gamma"])
        psis = [int(p) for p in cfg["psi"]]
        self.r, self.k = len(self.qs), len(self.qs) - 1
        self.full = Base(self.qs, psis, self.n, ar, device)
        self.drop = Base(self.qs[:-1], psis[:-1], self.n, ar, device)
        kept, ql = self.qs[:-1], self.qs[-1]
        self.q_last, self.half = ql, ql >> 1
        self.half_mod = col([self.half % q for q in kept], device)
        self.inv_last = col([pow(ql % q, -1, q) for q in kept], device)
        self.delta = col([q // self.t for q in kept], device)
        qp = 1
        for q in kept:
            qp *= q
        self.q_prod = qp
        self.inv_punct = col([pow(qp // q % q, -1, q) for q in kept], device)
        self._mult = None

    # keys and encryption

    def keygen(self, nonce: int):
        """-> (sk (r, n), pk (2, r, n)), both NTT domain."""
        n, r, fb = self.n, self.r, self.full
        words = keystream(-(-(9 * r * n + 4 * n) // 64), KEY_BYTE_MAIN,
                          [keygen_nonce(nonce)], self.device)[0]
        s = ternary(stream_bytes(words, 0, n))
        a = uniform(words, n, r * n, fb.q.repeat_interleave(n, 0)[:, 0]
                    ).reshape(r, n)
        e = gaussian(stream_u32(words, n + 8 * r * n, n))
        sk = fb.forward(fb.small(s))
        pk0 = neg(add(self.ar.mul(a, sk, fb.q), fb.forward(fb.small(e)),
                      fb.q), fb.q)
        return sk, torch.stack([pk0, a])

    def drop_last(self, c):
        """Divide (..., r, n) by q_last with rounding -> (..., r-1, n)."""
        ql, q = self.q_last, self.drop.q
        ra = c[..., -1:, :] + self.half
        ra = torch.where(ra >= ql, ra - ql, ra)
        tmp = torch.remainder(ra, q)
        tmp = torch.where(tmp < self.half_mod, tmp + q, tmp) - self.half_mod
        rest = c[..., :-1, :]
        v = torch.where(rest < tmp, rest + q, rest) - tmp
        return self.ar.mul(v, self.inv_last, q)

    def encrypt(self, pk, m, nonces):
        """pk (2, r, n), messages m (J, n) in [0, t), J nonces ->
        (J, 2, r-1, n) coefficient-domain ciphertexts."""
        n, fb, t = self.n, self.full, self.t
        words = keystream(-(-9 * n // 64), KEY_BYTE_MAIN,
                          [encrypt_nonce(int(v)) for v in nonces],
                          self.device)
        u = ternary(stream_bytes(words, 0, n))
        e = gaussian(stream_u32(words, n, 2 * n)).reshape(-1, 2, n)
        u_hat = fb.forward(fb.small(u))                     # (J, r, n)
        c = fb.inverse(self.ar.mul(u_hat[:, None], pk, fb.q))
        c = c + fb.small(e)
        c = torch.where(c > fb.q, c - fb.q, c)   # the stated add: > q only
        c = self.drop_last(c)
        m = m.to(I64)[:, None, :]
        fix = (m >= t - (t + 1) // 2).to(I64)
        c0 = torch.remainder(c[:, 0] + m * self.delta + fix, self.drop.q)
        return torch.stack([c0, c[:, 1]], dim=1)

    def decrypt(self, sk, ct):
        """sk (r, n) NTT domain, ct (J, 2, r-1, n) -> (J, n) round(t x / Q)
        mod t, x = c0 + c1 s over the r-1 kept moduli; -1 where t x / Q is
        within 1e-6 of a rounding tie (no ciphertext decrypts there)."""
        db, q = self.drop, self.drop.q
        x = db.inverse(self.ar.mul(db.forward(ct[:, 1]), sk[:-1], q))
        x = add(x, ct[:, 0], q)
        y = self.ar.mul(x, self.inv_punct, q)
        tt = torch.full_like(y, self.t)
        b, a = _mul_small(tt, y, q.expand_as(y))
        f = (b.double() / q.double()).sum(dim=-2)
        fr = f - torch.floor(f)
        m = torch.remainder(a.sum(dim=-2) + torch.floor(f + 0.5).to(I64),
                            self.t)
        return torch.where((fr - 0.5).abs() < 1e-6, -1, m)

    def relin_keygen(self, sk, nonce: int):
        """Relinearization keys (2, k, r, n), NTT domain: key0_j =
        -(a_j s + e_j) + P s^2 on modulus row j (P = q_last), key1_j =
        a_j, from the key-byte-2 stream."""
        n, r, k, fb = self.n, self.r, self.k, self.full
        per = 8 * r * n + 4 * n
        words = keystream(-(-(k * per) // 64), KEY_BYTE_RELIN,
                          [keygen_nonce(nonce)], self.device)[0]
        keys = words[:k * per // 4].reshape(k, per // 4)
        qcol = fb.q.repeat_interleave(n, 0)[:, 0]
        a = uniform(keys, 0, r * n, qcol).reshape(k, r, n)
        e = fb.small(gaussian(stream_u32(keys, 8 * r * n, n)))
        x = neg(add(self.ar.mul(a, sk, fb.q), fb.forward(e), fb.q), fb.q)
        s2 = self.ar.mul(sk, sk, fb.q)
        p = col([self.q_last % q for q in self.qs[:-1]], self.device)
        term = self.ar.mul(s2[:k], p, fb.q[:k])
        j = torch.arange(k, device=self.device)
        x[j, j] = add(x[j, j], term, fb.q[:k])
        return torch.stack([x, a])

    # the BEHZ product

    def _mult_setup(self):
        if self._mult is not None:
            return self._mult
        n, k, dev, ar = self.n, self.k, self.device, self.ar
        aux = ntt_primes(n, AUX_BITS, k + 1,
                         set(self.qs) | {self.gamma})
        bsk = Base(aux, [root_2n(p, n) for p in aux], n, ar, dev)
        kept, b = self.qs[:-1], aux[:k]
        msk = aux[k]
        qp = self.q_prod
        bp = 1
        for v in b:
            bp *= v
        pq = [qp // q for q in kept]
        pb = [bp // v for v in b]
        m = dict(
            bsk=bsk, msk=msk, b=col(b, dev),
            mt_q=col([M_TILDE % q for q in kept], dev),
            bcm_q_bsk=[col([pj % mm for mm in aux], dev) for pj in pq],
            bcm_q_mt=[pj % M_TILDE for pj in pq],
            neg_inv_q_mt=(-pow(qp, -1, M_TILDE)) % M_TILDE,
            q_bsk=col([qp % mm for mm in aux], dev),
            inv_mt_bsk=col([pow(M_TILDE, -1, mm) for mm in aux], dev),
            t_q=col([self.t % q for q in kept], dev),
            t_bsk=col([self.t % mm for mm in aux], dev),
            inv_q_bsk=col([pow(qp % mm, -1, mm) for mm in aux], dev),
            inv_punct_b=col([pow(p % v, -1, v) for p, v in zip(pb, b)],
                            dev),
            bcm_b_q=[col([p % q for q in kept], dev) for p in pb],
            bcm_b_msk=[p % msk for p in pb],
            inv_b_msk=pow(bp % msk, -1, msk),
            b_q=col([bp % q for q in kept], dev))
        self._mult = m
        return m

    def _conv(self, zp, rows, target):
        """sum_j zp_j * rows[j] mod target, zp (..., k, n) -> (..., kt, n)."""
        out = None
        for j in range(zp.shape[-2]):
            term = self.ar.mul(zp[..., j:j + 1, :], rows[j], target)
            out = term if out is None else add(out, term, target)
        return out

    def to_bsk(self, x):
        """x (..., k, n) in base q -> the same value in Bsk (..., k+1, n),
        exact by the m_tilde correction."""
        mm, q, ar = self._mult_setup(), self.drop.q, self.ar
        tb = mm["bsk"].q
        zp = ar.mul(ar.mul(x, mm["mt_q"], q), self.inv_punct, q)
        y = self._conv(zp, mm["bcm_q_bsk"], tb)
        ymt = torch.zeros_like(zp[..., 0, :])
        for j in range(self.k):
            ymt = ymt + zp[..., j, :] * mm["bcm_q_mt"][j]
        rr = (((ymt & M32) * mm["neg_inv_q_mt"]) & M32)[..., None, :]
        temp = torch.where(rr >= M_TILDE // 2, rr + tb - M_TILDE, rr)
        s = add(y, ar.mul(temp, mm["q_bsk"], tb), tb)
        return ar.mul(s, mm["inv_mt_bsk"], tb)

    def floor_tq(self, xq, xb):
        """floor(t x / q) (the fast conversion's error included) in Bsk."""
        mm, q, ar = self._mult_setup(), self.drop.q, self.ar
        tb = mm["bsk"].q
        zp = ar.mul(ar.mul(xq, mm["t_q"], q), self.inv_punct, q)
        conv = self._conv(zp, mm["bcm_q_bsk"], tb)
        yb = ar.mul(xb, mm["t_bsk"], tb)
        return ar.mul(sub(yb, conv, tb), mm["inv_q_bsk"], tb)

    def bsk_to_q(self, x):
        """Shenoy-Kumaresan: (..., k+1, n) in Bsk -> (..., k, n) in q."""
        mm, q, ar, k = self._mult_setup(), self.drop.q, self.ar, self.k
        msk = torch.tensor(mm["msk"], dtype=I64, device=x.device)
        xp = ar.mul(x[..., :k, :], mm["inv_punct_b"], mm["b"])
        cq = self._conv(xp, mm["bcm_b_q"], q)
        cm = None
        for j in range(k):
            term = ar.mul(xp[..., j, :], mm["bcm_b_msk"][j], msk)
            cm = term if cm is None else add(cm, term, msk)
        alpha = ar.mul(sub(cm, x[..., k, :], msk), mm["inv_b_msk"], msk)
        over = alpha > (mm["msk"] >> 1)
        mag = torch.where(over, msk - alpha, alpha)[..., None, :]
        corr = ar.mul(mag, mm["b_q"], q)
        return torch.where(over[..., None, :], add(cq, corr, q),
                           sub(cq, corr, q))

    def _tensor(self, base: Base, x):
        """x (J, 2, 2, r, n) (operand, component) -> (J, 3, r, n) negacyclic
        tensor product c0 = a0 b0, c1 = a0 b1 + a1 b0, c2 = a1 b1."""
        f = base.forward(x)
        mul = lambda o1, c1, o2, c2: base.inverse(self.ar.mul(
            f[:, o1, c1], f[:, o2, c2], base.q))
        c1 = add(mul(0, 0, 1, 1), mul(0, 1, 1, 0), base.q)
        return torch.stack([mul(0, 0, 1, 0), c1, mul(0, 1, 1, 1)], dim=1)

    def mul(self, a, b):
        """BEHZ product of a, b (J, 2, k, n) -> (J, 3, k, n)."""
        mm = self._mult_setup()
        x = torch.stack([a, b], dim=1)                       # (J, 2, 2, k, n)
        cq = self._tensor(self.drop, x)
        cb = self._tensor(mm["bsk"], self.to_bsk(x))
        return self.bsk_to_q(self.floor_tq(cq, cb))

    def relinearize(self, ct3, rlk):
        """(J, 3, k, n) + relinearization keys -> (J, 2, k, n): c2's RNS
        digits over the full base through rlk, P dropped, added to c0, c1."""
        fb, q = self.full, self.drop.q
        d = torch.remainder(ct3[:, 2, :, None, :], fb.q)     # (J, k, r, n)
        dh = fb.forward(d)
        acc = []
        for h in range(2):
            s = None
            for j in range(self.k):
                term = self.ar.mul(dh[:, j], rlk[h, j], fb.q)
                s = term if s is None else add(s, term, fb.q)
            acc.append(s)
        cc = self.drop_last(fb.inverse(torch.stack(acc, dim=1)))
        return add(ct3[:, :2], cc, q)
