"""RNS-axis data parallelism for the BFV programs: ShardedBFVContext, the
single-card context's API over the 'rns' axis of an ('rns', 'coef')
mesh, on torch.distributed.

Counterpart of `ntt_cuda_tpu/parallel/rns.py`, which places the
single-chip context's constant bundles over 'rns' and lets GSPMD
partition its jitted pipelines.  Torch has no GSPMD, so this context is a
wrapper over the explicit SPMD programs (parallel/spmd.py and
spmd_mult.py) and over `inner`, the single-card BFVContext on the rank's
device.  'coef' is replicated, as in the JAX package: every column of
'coef' runs the same program on its own 'rns' group (the mesh's 'rns'
sub-mesh, taken the same way on every rank).

Which ops run sharded (R the size of 'rns'):

  * where R divides r, the ops whose JAX body places a key or a switching
    key (key_sharding / rlk_sharding) run the SPMD programs on the rank's
    rows: decrypt (L = 2: SpmdBFVContext.decrypt; L = 3:
    SpmdMultContext.decrypt3), decrypt_batch (K3 and kernel 17 once a
    message, one all-reduce for the batch), mul, square, relin_keygen,
    galois_keygen and apply_galois.  An (L, r-1, n) ciphertext is padded
    to the programs' (L, r, n) layout on the way in (a zero row for the
    dropped modulus) and the padded row is stripped on the way out;
  * the ops that the JAX package passes to its inner context with no key
    placement run on `inner` on every rank: keygen, encrypt, encrypt_batch,
    add, sub, add_plain, mul_plain and mod_switch_to_next;
  * where R does not divide r, every op runs on `inner` (the JAX package
    then replicates the r-row bundles).

`next_context()` wraps inner.next_context() again, so the next level's r
decides its branch.  The JAX package's `backend` argument (TPU or
interpret paths) has no counterpart: the kernels are the CUDA ones.

Placements follow the JAX package's rule: key_sharding() (r, n) keys,
ct_sharding() (L, r-1, n) ciphertexts and rlk_sharding() (2, r-1, r, n)
switching keys are [Shard(row axis), Replicate()] where R divides the row
count (r, r-1, r), else [Replicate(), Replicate()].  Ciphertext outputs
(add, sub, mul, square, apply_galois, add_plain, mul_plain) are DTensors
placed by ct_sharding() (a batch's row axis is its second to last),
mod_switch_to_next's by the next level's, switching keys by
rlk_sharding(); keygen's keys, encrypt's and encrypt_batch's ciphertexts
and the plaintexts are plain tensors, the same on every rank, as the JAX
package leaves them unplaced.  Arguments are plain tensors or arrays
(full) or DTensors on this context's mesh.

Collectives (parallel.mesh logs each):

  * sharded branch: decrypt one (3, n) all-reduce over 'rns'
    (decrypt_batch one (3, J, n)); mul four all-gathers (with rlk also the
    key switch's all-gather and all-reduce), square three, apply_galois
    one all-gather and one all-reduce (spmd_mult.py); each ciphertext
    output one more all-gather of its padded (L, r, n) rows, where R > 1
    (ct_sharding() is then Replicate()); relin_keygen and galois_keygen
    none;
  * `inner` ops: none, beyond one all-gather of each DTensor argument
    sharded over 'rns' (it is gathered whole first), and none where
    R = 1.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import cuda
from ..models.bfv import BFVContext
from ..ops import bfv_tail
from ..ops.modmath import I64
from ..params import BFVParams
from . import mesh as mesh_mod
from .spmd import SpmdBFVContext
from .spmd_mult import SpmdMultContext


@dataclasses.dataclass(frozen=True)
class ShardedBFVContext:
    """One rank's BFV context over the 'rns' axis of an ('rns', 'coef')
    mesh.  Every rank builds it and calls each op together."""

    inner: BFVContext
    mesh: object                        # ('rns', 'coef') DeviceMesh
    spmd: SpmdBFVContext | None         # where R divides r, else None
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @staticmethod
    def build(params: BFVParams, mesh=None,
              device=None) -> "ShardedBFVContext":
        """`mesh` None is an (R, 1) mesh over every rank of the default
        process group (make_mesh), which must be initialized.  `device`
        None is this rank's current CUDA device; "cpu" runs the kernels'
        plain versions."""
        if mesh is None and not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "ShardedBFVContext.build: no process group is initialized; "
                "call parallel.multihost.initialize(...) first or pass a mesh")
        device = cuda.default_device(device, "ShardedBFVContext.build")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if mesh is None:
            mesh = mesh_mod.make_mesh(dist.get_world_size(), 1, device.type)
        return ShardedBFVContext._wrap(BFVContext.build(params, device=device),
                                       mesh)

    @staticmethod
    def _wrap(ctx: BFVContext, mesh) -> "ShardedBFVContext":
        names = (mesh_mod.RNS_AXIS, mesh_mod.COEF_AXIS)
        if tuple(mesh.mesh_dim_names or ()) != names:
            raise ValueError(f"ShardedBFVContext needs an {names} mesh, got "
                             f"axes {mesh.mesh_dim_names}")
        sp = None
        if ctx.params.r % mesh.size(0) == 0:
            sp = SpmdBFVContext.build(ctx.params, mesh[mesh_mod.RNS_AXIS],
                                      ctx.device)
        return ShardedBFVContext(inner=ctx, mesh=mesh, spmd=sp)

    # -- placements ---------------------------------------------------------

    @property
    def R(self) -> int:
        return self.mesh.size(0)

    def _rule(self, rows: int, dim: int) -> list:
        from torch.distributed.tensor import Replicate, Shard
        return [Shard(dim) if rows % self.R == 0 else Replicate(),
                Replicate()]

    def key_sharding(self) -> list:
        """Placements of an (r, n) key."""
        return self._rule(self.inner.params.r, 0)

    def ct_sharding(self) -> list:
        """Placements of an (L, r-1, n) ciphertext."""
        return self._rule(self.inner.params.r - 1, 1)

    def rlk_sharding(self) -> list:
        """Placements of a (2, r-1, r, n) switching key."""
        return self._rule(self.inner.params.r, 2)

    # -- the ops ------------------------------------------------------------

    def keygen(self):
        """-> (sk, pk) from inner.keygen(), plain tensors."""
        return self.inner.keygen()

    def encrypt(self, pk, m_poly):
        """inner.encrypt (nonce 0, as the JAX wrapper's), a plain tensor."""
        return self.inner.encrypt(self._full("pk", pk), self._full("m_poly",
                                                                   m_poly))

    def encrypt_batch(self, pk, m_batch, nonces):
        return self.inner.encrypt_batch(self._full("pk", pk),
                                        self._full("m_batch", m_batch), nonces)

    def decrypt(self, sk, ct):
        """Plaintext (n,), a plain tensor.  Sharded branch: the SPMD
        decrypt of the padded ciphertext (decrypt3 for L = 3)."""
        if self.spmd is None:
            return self.inner.decrypt(self._full("sk", sk),
                                      self._full("ct", ct))
        ct = self._padded("ct", ct)
        if ct.shape[0] not in (2, 3):
            raise ValueError(f"ct: the sharded decrypt takes L = 2 or 3 "
                             f"components, got {ct.shape[0]}")
        sk = self._rows("sk", sk)
        out = (self.spmd.decrypt(sk, ct) if ct.shape[0] == 2 else
               self._mult.decrypt3(sk, ct))
        return out.to_local()

    def decrypt_batch(self, sk, cts):
        """(J, 2, r-1, n) -> (J, n), a plain tensor.  Sharded branch: each
        message's BEHZ partials on the rank's rows (K3 and kernel 17 once
        a message: kernel 17 takes one (rl, n) polynomial), then one
        all-reduce of the J messages' stacked (3, J, n) partials and the
        rounding."""
        if self.spmd is None:
            return self.inner.decrypt_batch(self._full("sk", sk),
                                            self._full("cts", cts))
        sk, cts = self._rows("sk", sk), self._full("cts", cts)
        if cts.dim() != 4:
            raise ValueError(f"cts: expected (J, 2, r-1, n), got "
                             f"{tuple(cts.shape)}")
        parts = [self.spmd.decrypt_partials(sk, self._padded("ct", c))
                 for c in cts]
        p = self.inner.params
        x_t, x_g = bfv_tail.psum_behz_partials(
            torch.stack([t for t, _ in parts]),
            torch.stack([g for _, g in parts]), self.spmd.group, p)
        return bfv_tail.dec_round_from_sums(x_t, x_g, p)

    def add(self, ct_a, ct_b):
        return self._ct_out(self.inner.add(self._full("ct_a", ct_a),
                                           self._full("ct_b", ct_b)))

    def sub(self, ct_a, ct_b):
        return self._ct_out(self.inner.sub(self._full("ct_a", ct_a),
                                           self._full("ct_b", ct_b)))

    def add_plain(self, ct, m_poly):
        return self._ct_out(self.inner.add_plain(
            self._full("ct", ct), self._full("m_poly", m_poly)))

    def mul_plain(self, ct, m_poly):
        return self._ct_out(self.inner.mul_plain(
            self._full("ct", ct), self._full("m_poly", m_poly)))

    def mul(self, ct_a, ct_b, rlk=None):
        """EvalMult: (3, r-1, n), or (2, r-1, n) relinearized with rlk.
        Sharded branch: SpmdMultContext.mul on the padded operands."""
        if self.spmd is None:
            return self._ct_out(self.inner.mul(
                self._full("ct_a", ct_a), self._full("ct_b", ct_b),
                rlk=None if rlk is None else self._full("rlk", rlk)))
        return self._spmd_ct(self._mult.mul(
            self._padded("ct_a", ct_a), self._padded("ct_b", ct_b),
            rlk=None if rlk is None else self._rows("rlk", rlk)))

    def square(self, ct, rlk=None):
        """EvalSquare, equal to mul(ct, ct).  Sharded branch:
        SpmdMultContext.square."""
        if self.spmd is None:
            return self._ct_out(self.inner.square(
                self._full("ct", ct),
                rlk=None if rlk is None else self._full("rlk", rlk)))
        return self._spmd_ct(self._mult.square(
            self._padded("ct", ct),
            rlk=None if rlk is None else self._rows("rlk", rlk)))

    def relin_keygen(self, sk, nonce=0):
        """Relinearization keys placed by rlk_sharding()."""
        if self.spmd is None:
            return self._place(self.inner.relin_keygen(self._full("sk", sk),
                                                       nonce=nonce),
                               self.rlk_sharding())
        return self._lift(self._mult.relin_keygen(self._rows("sk", sk),
                                                  nonce=nonce))

    def galois_keygen(self, sk, elts, nonce=0):
        """Galois switching keys {g: key}, each placed by rlk_sharding()."""
        if self.spmd is None:
            keys = self.inner.galois_keygen(self._full("sk", sk), elts,
                                            nonce=nonce)
            return {g: self._place(k, self.rlk_sharding())
                    for g, k in keys.items()}
        keys = self._mult.galois_keygen(self._rows("sk", sk), elts,
                                        nonce=nonce)
        return {g: self._lift(k) for g, k in keys.items()}

    def apply_galois(self, ct, g, gk):
        """tau_g with the key switch back to sk.  Sharded branch:
        SpmdMultContext.apply_galois on the padded ciphertext."""
        if self.spmd is None:
            return self._ct_out(self.inner.apply_galois(
                self._full("ct", ct), g, self._full("gk", gk)))
        return self._spmd_ct(self._mult.apply_galois(
            self._padded("ct", ct), g, self._rows("gk", gk)))

    def next_context(self) -> "ShardedBFVContext":
        """The context one modulus-switch down on the same mesh (cached):
        the next level's r decides its branch."""
        nxt = self._cache.get("next")
        if nxt is None:
            nxt = ShardedBFVContext._wrap(self.inner.next_context(), self.mesh)
            self._cache["next"] = nxt
        return nxt

    def mod_switch_to_next(self, ct):
        """inner.mod_switch_to_next, placed by the next level's
        ct_sharding() (the row count falls from r-1 to r-2)."""
        return self.next_context()._ct_out(
            self.inner.mod_switch_to_next(self._full("ct", ct)))

    # -- the boundary -------------------------------------------------------

    @property
    def _mult(self) -> SpmdMultContext:
        m = self._cache.get("mult")
        if m is None:
            m = self._cache["mult"] = SpmdMultContext.build(self.spmd)
        return m

    def _check_mesh(self, name: str, x) -> None:
        if x.device_mesh != self.mesh:
            raise ValueError(f"{name}: a DTensor on {x.device_mesh}, expected "
                             f"this context's mesh {self.mesh}")

    def _full(self, name: str, x):
        """An argument whole: a DTensor on this mesh gathered over each
        axis it is sharded on (one all-gather each, none where the axis
        has one rank); anything else as it is (the op checks it)."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        self._check_mesh(name, x)
        return mesh_mod.gather_whole(x)

    def _rows(self, name: str, x):
        """A key argument for the SPMD programs: a DTensor sharded over
        'rns' becomes the same block on the 'rns' sub-mesh, a replicated
        one its (whole) local tensor; anything else as it is (the program
        slices a full tensor to the rank's rows)."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        self._check_mesh(name, x)
        rns, coef = x.placements
        if coef.is_shard():
            raise ValueError(f"{name}: sharded over 'coef' ({x.placements}); "
                             f"this context replicates 'coef'")
        if rns.is_shard():
            return DTensor.from_local(x.to_local(), self.spmd.mesh, [rns],
                                      run_check=False)
        return x.to_local()

    def _padded(self, name: str, ct) -> torch.Tensor:
        """An (L, r-1, n) ciphertext whole, as the SPMD programs' padded
        (L, r, n) on the device: a zero row for the dropped modulus."""
        ct = self.inner._ct_any(name, self._full(name, ct))
        pad = torch.zeros((ct.shape[0], 1, ct.shape[2]), dtype=I64,
                          device=ct.device)
        return torch.cat([ct, pad], dim=1)

    def _spmd_ct(self, y):
        """An SPMD program's padded (L, r, n) ciphertext DTensor
        [Shard(1)] -> (L, r-1, n) placed by ct_sharding(): its rows
        gathered over 'rns' (one all-gather, where R > 1), the padded row
        stripped."""
        local = y.to_local()
        if self.R > 1:
            local = mesh_mod.all_gather(local, self.spmd.group, dim=1)
        return self._ct_out(local[:, :-1])

    def _ct_out(self, ct):
        """A whole ciphertext, the same on every rank, placed by
        ct_sharding() with its row axis the second to last."""
        from torch.distributed.tensor import Shard
        pl = self.ct_sharding()
        if pl[0].is_shard():
            pl[0] = Shard(ct.dim() - 2)
        return self._place(ct, pl)

    def _place(self, x, placements):
        """A whole tensor, the same on every rank, as a DTensor on the mesh
        with `placements`: each rank keeps its block, nothing is sent."""
        from torch.distributed.tensor import DTensor
        local = x
        for i, pl in enumerate(placements):
            if pl.is_shard():
                w = x.shape[pl.dim] // self.mesh.size(i)
                local = local.narrow(pl.dim, self.mesh.get_local_rank(i) * w,
                                     w)
        return DTensor.from_local(local.contiguous(), self.mesh, placements,
                                  run_check=False)

    def _lift(self, y):
        """An SPMD program's DTensor on the 'rns' sub-mesh -> the same local
        block on this mesh, 'coef' replicated."""
        from torch.distributed.tensor import DTensor, Replicate
        return DTensor.from_local(y.to_local(), self.mesh,
                                  [y.placements[0], Replicate()],
                                  run_check=False)
