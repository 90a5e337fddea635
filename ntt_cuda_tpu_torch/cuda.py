"""Build, load and call the hand-written CUDA kernels in `csrc/`.

The kernels are compiled with `nvcc` for `sm_90a` (Hopper), one `nvcc`
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds).  The library goes to `build/cuda-<hash>/` at
the root of the checkout, keyed by a hash of the sources and flags, and is
built at the first kernel call of a process.  Nothing here runs at import:
the package imports where there is no CUDA at all.

The same sources build as host C++ with g++ (`host_library`, into
`build/host-<hash>/`): each kernel's `#else` branch runs its blocks on
the CPU, one thread a block, behind the same C launchers, which the
tests call through ctypes.  Both builds take one body: one compiler
process per source, all at once, then the link, under a lock in `build/`
so that processes starting together compile once.

Each `extern "C"` launcher takes device pointers and the stream as
`c_void_p` (a pointer passed as a plain int would be cut to 32 bits),
launches on PyTorch's current stream, allocates nothing and returns
`cudaGetLastError()`; `launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("salsa20.cu", "decrypt_tail.cu", "fused_ops.cu", "ntt_stage.cu",
           "behz.cu", "ntt30.cu")
HEADERS = ("modarith.cuh", "ntt_block.cuh", "ntt_cluster.cuh",
           "behz_sums.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-fPIC")
BLOCK_MAX_N = 16384     # one u64 polynomial per block in shared memory:
#                         128 KB
TRANSFORM_MAX_N = 131072  # the cluster kernels (stage and whole-op
#                           transforms): one cluster of 2-8 blocks per
#                           polynomial, 16 for the two-buffer whole-op
#                           launches at 2^17
TRANSFORM30_MAX_N = 65536  # kernel 22 (u32): one cluster of 1-8 blocks
#                            per polynomial, 2-8 at 2^16

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64

# argtypes of every launcher; the last argument is always the stream.
SIGNATURES = {
    # ks (nb * 16 u32 words), nb, key word, nonce, counter0
    "ntt_salsa20": (_P, _L, _U32, _U64, _U64, _P),
    # ks (J * nb * 16 words), nb, key word, nonces (J,) u64, J, counter0
    "ntt_salsa20_batch": (_P, _L, _U32, _P, _I, _U64, _P),
    # u_b (J, n), e_d (J, 2, n) int32, n, key word, user nonces (J,) u64, J
    "ntt_salsa20_draws": (_P, _P, _I, _U32, _P, _I, _P),
    # x, c0, out, k2_rows, glob, J, r-1, n, pow2, t, neg_t, nu_t, inv_gt
    "ntt_decrypt_tail": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _U64, _U64,
                         _U64, _U64, _P),
    # x, y, out, 4 tables, consts, P, r, log n, cluster size B (0: the
    # launchers' rule)
    "ntt_half_polymul_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _P),
    # s_b, a, e_d, sk, pk0, 4 tables, consts, r, log n, B
    "ntt_keygen_fused_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _P),
    # u_b, pk, e_d, scratch, 4 tables, consts, J, r, log n, B
    "ntt_encrypt_transform_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _P),
    # scratch, m, ct, per_mod, q_last, half, fix_th, J, r, n
    "ntt_encrypt_tail": (_P, _P, _P, _P, _U64, _U64, _U64, _I, _I, _I, _P),
    # u_b, pk, c, 4 tables, consts, r, log n, B
    "ntt_encrypt_front_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _P),
    # c, e, ra, m, ct, per_mod, q_last, fix_th, rl, n
    "ntt_encrypt_tail_padded": (_P, _P, _P, _P, _P, _P, _U64, _U64, _I, _I,
                                _P),
    # c, ra, ct, per_mod, q_last, rl, n
    "ntt_drop_last_padded": (_P, _P, _P, _P, _U64, _I, _I, _P),
    # x, c0, out, per_mod, glob, rl, n, pow2, t, nu_t
    "ntt_decrypt_tail_partial": (_P, _P, _P, _P, _P, _I, _I, _I, _U64, _U64,
                                 _P),
    # scratch c, e, m, ct, per_mod, q_last, half, fix_th, r, n
    "ntt_encrypt_tail_e": (_P, _P, _P, _P, _P, _U64, _U64, _U64, _I, _I, _P),
    # x, d, y, nu, out, 4 tables, consts, prologue, P, r, log n, mod_idx,
    # log2 C, shard
    "ntt_stage_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _P, _I, _I, _P),
    # x, y, e, out, 4 tables, consts, prologue, ny, P, r, log n, mod_idx,
    # log2 C, shard
    "ntt_stage_inverse": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _P, _I, _I, _P),
    # the same two with the cluster size B last (0: the launchers' rule)
    "ntt_stage_forward_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _P, _I, _I, _I, _P),
    "ntt_stage_inverse_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _P, _I, _I, _I, _P),
    # the same two at B = 8 with the path last: at least 1, the engine over
    # that many clusters; 0, over as many as the card holds; -1, the kernel
    # of OCC = 1
    "ntt_stage_forward_engine": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _P, _I, _I, _I, _P),
    "ntt_stage_inverse_engine": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _P, _I, _I, _I, _P),
    # x, partner, out, 4 tables, consts, inverse, u_side, w, P, r, log n,
    # log2 C
    "ntt_cross_stage": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P),
    # x, sk, c0, scratch, out, 4 tables, consts, per_mod, glob, r-1, log n,
    # pow2, t, neg_t, nu_t, inv_gt, B
    "ntt_decrypt_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _U64, _U64, _U64, _U64, _I, _P),
    # which, x, xb, out, 7 banks, C, k, n, row0, rl, group size G (0: the
    # launchers' rule, as the wrappers pass; 1 or 2 forces G, for tests)
    "ntt_behz": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                 _I, _I, _P),
    # x, out, 4 tables, consts, inverse, P, r, log n, B
    "ntt30_transform": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

# argtypes of the host build's entries that the card's library lacks (the
# tests' seams).
HOST_SIGNATURES = {
    # partial, group size G, x, c0, out, k2_rows, glob, J, rows, n, pow2, t,
    # neg_t, nu_t, inv_gt (K2 or kernel 17 at any G)
    "ntt_decrypt_tail_group": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _U64, _U64, _U64, _U64),
    # words, count, tern (4 * count), gauss (count): k_salsa20_draws'
    # converters on given u32 words
    "ntt_draws_convert": (_P, _L, _P, _P),
}

# The stage kernels' prologues (ntt_stage.cu PRO_*).
(PRO_COPY, PRO_TERNARY, PRO_ADDNEG_GAUSS, PRO_MONT, PRO_ADDNEG, PRO_DIGIT,
 PRO_KSACC) = range(7)


def _declare(lib: ctypes.CDLL, signatures: dict) -> None:
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare argtypes/restype of every launcher of a loaded library."""
    _declare(lib, SIGNATURES)
    lib.ntt_error_string.argtypes = [ctypes.c_int]
    lib.ntt_error_string.restype = ctypes.c_char_p
    lib.ntt_stage_cluster_size.argtypes = [ctypes.c_int]
    lib.ntt_stage_cluster_size.restype = ctypes.c_int
    lib.ntt_stage_paths.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.ntt_stage_paths.restype = None
    return lib


def _hash(flags: tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def source_hash() -> str:
    """The card build's key: the sources, the headers and NVCC_FLAGS."""
    return _hash(NVCC_FLAGS)


def host_hash() -> str:
    """The host build's key: the sources, the headers and HOST_FLAGS."""
    return _hash(HOST_FLAGS)


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "ntt_cuda_tpu_torch are built from csrc/ at first use")


class NoHostCompiler(RuntimeError):
    """No g++ to build csrc/ as host code."""


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise NoHostCompiler("g++ not found: the host build of csrc/ (the "
                             "kernels' C launchers on the CPU) needs it")
    return gxx


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands together; raise with the output of the first that
    fails, after every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed ({p.returncode})"
                               f":\n{' '.join(cmd)}\n{out}")


def _build(kind: str, find, flags: tuple[str, ...],
           link_flags: tuple[str, ...]) -> Path:
    """Compile csrc/*.cu with `find()`'s compiler, one process per source
    in parallel, and link them into `build/<kind>-<hash>/` (skipped when
    the hashed build exists); return the library's path.  The first
    process builds under an exclusive lock on `build/<kind>-<hash>.lock`;
    the others wait on it, then find the library it installed."""
    out_dir = CSRC.parents[1] / "build" / f"{kind}-{_hash(flags)}"
    lib = out_dir / "libntt_cuda_tpu_torch.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.is_file():
            return lib
        cc, tag = find(), f".tmp-{os.getpid()}"
        objs = [out_dir / f"{Path(s).stem}{tag}.o" for s in SOURCES]
        tmp = out_dir / f"{tag}.so"
        try:
            _run_all([[cc, *flags, "-c", "-o", str(o), str(CSRC / s)]
                      for s, o in zip(SOURCES, objs)])
            _run_all([[cc, *link_flags, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
            os.replace(tmp, lib)   # atomic: a reader never sees half
        finally:
            for o in objs + [tmp]:
                o.unlink(missing_ok=True)
    return lib


def build() -> Path:
    """The card's library: csrc/*.cu compiled by nvcc for sm_90a."""
    return _build("cuda", find_nvcc, NVCC_FLAGS, NVCC_FLAGS)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' library, built if needed and loaded once per process."""
    return bind(ctypes.CDLL(str(build())))


@functools.cache
def host_library() -> ctypes.CDLL:
    """csrc/*.cu built as host C++ with g++ (once per checkout) and loaded
    once per process, bound like the card's library plus the host-only
    entries; raises NoHostCompiler where there is no g++."""
    lib = bind(ctypes.CDLL(str(_build("host", find_gxx, HOST_FLAGS, ()))))
    _declare(lib, HOST_SIGNATURES)
    return lib


def loaded() -> ctypes.CDLL | None:
    """The kernels' library where this process has loaded it, else None
    (nothing is built or loaded here)."""
    return library() if library.cache_info().currsize else None


def default_device(device, name: str) -> torch.device:
    """`device`, where None is the current CUDA device; raises where there
    is none.  The CPU (the kernels' plain versions) only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device (torch.cuda.is_available()"
                           f" is False); pass device='cpu' to run the "
                           f"kernels' plain versions")
    return torch.device("cuda", torch.cuda.current_device())


def kernel_device(name: str, t: torch.Tensor, tables,
                  max_n: int) -> torch.device:
    """The device a transform kernel runs on: the tables' (NTTTables).
    Raises unless `t` is a CUDA tensor and the transform length is in
    [2, max_n]; the caller's `require` checks hold every operand to the
    device returned."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    if not 2 <= tables.n <= max_n:
        raise ValueError(f"{name}: n={tables.n} outside the kernel's range "
                         f"[2, {max_n}]")
    return tables.device


def require(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of the given dtype and
    shape on `device` (what the launcher's raw pointer arithmetic needs)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call one launcher on `device`'s current stream; raise on a CUDA
    error (a refused launch never runs, and synchronize() would not
    report it)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = lib.ntt_error_string(rc).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {rc} ({msg})")
