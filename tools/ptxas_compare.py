"""Registers, stack and spills of every kernel of two builds of csrc.

    python3 tools/ptxas_compare.py --root scratch/parent

Compiles the six sources of this checkout's ntt_cuda_tpu_torch/csrc and of
the tree under --root (a checkout of another commit, e.g. from `git
archive`) with nvcc -Xptxas -v (sm_90a, the library's flags; one nvcc a
source, all twelve at once, into build/ptxas_compare) and prints, as one
JSON object: each kernel's ptxas lines in both ("new", "old"), the kernels
whose lines differ ("changed"), and those only in one build ("only_new",
"only_old").  A kernel that gained a trailing `bool` template argument
(K2's and kernel 15's WIDE) is matched, at false, with its old name.
Needs nvcc: run it on the machine with the card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ntt_cuda_tpu_torch import cuda  # noqa: E402

SOURCES = ("ntt_stage", "fused_ops", "ntt30", "behz", "decrypt_tail",
           "salsa20")


def start(csrc: Path, out: Path) -> list[subprocess.Popen]:
    out.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen(
        [cuda.find_nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(out / f"{src}.o"), str(csrc / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in SOURCES]


def lines(procs: list[subprocess.Popen]) -> dict[str, str]:
    """Each kernel's ptxas lines (registers; stack and spills)."""
    res, fn = {}, None
    for proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out}")
        for line in out.splitlines():
            m = re.search(r"(?:entry function '|properties for )(\w+)", line)
            if m:
                fn = m.group(1) if m.group(1).startswith("_Z") else None
            elif fn and ("spill" in line or "registers" in line):
                res[fn] = (res.get(fn, "") + " " + line.split(":")[-1]
                           .strip()).strip()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="the other checkout (its ntt_cuda_tpu_torch/csrc)")
    args = ap.parse_args()
    other = Path(args.root).resolve() / "ntt_cuda_tpu_torch" / "csrc"
    base = ROOT / "build" / "ptxas_compare"
    new_p = start(cuda.CSRC, base / "new")
    old_p = start(other, base / "old")
    new, old = lines(new_p), lines(old_p)
    matched, changed, only_new = {}, {}, []
    for fn, v in new.items():
        key = fn if fn in old else fn.replace("ELb0EEv", "EEv", 1)
        if key not in old:
            only_new.append(fn)
            continue
        matched[key] = fn
        if v != old[key]:
            changed[fn] = {"new": v, "old": old[key]}
    print(json.dumps({
        "kernels_new": len(new), "kernels_old": len(old),
        "matched": len(matched), "changed": changed,
        "only_new": {fn: new[fn] for fn in only_new},
        "only_old": {fn: old[fn] for fn in old if fn not in matched},
        "new": new}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
