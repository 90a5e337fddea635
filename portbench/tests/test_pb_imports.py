"""What the harness and the reference load, module by module, compared
by whole top-level names: neither JAX nor the JAX package, and the
reference nothing of the library either."""

import json
import subprocess
import sys

from portbench.harness.manifest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(
        root=str(ROOT), imports=imports)], capture_output=True, text=True,
        check=True, cwd=str(ROOT), env={"PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_library():
    names = loaded("import torch\n"
                   "from portbench.reference import bfv_ref\n"
                   "bfv_ref.RefContext(dict(n=64, q=[193, 257], "
                   "psi=[3, 3], t=4, gamma=7681), 'cpu')")
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "ntt_cuda_tpu",
                        "ntt_cuda_tpu_torch"}


def test_harness_loads_no_jax():
    names = loaded(
        "from portbench.harness import manifest, runner\n"
        "m = manifest.load_manifest()\n"
        "for w in m['workloads']: manifest.cell(m, w['name'])\n"
        "import ntt_cuda_tpu_torch.models.bfv")
    assert "ntt_cuda_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "ntt_cuda_tpu"}
    from portbench.harness.runner import banned_modules
    assert "ntt_cuda_tpu_torch" not in banned_modules()
