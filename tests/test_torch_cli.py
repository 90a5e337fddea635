"""The port's CLI (`python -m ntt_cuda_tpu_torch`) on the CPU: every
subcommand with `--device cpu` prints the JAX CLI's PASS lines, and its
.npz files interchange with the JAX CLI's (`ntt_cuda_tpu.cli`)."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ntt_cuda_tpu import cli as jcli
from ntt_cuda_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("family", ["60bit", "30bit"])
def test_ntt_test(capsys, family):
    assert cli.main(CPU + ["ntt-test", "--n", "2048", "--family",
                           family]) == 0
    out = capsys.readouterr().out
    assert "polymul vs schoolbook golden model: PASS" in out
    assert f"{family} family" in out


def test_decryption_test(capsys):
    assert cli.main(CPU + ["decryption-test", "--fixtures",
                           str(REPO / "tests" / "fixtures")]) == 0
    assert "reference golden vectors (n=4096, r=3): PASS" in \
        capsys.readouterr().out


def test_keygen_test(capsys):
    assert cli.main(CPU + ["keygen-test", "--samples", "262144"]) == 0
    out = capsys.readouterr().out
    assert "[keygen-test] 262144 ternary samples" in out
    assert out.rstrip().endswith("[keygen-test] PASS")


def test_demo(capsys):
    assert cli.main(CPU + ["demo"]) == 0
    out = capsys.readouterr().out
    assert "[demo] decrypt(encrypt(m)) == m: PASS" in out
    assert "device=cpu fusion=op n=4096" in out


def test_demo_time(capsys, monkeypatch):
    """demo --time with short chains (2 and 8 steps, patched in here): three
    per-phase lines in the JAX CLI's format, each a slope that
    time_chained clamps at 0 (two short chains on a loaded CPU can read
    0; test_torch_graphs.py holds the slope positive on a chain of known
    cost), then the eager medians on a line of their own."""
    phase_times = cli._phase_times
    monkeypatch.setattr(cli, "_phase_times", lambda ctx, params:
                        phase_times(ctx, params, inner=(2, 8)))
    assert cli.main(["--device", "cpu", "demo", "--time"]) == 0
    lines = capsys.readouterr().out.splitlines()
    for phase in ("keygen ", "encrypt", "decrypt"):
        line = next(ln for ln in lines if ln.startswith(f"[demo] {phase} "))
        assert line.endswith(" us") and float(line.split()[-2]) >= 0
    assert any(ln.startswith("[demo] one eager call (median): ")
               for ln in lines)


def test_keys_encrypt_decrypt(tmp_path, capsys):
    keys, ct = str(tmp_path / "keys.npz"), str(tmp_path / "ct.npz")
    assert cli.main(CPU + ["keys", "--out", keys]) == 0
    assert cli.main(CPU + ["encrypt", "--keys", keys, "--out", ct]) == 0
    assert cli.main(CPU + ["decrypt", "--keys", keys, "--ct", ct]) == 0
    assert "[decrypt] plaintext head: " + str(list(range(16))) in \
        capsys.readouterr().out


def test_jax_keys_and_ciphertext_decrypt_in_the_port(tmp_path, capsys):
    """The JAX CLI's keys and random-message ciphertext: the port's decrypt
    prints the JAX decrypt's head."""
    keys, ct = str(tmp_path / "keys.npz"), str(tmp_path / "ct.npz")
    assert jcli.main(["keys", "--out", keys]) == 0
    assert jcli.main(["--seed", "7", "encrypt", "--keys", keys, "--out", ct,
                      "--message", "random"]) == 0
    assert jcli.main(["decrypt", "--keys", keys, "--ct", ct]) == 0
    jax_head = capsys.readouterr().out.splitlines()[-1]
    assert cli.main(CPU + ["decrypt", "--keys", keys, "--ct", ct]) == 0
    ours = capsys.readouterr().out.splitlines()[-1]
    assert ours == jax_head and ours.startswith("[decrypt] plaintext head: ")


def test_no_card_raises(monkeypatch):
    """With no card and no --device, every subcommand raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["ntt-test"], ["ntt-test", "--family", "30bit"],
                 ["decryption-test"], ["keygen-test"], ["demo"], ["keys"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)


def test_module_entry_point():
    """`python -m ntt_cuda_tpu_torch` runs the CLI."""
    out = subprocess.run([sys.executable, "-m", "ntt_cuda_tpu_torch",
                          "--device", "cpu", "ntt-test", "--n", "2048",
                          "--family", "30bit"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "PASS" in out.stdout
