"""The command itself: no card, no result; a checkout without the library,
no result; on a card (a test marked gpu, which decides in the test), one
cell for a second."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.harness.manifest import BENCH, ROOT

ARGS = ["--workload", "32k_9q.mulrelin", "--seed", "2147483999",
        "--seconds", "1", "--trace", "0"]


def command(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=str(cwd), capture_output=True, text=True,
                          timeout=600)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = command(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_bare_benchmark_directory_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = command(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
def test_one_cell_for_a_second_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = command(ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    assert {"server_mults_per_s", "setup_s"} <= set(result["metrics"])
