"""The command as the checker runs it: no result without a card, none from a
directory holding only the benchmark, and on the card (``cuda``) every cell
correct in a short run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


def _cli(cwd, *args, timeout=900):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_no_result_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path, "--workload", CELLS[0], "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and not p.stdout.strip()


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _cli(spec.ROOT, "--workload", CELLS[0], "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_card(workload, card):
    p = _cli(spec.ROOT, "--workload", workload, "--seed", str(2**31 + 99), "--seconds", "3")
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
