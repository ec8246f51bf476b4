"""On the card: a cell runs through the command that the benchmark's
contract gives, to a correct result line on the H100 (``-m gpu``)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import run


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with -m gpu")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["danube-train-4x8k"])
def test_a_cell_is_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", cell, "--seed", "2147483647",
                          "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900,
                         cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, last["compared"]
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["kind"].startswith("NVIDIA")
