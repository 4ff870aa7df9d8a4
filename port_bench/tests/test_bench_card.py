"""The run on its own: without a CUDA device it prints no result and exits
non-zero; on the card (marked ``cuda``) a short run of each cell is
correct and names the card."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from port_bench.tests.small import CELLS

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _run(cell, seconds="1", trace="0"):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 3), "--seconds", seconds, "--trace", trace],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run(CELLS[0])
    assert res.returncode != 0
    assert not res.stdout.strip()
    assert "no CUDA device" in res.stderr


def test_refuses_an_unknown_cell():
    res = _run("no-such-cell")
    assert res.returncode != 0 and not res.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = _run(cell, seconds="2")
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
