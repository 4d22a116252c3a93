"""chip_smoke.py's contract on a machine without a card: it exits non-zero
and prints no result, from the repo and from a directory that holds the
script alone."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(alone, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    run = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode != 0
    assert run.stdout == ""
    assert "cuda" in run.stderr.lower()
