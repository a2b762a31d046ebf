"""A short run of each cell's command on the card (`-m cuda`; skips
without one): the last line is the contract's result, correct."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import cell as C

SPEC = C.load_json(os.path.join(C.ROOT, "BENCHMARK.json"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_short_run_on_the_card(card, cell):
    cmd = SPEC["command"] + ["--workload", cell, "--seed", str(2**31 + 77),
                             "--seconds", "3", "--trace", "0"]
    p = subprocess.run(cmd, cwd=C.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
