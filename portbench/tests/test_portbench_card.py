"""On the card, at each cell's own size: one short run of each cell
prints a well-formed, correct result, and the float8 control put in the
program's place fails the cell's limits.  Skips without CUDA (decided in
the fixture)."""

import json
import subprocess
import sys

import pytest

from portbench.tests.tiny import CELLS, ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell(card, cell):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483901", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert {"tokens_per_s", "setup_s"} <= set(res["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    import torch

    from portbench.lib import check as C
    from portbench.lib import harness as H
    from portbench.lib import registry as REG
    w = REG.workload(cell)
    ctx = H.Ctx(cell=w, conf=REG.config(w["config"]), seed=2147483902,
                seconds=0.0, trace=False, device=card)
    kind = REG.traffic(w["traffic"])
    ref = kind.reference(ctx)
    torch.cuda.empty_cache()
    control = kind.reference(ctx, quant=True)
    ok, checks = C.judge(C.readings(control, ref), w["limits"])
    assert ok is False, checks
