"""``correct`` comes out false when the timed path is broken underneath
(the look for a card skipped, the rest of a run driven on the CPU at a
tiny size, against the cells' own limits), and when the lower-precision
control is put in the program's place."""

import json

import pytest
import torch

from portbench.tests import tiny
from portbench import run as RUN
from portbench.lib import check as C
from portbench.lib import harness as H
from portbench.lib import registry as REG

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One torch thread; and no JAX guard, since other test modules in
    the same worker import JAX (``test_portbench_guard.py`` tests it)."""
    from portbench.lib import harness
    monkeypatch.setattr(harness, "forbidden_loaded", lambda: [])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, capsys):
    w = tiny.cell(cell)
    assert RUN.main(tiny.argv(cell), device=CPU, cell=w,
                    conf=tiny.conf(w["config"])) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_sound_run_is_correct(cell, capsys):
    res = _run(cell, capsys)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_an_update_that_leaves_the_state_unchanged(cell, capsys,
                                                   monkeypatch):
    from repro_torch.optim import adamw
    real = adamw.apply_updates

    def frozen(params, grads, state, cfg, **kw):
        _, state, mx = real(params, [g * 0 for g in grads], state,
                            adamw.OptConfig(**{**cfg.__dict__,
                                               "learning_rate": 0.0}),
                            **kw)
        return params, state, mx
    monkeypatch.setattr(adamw, "apply_updates", frozen)
    res = _run(cell, capsys)
    assert res["correct"] is False
    assert res["checks"]["dparam_gap"]["value"] > \
        res["checks"]["dparam_gap"]["limit"]


def test_an_outer_step_that_leaves_the_state_unchanged(capsys,
                                                       monkeypatch):
    from repro_torch.train import local_sgd as LS
    monkeypatch.setattr(LS, "_outer_update",
                        lambda glob, mean, mom, ls: list(glob))
    res = _run("opt-1.3b.diloco-int8", capsys)
    assert res["correct"] is False
    assert res["checks"]["dparam_gap"]["value"] > \
        res["checks"]["dparam_gap"]["limit"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_half_the_batch_left_out(cell, capsys, monkeypatch):
    """Each step's loss and gradient from the first half of its rows, the
    mean taken over them."""
    from repro_torch.models import model as M
    real = M.forward_train

    def half(params, cfg, batch, **kw):
        B = batch["tokens"].shape[0]
        if B > 1:
            batch = {k: v[:B // 2] for k, v in batch.items()}
        return real(params, cfg, batch, **kw)
    monkeypatch.setattr(M, "forward_train", half)
    if cell == "granite-3-2b.train-4k":
        # one row a microbatch: leave out the second half of the
        # microbatches
        from repro_torch.train import step as S
        real_split = S._split_microbatches
        monkeypatch.setattr(
            S, "_split_microbatches",
            lambda batch, m: real_split(batch, m)[:m // 2] * 2)
    res = _run(cell, capsys)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["granite-3-2b.train-4k"])
def test_the_control_is_not_correct(cell):
    """The reference with every matmul's inputs in float8 e4m3, put in
    the program's place, fails the cell's limits.  The DiLoCo cell's
    control is held at its own size on the card
    (``test_portbench_card.py``): at this size its loss gap, 0.01-0.05,
    does not reach the limit set at full width."""
    w = tiny.cell(cell)
    ctx = H.Ctx(cell=w, conf=tiny.conf(w["config"]), seed=12345,
                seconds=0.0, trace=False, device=CPU)
    kind = REG.traffic(w["traffic"])
    ref = kind.reference(ctx)
    control = kind.reference(ctx, quant=True)
    ok, checks = C.judge(C.readings(control, ref), w["limits"])
    assert ok is False, checks
