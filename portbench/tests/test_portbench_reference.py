"""The plain reference agrees with the port run on the CPU: the loss and
gradients of OPT and Granite (the port through ``attn_impl="chunked"``),
one AdamW step, the int8 round trip with error feedback and the outer
step; and a whole benchmark run of each cell on the CPU in fp32, where
the program's check steps must equal the reference's to round-off."""

import math

import pytest
import torch

from portbench.tests import tiny
from portbench.lib import weights as W
from portbench.reference import model as RM
from portbench.reference import optim as RO
from portbench.reference import train as RT

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


def _fp32(name):
    return tiny.conf(name, param_dtype="float32",
                     compute_dtype="float32")["model"]


@pytest.mark.parametrize("name", ["opt-1.3b", "granite-3-2b"])
def test_loss_and_gradients_equal_the_ports(name):
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.params import tree_leaves
    m = _fp32(name)
    tree = W.make(m, 3, CPU, torch.float32)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, m["vocab_size"], (2, 24), generator=g)
    labels = torch.randint(0, m["vocab_size"], (2, 24), generator=g)
    labels[1, :5] = -1
    leaves = tree_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = M.forward_train(tree, ModelConfig(**m),
                              {"tokens": tokens, "labels": labels},
                              attn_impl="chunked")
    grads = torch.autograd.grad(loss, leaves)
    P = RT.to_pieces(tree, m)
    ref, G = RM.loss_and_grads(P, m, tokens, labels)
    assert ref == pytest.approx(float(loss.detach()), rel=1e-5)
    for path, g_port in zip(W.paths(tree), grads):
        g_ref = torch.stack(G[path]) if len(G[path]) > 1 else G[path][0]
        torch.testing.assert_close(g_ref, g_port.reshape(g_ref.shape),
                                   rtol=1e-4, atol=1e-6)


def test_adamw_step_equals_the_ports():
    from repro_torch.optim import adamw
    m = _fp32("opt-1.3b")
    tree = W.make(m, 4, CPU, torch.float32)
    opt = tiny.cell("opt-1.3b.diloco-int8")["traffic_params"]["opt"]
    g = torch.Generator().manual_seed(2)
    grads = W.leaves(tree)
    grads = [torch.randn(p.shape, generator=g) * 3 for p in grads]
    P = RT.to_pieces(tree, m)
    G = {}
    for path, x in zip(W.paths(tree), grads):
        G[path] = list(x.unbind(0)) if len(P[path]) > 1 else [x]
    ref = RO.AdamW(P, opt, RT.decay_map(m))
    ocfg = adamw.OptConfig(**opt)
    state = adamw.init_opt_state(tree, ocfg)
    for _ in range(3):
        norms = ref.step(P, G, torch.float32)
        adamw.apply_updates(tree, grads, state, ocfg)
    for path in W.paths(tree):
        got = torch.stack(P[path]) if len(P[path]) > 1 else P[path][0]
        torch.testing.assert_close(got, W.get(tree, path), rtol=1e-6,
                                   atol=1e-7)
    total = math.sqrt(sum(v * v for v in norms.values()))
    assert total == pytest.approx(1.0, rel=1e-5)       # clipped to 1


def test_int8_with_error_feedback_equals_the_ports():
    from repro_torch.optim.compress import CompressConfig, compress_leaf
    cfg = CompressConfig(method="int8", block=256)
    g = torch.Generator().manual_seed(5)
    e_port = e_ref = None
    for _ in range(3):
        d = torch.randn(1000, generator=g) * 1e-3
        sent, e_port = compress_leaf(d, e_port, cfg)
        ref, e_ref = RO.compress(d, e_ref, 256)
        torch.testing.assert_close(ref, sent, rtol=0, atol=0)
        torch.testing.assert_close(e_ref, e_port, rtol=0, atol=0)


def test_outer_step_equals_the_ports():
    from repro_torch.train.local_sgd import LocalSGDConfig, _outer_update
    ls = LocalSGDConfig(outer_lr=0.7, outer_momentum=0.9, nesterov=True)
    g = torch.Generator().manual_seed(6)
    p = (torch.randn(300, generator=g) * 0.02).to(torch.bfloat16)
    m_port, m_ref = torch.zeros(300), torch.zeros(300)
    glob = {("w",): p.float()}
    for _ in range(3):
        d = torch.randn(300, generator=g) * 1e-3
        (p,) = _outer_update([p], [d], [m_port], ls)
        RO.outer_step(glob, {("w",): d}, {("w",): m_ref}, 0.7, 0.9, True,
                      torch.bfloat16)
    torch.testing.assert_close(glob[("w",)], p.float(), rtol=0, atol=0)
    torch.testing.assert_close(m_ref, m_port, rtol=0, atol=0)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_cpu_run_in_fp32_equals_the_reference(cell, capsys):
    """The whole run on the CPU (the look for a card skipped), the model
    in fp32: the program's check steps and the reference's differ by
    round-off only, far inside every limit."""
    import json

    from portbench import run as RUN
    w = tiny.cell(cell)
    c = tiny.conf(w["config"], param_dtype="float32",
                  compute_dtype="float32")
    assert RUN.main(tiny.argv(cell), device=CPU, cell=w, conf=c) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    for name in ("loss_gap", "grad_gap", "dparam_gap"):
        assert res["checks"][name]["value"] < 2e-5
