"""Which AdamW path each leaf takes, on the CPU: CPU, ``meta`` and fake
leaves run the plain loop of ``kernels/adamw/ref.py`` with no kernel
launch, the ``meta`` step runs exactly the ops the plain loop ran (the
dry run's counts), the kernel wrappers run their plain versions for CPU
tensors and refuse abstract ones, and the tracer's ``adamw/fused_share``
counter reads once a step.  The kernels themselves are held to the plain
loop on the card (``tests/test_torch_cuda.py``)."""

import collections

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.kernels.adamw import kernel as K  # noqa: E402
from repro_torch.kernels.adamw import ref as R  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

SHAPES = {"w": (6, 5), "b": (7,), "stack": (2, 3, 4)}
OPT = adamw.OptConfig(learning_rate=1e-2, warmup_steps=1, clip_norm=0.5)


def tree(device="cpu", dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g).to(device=device, dtype=dtype)
            for k, s in SHAPES.items()}


def launches():
    return K.square_sums.launches, K.adamw_update.launches


def plain_loop(params, grads, state, cfg):
    """The update as ``apply_updates`` wrote it before the kernels: the
    op sequence the dry run counts."""
    leaves = [params[k] for k in sorted(params)]
    flat_g = [grads[k] for k in sorted(grads)]
    step = state["step"] + 1
    lr = adamw.schedule(cfg, step)
    gnorm = torch.stack([x.float().square().sum() for x in flat_g]).sum() \
        .sqrt()
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    for k, p, g in zip(sorted(params), leaves, flat_g):
        mu, nu = state["mu"][k], state["nu"][k]
        ndim = p.dim()
        g = g.float() * clip
        mu_f = mu.float() * b1 + (1 - b1) * g
        nu_f = nu.float() * b2 + (1 - b2) * g.square()
        delta = (mu_f / bc1) / ((nu_f / bc2).sqrt() + cfg.eps)
        if ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        mu.copy_(mu_f)
        nu.copy_(nu_f)
    state["step"] = step


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the plain versions' calls through ``optim.adamw``."""
    calls = collections.Counter()
    for name in ("adamw_update_reference", "square_sum_reference"):
        real = getattr(R, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(R, name, counted)
    return calls


@pytest.mark.parametrize("param_dtype,moment_dtype", [
    (torch.float32, "float32"), (torch.bfloat16, "float32"),
    (torch.bfloat16, "bfloat16")], ids=["f32", "bf16-f32", "bf16-bf16"])
def test_cpu_leaves_take_the_plain_loop_bit_for_bit(param_dtype,
                                                    moment_dtype,
                                                    plain_calls):
    cfg = adamw.OptConfig(**{**OPT.__dict__, "moment_dtype": moment_dtype})
    got, want = tree(dtype=param_dtype), tree(dtype=param_dtype)
    s_got, s_want = (adamw.init_opt_state(t, cfg) for t in (got, want))
    before = launches()
    for i in range(3):
        grads = tree(dtype=param_dtype, seed=i + 1)
        adamw.apply_updates(got, grads, s_got, cfg)
        plain_loop(want, grads, s_want, cfg)
    assert launches() == before
    assert plain_calls == {"adamw_update_reference": 3 * len(SHAPES),
                           "square_sum_reference": 3 * len(SHAPES)}
    for k in SHAPES:
        assert torch.equal(got[k], want[k])
        assert torch.equal(s_got["mu"][k], s_want["mu"][k])
        assert torch.equal(s_got["nu"][k], s_want["nu"][k])
    assert int(s_got["step"]) == 3


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_meta_leaves_run_the_plain_loops_ops(plain_calls):
    """The dry run traces the step on ``meta`` leaves: they take the plain
    loop, with the very ops (and counts) the loop ran before the kernels,
    and launch nothing."""
    counts = []
    before = launches()
    for run in (adamw.apply_updates, plain_loop):
        params = tree(device="meta")
        state = adamw.init_opt_state(params, OPT)
        grads = tree(device="meta", seed=1)
        with OpLog() as log:
            run(params, grads, state, OPT)
        counts.append(log.ops)
    assert counts[0] == counts[1]
    assert launches() == before
    assert plain_calls["adamw_update_reference"] == len(SHAPES)


def test_fake_cuda_leaves_take_the_plain_norm(plain_calls):
    """Fake tensors report a CUDA device but hold no data: no kernel is
    asked to read them, and the plain sums trace the norm."""
    before = launches()
    with FakeTensorMode():
        grads = [torch.empty(s, device="cuda") for s in SHAPES.values()]
        assert not any(K.takes(t) for t in grads)
        assert not K.update_takes(*grads[:1] * 4)
        assert adamw.global_norm(grads).device.type == "cuda"
    assert launches() == before
    assert plain_calls == {"square_sum_reference": len(SHAPES)}


def test_fused_share_is_counted_once_a_step():
    tr = trace.Tracer(enabled=True)
    old = trace.set_tracer(tr)
    try:
        params = tree()
        state = adamw.init_opt_state(params, OPT)
        for i in range(2):
            adamw.apply_updates(params, tree(seed=i + 1), state, OPT)
    finally:
        trace.set_tracer(old)
    got = [(e["name"], e["args"]["value"]) for e in tr.events
           if e["ph"] == "C"]
    assert got == [("adamw/fused_share", 0.0)] * 2


def test_kernel_wrappers_run_the_plain_versions_on_the_cpu():
    before = launches()
    xs = list(tree(dtype=torch.bfloat16).values())
    assert torch.equal(K.square_sums(xs),
                       torch.stack([x.float().square().sum() for x in xs]))
    p, mu, nu = torch.randn(9), torch.zeros(9), torch.zeros(9)
    want_p, want_mu, want_nu = p.clone(), mu.clone(), nu.clone()
    g = torch.randn(9).bfloat16()
    hyper = dict(lr=torch.tensor(1e-2), clip=torch.tensor(0.5),
                 bc1=torch.tensor(0.1), bc2=torch.tensor(0.05), b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1, decay=False)
    K.adamw_update(p, g, mu, nu, **hyper)
    R.adamw_update_reference(want_p, g, want_mu, want_nu, **hyper)
    assert torch.equal(p, want_p) and torch.equal(mu, want_mu) \
        and torch.equal(nu, want_nu)
    assert launches() == before


def test_kernel_wrappers_refuse_meta_tensors():
    x = torch.empty(8, device="meta")
    scalar = torch.tensor(1.0)
    with pytest.raises(ValueError, match="meta"):
        K.square_sums([x])
    with pytest.raises(ValueError, match="meta"):
        K.adamw_update(x, x, x, x, lr=scalar, clip=scalar, bc1=scalar,
                       bc2=scalar, b1=0.9, b2=0.95, eps=1e-8,
                       weight_decay=0.1, decay=False)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(8), lambda: torch.zeros(8, device="meta"),
    lambda: torch.zeros(8, dtype=torch.float16),
    lambda: torch.zeros(4, 4).t()], ids=["cpu", "meta", "fp16", "strided"])
def test_takes_only_card_tensors(make):
    t = make()
    assert not K.takes(t)
    assert not K.update_takes(t, t, t, t)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_only_abstract_leaves_bypass_the_wrappers(device, monkeypatch):
    """``apply_updates`` hands every leaf with data to the kernel wrappers,
    which alone choose kernel, plain version or refusal; only ``meta``
    (and fake) leaves go to the plain loop directly."""
    calls = collections.Counter()
    for name in ("adamw_update", "square_sums"):
        real = getattr(K, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(K, name, counted)
    params = tree(device=device)
    state = adamw.init_opt_state(params, OPT)
    adamw.apply_updates(params, tree(device=device, seed=1), state, OPT)
    want = ({"adamw_update": len(SHAPES), "square_sums": 1}
            if device == "cpu" else {})
    assert calls == want
