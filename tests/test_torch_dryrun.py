"""The port's dry run (``repro_torch.launch.{mesh,step_analysis,dryrun,
coll_attr}``): every case traced on a fake process group, each rank's
record held to the port's sharding tables and to the JAX package's HLO
count of the single-device step.

The JAX dry run's own sharded lowering fails on the installed jax
(``tests/test_hlo_analysis.py``), so its records are no oracle.  The
gates: (a) the per-device parameter bytes equal ``sharding_report`` of
the rule tables on both production meshes, and the moments are their
dtype times the same shards; (c) the dot FLOPs of the microbatched,
rematerialised step equal ``hlo_analysis.compute_totals`` of the JAX
step compiled for one device within 2 %, on 1 x 1 and, times four, on
2 x 2; (d) ``--all`` runs the 33 ``shape_applicable`` cases and a case
of each kind writes every field of the JAX record; ``coll_attr`` prints
by kind and by source.  The collectives against a real gloo run (b) and
the mesh step against JAX (e) are in ``tests/test_torch_mesh_train.py``
and ``tests/test_torch_serve_step.py``, which spawn the ranks.

The fake group is process-global: the module-scoped ``fake`` fixture
holds one mesh at a time and destroys the group when the module ends.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.registry import (INPUT_SHAPES as JAX_SHAPES,  # noqa: E402
                                    list_archs as jax_archs,
                                    shape_applicable as jax_applicable)
from repro.launch import hlo_analysis as HA  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import InputShape, input_shape  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import coll_attr as CA  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

from test_torch_helpers import one_torch_thread  # noqa: E402,F401

FLOP_RTOL = 0.02
POD = ((16, 16), ("data", "model"))
MULTIPOD = ((2, 16, 16), ("pod", "data", "model"))
SMALL = ((2, 2), ("data", "model"))
ONE = ((1, 1), ("data", "model"))
# the JAX record's fields (repro/launch/dryrun.py), with run_and_save's tag
RECORD = {"arch", "shape", "mesh", "chips", "kind", "remat", "moment_dtype",
          "rules", "microbatches", "lower_s", "compile_s",
          "flops_per_device", "bytes_accessed_per_device",
          "hlo_flops_per_device", "hlo_bytes_per_device", "memory",
          "collectives", "params_total", "params_active", "tag"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}


@pytest.fixture(scope="module")
def fake():
    """``fake(shape, names)``: a fake mesh of that shape, the group kept
    while the next call asks for the same mesh, destroyed at the end."""
    stack = contextlib.ExitStack()
    held = {}

    def mesh(dims, names):
        if held.get("key") != (dims, names):
            stack.close()
            held["mesh"] = stack.enter_context(LM.fake_mesh(dims, names))
            held["key"] = (dims, names)
        return held["mesh"]
    yield mesh
    stack.close()
    assert not dist.is_initialized()


def test_fake_mesh_is_rank_0_of_the_whole_group_and_leaves_nothing():
    assert not dist.is_initialized()
    with LM.fake_production_mesh(multi_pod=True) as mesh:
        assert dist.get_world_size() == 512 and dist.get_rank() == 0
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert mesh.device_type == "cpu"
        assert list(mesh.get_coordinate()) == [0, 0, 0]
        with pytest.raises(RuntimeError, match="no process group"):
            with LM.fake_mesh((2, 2), ("data", "model")):
                pass
    assert not dist.is_initialized()


# --------------------------------------------------------------------------- #
# (a) parameter and moment bytes against the rule tables
# --------------------------------------------------------------------------- #

PARAM_CASES = [(a, "") for a in jax_archs(assigned_only=True)] + [
    ("mixtral-8x7b", "ep_full"), ("deepseek-v3-671b", "ep_full")]


@pytest.mark.parametrize("layout", [POD, MULTIPOD], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,moe_layout", PARAM_CASES,
                         ids=[a + (f"-{m}" if m else "") for a, m in PARAM_CASES])
def test_param_bytes_equal_the_sharding_report(fake, layout, arch,
                                               moe_layout):
    mesh = fake(*layout)
    cfg = DR.case_config(arch, moe_layout)
    want = SH.sharding_report(cfg, mesh, SH._param_rules(cfg, None))
    state = DR.build_state(cfg, input_shape("train_4k"), mesh,
                           rules_name="default", moment_dtype="bfloat16")
    got = DR.local_bytes(state["params"])
    elems = sum(DR.SA.local(p).numel()
                for p in TP.tree_leaves(state["params"]))
    opt = DR.local_bytes(state["opt"])
    assert got == want["param_bytes_per_device"]
    assert opt == 2 * 2 * elems + 4          # mu and nu in bf16, the step


# --------------------------------------------------------------------------- #
# (c) dot FLOPs against the JAX step's HLO
# --------------------------------------------------------------------------- #

B, S = 4, 64


@pytest.fixture(scope="module")
def jax_flops():
    """``compute_totals`` of ``make_train_step(..., microbatches=2,
    remat="full")`` of opt-1.3b-smoke compiled for one device."""
    jcfg = jax_config("opt-1.3b-smoke")
    p = JP.init_params(jcfg, jax.random.PRNGKey(0))
    oc = JA.OptConfig()
    batch = {k: jnp.zeros((B, S), jnp.int32) for k in ("tokens", "labels")}
    hlo = jax.jit(JS.make_train_step(jcfg, oc, remat="full",
                                     microbatches=2)).lower(
        p, JA.init_opt_state(p, oc), batch).compile().as_text()
    return HA.compute_totals(hlo)["flops"]


@pytest.mark.parametrize("layout", [ONE, SMALL], ids=["1x1", "2x2"])
def test_dot_flops_match_the_jax_hlo(fake, jax_flops, layout):
    mesh = fake(*layout)
    t = DR.trace_case(get_config("opt-1.3b-smoke"),
                      InputShape("gate", S, B, "train"), mesh, remat="full",
                      microbatches=2)
    counter = t["counter"]
    ranks = mesh.size()
    got = counter.flops * ranks
    assert got == pytest.approx(jax_flops, rel=FLOP_RTOL), (
        f"{ranks} x {counter.flops} port FLOPs against {jax_flops} in the "
        f"JAX HLO; the port's by op: {dict(counter.flops_by_op)}")


# --------------------------------------------------------------------------- #
# (d) the case list, the records, coll_attr
# --------------------------------------------------------------------------- #

def test_all_runs_the_33_applicable_cases(monkeypatch):
    want = [(a, s) for a in jax_archs(assigned_only=True) for s in JAX_SHAPES
            if jax_applicable(a, s)]
    assert len(want) == 33
    assert sorted(DR.cases()) == sorted(want)
    ran = []
    monkeypatch.setattr(DR, "run_and_save",
                        lambda arch, shape, **kw: ran.append((arch, shape)))
    DR.main(["--all"])
    assert ran == list(DR.cases())
    ran.clear()
    DR.main(["--arch", "qwen2-7b", "--shape", "long_500k"])   # not applicable
    assert ran == []


KIND_CASES = [("qwen2-7b", "train_4k"), ("qwen2-7b", "prefill_32k"),
              ("qwen2-7b", "decode_32k"), ("mixtral-8x7b", "long_500k")]


@pytest.mark.parametrize("arch,shape", KIND_CASES,
                         ids=[s for _, s in KIND_CASES])
def test_a_smoke_case_of_each_kind_writes_the_jax_record(fake, tmp_path, arch,
                                                         shape):
    mesh = fake(*POD)
    rec = DR.run_and_save(arch, shape, out_dir=tmp_path, microbatches=2,
                          cfg=get_config(arch + "-smoke"), mesh=mesh)
    saved = json.loads((tmp_path / f"{arch}_{shape}_pod.json").read_text())
    assert saved == rec
    rows = DR.table(tmp_path)                    # --table's printout
    assert len(rows) == 3 and rows[2].startswith(f"| {arch} | {shape} | ")
    assert RECORD <= set(rec)
    assert set(rec["memory"]) == MEMORY
    assert {"bytes_by_op", "counts", "total_bytes"} <= set(rec["collectives"])
    kind = input_shape(shape).kind
    assert rec["kind"] == kind and rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["microbatches"] == (2 if kind == "train" else None)
    assert rec["flops_per_device"] == rec["hlo_flops_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["collectives"]["total_bytes"] == sum(
        rec["collectives"]["bytes_by_op"].values()) > 0
    if kind == "train":                  # parameters and moments in place
        assert rec["memory"]["alias_bytes"] >= (
            rec["param_bytes_per_device"] + rec["opt_bytes_per_device"] - 4)
    if shape == "long_500k":            # batch 1: the cache's sequence on
        cfg = get_config(arch + "-smoke")               # data and model
        cache = DR.M.abstract_cache(cfg, 1, 524_288)
        specs = SH.cache_shardings(cfg, mesh, cache, 1)
        assert specs["g0"]["s0_attn"]["k"][2] == ("model", "data")


def test_coll_attr_prints_by_kind_and_by_source(fake, capsys):
    mesh = fake(*SMALL)
    lines = CA.run("qwen2-7b", "train_4k", top=8, microbatches=2,
                   cfg=get_config("qwen2-7b-smoke"), mesh=mesh)
    by_op = lines[1:lines.index("== top sources ==")]
    assert lines[0] == "== by op ==" and len(by_op) >= 3
    assert {ln.split()[-1] for ln in by_op} >= {"all-gather", "all-reduce",
                                                "reduce-scatter"}
    sources = lines[lines.index("== top sources ==") + 1:]
    assert 0 < len(sources) <= 8
    assert any("backward" in ln for ln in sources)
    assert any("forward_train" in ln for ln in sources)
    with pytest.raises(SystemExit, match="decode attribution"):
        CA.run("qwen2-7b", "decode_32k")


# --------------------------------------------------------------------------- #
# The kernels refuse what a trace gives them
# --------------------------------------------------------------------------- #

def test_kernel_wrappers_refuse_fake_and_meta_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention import decode as FD
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.quant8 import kernel as QK
    from repro_torch.kernels.ssd_scan import kernel as SK
    for make in (lambda *s, **k: torch.empty(*s, device="meta", **k),
                 None):
        with contextlib.ExitStack() as stack:
            if make is None:
                stack.enter_context(FakeTensorMode())
                make = torch.empty
            q = make(1, 2, 8, 16)
            with pytest.raises(ValueError,
                               match='attn_impl="chunked"'):
                FK.flash_attention_fwd(q, q, q)
            with pytest.raises(ValueError,
                               match='attn_impl="chunked"'):
                FK.flash_attention_bwd_dq(q, q, q, q, q[..., 0], q[..., 0])
            with pytest.raises(ValueError,
                               match='attn_impl="chunked"'):
                FK.flash_attention_bwd_dkdv(q, q, q, q, q[..., 0], q[..., 0])
            pages = make(4, 16, 2, 16)
            with pytest.raises(ValueError, match="gather"):
                FD.flash_decode_paged(make(2, 2, 16), pages, pages,
                                      make(2, 2, dtype=torch.int32),
                                      make(2, dtype=torch.int32))
            x = make(1, 2, 32, 4)
            bc = make(1, 1, 32, 8)
            with pytest.raises(ValueError, match="ssd_reference"):
                SK.ssd_bhcq(x, make(1, 2, 32), make(2), bc, bc, chunk=16)
            with pytest.raises(ValueError,
                               match="quantize_reference"):
                QK.quantize_blocks(make(512))
            with pytest.raises(ValueError,
                               match="dequantize_reference"):
                QK.dequantize_blocks(make(512, dtype=torch.int8), make(2))
