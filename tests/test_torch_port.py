"""The port as a package: the parameter bridge, its independence from JAX
and from ``repro``, entry points that refuse to fall back to the CPU, the
sampler, the torch-RNG init, and the serving launcher."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import params as JP  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.serve.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.sampling import sample_tokens  # noqa: E402

from test_torch_helpers import ARCH_IDS, PARITY_ARCHS, bridged, configs  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the torch twins of the examples: scripts beside the JAX ones
TWINS = sorted((ROOT / "examples").glob("torch_*.py"))
TWIN_NAMES = ["torch_decentralized_pipeline", "torch_diloco_edge",
              "torch_edge_carbon_sim",
              "torch_quickstart", "torch_serve_batched"]


# the dense parity archs, and the jamba hybrid's ssm + mlp + attn + moe
# leaves (its smoke config: an SSD mixer with an MLP, then attention and a
# 4-expert MoE)
@pytest.mark.parametrize("arch,patch", PARITY_ARCHS + [("jamba-v0.1-52b", {})],
                         ids=ARCH_IDS + ["jamba"])
def test_bridge_round_trips_exactly_and_keys_match_keystr(arch, patch):
    jcfg, tcfg = configs(arch, **patch)
    jp, tp = bridged(jcfg, tcfg)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    jkeys = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in flat}
    assert {k: tuple(v.shape) for k, v in bridge.flatten(tp)} == jkeys
    back = bridge.params_to_numpy(tp)
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        assert node.dtype == np.asarray(leaf).dtype
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_bridge_carries_bf16_bit_exactly():
    jcfg, tcfg = configs("qwen2-7b", num_kv_heads=2)
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert tp["embed"]["tok"].dtype == torch.bfloat16
    back = bridge.params_to_numpy(tp)
    a = np.asarray(jp["embed"]["tok"]).view(np.uint16)
    np.testing.assert_array_equal(back["embed"]["tok"].view(np.uint16), a)


def test_bridge_rejects_a_tree_of_another_shape():
    jcfg, tcfg = configs("qwen2-7b", num_kv_heads=2)
    tree = jax.tree.map(np.asarray, JP.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    del tree["final_norm"]
    with pytest.raises(KeyError):
        bridge.params_from_numpy(tree, tcfg, "cpu")


def test_package_imports_with_jax_blocked():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    # every module of the port, the newest slices' included
    for m in ("repro_torch.models.moe", "repro_torch.models.mamba2",
              "repro_torch.models.mla",
              "repro_torch.configs.mixtral_8x7b",
              "repro_torch.configs.jamba_v01_52b",
              "repro_torch.configs.deepseek_v3_671b",
              "repro_torch.configs.granite_3_2b",
              "repro_torch.configs.qwen15_32b",
              "repro_torch.configs.llama3_405b",
              "repro_torch.configs.whisper_medium",
              "repro_torch.configs.qwen2_vl_2b",
              "repro_torch.launch.specs",
              "repro_torch.obs.health", "repro_torch.obs.slo",
              "repro_torch.obs.analyze", "repro_torch.obs.validate",
              "repro_torch.core.placement", "repro_torch.core.placement.spec",
              "repro_torch.core.placement.search",
              "repro_torch.core.planner.dtfm",
              "repro_torch.checkpoint.spec", "repro_torch.checkpoint.elastic",
              "repro_torch.core.carbon.llmcarbon",
              "repro_torch.core.carbon.offload",
              "repro_torch.core.planner.idealized",
              "repro_torch.core.sched.thermal",
              "repro_torch.core.sched.carbon_aware",
              "repro_torch.core.sched.faults",
              "repro_torch.core.sched.orchestrator",
              "repro_torch.core.sched.fleet_sim",
              "repro_torch.core.net.fleet_arrays",
              "repro_torch.core.placement.fleet",
              "repro_torch.distributed", "repro_torch.distributed.pipeline",
              "repro_torch.distributed.runtime",
              "repro_torch.distributed.stages", "repro_torch.launch.mesh",
              "repro_torch.distributed.sharding",
              "repro_torch.distributed.act_sharding",
              "repro_torch.distributed.spmd", "repro_torch.launch.specs",
              "repro_torch.launch.dryrun", "repro_torch.launch.step_analysis",
              "repro_torch.launch.coll_attr"):
        assert m in mods, m
    assert [f.stem for f in TWINS] == TWIN_NAMES
    twins = [str(f) for f in TWINS]
    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\nimport importlib\n"
            "import importlib.util\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            f"for i, f in enumerate({twins!r}):\n"
            "    s = importlib.util.spec_from_file_location(f'twin{i}', f)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_no_file_of_the_port_imports_jax_or_repro():
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + TWINS
    assert len(files) > 20 and len(TWINS) == 5
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (f, n)


def test_entry_points_refuse_to_fall_back_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg = configs("qwen2-7b", num_kv_heads=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.init_params(tcfg)
    params = TP.init_params(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, tcfg, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.init_params(tcfg, device="cuda")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])
    from repro_torch.models import model as TM
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_paged_cache(tcfg, 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_cache(tcfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-130m"])
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([])
    from repro_torch.train.trainer import TrainerConfig
    from repro_torch.train.trainer import train as run_train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train(tcfg, TrainerConfig(steps=1))
    from repro_torch.train.local_sgd import LocalSGDConfig, train_local_sgd
    for mode in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_local_sgd(tcfg, TrainerConfig(steps=1),
                            LocalSGDConfig(replicas=2, inner_steps=1,
                                           async_mode=mode))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--local-sgd"])


def test_engine_refuses_params_on_another_device():
    _, tcfg = configs("qwen2-7b", num_kv_heads=2)
    params = TP.init_params(tcfg, device="cpu")
    params = TP.tree_map(lambda a: a.to("meta"), params)
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(params, tcfg, EngineConfig(), torch_device="cpu")


def test_init_params_distributions_follow_the_spec():
    _, tcfg = configs("opt-125m")
    g = torch.Generator().manual_seed(0)
    p = TP.init_params(tcfg, g, device="cpu")
    wq = p["decoder"]["g0"]["s0_attn"]["wq"]          # fan-in d
    assert abs(float(wq.std()) - tcfg.d_model ** -0.5) < 0.01
    assert float(p["decoder"]["g0"]["s0_attn"]["bq"].abs().max()) == 0.0
    assert float(p["final_norm"]["scale"].min()) == 1.0
    pos = p["embed"]["pos"].numpy()
    np.testing.assert_allclose(pos[0, : tcfg.d_model // 2], 0.0)
    again = TP.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again["embed"]["tok"], p["embed"]["tok"])
    assert TP.count_params(tcfg) == sum(
        x.numel() for x in TP.tree_leaves(p))


def test_bf16_init_draws_directly_in_bf16():
    _, tcfg = configs("qwen2-7b", num_kv_heads=2)
    p = TP.init_params(dataclasses.replace(tcfg, param_dtype="bfloat16"),
                       device="cpu")
    assert all(x.dtype == torch.bfloat16 for x in TP.tree_leaves(p))


def test_sampler_greedy_and_topk():
    logits = torch.from_numpy(np.random.RandomState(0).randn(4, 50)
                              .astype(np.float32))
    out = sample_tokens(logits, torch.Generator().manual_seed(0),
                        torch.zeros(4), torch.zeros(4, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), logits.argmax(-1).numpy())
    top = np.argsort(logits.numpy(), axis=-1)[:, -3:]
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(20):
        out = sample_tokens(logits, gen, torch.full((4,), 1.0),
                            torch.full((4,), 3, dtype=torch.int32))
        for b in range(4):
            assert int(out[b]) in top[b]
            seen.add((b, int(out[b])))
    assert len(seen) > 4                      # it samples, not argmax
    mixed = sample_tokens(logits, gen, torch.tensor([0.0, 1.0, 0.0, 1.0]),
                          torch.tensor([0, 3, 0, 3], dtype=torch.int32))
    assert int(mixed[0]) == int(logits[0].argmax())
    assert int(mixed[2]) == int(logits[2].argmax())


def test_kernel_build_helpers(monkeypatch, tmp_path):
    assert len(build.c_args("p" * 10 + "i" * 12 + "f" + "i" + "p")) == 25
    import ctypes
    assert build.c_args("lip") == [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_void_p]
    lib = build._lib_path("flash_decode")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith(
        "flash_decode-")
    assert {p.stem for p in build.CSRC.glob("*.cu")} == {
        "flash_decode", "flash_attn_fwd", "flash_attn_bwd", "quant8",
        "ssd_scan", "adamw"}
    header = build.CSRC / "flash_attn.cuh"
    assert header.is_file()
    # the shared header is part of every library's name
    monkeypatch.setattr(build, "CSRC", tmp_path)
    for name in ("flash_attn_fwd.cu", "flash_attn.cuh"):
        (tmp_path / name).write_text("// a")
    before = build._lib_path("flash_attn_fwd")
    (tmp_path / "flash_attn.cuh").write_text("// b")
    assert build._lib_path("flash_attn_fwd") != before
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_serve_launcher_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve
    out = tmp_path / "m.jsonl"
    serve.main(["--torch-device", "cpu", "--batch", "3", "--max-new", "3",
                "--metrics-out", str(out)])
    text = capsys.readouterr().out
    assert "9 tokens" in text and "attn=kernel" in text
    assert out.read_text().count("\n") > 3


def test_resolve_device_names_the_current_card_for_cuda(monkeypatch):
    """The trainer and local SGD check that caller weights live on their
    device: tensors made on ``"cuda"`` report ``cuda:<n>``, so ``"cuda"``
    (and the default) resolve to that indexed device and a plain ``!=``
    holds them."""
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cuda0, cuda1 = torch.device("cuda:0"), torch.device("cuda:1")
    assert resolve_device(None) == cuda0 and resolve_device("cuda") == cuda0
    assert resolve_device(torch.device("cuda")) == cuda0
    assert resolve_device("cuda:1") == cuda1 != cuda0
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def _load_twin(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"twin_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", TWIN_NAMES)
def test_example_twins_raise_without_a_card_unless_asked_for_the_cpu(
        name, monkeypatch, capsys):
    """Each twin defaults to the card and raises without one, as the
    launchers do; ``--torch-device cpu`` runs it (at a tiny size)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    twin = _load_twin(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main([])
    if name == "torch_decentralized_pipeline":     # a 1 x 2 mesh
        monkeypatch.setattr(twin, "DATA", 1)
        monkeypatch.setattr(twin, "STAGES", 2)
    small = {"torch_decentralized_pipeline": ["--steps", "12", "--batch",
                                              "2", "--seq", "32",
                                              "--microbatches", "2"],
             "torch_quickstart": ["--steps", "2", "--batch", "2",
                                  "--seq", "16"],
             "torch_diloco_edge": ["--rounds", "1", "--inner", "2",
                                   "--batch", "2", "--seq", "16"],
             "torch_serve_batched": ["--arch", "qwen2-7b", "--requests",
                                     "2", "--max-new", "3"],
             "torch_edge_carbon_sim": ["--steps", "10"]}[name]
    twin.main(small + ["--torch-device", "cpu"])
    out = capsys.readouterr().out
    assert {"torch_decentralized_pipeline": "executes: loss",
            "torch_quickstart": "operational CO2 :",
            "torch_diloco_edge": "naive every-step sync:",
            "torch_serve_batched": "served 2 requests",
            "torch_edge_carbon_sim": "net reduction"}[name] in out
