"""A measurement never runs without a card, nothing under portbench/
imports JAX, Flax or the JAX package, and the reference imports nothing
of the program."""

import ast
import sys
from pathlib import Path

import pytest

from portbench.tests.tiny import ROOT
from portbench.lib import harness as H

BENCH = ROOT / "portbench"
SOURCES = sorted(p for p in BENCH.rglob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imports(path))


def test_the_harness_reads_no_old_benchmark():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path


def test_forbidden_modules_compared_by_whole_top_level_name():
    assert H.forbidden_loaded(["repro_torch", "repro_torch.train",
                               "jaxtyping", "flaxen"]) == []
    assert H.forbidden_loaded(["repro.models", "jax", "jaxlib.xla",
                               "flax.linen", "torch"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_with_jax_loaded_prints_no_result(capsys, monkeypatch):
    """Once the window has closed, a process that holds JAX or the JAX
    package exits non-zero, names what it found and prints no result."""
    import torch

    from portbench import run as RUN
    from portbench.tests import tiny
    monkeypatch.setattr(H, "forbidden_loaded", lambda: ["jax"])
    w = tiny.cell("granite-3-2b.train-4k")
    rc = RUN.main(tiny.argv(w["name"]), device=torch.device("cpu"), cell=w,
                  conf=tiny.conf(w["config"]))
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err


def test_without_a_card_a_run_fails_and_prints_no_result(capsys,
                                                          monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from portbench import run as RUN
    with pytest.raises(SystemExit) as exc:
        RUN.main(["--workload", "granite-3-2b.train-4k", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert exc.value.code not in (0, None)
    assert "no CUDA card" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_too_few_cards_fail(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit, match="needs 1 cards"):
        H.require_cards(1)


def test_a_run_outside_a_checkout_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the
    program is missing, and the run exits non-zero with no result."""
    import shutil
    import subprocess
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "granite-3-2b.train-4k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""}, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
