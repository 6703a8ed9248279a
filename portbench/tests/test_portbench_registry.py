"""The harness finds every configuration, cell, traffic kind, metric and
kernel work count by name, and BENCHMARK.json keeps to its contract."""

import json
import re

import pytest

from portbench.tests.tiny import CELLS, ROOT
from portbench.lib import registry as REG

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = REG.benchmark()


def test_benchmark_has_exactly_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cells_in_order_each_one_chip():
    assert [w["name"] for w in BENCH["workloads"]] == list(CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_names_its_config_and_traffic(cell):
    w = REG.workload(cell)
    entry = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert w["name"] == cell
    assert (w["config"], w["traffic"], w["why"]) == (
        entry["config"], entry["traffic"], entry["why"])
    conf = REG.config(w["config"])
    assert conf["name"] == w["config"]
    kind = REG.traffic(w["traffic"])
    assert callable(kind.run) and callable(kind.reference)
    assert kind.MIN_TRACED >= 1
    assert set(w["limits"]) == {"loss_gap", "grad_gap", "dparam_gap"}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry_matches_its_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    widths = ("hidden", "intermediate", "head", "_dim", "_rank", "ffn",
              "num_attention_heads", "num_key_value_heads")
    assert not any(w in k for k in entry["reduced"] for w in widths)
    for k in entry["reduced"]:
        assert k in conf


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(REG.metric(m["name"]).read)
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_and_a_layer(cell):
    mets = REG.cell_metrics(BENCH, cell)
    names = {m["name"] for m in mets["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert mets["per_layer"]


def test_sync_metrics_are_the_diloco_cells():
    mets = REG.cell_metrics(BENCH, "granite-3-2b.train-4k")["per_layer"]
    assert {"sync_ms_per_round", "quant8_roofline"}.isdisjoint(
        m["name"] for m in mets)
    mets = REG.cell_metrics(BENCH, "opt-1.3b.diloco-int8")["per_layer"]
    assert {"sync_ms_per_round", "quant8_roofline"} <= {
        m["name"] for m in mets}


@pytest.mark.parametrize("kernel", ["fa2", "quant8"])
def test_kernel_work_counts_found_by_name(kernel):
    assert REG.work(kernel).__doc__


def test_a_missing_piece_is_named():
    with pytest.raises(FileNotFoundError, match="no-such-cell"):
        REG.workload("no-such-cell")
    with pytest.raises(FileNotFoundError, match="no_such_metric"):
        REG.metric("no_such_metric")
