"""The frozen yardsticks: the FLOP count, the FA-2 and int8 work counts,
the data stream and the power sampler, held to the figures the port's
records give and to the port's current code."""

import os
import stat
import sys
import time

import numpy as np
import pytest

from portbench.tests.tiny import ROOT
from portbench.lib import data, flops, peaks
from portbench.lib import registry as REG

FA2 = REG.work("fa2")
Q8 = REG.work("quant8")


def _model(name):
    return REG.config(name)["model"]


def test_train_step_flops_of_the_cells():
    opt, gra = _model("opt-1.3b"), _model("granite-3-2b")
    assert flops.train_step_flops(opt, 4, 2048) == pytest.approx(
        6.937e13, rel=1e-3)
    assert flops.train_step_flops(gra, 4, 4096) == pytest.approx(
        2.82e14, rel=2e-3)
    # a DiLoCo round: 2 replicas x 2 inner steps of 2 x 2048
    assert 4 * flops.train_step_flops(opt, 2, 2048) == pytest.approx(
        1.387e14, rel=1e-3)


@pytest.mark.parametrize("name", ["opt-1.3b", "granite-3-2b"])
def test_flops_differ_from_the_ports_count_by_its_known_terms(name):
    """The port's ``train_flops`` charges 6 FLOP a token to every
    parameter (learned positions, padded vocabulary rows, biases and
    norms included); the frozen count charges the matrices a matmul
    reads, and causal attention over the S (S + 1) / 2 pairs a row has
    where the port takes S^2 / 2."""
    from repro_torch.core import flops as PF
    from repro_torch.models.config import ModelConfig
    m = _model(name)
    cfg = ModelConfig(**m)
    B, S = 2, 512
    extra = cfg.param_count() - flops.matmul_params(m)
    hd = cfg.resolved_head_dim
    diagonal = 3.0 * cfg.num_layers * B * cfg.num_heads * 4 * hd * S / 2
    assert PF.train_flops(cfg, B, S, remat=False) == pytest.approx(
        flops.train_step_flops(m, B, S) + 6.0 * extra * B * S - diagonal,
        rel=1e-12)


@pytest.mark.parametrize("shape,ms", [
    ((4, 2048, 32, 32, 64), (0.0695, 0.1043, 0.1390)),   # opt, PERF table
    ((1, 2048, 16, 16, 64), (0.0087, 0.0130, 0.0174)),   # a mesh rank's row
])
def test_fa2_bounds_of_the_kernel_table(shape, ms):
    B, S, H, K, D = shape
    w = FA2.work(B, S, H, K, D, D)
    got = [max(f / peaks.BF16_FLOP_PER_S, b / peaks.HBM_BYTES_PER_S) * 1e3
           for f, b in (w["fwd"], w["dq"], w["dkdv"])]
    assert got == pytest.approx(list(ms), abs=6e-5)
    assert FA2.bound_s(B, S, H, K, D, D, peaks.BF16_FLOP_PER_S,
                       peaks.HBM_BYTES_PER_S) * 1e3 == pytest.approx(
        sum(got), rel=1e-9)


def test_fa2_counts_causal_pairs_of_the_inputs():
    assert FA2.pairs(4) == 10
    f, b = FA2.work(1, 4, 1, 1, 2, 2)["fwd"]
    assert f == 2 * 4 * 10
    assert b == (4 * 2 + 4 * 4 + 4 * 2) * 2 + 4 * 4


@pytest.mark.parametrize("n,ms", [(100_663_296, 0.1507),
                                  (402_653_184, 0.6029)])
def test_quant8_bounds_of_the_kernel_table(n, ms):
    for b in (Q8.quantize_bytes(n, 256), Q8.dequantize_bytes(n, 256)):
        assert b / peaks.HBM_BYTES_PER_S * 1e3 == pytest.approx(ms,
                                                                abs=6e-5)


def test_quant8_bytes_of_a_ragged_leaf():
    assert Q8.quantize_bytes(300, 256) == 300 * 4 + 512 + 8
    assert Q8.dequantize_bytes(300, 256) == 512 + 8 + 512 * 4


@pytest.mark.parametrize("seed", [0, 7, 2147483711, 2 ** 40 + 3])
def test_data_stream_equals_the_ports(seed):
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(**dict(_model("opt-1.3b"), vocab_size=777))
    mine = data.batches(3, 40, 777, seed)
    port = make_batch_fn(cfg, 3, 40, seed)
    for _ in range(3):
        a, b = next(mine), next(port)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_power_stream_reads_one_process(tmp_path, monkeypatch):
    """A stand-in nvidia-smi prints a reading every 20 ms: the sampler
    starts one process, averages the readings of a window and stops it."""
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\nwhile true; do echo 250.5; sleep 0.02; "
                    "done\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    from portbench.lib.power import PowerStream
    p = PowerStream("0", period_ms=20)
    try:
        t0 = time.perf_counter()
        time.sleep(0.5)
        t1 = time.perf_counter()
        w, n = p.mean_w(t0, t1)
    finally:
        p.close()
    assert w == pytest.approx(250.5) and n >= 5
    assert p._proc.poll() is not None


def test_power_stream_without_nvidia_smi_fails(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    from portbench.lib.power import PowerStream
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        PowerStream("0")


def test_peaks_are_the_data_sheets():
    assert peaks.BF16_FLOP_PER_S == 989e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert str(ROOT) in sys.path
