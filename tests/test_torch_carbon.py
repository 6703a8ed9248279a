"""The port's carbon, energy and FLOP models against the JAX package's.

These modules are numpy and standard-library code in both packages, so
the bar is exact: ``==`` for every float, equal dicts and dataclasses.
Covered: the diurnal ``IntensityTrace`` at every hour and offset of every
region, ``device_operational_kwh``, ``train_time_s`` / ``train_energy_wh``
for every catalog device, the four byte models of ``core/flops.py`` on
all ten assigned configs and their ``-smoke`` variants, LLMCarbon's Fig. 2
table, the offloading analysis (Figs. 4 and 5) and the idealized planner
(Fig. 3)."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.core import flops as JF  # noqa: E402
from repro.core.carbon import accounting as JA  # noqa: E402
from repro.core.carbon import intensity as JI  # noqa: E402
from repro.core.carbon import llmcarbon as JL  # noqa: E402
from repro.core.carbon import offload as JO  # noqa: E402
from repro.core.energy import devices as JD  # noqa: E402
from repro.core.planner import idealized as JZ  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.core import flops as TF  # noqa: E402
from repro_torch.core.carbon import accounting as TA  # noqa: E402
from repro_torch.core.carbon import intensity as TI  # noqa: E402
from repro_torch.core.carbon import llmcarbon as TL  # noqa: E402
from repro_torch.core.carbon import offload as TO  # noqa: E402
from repro_torch.core.energy import devices as TD  # noqa: E402
from repro_torch.core.planner import idealized as TZ  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

REGIONS = sorted(JI.INTENSITY_BY_REGION)
ARCHS = [a for a in ASSIGNED] + [a + "-smoke" for a in ASSIGNED]


def _cfgs(name):
    j, t = j_config(name), t_config(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def test_region_table_is_the_same():
    assert TI.INTENSITY_BY_REGION == JI.INTENSITY_BY_REGION
    assert TI.paper_average_intensity() == JI.paper_average_intensity()


@pytest.mark.parametrize("region", REGIONS)
def test_intensity_trace_every_hour_and_offset(region):
    for year in JI.PAPER_YEARS:
        for solar in (0.0, 0.35, 0.8):
            jt = JI.IntensityTrace(region, year, solar)
            tt = TI.IntensityTrace(region, year, solar)
            for tz in (-8.0, -5.5, 0.0, 1.0, 5.5, 9.0, 13.0):
                assert tt.daily_mean(tz) == jt.daily_mean(tz)
                for h in range(48):
                    for frac in (0.0, 0.25, 0.5):
                        assert tt.at_hour(h + frac, tz) \
                            == jt.at_hour(h + frac, tz), (h, frac, tz)


@pytest.mark.parametrize("name", sorted(JD.CATALOG))
def test_device_models_for_every_catalog_device(name):
    jd, td = JD.CATALOG[name], TD.CATALOG[name]
    assert dataclasses.asdict(jd) == dataclasses.asdict(td)
    for flops in (1.0, 3.7e12, 6e15, 2.1e21):
        assert TD.train_time_s(td, flops) == JD.train_time_s(jd, flops)
        assert TD.train_energy_wh(td, flops) == JD.train_energy_wh(jd, flops)
    for hours, years, base in ((8.0, 3.0, 0.0), (4.5, 1.0, 2.0),
                               (0.0, 5.0, 24.0), (12.25, 0.5, 3.75)):
        assert TA.device_operational_kwh(td, hours, years,
                                         baseline_hours=base) \
            == JA.device_operational_kwh(jd, hours, years,
                                         baseline_hours=base)


@pytest.mark.parametrize("name", ARCHS)
def test_flops_byte_models_on_every_config(name):
    j, t = _cfgs(name)
    for B, S in ((1, 128), (4, 2048), (3, 4000)):
        assert TF.activation_bytes(t, B, S) == JF.activation_bytes(j, B, S)
        assert TF.activation_bytes(t, B, S, 4) \
            == JF.activation_bytes(j, B, S, 4)
        assert TF.decode_hbm_bytes(t, B, S) == JF.decode_hbm_bytes(j, B, S)
        assert TF.decode_hbm_bytes(t, B, S, 1) \
            == JF.decode_hbm_bytes(j, B, S, 1)
        assert TF.summary(t, B, S) == JF.summary(j, B, S)
    assert TF.train_state_bytes(t) == JF.train_state_bytes(j)
    assert TF.train_state_bytes(t, 4, 2) == JF.train_state_bytes(j, 4, 2)


def test_llmcarbon_fig2_table_and_estimates():
    assert TL.fig2_table() == JL.fig2_table()
    for jm, tm in zip(JL.FIG2_MODELS, TL.FIG2_MODELS):
        assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
        assert TL.pflops_day(tm) == JL.pflops_day(jm)
        for kw in ({}, {"mfu": 0.5}, {"intensity": 0.1},
                   {"include_embodied": False}):
            assert TL.estimated_tco2e(tm, **kw) == JL.estimated_tco2e(jm,
                                                                      **kw)


def test_offload_fig4_table():
    jt, tt = JO.fig4_table(), TO.fig4_table()
    assert list(tt) == list(jt)
    for k in jt:
        assert dataclasses.asdict(tt[k]) == dataclasses.asdict(jt[k])
        assert tt[k].total_kg == jt[k].total_kg
        assert tt[k].embodied_pct == jt[k].embodied_pct


@pytest.mark.parametrize("name", sorted(JD.CATALOG))
def test_offload_analysis_for_every_device(name):
    jd, td = JD.CATALOG[name], TD.CATALOG[name]
    for paper in (False, True):
        for kw in ({}, {"hours_per_day": 4.0, "years": 2.0},
                   {"comm_kwh_per_device": 1.5}, {"device_count": 7}):
            assert TO.offload_analysis(td, use_paper_counts=paper, **kw) \
                == JO.offload_analysis(jd, use_paper_counts=paper, **kw)
    assert TO.equivalent_count(td) == JO.equivalent_count(jd)
    assert dataclasses.asdict(TO.baseline_footprint(td, years=2.0)) \
        == dataclasses.asdict(JO.baseline_footprint(jd, years=2.0))
    assert TO.comm_energy_kwh_per_device(
        td, model_bytes=2.6e9, activation_bytes_per_step=4e8,
        steps_per_day=30.0) == JO.comm_energy_kwh_per_device(
        jd, model_bytes=2.6e9, activation_bytes_per_step=4e8,
        steps_per_day=30.0)


@pytest.mark.parametrize("arch", ["opt-125m", "opt-1.3b"])
def test_idealized_plan_and_fig3(arch):
    j, t = _cfgs(arch)
    for name in sorted(JD.CATALOG):
        jd, td = JD.CATALOG[name], TD.CATALOG[name]
        assert TZ.devices_required(t, td) == JZ.devices_required(j, jd)
        assert TZ.fig3_energy(t, td) == JZ.fig3_energy(j, jd)
        for n in (0, 1, 12):
            assert dataclasses.asdict(
                TZ.plan(t, td, batch=8, seq_len=256, steps=10,
                        num_devices=n)) == dataclasses.asdict(
                JZ.plan(j, jd, batch=8, seq_len=256, steps=10,
                        num_devices=n))
