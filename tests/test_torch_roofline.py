"""The roofline's analytic half (``repro_torch.launch.roofline``) against
``repro.launch.roofline``: ``attention_flops``, ``model_flops`` and
``active_param_count`` on all ten configs at full width (the port's
``meta`` params, the reference's ``jax.eval_shape`` params) and all four
input shapes, equal within 1e-12 relative; ``RooflineReport``'s terms,
``bottleneck`` and ``useful_flops_ratio`` at the H100's constants (the
twin of ``tests/test_substrate.py::test_roofline_report_terms``); and a
saved report that loads with the reference's keys.
"""

import functools

import jax
import pytest

from repro.configs import ARCH_NAMES, INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import roofline as JRF
from repro.models import model as JM
from repro_torch.configs import INPUT_SHAPES as T_INPUT_SHAPES
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import roofline as RF
from repro_torch.models import model as TM


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_match_reference(arch):
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    jp = jax.eval_shape(functools.partial(JM.init_params, jcfg),
                        jax.random.PRNGKey(0))
    n_ref = JRF.active_param_count(jcfg, jp)
    n = RF.active_param_count(tcfg, TM.init_params(tcfg, None))
    assert n == n_ref
    for name in INPUT_SHAPES:
        jshape, tshape = INPUT_SHAPES[name], T_INPUT_SHAPES[name]
        assert RF.attention_flops(tcfg, tshape) == pytest.approx(
            JRF.attention_flops(jcfg, jshape), rel=1e-12, abs=0.0)
        assert RF.model_flops(tcfg, tshape, n) == pytest.approx(
            JRF.model_flops(jcfg, jshape, n_ref), rel=1e-12)


def _report(**kw):
    args = dict(
        arch="x", shape="train_4k", mesh="16x16", chips=256,
        flops_per_chip=RF.PEAK_FLOPS * 0.010,         # 10 ms compute
        bytes_per_chip=RF.HBM_BW * 0.005,             # 5 ms memory
        collective_bytes_per_chip=RF.LINK_BW * 0.001,  # 1 ms collective
        peak_memory_per_chip=1 << 30, argument_bytes=0, output_bytes=0,
        temp_bytes=0, collectives={},
        model_flops=RF.PEAK_FLOPS * 0.010 * 256 * 0.5, wall_s=1.0)
    args.update(kw)
    return RF.RooflineReport(**args)


def test_roofline_report_terms():
    assert (RF.PEAK_FLOPS, RF.HBM_BW, RF.LINK_BW) == (989e12, 3.35e12, 450e9)
    rep = _report()
    assert rep.t_compute == pytest.approx(0.010)
    assert rep.t_memory == pytest.approx(0.005)
    assert rep.t_collective == pytest.approx(0.001)
    assert rep.bottleneck == "compute"
    assert rep.useful_flops_ratio == pytest.approx(0.5)
    assert _report(collective_bytes_per_chip=RF.LINK_BW * 0.02
                   ).bottleneck == "collective"
    assert _report(flops_per_chip=0.0).useful_flops_ratio == 0.0


def test_saved_report_has_the_reference_keys(tmp_path):
    ref = JRF.RooflineReport(
        arch="x", shape="train_4k", mesh="16x16", chips=256,
        flops_per_chip=1.0, bytes_per_chip=1.0,
        collective_bytes_per_chip=1.0, peak_memory_per_chip=1.0,
        argument_bytes=0, output_bytes=0, temp_bytes=0, collectives={},
        model_flops=1.0, wall_s=1.0)
    rep = _report()
    path = str(tmp_path / "r.json")
    RF.save_report(rep, path)
    loaded = RF.load_report(path)
    assert set(loaded) == set(ref.as_dict())
    assert loaded == rep.as_dict()
    assert loaded["raw_xla_flops"] == loaded["raw_xla_bytes"] == 0.0
    assert JRF.load_report(path)["bottleneck"] == "compute"
    assert "useful=" in rep.row() and "[compute" in rep.row()
