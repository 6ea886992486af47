"""The port's config mirrors red_gym_tpu.config: fields, defaults, checks."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from red_gym_tpu import config as jcfg
from red_gym_tpu_torch import config as tcfg


def test_simconfig_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.SimConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.SimConfig)}
    assert list(tf) == list(jf)
    for name, default in jf.items():
        td = tf[name]
        if isinstance(default, jcfg.Integrator):
            assert td.name == default.name and td.value == default.value
        else:
            assert td == default and type(td) is type(default), name


def test_vehicle_params_match():
    assert tcfg.VehicleParams._fields == jcfg.VehicleParams._fields
    assert tcfg.DEFAULT_PARAMS_DICT == jcfg.DEFAULT_PARAMS_DICT
    v = tcfg.VehicleParams.default(torch.float64)
    for k, val in jcfg.DEFAULT_PARAMS_DICT.items():
        assert getattr(v, k).dtype == torch.float64
        assert float(getattr(v, k)) == val
    v = tcfg.VehicleParams.from_dict({"mu": 0.5}).replace(m=4.0)
    assert float(v.mu) == 0.5 and float(v.m) == 4.0 and v.mu.dtype == torch.float32
    with pytest.raises(KeyError, match="unknown vehicle params"):
        tcfg.VehicleParams.from_dict({"bogus": 1.0})
    assert [i.name for i in tcfg.Integrator] == [i.name for i in jcfg.Integrator]


BAD_CONFIGS = [
    dict(scan_mode="fastest"), dict(scan_backend="gpu"),
    dict(scan_interp="cubic"), dict(rt_spatial="trilinear"),
    dict(rt_dtype="float16"), dict(rt_ew_dtype="float16"),
    dict(fuse_scan_ttc="yes"), dict(fuse_scan_opp="yes"),
    dict(scan_megakernel="yes"), dict(state_kernel="yes"),
    dict(noise_mode="gaussian"), dict(rt_occlusion="soft"),
    dict(scan_backend="pallas", rt_occlusion="snap"),
    dict(num_agents=0), dict(num_beams=1), dict(ego_idx=2),
    dict(speed_controller=3),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: ",".join(kw))
def test_validation_errors_match(kw):
    with pytest.raises(ValueError) as je:
        jcfg.SimConfig(**kw)
    with pytest.raises(ValueError) as te:
        tcfg.SimConfig(**kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    {}, dict(scan_interp="spectral"), dict(rt_occlusion="off", rt_grad=False),
    dict(dtype="float64", fov=4.7, num_beams=270), dict(rt_dtype="float32")])
def test_derived_properties_match(kw):
    j, t = jcfg.SimConfig(**kw), tcfg.SimConfig(**kw)
    assert t.rt_channels == j.rt_channels
    assert t.rt_eff_occlusion == j.rt_eff_occlusion
    assert math.isclose(t.angle_increment, j.angle_increment, rel_tol=0, abs_tol=0)
    assert str(t.tdtype).removeprefix("torch.") == np.dtype(j.jdtype).name
    assert str(t.rt_tdtype).removeprefix("torch.") == np.dtype(j.rt_jdtype).name
