"""Every dataclass of `sfm_tpu_torch.config` has the fields and defaults of
`sfm_tpu.config`, and `convert.config_from_dict` round-trips them."""

import dataclasses

import pytest

from sfm_tpu import config as jcfg
from sfm_tpu_torch import config as tcfg
from sfm_tpu_torch.convert import config_from_dict

NAMES = sorted(n for n, c in vars(jcfg).items()
               if dataclasses.is_dataclass(c) and isinstance(c, type))


def test_same_dataclasses():
    ours = sorted(n for n, c in vars(tcfg).items()
                  if dataclasses.is_dataclass(c) and isinstance(c, type))
    assert ours == NAMES and len(NAMES) == 8


@pytest.mark.parametrize("name", NAMES)
def test_fields_and_defaults_equal(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [str(f.type) for f in tf] == [str(f.type) for f in jf]
    assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(
        getattr(jcfg, name)())


@pytest.mark.parametrize("name", NAMES)
def test_config_from_dict_round_trip(name):
    jc = getattr(jcfg, name)()
    if name == "StereoParams":
        jc = jcfg.replace(jc, base=0.571, ransac_iters=50,
                          calib=jcfg.Calibration(f=645.2, cu=635.9, cv=194.1),
                          match=jcfg.MatcherParams(refinement=2))
    if name == "EngineConfig":
        jc = jcfg.replace(jc, outlier_mode="knn", refine_window=256)
    d = dataclasses.asdict(jc)
    tc = config_from_dict(d, name)
    assert type(tc) is getattr(tcfg, name)
    assert dataclasses.asdict(tc) == d
    # the class is inferred from the field names where they identify it
    assert type(config_from_dict(d)) is getattr(tcfg, name)


def test_config_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError):
        config_from_dict({"f": 1.0, "cu": 0.0, "cv": 0.0, "nope": 1},
                         "Calibration")


def test_replace_works_on_frozen_configs():
    e = tcfg.replace(tcfg.EngineConfig(), max_matches=7)
    assert e.max_matches == 7
    with pytest.raises(dataclasses.FrozenInstanceError):
        e.max_matches = 8
