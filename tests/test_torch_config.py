"""The port's own copies of the config schema and the bucket registry behave
as the JAX package's."""

import dataclasses

import pytest

from montecarlo_gated_mil_tpu.core import bag as jbag
from montecarlo_gated_mil_tpu.core import config as jcfg
from montecarlo_gated_mil_tpu_torch.core import bag as tbag
from montecarlo_gated_mil_tpu_torch.core import config as tcfg

VALID = [
    {},
    {"model": "r50", "N": 30, "shared_att": True, "is_MCDO-test": False},
    {"data": {"patch_size": 112, "overlap_val_test": 0.5, "view": ["CC"]},
     "tpu": {"buckets": [8, 16], "compute_dtype": "bfloat16", "oversized_bags": "truncate"}},
    {"training_plan": {"parameters": {"lr": 0.01}, "scheduler": {"name": "step"}}},
]
INVALID = [
    {"model": "r101"},
    {"N": 0},
    {"feature_dropout": 1.0},
    {"data": {"overlap_train": 1.0}},
    {"data": {"bag_size_val_test": 0}},
    {"tpu": {"buckets": [16, 8]}},
    {"tpu": {"buckets": [12]}},
    {"tpu": {"oversized_bags": "drop"}},
    {"training_plan": {"parameters": {"batch_size": 2}}},
    {"unknown_key": 1},
]


@pytest.mark.parametrize("raw", VALID)
def test_valid_configs_parse_identically(raw):
    got = dataclasses.asdict(tcfg.config_from_dict(raw))
    want = dataclasses.asdict(jcfg.config_from_dict(raw))
    assert got == want


@pytest.mark.parametrize("raw", INVALID)
def test_invalid_configs_are_refused_by_both(raw):
    with pytest.raises(ValueError):
        jcfg.config_from_dict(raw)
    with pytest.raises(ValueError):
        tcfg.config_from_dict(raw)


def test_load_config_reads_yaml(tmp_path):
    path = tmp_path / "cfg.yml"
    path.write_text("model: r34\nN: 7\ndata:\n  patch_size: 64\n")
    assert dataclasses.asdict(tcfg.load_config(str(path))) == dataclasses.asdict(
        jcfg.load_config(str(path))
    )


@pytest.mark.parametrize("sizes", [(64, 128, 256, 512, 1024), (8,), (8, 24)])
def test_bucket_spec_equals_jax(sizes):
    t, j = tbag.BucketSpec(sizes), jbag.BucketSpec(sizes)
    for n in [-1, 0, 1, 7, 8, 9, 63, 64, 65, 1000, 1024, 1025, 2400, 3072, 6000]:
        assert t.bucket_for(n) == j.bucket_for(n)
        for mult in (1, 3, 8):
            assert t.extended_bucket(n, mult) == j.extended_bucket(n, mult)
    with pytest.raises(ValueError):
        tbag.BucketSpec((16, 8))
