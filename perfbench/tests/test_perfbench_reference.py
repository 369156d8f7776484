"""The plain reference against the port's CPU path (its kernels' plain
versions) on tiny scenes."""

import json

import numpy as np
import pytest
import torch

from perfbench.harness import manifest
from perfbench.inputs import forest as forest_fit
from perfbench.inputs import scenes as scene_gen
from perfbench.reference import landcover

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cfg():
    with open(manifest.PERFBENCH / "configs" / "tm-tile-600.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def pool():
    return scene_gen.synthetic_pool(4, 96, 96, 2 ** 31 + 11, CPU)


@pytest.fixture(scope="module")
def port_cfg():
    from rs_image_segmentation_tpu_torch.core.config import (
        CalibrationConfig, FeatureStageConfig, RuleBasedConfig)
    return FeatureStageConfig(), CalibrationConfig(), RuleBasedConfig()


def test_pool_takes_both_stretch_routes(pool, cfg):
    cal = cfg["calibration"]
    modes = np.stack([scene_gen.stretch_modes(s, cal["gains"], cal["biases"])
                      for s in pool])
    assert modes.any() and not modes.all()
    assert (modes[:, scene_gen.FULL_RANGE_BAND] == 0).all()


def test_stretch_tables_equal_the_ports(pool, cfg, port_cfg):
    from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
        build_stretch_params, build_stretch_stats)
    cal = port_cfg[1]
    for s in pool:
        lut, params, hist = build_stretch_stats(s, cal.gains, cal.biases)
        ref = landcover.stretch_lut(s, cal.gains, cal.biases)
        for b in range(s.shape[0]):         # the DNs the scene holds
            dn = np.unique(s[b])
            np.testing.assert_array_equal(ref[b][dn], lut[b][dn])
        _, ref_hist = landcover.stretched(s, cal.gains, cal.biases, CPU)
        np.testing.assert_array_equal(ref_hist, hist)
        np.testing.assert_array_equal(
            scene_gen.stretch_modes(s, cal.gains, cal.biases), params[:, 0])


def test_stack_matches_the_ports(pool, cfg, port_cfg):
    from rs_image_segmentation_tpu_torch.pipeline import preprocess, turbo
    feat, cal, _ = port_cfg
    luts = np.stack([preprocess.build_stretch_lut(s, cal.gains, cal.biases)
                     for s in pool]).astype(np.uint8)
    got = turbo.hierarchical_stack_turbo_cm(pool, luts, feat, device="cpu")
    for i, s in enumerate(pool):
        ref = landcover.stack(s, cfg, CPU)
        # float32 sums in another order; std5's sqrt of a near-zero
        # variance magnifies them most
        np.testing.assert_allclose(got[i].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-4)


def test_forest_labels_match_the_ports(pool, cfg, port_cfg):
    from rs_image_segmentation_tpu_torch.models.forest import (
        _gemm_for, flat_forest_from_numpy)
    from rs_image_segmentation_tpu_torch.pipeline import preprocess, turbo
    feat, cal, _ = port_cfg
    stack0 = landcover.stack(pool[0], cfg, CPU).numpy()
    fields, depth = forest_fit.rule_forest(stack0, 33, 20, 42)
    gf = _gemm_for(flat_forest_from_numpy(fields), 19)
    luts = np.stack([preprocess.build_stretch_lut(s, cal.gains, cal.biases)
                     for s in pool]).astype(np.uint8)
    got = turbo.classify_scenes_turbo(pool, luts, gf, feat,
                                      device="cpu").numpy()
    for i, s in enumerate(pool):
        ref, comparisons = landcover.forest_labels(s, cfg, fields, depth, CPU)
        assert np.mean(got[i] != ref) <= 1e-3
        # each of 20 trees makes at least one comparison a pixel
        assert comparisons >= 20 * s.shape[1] * s.shape[2]


def test_rule_labels_equal_the_ports(pool, cfg, port_cfg):
    from rs_image_segmentation_tpu_torch.pipeline import preprocess, turbo
    feat, cal, rules = port_cfg
    stats = [preprocess.build_stretch_stats(s, cal.gains, cal.biases)
             for s in pool]
    luts, sps, hists = (np.stack(p) for p in zip(*stats))
    got = turbo.rule_based_scenes_turbo_batch(
        pool, luts.astype(np.uint8), feat, rules, stretch_params=sps,
        stretch_hists=hists, device="cpu").numpy()
    for i, s in enumerate(pool):
        np.testing.assert_array_equal(got[i],
                                      landcover.rule_labels(s, cfg, CPU))


def test_control_moves_the_answer(pool, cfg):
    s = landcover.stack(pool[0], cfg, CPU)
    c = landcover.stack(pool[0], cfg, CPU, store_dtype=torch.bfloat16)
    assert (s != c).float().mean() > 0.5
