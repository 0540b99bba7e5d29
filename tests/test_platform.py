"""Platform wiring: the SW implementation chosen per platform, the compile
cache directory, config loading across retired options, and integer-only
DP-means counting (exact whatever matmul precision a backend picks)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rambl_tpu.config import PipelineConfig
from rambl_tpu.oracle.cluster import dp_means
from rambl_tpu.ops.sw import sw_score
from rambl_tpu.ops.sw_pallas import sw_score_pallas
from rambl_tpu.pipeline.align import score_fn
from rambl_tpu.pipeline.cluster import dp_means_leaves
from rambl_tpu.utils import cache


@pytest.mark.parametrize("platform,impl", [("gpu", sw_score_pallas),
                                           ("cpu", sw_score)])
def test_score_fn_by_platform(platform, impl):
    assert score_fn(platform) is impl


@pytest.mark.parametrize("platform", ["rocm", "METAL", "xpu"])
def test_score_fn_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no SW score implementation"):
        score_fn(platform)


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.cache_dir() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_in_checkout(monkeypatch):
    monkeypatch.delenv(cache.ENV, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_from_json_drops_retired_keys():
    cfg = PipelineConfig(sw_rows=104, shard_index=True)
    d = json.loads(cfg.to_json())
    d.update(sw_impl="pallas", ring_impl="dma")   # an older checkpoint
    assert PipelineConfig.from_json(json.dumps(d)) == cfg
    with pytest.raises(TypeError):
        PipelineConfig.from_json(json.dumps({"not_an_option": 1}))


def test_dp_means_int32_counts_match_oracle():
    cfg = PipelineConfig()
    rng = np.random.default_rng(2)
    NL, M, P = 3, 96, 12
    feats = []
    for leaf in range(NL):
        base = rng.integers(0, 4, P)
        f = np.tile(base, (M, 1))
        alt = rng.integers(0, 4, P)
        f[M // 3:] = np.where(rng.random(P) < 0.5, alt, base)  # a variant
        err = rng.random((M, P)) < 0.02
        f = np.where(err, rng.integers(0, 4, (M, P)), f)
        f = np.where(rng.random((M, P)) < 0.4, -1, f)           # coverage
        feats.append(f.astype(np.int8))
    feat = np.stack(feats)
    can_seed = np.ones((NL, M), bool)
    out = dp_means_leaves(jnp.asarray(feat), jnp.asarray(can_seed), cfg)
    for leaf in range(NL):
        a, c, k = dp_means(feat[leaf], cfg, can_seed[leaf])
        assert int(out.kact[leaf]) == k
        np.testing.assert_array_equal(np.asarray(out.assign[leaf]), a)
        np.testing.assert_array_equal(np.asarray(out.centers[leaf])[:k], c)
    # no float matmul anywhere in the clustering step
    jaxpr = str(jax.make_jaxpr(
        lambda f, s: dp_means_leaves(f, s, cfg))(feat, can_seed))
    dots = [ln for ln in jaxpr.splitlines() if "dot_general" in ln]
    assert dots and not any("f32" in ln or "bf16" in ln for ln in dots)
