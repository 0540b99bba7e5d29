#!/usr/bin/env python
"""Benchmark: driver config 1 (toy mock community) on the local GPU.

Prints ONE JSON line:
  {"metric": "reads_aligned_per_s_per_chip", "value": N, "unit": "reads/s",
   "vs_baseline": N, ...}

vs_baseline: the reference publishes no throughput numbers (BASELINE.md:
"published": {}), so the baseline is a documented estimate of the reference
pipeline's alignment stage: BWA-MEM sustains roughly 1.25k 100bp reads/s per
CPU thread => ~20k reads/s for a 16-thread single node, the hardware class the
reference targets. vs_baseline = value / 20_000.

Every time is host wall time around work that ends in block_until_ready,
after a warm-up call that compiles. The card's name and power limit and the
secondary metrics (SW GCUPS of the score path the align step runs, batch
latency, end-to-end genes/hour) go to stderr. Fails without a GPU.
"""

import functools
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.data.simulate import toy_dataset
from rambl_tpu.index.builder import build_seed_index
from rambl_tpu.ops.seed import SeedTable
from rambl_tpu.pipeline.align import align_batch, score_fn

BWA_NODE_READS_PER_S = 20_000.0  # documented estimate, see module docstring


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(f, args, reps):
    """Median and spread of `reps` warm calls, each ended by
    block_until_ready."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    med = float(np.median(ts))
    return med, (max(ts) - min(ts)) / med, ts


def main():
    from rambl_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {dev.platform!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"device: {dev.device_kind} | card: {smi}")

    B = 8192
    cfg = PipelineConfig(batch_size=B, sw_rows=104)
    ds = toy_dataset(n_reads=16384)
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    table = SeedTable.from_index(index)
    refs = jnp.asarray(ds.ref_seqs)

    f = jax.jit(functools.partial(align_batch, table=table, ref_seqs=refs,
                                  cfg=cfg))
    r1 = jnp.asarray(ds.reads[B:])
    l1 = jnp.asarray(ds.read_lens[B:])
    t0 = time.time()
    jax.block_until_ready(f(jnp.asarray(ds.reads[:B]),
                            jnp.asarray(ds.read_lens[:B])))
    log(f"align compile+first: {time.time() - t0:.1f}s")
    per, align_spread, ts = timed(f, (r1, l1), 20)
    reads_per_s = B / per
    log(f"align: {per * 1000:.3f} ms/batch({B}) = {reads_per_s:.0f} "
        f"reads/s (20 runs, spread {align_spread * 100:.1f}%)")

    # SW score pass of the align step, at the align step's pair count;
    # 100-base reads padded to L, so the sw_rows truncation is exact
    pairs = 131072
    L, W = cfg.read_len_max, cfg.window_len
    rng = np.random.default_rng(0)
    q = rng.integers(0, 5, (pairs, L)).astype("int8")
    q[:, 100:] = 4
    q = jnp.asarray(q)
    w = jnp.asarray(rng.integers(0, 4, (pairs, W)).astype("int8"))
    impl = score_fn(dev.platform)
    g = jax.jit(functools.partial(impl, sc=cfg.scoring, rows=cfg.sw_rows))

    # compiled-mode parity gate against the NumPy oracle before any number
    from rambl_tpu.oracle.sw import sw_batch

    chk = 256
    got = [np.asarray(x)[:chk] for x in g(q, w)]
    ref = sw_batch(np.asarray(q[:chk]), np.asarray(w[:chk]), cfg.scoring,
                   want_dirs=False)[:3]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    log(f"sw compiled-mode parity: OK ({chk} pairs vs NumPy oracle)")
    sw_per, sw_spread, _ = timed(g, (q, w), 20)
    gcups = pairs * cfg.sw_rows * W / sw_per / 1e9
    log(f"{impl.__module__}.{impl.__name__}: {sw_per * 1000:.3f} ms/"
        f"{pairs} pairs = {gcups:.1f} GCUPS (sw_rows {cfg.sw_rows}, "
        f"spread {sw_spread * 100:.1f}%)")

    # end-to-end assembly -> full-length 16S genes/hour (driver metric B:2)
    from rambl_tpu.data.simulate import simulate_dataset
    from rambl_tpu.index.taxonomy import build_taxonomy_tables
    from rambl_tpu.pipeline.assemble import assemble_jax

    ds2 = simulate_dataset(n_species=5, refs_per_species=2, n_reads=4096,
                           seed=3, skewed_abundance=False)
    tax2 = build_taxonomy_tables(ds2.tax_parent, ds2.tax_depth, ds2.ref_taxon)
    cfg2 = PipelineConfig(batch_size=2048, max_assembly_iters=3, sw_rows=104)
    t0 = time.time()
    res2 = assemble_jax(ds2.reads, ds2.read_lens, ds2.ref_seqs, ds2.ref_lens,
                        tax2, cfg2)
    e2e_wall = time.time() - t0
    n_full = len(res2.full_length(cfg2))
    genes_per_hour = n_full / (e2e_wall / 3600.0)
    log(f"e2e assembly: {e2e_wall:.1f}s incl. compiles, {len(res2.genes)} "
        f"genes ({n_full} full-length) = {genes_per_hour:.0f} genes/hour "
        f"(toy mock community, {res2.n_rounds} rounds + polish)")

    print(json.dumps({
        "metric": "reads_aligned_per_s_per_chip",
        "value": round(float(reads_per_s), 1),
        "unit": "reads/s",
        "vs_baseline": round(float(reads_per_s) / BWA_NODE_READS_PER_S, 3),
        "align_spread_pct": round(float(align_spread) * 100, 1),
        "sw_gcups": round(float(gcups), 1),
        "sw_gcups_spread_pct": round(float(sw_spread) * 100, 1),
        "genes_per_hour": round(float(genes_per_hour), 1),
        "e2e_wall_s": round(float(e2e_wall), 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
