"""Probe-gather variants at config-3 index scale (the round-0 align gap).

Round-0 align at config 3 probes the 153M-entry index (random 16-byte-row
gathers over the ~2.5 GB packed table). This measures, on the GPU at the
REAL index size, the legacy per-entry row gather vs the chunked
128-byte-row probe (ops.seed.probe fast path), plus the full seed stage and
the two-level window gather. All timings are pipelined (N async dispatches,
scalar-reduced outputs fetched at the end).

  PYTHONPATH=. python scripts/bench_probe_scale.py [B] [R]
"""

import functools
import os
import pickle
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.index.builder import build_seed_index
from rambl_tpu.ops.seed import (
    _gather_windows_twolevel,
    hash_kmer_jax,
    pack_entries,
    probe,
    query_kmers_jax,
    select_candidates,
)
from rambl_tpu.utils.cache import enable_compile_cache


def reduced(f):
    def g(*args):
        out = f(*args)
        return sum(jnp.sum(x.astype(jnp.int32) if x.dtype == bool else x)
                   for x in jax.tree_util.tree_leaves(out))
    return jax.jit(g)


def timed(name, f, args0, args1, reps=8):
    out = f(*args0)
    np.asarray(out)
    t0 = time.time()
    outs = [f(*(args0 if i % 2 == 0 else args1)) for i in range(reps)]
    for o in outs:
        np.asarray(o)
    dt = (time.time() - t0) / reps
    print(f"{name}: {dt * 1e3:8.1f} ms pipelined", flush=True)
    return dt


def main():
    enable_compile_cache()
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    R = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
    cfg = PipelineConfig(batch_size=B, sw_rows=104)

    cache = f"/tmp/config3_cache_10000000_{R}_k{cfg.k}_v3_seed13.pkl"
    t0 = time.time()
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            ds, index = pickle.load(f)
        reads = ds.reads[: 2 * B]
        lens = ds.read_lens[: 2 * B]
        refs = ds.ref_seqs
        print(f"config3 cache loaded in {time.time() - t0:.0f}s", flush=True)
    else:
        rng = np.random.default_rng(0)
        ref_lens = rng.integers(1200, 1600, R).astype(np.int32)
        refs = np.full((R, 2048), 4, np.int8)
        for r in range(R):
            refs[r, : ref_lens[r]] = rng.integers(0, 4, ref_lens[r])
        index = build_seed_index(refs, ref_lens, k=cfg.k)
        src = rng.integers(0, R, 2 * B)
        off = rng.integers(0, 1100, 2 * B)
        reads = np.full((2 * B, 128), 4, np.int8)
        for i in range(2 * B):
            reads[i, :100] = refs[src[i], off[i] : off[i] + 100]
        lens = np.full(2 * B, 100, np.int32)
        print(f"random index built in {time.time() - t0:.0f}s", flush=True)

    ent_pad = pack_entries(index.entry_key, index.entry_ref, index.entry_pos)
    n = index.n_entries
    ent_legacy = np.zeros((n, 4), np.int32)
    ent_legacy[:, 0] = index.entry_key
    ent_legacy[:, 1] = index.entry_ref
    ent_legacy[:, 2] = index.entry_pos
    print(f"B={B} R={R} entries={index.n_entries} "
          f"({ent_pad.nbytes / 1e9:.2f} GB packed) buckets=2^{index.n_bits}",
          flush=True)

    # tables go in as ARGUMENTS (as the production stream does) - closing
    # over them bakes 3 GB of constants into the lowered HLO
    bs_d = jnp.asarray(index.bucket_start)
    pad_d = jnp.asarray(ent_pad)
    leg_d = jnp.asarray(ent_legacy)
    refs_d = jnp.asarray(refs)
    a0 = (jnp.asarray(reads[:B]), jnp.asarray(lens[:B]))
    a1 = (jnp.asarray(reads[B:]), jnp.asarray(lens[B:]))

    def probe_only(r, l, bs, ent):
        keys, valid = query_kmers_jax(r, l, cfg)
        bucket = hash_kmer_jax(keys, index.n_bits)
        return probe(keys, valid, bucket, bs, ent, cfg)

    def seed_full(r, l, bs, ent):
        keys, valid = query_kmers_jax(r, l, cfg)
        bucket = hash_kmer_jax(keys, index.n_bits)
        ck = probe(keys, valid, bucket, bs, ent, cfg)
        return select_candidates(ck, cfg)

    t_leg = timed("probe legacy (16B rows) ", reduced(probe_only),
                  a0 + (bs_d, leg_d), a1 + (bs_d, leg_d))
    t_chk = timed("probe chunked (128B rows)", reduced(probe_only),
                  a0 + (bs_d, pad_d), a1 + (bs_d, pad_d))
    timed("seed  legacy full        ", reduced(seed_full),
          a0 + (bs_d, leg_d), a1 + (bs_d, leg_d))
    timed("seed  chunked full       ", reduced(seed_full),
          a0 + (bs_d, pad_d), a1 + (bs_d, pad_d))
    print(f"probe speedup: {t_leg / t_chk:.2f}x", flush=True)

    # window gather at the same scale (on-grid candidates)
    nd = cfg.n_diag_bins
    s0 = -cfg.read_len_max + cfg.diag_bin // 2 - cfg.window_margin
    rng = np.random.default_rng(1)
    P = 2 * cfg.max_candidates
    cr0 = jnp.asarray(rng.integers(0, R, (B, P)).astype(np.int32))
    cw0 = jnp.asarray(rng.integers(0, nd, (B, P)).astype(np.int32)
                      * cfg.diag_bin + s0)
    cr1 = jnp.asarray(rng.integers(0, R, (B, P)).astype(np.int32))
    cw1 = jnp.asarray(rng.integers(0, nd, (B, P)).astype(np.int32)
                      * cfg.diag_bin + s0)
    W = cfg.window_len
    timed("window two-level gather  ",
          reduced(lambda rs, cr, cw: _gather_windows_twolevel(
              rs, cr, cw, W, cfg)),
          (refs_d, cr0, cw0), (refs_d, cr1, cw1))

    # parity: chunked vs legacy select output at scale
    f = jax.jit(seed_full)
    o_new = jax.tree_util.tree_map(np.asarray, f(*a0, bs_d, pad_d))
    o_old = jax.tree_util.tree_map(np.asarray, f(*a0, bs_d, leg_d))
    for k in o_new:
        np.testing.assert_array_equal(o_new[k], o_old[k])
    print("parity ok (chunked == legacy candidates at scale)", flush=True)


if __name__ == "__main__":
    main()
