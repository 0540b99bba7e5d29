"""Measure seed-probe gather variants on the GPU (one large dispatch each).

The probe gather (B, Q, cap) x entry rows dominates seeding cost; this
compares row widths / packings to pick the fastest layout.
"""

import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.data.simulate import toy_dataset
from rambl_tpu.index.builder import build_seed_index
from rambl_tpu.ops.seed import (
    SeedTable,
    hash_kmer_jax,
    probe,
    query_kmers_jax,
    seed_candidates_jax,
    select_candidates,
)


def reduced(f):
    """Sum outputs INSIDE jit: fetching a scalar avoids timing the copy of
    megabyte outputs to the host."""
    def g(*args):
        out = f(*args)
        return sum(jnp.sum(x.astype(jnp.int32) if x.dtype == bool else x)
                   for x in jax.tree_util.tree_leaves(out))
    return jax.jit(g)


def t(name, f, *args, n=3):
    out = f(*args)
    np.asarray(out)
    t0 = time.time()
    for _ in range(n):
        np.asarray(f(*args))
    print(f"{name}: {(time.time() - t0) / n * 1e3:8.1f} ms", flush=True)
    return out


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    cfg = PipelineConfig()
    ds = toy_dataset(n_reads=B)
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    table = SeedTable.from_index(index)
    r = jnp.asarray(ds.reads[:B])
    l = jnp.asarray(ds.read_lens[:B])
    print(f"B={B} entries={table.entries.shape}", flush=True)

    # current full path
    f0 = reduced(functools.partial(seed_candidates_jax, table=table, cfg=cfg))
    t("seed full (row4 gather)", f0, r, l)

    # phase split: kmers+hash only
    def kmers_only(r, l):
        keys, valid = query_kmers_jax(r, l, cfg)
        return hash_kmer_jax(keys, table.n_bits)
    t("  kmers+hash", reduced(kmers_only), r, l)

    # probe only (row4)
    def probe_only(r, l):
        keys, valid = query_kmers_jax(r, l, cfg)
        bucket = hash_kmer_jax(keys, table.n_bits)
        return probe(keys, valid, bucket, table.bucket_start, table.entries, cfg)
    t("  kmers+probe(row4)", reduced(probe_only), r, l)

    # select only (feed precomputed ckey)
    ck = jax.jit(probe_only)(r, l)
    t("  select(sorts)", reduced(functools.partial(select_candidates, cfg=cfg)), ck)

    # variant: packed 2-col entries (key, ref*2048+pos)
    ent = np.asarray(table.entries)
    packed = np.stack([ent[:, 0], ent[:, 1] * cfg.ref_len_max + ent[:, 2]], 1)
    packed_d = jnp.asarray(packed)

    def probe2(r, l):
        keys, valid = query_kmers_jax(r, l, cfg)
        bucket = hash_kmer_jax(keys, table.n_bits)
        pos = jnp.arange(0, cfg.read_len_max - cfg.k + 1, cfg.seed_stride,
                         dtype=jnp.int32)
        cap = cfg.bucket_cap
        n_local = table.bucket_start.shape[0] - 1
        lb = jnp.clip(bucket, 0, n_local - 1)
        start = jnp.take(table.bucket_start, lb)
        count = jnp.take(table.bucket_start, lb + 1) - start
        slot = jnp.arange(cap, dtype=jnp.int32)
        eidx = jnp.clip(start[..., None] + slot, 0, packed_d.shape[0] - 1)
        in_bucket = slot[None, None, :] < count[..., None]
        g = jnp.take(packed_d, eidx, axis=0)          # (B, Q, cap, 2)
        ekey = g[..., 0]
        erp = g[..., 1]
        hit = in_bucket & (ekey == keys[..., None]) & valid[..., None]
        epos = erp % cfg.ref_len_max
        eref = erp // cfg.ref_len_max
        diag = epos - pos[None, :, None]
        dbin = (diag + cfg.read_len_max) // cfg.diag_bin
        ckey = eref * cfg.n_diag_bins + dbin
        from rambl_tpu.ops.seed import BIGK
        return jnp.where(hit, ckey, BIGK)
    t("  kmers+probe(row2 packed)", reduced(probe2), r, l)
    print("  row2 == row4:", bool(jnp.array_equal(ck, jax.jit(probe2)(r, l))), flush=True)

    # variant: two separate 1-col gathers
    keys_col = jnp.asarray(ent[:, 0])
    rp_col = jnp.asarray(packed[:, 1])

    def probe1(r, l):
        keys, valid = query_kmers_jax(r, l, cfg)
        bucket = hash_kmer_jax(keys, table.n_bits)
        pos = jnp.arange(0, cfg.read_len_max - cfg.k + 1, cfg.seed_stride,
                         dtype=jnp.int32)
        cap = cfg.bucket_cap
        n_local = table.bucket_start.shape[0] - 1
        lb = jnp.clip(bucket, 0, n_local - 1)
        start = jnp.take(table.bucket_start, lb)
        count = jnp.take(table.bucket_start, lb + 1) - start
        slot = jnp.arange(cap, dtype=jnp.int32)
        eidx = jnp.clip(start[..., None] + slot, 0, keys_col.shape[0] - 1)
        in_bucket = slot[None, None, :] < count[..., None]
        ekey = jnp.take(keys_col, eidx)               # (B, Q, cap)
        erp = jnp.take(rp_col, eidx)
        hit = in_bucket & (ekey == keys[..., None]) & valid[..., None]
        epos = erp % cfg.ref_len_max
        eref = erp // cfg.ref_len_max
        diag = epos - pos[None, :, None]
        dbin = (diag + cfg.read_len_max) // cfg.diag_bin
        ckey = eref * cfg.n_diag_bins + dbin
        from rambl_tpu.ops.seed import BIGK
        return jnp.where(hit, ckey, BIGK)
    t("  kmers+probe(2x col gather)", reduced(probe1), r, l)
    print("  col == row4:", bool(jnp.array_equal(ck, jax.jit(probe1)(r, l))), flush=True)


if __name__ == "__main__":
    main()
