"""Split the round-0 cluster-stage wall into its parts on the GPU (the
cluster stage is the largest part of a config-3 round 0).

Builds config-3-shaped synthetic inputs (shapes are what matter: the
dp-means fori_loop has a fixed trip count and vmapped lax.cond lowers to
select, so content changes nothing structural) and times each jitted piece
of cluster_round0_core separately, one large dispatch each:

  bin_sort        argsort of B bins + range search
  member_gather   member_table_ranges + query/ref_col row gathers
  sort_cols       sorted_col_base over the gathered members
  pileup_feat     leaf pileups + polymorphic mask + leaf_features
  dp_means        dp_means_leaves
  consensus       cluster_consensus_leaves + minorhap

Usage: PYTHONPATH=. python scripts/profile_cluster.py \
           [n_reads] [n_leaves_block]
"""

import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.utils.cache import enable_compile_cache


def fetch(x):
    return np.asarray(jax.tree_util.tree_leaves(x)[0]).ravel()[:4].sum()


def timeit(name, f, *args, reps=2):
    out = f(*args)                     # compile
    fetch(out)
    t0 = time.time()
    for _ in range(reps):
        fetch(f(*args))
    dt = (time.time() - t0) / reps
    print(f"  {name:14s}: {dt * 1000:8.1f} ms", flush=True)
    return out


def main():
    enable_compile_cache()
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    NL = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    cfg = PipelineConfig(batch_size=16000, max_genes=1024,
                         max_clusters_per_bin=16, bin_share_depth=3,
                         cluster_leaf_block=512, sw_rows=104)
    L, ref_len = 128, 2048
    n_nodes = 187_667
    M = cfg.max_bin_reads
    from rambl_tpu.index.taxonomy import MAX_DEPTH as D
    rng = np.random.default_rng(0)
    print(f"shapes: B={B} NL={NL} M={M} L={L} ref_len={ref_len} "
          f"n_nodes={n_nodes}", flush=True)

    # synthetic retention: reads spread over ~8500 active leaves' chains
    query = jnp.asarray(rng.integers(0, 4, (B, L)).astype(np.int8))
    start = rng.integers(0, ref_len - L, B)
    ref_col = jnp.asarray(
        (start[:, None] + np.arange(L)[None, :]).astype(np.int16))
    leaves_np = np.sort(rng.choice(n_nodes // 2, NL * 17, replace=False)
                        .astype(np.int32)) + n_nodes // 2
    bins_np = leaves_np[rng.integers(0, leaves_np.size, B)].astype(np.int32)
    bins = jnp.asarray(bins_np)
    # a simple deep tree: anc_path rows = straight chains
    anc_np = np.tile(np.arange(D, dtype=np.int32)[None, :], (n_nodes, 1))
    anc_np[:, -1] = np.arange(n_nodes, dtype=np.int32)
    for d in range(D - 1):
        anc_np[:, d] = np.minimum(anc_np[:, d], anc_np[:, -1])
    depth_np = np.full(n_nodes, D - 1, np.int32)
    anc = jnp.asarray(anc_np)
    depth = jnp.asarray(depth_np)
    leaves = jnp.asarray(leaves_np[:NL])

    from rambl_tpu.pipeline.cluster import (
        bin_sort,
        dp_means_leaves,
        leaf_features_dense,
        member_table_ranges,
    )

    f_binsort = jax.jit(functools.partial(bin_sort, n_nodes=n_nodes))
    order, ns, ne = timeit("bin_sort", f_binsort, bins)

    @jax.jit
    def f_members(order, ns, ne, leaves, query, ref_col):
        midx, mvalid = member_table_ranges(
            order, ns, ne, leaves, anc, depth, M, cfg.bin_share_depth)
        return query[midx], ref_col[midx].astype(jnp.int32), midx, mvalid

    qm, rcm, midx, mvalid = timeit("member_gather", f_members, order, ns, ne,
                                   leaves, query, ref_col)

    # slot accumulators like config 3 (n_slots ~ 4864)
    n_slots = 4864
    counts = jnp.asarray(rng.integers(0, 50, (n_slots, ref_len, 4))
                         .astype(np.int32))
    span = jnp.asarray(rng.integers(0, 5, (n_slots, ref_len + 1))
                       .astype(np.int32))
    node2slot_np = np.full(n_nodes, -1, np.int32)
    slot_nodes = np.unique(np.concatenate([leaves_np[: n_slots // 2],
                                           np.arange(n_slots // 2)]))
    node2slot_np[slot_nodes] = np.arange(slot_nodes.size, dtype=np.int32)
    node2slot = jnp.asarray(node2slot_np)

    from rambl_tpu.pipeline.pileup import leaf_pileup_slots, polymorphic_mask

    @jax.jit
    def f_pf(counts, span, leaves, qm, rcm, mvalid):
        lc, lsp = leaf_pileup_slots(counts, span, node2slot, leaves, anc,
                                    depth, cfg.bin_share_depth)
        pm = polymorphic_mask(lc, cfg.min_coverage, cfg.poly_min_minor_count,
                              cfg.poly_minor_frac_num,
                              cfg.poly_minor_frac_den, ref_len)
        cols = jnp.arange(ref_len, dtype=jnp.int32)
        key = jnp.where(pm, cols[None, :], jnp.int32(1 << 30))
        pol_cols = -jax.lax.top_k(-key, cfg.max_poly_cols)[0]
        pol_valid = pol_cols < (1 << 30)
        pol_cols = jnp.where(pol_valid, pol_cols, 0)
        feat = leaf_features_dense(qm, rcm, mvalid, pol_cols, pol_valid,
                                   ref_len)
        return lc, lsp, pm, feat

    lc, lsp, pm, feat = timeit("pileup_feat", f_pf, counts, span, leaves,
                               qm, rcm, mvalid)

    can_seed = (bins[midx] == leaves[:, None]) & mvalid
    f_dp = jax.jit(functools.partial(dp_means_leaves, cfg=cfg))
    dp = timeit("dp_means", f_dp, feat, can_seed)

    from rambl_tpu.pipeline.consensus import (
        _chain_read_count,
        cluster_consensus_leaves,
        minor_haplotype_leaves,
    )

    @jax.jit
    def f_cons(qm, rcm, mvalid, assign, pm, lc, lsp):
        cons = cluster_consensus_leaves(qm, rcm, mvalid, assign, pm, lc, lsp,
                                        cfg)
        ls = node2slot[leaves]
        excl = jnp.where((ls >= 0)[:, None, None],
                         counts[jnp.clip(ls, 0, n_slots - 1)], 0)
        mh = minor_haplotype_leaves(excl, lc, lsp, cfg)
        return cons, mh

    timeit("consensus", f_cons, qm, rcm, mvalid, dp.assign, pm, lc, lsp)


if __name__ == "__main__":
    main()
