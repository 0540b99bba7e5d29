"""Jitted batched DP-means clustering over leaf bins.

Bit-identical to oracle.cluster.dp_means (integer distance arithmetic, same
spawn/merge rules - see that module's docstring) but fully vectorized:

- membership tables are built from bin nodes + ancestor paths (static cap
  cfg.max_bin_reads members per leaf, ascending read index);
- per-read (column -> base) lookups use a per-read lax.sort once, then binary
  search per polymorphic column;
- per-leaf clustering runs under lax.map with a fori_loop whose state freezes
  at convergence (fixed dp_max_iters trip count, masked updates - the
  jit-safe equivalent of the oracle's early break);
- center recomputation is a one-hot einsum (assign x base one-hots) in int32:
  exact counts on every backend (no reduced-precision float matmul can
  enter).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rambl_tpu.config import PipelineConfig
from rambl_tpu.index.taxonomy import MAX_DEPTH

_BIG = jnp.int32(1 << 30)


def member_table(
    bins: jax.Array,      # (B,) int32 bin node per read
    leaves: jax.Array,    # (NL,) int32
    anc_path: jax.Array,  # (n_nodes, D) int32
    depth: jax.Array,     # (n_nodes,) int32
    max_members: int,
    share_depth: int = MAX_DEPTH,
):
    """(NL, M) member read indices (ascending) + (NL, M) valid mask.

    A read is a member of a leaf iff its bin is on the leaf's ancestor chain
    within share_depth ranks (leaf itself included) -
    oracle.binning.leaf_membership.
    """
    from rambl_tpu.pipeline.pileup import chain_use_mask

    B = bins.shape[0]
    paths = anc_path[leaves]                              # (NL, D)
    use = chain_use_mask(leaves, depth, share_depth)      # (NL, D)
    # member mask (NL, B): bins[b] equals any used ancestor
    m = (bins[None, :, None] == paths[:, None, :]) & use[:, None, :]
    member = m.any(axis=2)                                # (NL, B)
    # first M members by read index
    key = jnp.where(member, jnp.arange(B, dtype=jnp.int32)[None, :], _BIG)
    sortedk = jnp.sort(key, axis=1)[:, :max_members]      # (NL, M)
    valid = sortedk < _BIG
    idx = jnp.where(valid, sortedk, 0)
    return idx, valid


def bin_sort(bins: jax.Array, n_nodes: int):
    """Sort reads by bin node for range-based membership.

    Returns (order (B,) int32 read indices sorted by (bin, read idx),
             node_start (n_nodes,), node_end (n_nodes,)) - the contiguous
    range of sorted positions holding each node's reads. Unaligned reads
    (bin -1) sort first and fall outside every node range."""
    order = jnp.argsort(bins, stable=True).astype(jnp.int32)
    bins_sorted = bins[order]
    nodes = jnp.arange(n_nodes, dtype=bins.dtype)
    node_start = jnp.searchsorted(bins_sorted, nodes, side="left").astype(jnp.int32)
    node_end = jnp.searchsorted(bins_sorted, nodes, side="right").astype(jnp.int32)
    return order, node_start, node_end


def member_table_ranges(
    order: jax.Array,       # (B,) from bin_sort
    node_start: jax.Array,  # (n_nodes,)
    node_end: jax.Array,    # (n_nodes,)
    leaves: jax.Array,      # (NL,)
    anc_path: jax.Array,
    depth: jax.Array,
    max_members: int,
    share_depth: int = MAX_DEPTH,
):
    """member_table without the (NL, B) mask: a leaf's members are the union
    of its ancestor-node ranges (depths [depth-share_depth, depth]) in the
    bin-sorted read order. Each range is ascending in read index (stable
    sort), so the first max_members of the merged union == member_table's.
    O(NL * W * M) with W = share_depth+1 instead of O(NL * B).

    The candidate list is compacted to the W live window depths BEFORE the
    merge sort: the (NL, MAX_DEPTH*M) sort costs far more than the row
    gathers themselves (scripts/profile_cluster.py times both) and only W
    of the D depth rows can hold reads. In-window path nodes are a unique real chain
    (taxonomy.build_taxonomy_tables pads only BEYOND depth(leaf)), so the
    candidate multiset - and the sorted first-M prefix - is bitwise
    unchanged."""
    B = order.shape[0]
    M = max_members
    D = anc_path.shape[1]
    W = min(share_depth + 1, D)
    dl = depth[leaves][:, None]                           # (NL, 1)
    didx = dl - (W - 1) + jnp.arange(W, dtype=jnp.int32)[None, :]  # (NL, W)
    w_ok = (didx >= 0) & (didx <= dl)
    paths = jnp.take_along_axis(
        anc_path[leaves], jnp.clip(didx, 0, D - 1), axis=1)        # (NL, W)
    # the clipped low end can repeat a node for shallow leaves; count each
    # range once (a duplicate only suppresses against an earlier USABLE
    # column - the clipped out-of-window copies must not shadow the real
    # depth-0 range)
    first = jnp.ones_like(paths, dtype=bool)
    for d in range(1, W):
        dup = ((paths[:, d:d + 1] == paths[:, :d])
               & w_ok[:, :d]).any(axis=1)
        first = first.at[:, d].set(~dup)
    use = w_ok & first
    starts = node_start[paths]                            # (NL, W)
    cnt = jnp.where(use, node_end[paths] - starts, 0)     # (NL, W)
    k = jnp.arange(M, dtype=jnp.int32)
    pos = starts[:, :, None] + k[None, None, :]           # (NL, W, M)
    valid = k[None, None, :] < cnt[:, :, None]
    cand = jnp.where(
        valid, order[jnp.clip(pos, 0, B - 1)], _BIG
    ).reshape(paths.shape[0], -1)                         # (NL, W*M)
    sortedk = jax.lax.sort(cand, dimension=1)[:, :M]
    ok = sortedk < _BIG
    return jnp.where(ok, sortedk, 0), ok


def sorted_col_base(query: jax.Array, ref_col: jax.Array):
    """Per-read (cols_sorted, base_sorted) for binary-search lookups.

    Unaligned/ambiguous positions get column _BIG so they sort last.
    Alignment columns are strictly increasing, so no duplicates.
    """
    ok = (ref_col >= 0) & (query < 4)
    cols = jnp.where(ok, ref_col, _BIG)
    cols_sorted, base_sorted = jax.lax.sort(
        (cols, query.astype(jnp.int32)), num_keys=1
    )
    return cols_sorted, base_sorted.astype(jnp.int8)


def leaf_features(
    mc: jax.Array,            # (NL, M, L) member cols_sorted
    mb: jax.Array,            # (NL, M, L) member base_sorted
    member_valid: jax.Array,  # (NL, M)
    pol_cols: jax.Array,      # (NL, P) int32 column ids (padded arbitrary)
    pol_valid: jax.Array,     # (NL, P) bool
):
    """feat (NL, M, P) int8: member base at polymorphic column, -1 uncovered.

    Takes the member-gathered sorted-column arrays directly so the caller
    can choose gather-then-sort (B >> NL*M, config-3/5 scale) or
    sort-then-gather (small B) - bitwise identical either way because
    sorted_col_base is row-independent."""
    L = mc.shape[2]

    def one_read(cols_row, base_row, pcols):
        i = jnp.clip(jnp.searchsorted(cols_row, pcols), 0, L - 1)
        hit = cols_row[i] == pcols
        return jnp.where(hit, base_row[i], -1).astype(jnp.int8)

    f = jax.vmap(jax.vmap(one_read, in_axes=(0, 0, None)), in_axes=(0, 0, 0))(
        mc, mb, pol_cols
    )                                  # (NL, M, P)
    f = jnp.where(member_valid[:, :, None], f, jnp.int8(-1))
    f = jnp.where(pol_valid[:, None, :], f, jnp.int8(-1))
    return f


def leaf_features_dense(qm, rcm, member_valid, pol_cols, pol_valid,
                        ref_len: int, chunk: int = 8):
    """feat (NL, M, P) int8 via scatter-into-column-space + integer matmul.

    Bitwise identical to leaf_features(sorted_col_base(...)): alignment
    columns are unique within a read, so at most one member position matches
    each polymorphic column and the integer dot picks exactly that base's
    value (+1; 0 = uncovered). The member bases scatter once into a dense
    (M, ref_len) plane and one (M, ref_len) x (ref_len, P) int8 dot_general
    with int32 accumulation contracts it onto the polymorphic columns
    (values <= 5: exact). This replaces the sorted formulation's per-row
    sort plus per-lane binary searches. Leaves run in lax.map chunks to
    bound the dense plane at ~70 MB."""
    NL, M, L = qm.shape
    P = pol_cols.shape[1]
    ch = max(1, min(chunk, NL))

    def one_chunk(args):
        q, rc, pc, pv = args
        c = q.shape[0]
        rc = rc.astype(jnp.int32)
        ok = (rc >= 0) & (q < 4)
        col = jnp.clip(rc, 0, ref_len - 1)
        li = jnp.arange(c, dtype=jnp.int32)[:, None, None]
        mi = jnp.arange(M, dtype=jnp.int32)[None, :, None]
        # base+1 at its column; invalid positions contribute 0 and .max keeps
        # any real base they might collide with at the clip boundary
        dense = jnp.zeros((c, M, ref_len), jnp.int8)
        dense = dense.at[li, mi, col].max(
            jnp.where(ok, q + 1, 0).astype(jnp.int8))
        pli = jnp.arange(c, dtype=jnp.int32)[:, None]
        ppi = jnp.clip(pc, 0, ref_len - 1)
        onep = jnp.zeros((c, P, ref_len), jnp.int8)
        onep = onep.at[pli, jnp.arange(P)[None, :], ppi].max(
            pv.astype(jnp.int8))
        f1 = jnp.einsum("lmc,lpc->lmp", dense, onep,
                        preferred_element_type=jnp.int32)
        return jnp.where(f1 > 0, f1 - 1, -1).astype(jnp.int8)

    pv_orig = pol_valid
    if NL % ch:
        pad = ch - NL % ch
        qm = jnp.concatenate([qm, qm[:1].repeat(pad, 0)])
        rcm = jnp.concatenate([rcm, rcm[:1].repeat(pad, 0)])
        pol_cols = jnp.concatenate([pol_cols, pol_cols[:1].repeat(pad, 0)])
        pol_valid = jnp.concatenate([pol_valid, pol_valid[:1].repeat(pad, 0)])
    G = qm.shape[0] // ch
    f = jax.lax.map(
        one_chunk,
        (qm.reshape(G, ch, M, L), rcm.reshape(G, ch, M, L),
         pol_cols.reshape(G, ch, P), pol_valid.reshape(G, ch, P)),
    ).reshape(G * ch, M, P)[:NL]
    f = jnp.where(member_valid[:, :, None], f, jnp.int8(-1))
    return jnp.where(pv_orig[:, None, :], f, jnp.int8(-1))


class DPMeansOut(NamedTuple):
    assign: jax.Array    # (NL, M) int32 cluster id per member
    centers: jax.Array   # (NL, K, P) int8
    kact: jax.Array      # (NL,) int32 active cluster count


def _consensus_counts(feat, weights):
    """Per-column base counts (P, 4) over reads weighted by `weights` (M,);
    int32 throughout, so the counts are exact on every backend."""
    onehot = (feat[:, :, None] == jnp.arange(4, dtype=jnp.int8)[None, None, :])
    return jnp.einsum(
        "m,mpb->pb", weights.astype(jnp.int32), onehot.astype(jnp.int32),
        preferred_element_type=jnp.int32,
    )


def _dp_means_single(cfg: PipelineConfig, args):
    """DP-means for one leaf. feat (M, P) int8 (-1 = uncovered; invalid member
    rows are all -1); can_seed (M,) bool restricts spawn seeds/support to
    leaf-exclusive reads. Mirrors oracle.cluster.dp_means exactly."""
    feat, can_seed = args
    M, P = feat.shape
    K = cfg.max_clusters_per_bin
    S = cfg.dp_spawn_scan
    lam_n, lam_d = cfg.dp_lambda_num, cfg.dp_lambda_den

    cov = feat >= 0                               # (M, P)
    ncov = cov.sum(axis=1).astype(jnp.int32)      # (M,)
    covered_reads = jnp.ones((M,), jnp.int32)     # all rows; empties harmless

    # fallback = bin consensus (argmax counts; ties lowest base; empty -> 0)
    cnt_all = _consensus_counts(feat, covered_reads)          # (P, 4)
    fallback = jnp.where(
        cnt_all.sum(axis=1) > 0, jnp.argmax(cnt_all, axis=1), 0
    ).astype(jnp.int8)

    centers0 = jnp.zeros((K, P), jnp.int8).at[0].set(fallback)
    assign0 = jnp.zeros((M,), jnp.int32)
    state0 = (centers0, assign0, jnp.int32(1), jnp.bool_(False))

    def one_iter(state):
        centers, assign, kact, _ = state
        eq = feat[:, None, :] == centers[None, :, :]           # (M, K, P)
        diff = ((~eq) & cov[:, None, :]).sum(axis=2).astype(jnp.int32)
        diff = jnp.where(jnp.arange(K)[None, :] < kact, diff, _BIG)
        new_assign = jnp.argmin(diff, axis=1).astype(jnp.int32)
        dmin = jnp.take_along_axis(diff, new_assign[:, None], axis=1)[:, 0]
        orphans = (dmin * lam_d > lam_n * ncov) & can_seed     # (M,)
        n_orph = orphans.sum()
        can_spawn = (n_orph >= cfg.dp_spawn_min_orphans) & (kact < K)

        # first S orphan indices (ascending read index; _BIG = none)
        okey = jnp.where(orphans, jnp.arange(M, dtype=jnp.int32), _BIG)
        seeds = -jax.lax.top_k(-okey, S)[0]                    # (S,) ascending

        def seed_support(sidx):
            fv = feat[jnp.clip(sidx, 0, M - 1)]                # (P,)
            common = cov & (fv >= 0)[None, :]
            ncom = common.sum(axis=1).astype(jnp.int32)
            dc = ((feat != fv[None, :]) & common).sum(axis=1).astype(jnp.int32)
            supp = (orphans & (ncom > 0) & (dc * lam_d <= lam_n * ncom)).sum()
            return jnp.where(sidx < _BIG, supp, 0)

        supports = jax.vmap(seed_support)(seeds)               # (S,)
        good = supports >= cfg.dp_spawn_min_orphans
        any_good = good.any() & can_spawn
        first = jnp.argmax(good)                               # first good seed
        cand = jnp.clip(seeds[first], 0, M - 1)
        fv = feat[cand]
        newc = jnp.where(fv >= 0, fv, fallback).astype(jnp.int8)

        centers = jnp.where(
            any_good,
            centers.at[jnp.clip(kact, 0, K - 1)].set(newc),
            centers,
        )
        new_assign = jnp.where(
            any_good, new_assign.at[cand].set(kact), new_assign
        )
        kact_new = kact + any_good.astype(jnp.int32)

        # recompute centers: counts per (k, p, base) via one-hot einsum
        aoh = (
            new_assign[:, None] == jnp.arange(K, dtype=jnp.int32)[None, :]
        ).astype(jnp.int32)                                    # (M, K)
        foh = (
            feat[:, :, None] == jnp.arange(4, dtype=jnp.int8)[None, None, :]
        ).astype(jnp.int32)                                    # (M, P, 4)
        cnt = jnp.einsum("mk,mpb->kpb", aoh, foh,
                         preferred_element_type=jnp.int32)     # (K, P, 4)
        has = cnt.sum(axis=2) > 0
        cen_new = jnp.where(
            has, jnp.argmax(cnt, axis=2), fallback[None, :].astype(jnp.int32)
        ).astype(jnp.int8)
        cen_new = jnp.where(
            jnp.arange(K)[:, None] < kact_new, cen_new, jnp.int8(0)
        )
        changed = (new_assign != assign).any() | any_good
        return (cen_new, new_assign, kact_new, ~changed)

    def body(_, state):
        done = state[3]
        return jax.lax.cond(done, lambda s: s, one_iter, state)

    centers, assign, kact, _ = jax.lax.fori_loop(
        0, cfg.dp_max_iters, body, state0
    )

    # merge identical active centers, compact ids in first-seen order
    same = (centers[:, None, :] == centers[None, :, :]).all(axis=2)  # (K, K)
    kk = jnp.arange(K, dtype=jnp.int32)
    active = kk < kact
    same = same & active[:, None] & active[None, :]
    # canon[k] = smallest j with same[k, j] (j <= k always qualifies via k==k)
    canon = jnp.argmax(same, axis=1).astype(jnp.int32)  # first True = smallest j
    keep = canon == kk
    remap = jnp.cumsum(keep.astype(jnp.int32)) - 1      # new id per kept k
    assign = remap[canon[assign]]
    kact2 = keep.sum().astype(jnp.int32)
    # compact centers: kept centers in order
    order_key = jnp.where(keep, kk, _BIG)
    order = -jax.lax.top_k(-order_key, K)[0]            # kept ids ascending
    centers2 = centers[jnp.clip(order, 0, K - 1)]
    centers2 = jnp.where(jnp.arange(K)[:, None] < kact2, centers2, jnp.int8(0))
    return assign, centers2, kact2


def dp_means_leaves(feat: jax.Array, can_seed: jax.Array,
                    cfg: PipelineConfig) -> DPMeansOut:
    """Run DP-means over all leaves. feat (NL, M, P) int8, can_seed (NL, M).

    Leaves are independent, so they run vmapped in chunks of
    cfg.dp_leaf_vmap (sequential lax.map over chunks bounds the (ch, M, K, P)
    temporaries): a pure lax.map serialized NL small latency-bound steps and
    dominated config-3-scale rounds. Bitwise identical to the sequential
    map - every per-leaf op is integer-exact (the einsums accumulate in
    int32) and vmap adds only a batch dimension."""
    NL = feat.shape[0]
    ch = max(1, min(cfg.dp_leaf_vmap, NL))
    single = functools.partial(_dp_means_single, cfg)
    if NL % ch:
        pad = ch - NL % ch
        feat = jnp.concatenate([feat, feat[:1].repeat(pad, 0)])
        can_seed = jnp.concatenate([can_seed, can_seed[:1].repeat(pad, 0)])
    G = feat.shape[0] // ch
    assign, centers, kact = jax.lax.map(
        jax.vmap(single),
        (feat.reshape(G, ch, *feat.shape[1:]),
         can_seed.reshape(G, ch, *can_seed.shape[1:])),
    )
    assign = assign.reshape(G * ch, *assign.shape[2:])[:NL]
    centers = centers.reshape(G * ch, *centers.shape[2:])[:NL]
    kact = kact.reshape(G * ch)[:NL]
    return DPMeansOut(assign=assign, centers=centers, kact=kact)
