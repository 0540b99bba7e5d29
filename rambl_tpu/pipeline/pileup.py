"""On-chip pileup tensors: the samtools-mpileup replacement (SURVEY.md L7).

Alignments stay dense on device; pileup is a scatter-add into
(node, column, base) count tensors in *taxonomy-node space*:

- each read scatters its aligned bases into its bin node's counts;
- a leaf bin's pileup is then the sum over the leaf's ancestor chain
  (gather anc_path + sum), reproducing oracle.binning.leaf_membership's
  "reads shared down the tree" semantics without any per-leaf masking;
- span (interval) coverage uses the same +1/-1 diff trick as the oracle,
  scattered per node and cumsum'd per leaf after the ancestor merge.

Across devices these count tensors are merged with jax.lax.psum before
consensus (BASELINE.json:5), which is exact for integer counts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rambl_tpu.index.taxonomy import MAX_DEPTH


#: rows per scatter chunk when a single call covers a whole retention buffer
#: (slot mode scatters ALL reads in one jit). A scatter-add lowered via a
#: full sort of the flattened (B*L) index array needs three int32 temps of
#: that size - 3 x 4.8 GB for an unchunked 10M-read call. 512Ki rows bound
#: the temps at ~0.8 GB while keeping each call large.
_SCATTER_ROW_CHUNK = 1 << 19


def _scatter_flat(query, ref_col, bins, n_nodes: int, ref_len: int):
    """One scatter pass in FLAT index space. Returns (counts_1d
    (n_nodes*ref_len*4 + 1,), span_1d (n_nodes*(ref_len+1) + 1,)); the last
    element of each is the inert overflow/sentinel slot. 1D on purpose: a
    (n, ref_len, 4) carry can be laid out with its trailing dim of 4 padded
    to a full tile; the flat layout cannot."""
    B, L = query.shape
    # the streaming driver retains ref_col as int16 (values < ref_len_max
    # round-trip exactly); widen inside the jit so the cast fuses
    ref_col = ref_col.astype(jnp.int32)
    ok = (ref_col >= 0) & (query < 4) & (bins[:, None] >= 0)
    node = jnp.broadcast_to(jnp.clip(bins, 0, n_nodes - 1)[:, None], (B, L))
    col = jnp.clip(ref_col, 0, ref_len - 1)
    base = jnp.clip(query, 0, 3).astype(jnp.int32)

    flat = (node * ref_len + col) * 4 + base
    flat = jnp.where(ok, flat, n_nodes * ref_len * 4)  # overflow slot
    counts = jnp.zeros((n_nodes * ref_len * 4 + 1,), jnp.int32)
    counts = counts.at[flat.reshape(-1)].add(1)

    # span: per read lo/hi of aligned columns
    has = ok.any(axis=1)
    masked_lo = jnp.where(ok, ref_col, 1 << 30).min(axis=1)
    masked_hi = jnp.where(ok, ref_col, -1).max(axis=1)
    node1 = jnp.clip(bins, 0, n_nodes - 1)
    lo_flat = node1 * (ref_len + 1) + jnp.clip(masked_lo, 0, ref_len)
    hi_flat = node1 * (ref_len + 1) + jnp.clip(masked_hi + 1, 0, ref_len)
    sentinel = n_nodes * (ref_len + 1)
    lo_flat = jnp.where(has, lo_flat, sentinel)
    hi_flat = jnp.where(has, hi_flat, sentinel)
    span = jnp.zeros((n_nodes * (ref_len + 1) + 1,), jnp.int32)
    span = span.at[lo_flat].add(1)
    span = span.at[hi_flat].add(-1)
    return counts, span


def node_pileup(
    query: jax.Array,     # (B, L) int8 aligned-orientation codes
    ref_col: jax.Array,   # (B, L) int32 global columns, -1 = unaligned
    bins: jax.Array,      # (B,) int32 bin node per read (-1 = unaligned)
    n_nodes: int,
    ref_len: int,
):
    """Scatter reads into node space.

    Returns (counts (n_nodes, ref_len*4) int32 FLAT rows, span_diff
    (n_nodes, ref_len+1) int32). span_diff is the un-cumsum'd
    interval-difference array. counts rows stay FLAT in node/slot space:
    a (n, ref_len, 4) device array is tiled T(8,128) with the 4-lane minor
    dim padded to 128 (32x memory - a 32k-slot accumulator tried to
    allocate 33.6 GB); consumers reshape AFTER the per-leaf gather, where
    blocks are small. Flat and 3D hold identical integers.

    Calls larger than _SCATTER_ROW_CHUNK rows run as a lax.scan of per-chunk
    scatters accumulated in FLAT 1D space (no tiled-layout padding), with the
    non-multiple tail scattered directly - no padded copy of the multi-GB
    retention buffers. Integer scatter-adds commute, so the chunked sum is
    bit-identical to the one-shot scatter (tests/test_scale_paths.py).
    """
    B, L = query.shape
    ck = _SCATTER_ROW_CHUNK
    if B > ck:
        nfull = (B // ck) * ck

        # scan over chunk INDICES with dynamic_slice, not over sliced xs:
        # `query[:nfull].reshape(...)` as a scan input materializes a copy of
        # the whole multi-GB retention (+7.5 GB for a 20M-read config-5
        # run), while a per-iteration slice holds one ~64-128 MB chunk at a
        # time
        def body(carry, i):
            c, s = carry
            q = jax.lax.dynamic_slice_in_dim(query, i * ck, ck, 0)
            rc = jax.lax.dynamic_slice_in_dim(ref_col, i * ck, ck, 0)
            b = jax.lax.dynamic_slice_in_dim(bins, i * ck, ck, 0)
            cc, ss = _scatter_flat(q, rc, b, n_nodes, ref_len)
            return (c + cc, s + ss), None

        init = (jnp.zeros((n_nodes * ref_len * 4 + 1,), jnp.int32),
                jnp.zeros((n_nodes * (ref_len + 1) + 1,), jnp.int32))
        (counts, span), _ = jax.lax.scan(
            body, init, jnp.arange(B // ck, dtype=jnp.int32))
        if B > nfull:
            cc, ss = _scatter_flat(query[nfull:], ref_col[nfull:],
                                   bins[nfull:], n_nodes, ref_len)
            counts = counts + cc
            span = span + ss
    else:
        counts, span = _scatter_flat(query, ref_col, bins, n_nodes, ref_len)
    return (counts[:-1].reshape(n_nodes, ref_len * 4),
            span[:-1].reshape(n_nodes, ref_len + 1))


def chain_use_mask(leaves, depth, share_depth: int = MAX_DEPTH):
    """(NL, MAX_DEPTH) bool: which anc_path depths contribute to each leaf -
    depths in [depth(leaf) - share_depth, depth(leaf)] (the bounded
    share-down-the-tree window, oracle.binning.leaf_membership)."""
    dd = jnp.arange(MAX_DEPTH, dtype=jnp.int32)
    dl = depth[leaves][:, None]
    return (dd[None, :] <= dl) & (dd[None, :] >= dl - share_depth)


def leaf_pileup(
    counts: jax.Array,      # (n_nodes, ref_len*4) flat node_pileup rows
    span_diff: jax.Array,   # (n_nodes, ref_len+1)
    leaves: jax.Array,      # (NL,) int32 leaf node ids
    anc_path: jax.Array,    # (n_nodes, MAX_DEPTH) int32
    depth: jax.Array,       # (n_nodes,) int32
    share_depth: int = MAX_DEPTH,
):
    """Merge ancestor-chain node pileups per leaf.

    Returns (leaf_counts (NL, ref_len, 4) int32,
             leaf_span (NL, ref_len) int32 cumulative span coverage).

    The ancestor chain of a leaf at depth d is anc_path[leaf, 0..d] (padding
    repeats the leaf itself, which must not be double counted - mask by
    depth index), bounded below by share_depth.
    """
    NL = leaves.shape[0]
    ref_len = counts.shape[1] // 4
    paths = anc_path[leaves]                     # (NL, D)
    use = chain_use_mask(leaves, depth, share_depth)
    c = counts[paths]                            # (NL, D, ref_len*4) flat
    leaf_counts = jnp.sum(c * use[:, :, None], axis=1).reshape(
        NL, ref_len, 4)
    s = span_diff[paths]                         # (NL, D, ref_len+1)
    leaf_span_diff = jnp.sum(s * use[:, :, None], axis=1)
    leaf_span = jnp.cumsum(leaf_span_diff[:, :-1], axis=1)
    return leaf_counts.astype(jnp.int32), leaf_span.astype(jnp.int32)


def node_slot_pileup(
    query: jax.Array,
    ref_col: jax.Array,
    bins: jax.Array,
    node2slot: jax.Array,   # (n_nodes,) int32 slot id or -1 (inactive)
    n_slots: int,
    ref_len: int,
):
    """node_pileup into a COMPACTED slot space.

    The dense (n_nodes, ref_len, 4) tensor is infeasible for a
    full-Greengenes-sized taxonomy (BASELINE configs 3/5: ~1e5-1e6 nodes x
    2048 cols would be terabytes); a sample only touches the nodes on its
    ACTIVE leaves' ancestor chains, so those get slots and everything else
    drops (reads at slotless nodes cannot contribute to any emitted leaf).
    Bit-identical to node_pileup restricted to slotted nodes."""
    slot = node2slot[jnp.clip(bins, 0, node2slot.shape[0] - 1)]
    slot = jnp.where(bins >= 0, slot, -1)
    return node_pileup(query, ref_col, slot, n_slots, ref_len)


def leaf_pileup_slots(
    counts_s: jax.Array,     # (n_slots, ref_len*4) flat node_pileup rows
    span_s: jax.Array,       # (n_slots, ref_len+1)
    node2slot: jax.Array,    # (n_nodes,) int32
    leaves: jax.Array,       # (NL,)
    anc_path: jax.Array,
    depth: jax.Array,
    share_depth: int = MAX_DEPTH,
):
    """leaf_pileup over slot-compacted accumulators (chain nodes without a
    slot contribute zero, exactly like zero-count nodes in the dense path)."""
    NL = leaves.shape[0]
    ref_len = counts_s.shape[1] // 4
    paths = anc_path[leaves]                     # (NL, D)
    slots = node2slot[paths]                     # (NL, D)
    use = chain_use_mask(leaves, depth, share_depth) & (slots >= 0)
    sidx = jnp.clip(slots, 0, counts_s.shape[0] - 1)
    c = counts_s[sidx]                           # (NL, D, ref_len*4) flat
    leaf_counts = jnp.sum(c * use[:, :, None], axis=1).reshape(
        NL, ref_len, 4)
    s = span_s[sidx]                             # (NL, D, ref_len+1)
    leaf_span_diff = jnp.sum(s * use[:, :, None], axis=1)
    leaf_span = jnp.cumsum(leaf_span_diff[:, :-1], axis=1)
    return leaf_counts.astype(jnp.int32), leaf_span.astype(jnp.int32)


def polymorphic_mask(
    leaf_counts: jax.Array,  # (NL, ref_len, 4)
    min_coverage: int,
    poly_min_minor_count: int,
    poly_minor_frac_num: int,
    poly_minor_frac_den: int,
    max_poly_cols: int,
):
    """Bool (NL, ref_len) mask of the first max_poly_cols polymorphic columns
    per leaf (ascending column), matching oracle.cluster.polymorphic_cols.

    The fraction threshold is the integer-exact cross-multiplication
    minor * den >= num * max(tot, 1) - no float arithmetic in any
    output-affecting path (CLAUDE.md invariant)."""
    tot = leaf_counts.sum(axis=2)
    top = leaf_counts.max(axis=2)
    minor = tot - top
    is_poly = (
        (tot >= min_coverage)
        & (minor >= poly_min_minor_count)
        & (minor * poly_minor_frac_den
           >= poly_minor_frac_num * jnp.maximum(tot, 1))
    )
    rank = jnp.cumsum(is_poly.astype(jnp.int32), axis=1)
    return is_poly & (rank <= max_poly_cols)
