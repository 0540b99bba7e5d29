"""End-to-end device assembly driver (single host; shard_map wiring in
rambl_tpu.parallel).

Mirrors oracle.pipeline.assemble bit-for-bit: round 0 discovers variants
(align -> LCA bin -> DP-means -> variant-aware consensus), later rounds refine
(realign to the panel -> exclusive/backbone consensus -> prune). Panel
management (gene lists, dedupe, pruning, convergence) is host logic on tiny
data; everything per-read or per-column runs jitted on device.

Reads stream through the jitted align+bin step in fixed-size batches (static
shapes; the last batch is padded with empty reads that bin to -1), node-space
pileup tensors accumulate on device - the multi-host version psums exactly
these accumulators (BASELINE.json:5).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import time
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.index.builder import build_seed_index
from rambl_tpu.index.taxonomy import TaxonomyTables, build_taxonomy_tables
from rambl_tpu.oracle.pipeline import Gene  # shared host-side gene record
from rambl_tpu.ops.seed import SeedTable
from rambl_tpu.pipeline.align import align_batch
from rambl_tpu.pipeline.binning import bin_batch
from rambl_tpu.pipeline.cluster import (
    bin_sort,
    dp_means_leaves,
    leaf_features_dense,
)
from rambl_tpu.pipeline.consensus import cluster_consensus_leaves
from rambl_tpu.pipeline.pileup import (
    leaf_pileup,
    node_pileup,
    polymorphic_mask,
)

_BIG = 1 << 30

# RAMBL_STAGE_TIMING=1: per-stage wall timers (with device syncs at stage
# boundaries) recorded into each round's stats dict. Diagnostic only - the
# syncs serialize the dispatch pipeline, so leave it off for benchmarks.
_STAGE_TIMING = bool(int(os.environ.get("RAMBL_STAGE_TIMING", "0")))


class _StageClock:
    """Accumulates wall time per named stage (no-op unless enabled)."""

    def __init__(self):
        self.t = {}
        self._last = time.time()

    def mark(self, name, *sync):
        if not _STAGE_TIMING:
            return
        for x in sync:
            if x is not None:
                jax.block_until_ready(x)
        now = time.time()
        dt = now - self._last
        self.t[name] = round(self.t.get(name, 0.0) + dt, 2)
        self._last = now
        if dt > 5.0:
            # live progress for long runs: stage boundaries as they happen
            # (stderr; the stats dict still gets the per-round totals)
            print(f"[stage] {name} +{dt:.0f}s", file=sys.stderr, flush=True)

    def into(self, stats):
        if _STAGE_TIMING:
            stats.update({f"t_{k}": v for k, v in self.t.items()})


# --------------------------------------------------------------------------
# jitted cores
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg", "n_bits"))
def _align_bin_batch(reads, lens, bucket_start, entries,
                     ref_seqs, ref_taxon, anc_path, depth, col_map,
                     cfg: PipelineConfig, n_bits: int):
    table = SeedTable(bucket_start, entries, n_bits)
    res = align_batch(reads, lens, table, ref_seqs, cfg)
    bins = bin_batch(res, ref_taxon, anc_path, depth, cfg)
    # anchor-coordinate projection (see index.colmap / oracle.assemble_round)
    refc = jnp.clip(res.ref, 0, ref_seqs.shape[0] - 1)
    rc = res.ref_col
    proj = jnp.where(
        rc >= 0,
        col_map[refc[:, None], jnp.clip(rc, 0, ref_seqs.shape[1] - 1)],
        -1,
    ).astype(jnp.int32)
    return res.query, proj, bins, res.score, res.ref, res.strand


@functools.partial(jax.jit, static_argnames=("cfg", "n_nodes", "ref_len"))
def _pileup_accum(query, ref_col, bins, counts, span_diff, read_count,
                  cfg: PipelineConfig, n_nodes: int, ref_len: int):
    c, s = node_pileup(query, ref_col, bins, n_nodes, ref_len)
    rc = jnp.zeros((n_nodes + 1,), jnp.int32).at[
        jnp.where(bins >= 0, bins, n_nodes)
    ].add(1)[:-1]
    return counts + c, span_diff + s, read_count + rc


@functools.partial(jax.jit, static_argnames=("n_nodes",))
def _read_count_accum(bins, read_count, n_nodes: int):
    return read_count + jnp.zeros((n_nodes + 1,), jnp.int32).at[
        jnp.where(bins >= 0, bins, n_nodes)
    ].add(1)[:-1]


@functools.partial(jax.jit, static_argnames=("n_slots", "ref_len"))
def _slot_pileup(query, ref_col, bins, node2slot, n_slots: int, ref_len: int):
    from rambl_tpu.pipeline.pileup import node_slot_pileup

    return node_slot_pileup(query, ref_col, bins, node2slot, n_slots, ref_len)


@functools.partial(jax.jit, donate_argnums=(0,))
def _fill_rows(buf, val, start):
    """In-place (donated) write of a batch block into a retention buffer -
    streaming keeps ONE preallocated array per per-read output instead of a
    list + concatenate, which would double peak memory at config-3 scale."""
    return jax.lax.dynamic_update_slice(
        buf, val, (start,) + (0,) * (buf.ndim - 1))


def cluster_round0_members(qm, rcm, bins_m, mvalid, counts, span_diff,
                           read_count, leaves, anc_path, depth,
                           cfg: PipelineConfig, node2slot=None,
                           spawn: bool = True):
    """Round-0 clustering + consensus from pre-gathered member tensors.

    The post-gather half of cluster_round0_core, shared by the single-device
    path (local gather) and the mesh cluster step (distributed masked-gather
    + psum over the sharded read retention; parallel.steps.make_cluster_step).
    qm/rcm: (NL, M, L) member query codes / projected columns (int32);
    bins_m: (NL, M) member bin nodes; mvalid: (NL, M). node2slot switches
    the pileup accumulators to slot-compacted active-node space
    (full-Greengenes-scale taxonomies; see pipeline.pileup) - bitwise
    identical where slots exist. Features come from the dense scatter+matmul
    featurizer (cluster.leaf_features_dense).

    spawn=False is the LIGHT path for leaves with no leaf-exclusive reads:
    their can_seed mask is all-false, so DP-means provably degenerates to
    assign-all-to-cluster-0 / kact=1 - skip features + DP entirely. Bitwise
    identical to spawn=True on such leaves (tests/test_scale_paths.py)."""
    from rambl_tpu.pipeline.pileup import leaf_pileup_slots

    ref_len = counts.shape[1] // 4   # counts rows are FLAT (node_pileup)
    if node2slot is None:
        leaf_counts, leaf_span = leaf_pileup(
            counts, span_diff, leaves, anc_path, depth, cfg.bin_share_depth)
        excl_counts = counts[leaves].reshape(-1, ref_len, 4)
    else:
        leaf_counts, leaf_span = leaf_pileup_slots(
            counts, span_diff, node2slot, leaves, anc_path, depth,
            cfg.bin_share_depth)
        ls = node2slot[leaves]
        excl_counts = jnp.where(
            (ls >= 0)[:, None, None],
            counts[jnp.clip(ls, 0, counts.shape[0] - 1)].reshape(
                -1, ref_len, 4), 0)
    # consensus mask is UNCAPPED (capping would crowd out late discriminating
    # columns); the feature columns below take the first max_poly_cols of it
    pm = polymorphic_mask(
        leaf_counts, cfg.min_coverage, cfg.poly_min_minor_count,
        cfg.poly_minor_frac_num, cfg.poly_minor_frac_den, ref_len,
    )
    if spawn:
        cols = jnp.arange(ref_len, dtype=jnp.int32)
        key = jnp.where(pm, cols[None, :], _BIG)
        pol_cols = -jax.lax.top_k(-key, cfg.max_poly_cols)[0]  # ascending
        pol_valid = pol_cols < _BIG
        pol_cols = jnp.where(pol_valid, pol_cols, 0)

        feat = leaf_features_dense(qm, rcm, mvalid, pol_cols, pol_valid,
                                   ref_len)
        can_seed = (bins_m == leaves[:, None]) & mvalid  # leaf-exclusive only
        dp = dp_means_leaves(feat, can_seed, cfg)
        assign, kact = dp.assign, dp.kact
    else:
        assign = jnp.zeros(mvalid.shape, jnp.int32)
        kact = jnp.ones((mvalid.shape[0],), jnp.int32)

    cons = cluster_consensus_leaves(
        qm, rcm, mvalid, assign, pm, leaf_counts, leaf_span, cfg
    )
    from rambl_tpu.pipeline.consensus import (
        _chain_read_count,
        minor_haplotype_leaves,
    )

    # node-space counts at the leaf itself = leaf-EXCLUSIVE pileup
    mh = minor_haplotype_leaves(excl_counts, leaf_counts, leaf_span, cfg)
    n_mem = _chain_read_count(read_count, leaves, anc_path, depth,
                              cfg.bin_share_depth)
    return cons, kact, n_mem, mh


def cluster_round0_core(query, ref_col, bins, counts, span_diff,
                        read_count, leaves, anc_path, depth,
                        cfg: PipelineConfig, node2slot=None,
                        spawn: bool = True, bin_ranges=None,
                        packed16=None):
    """Round-0 clustering + consensus over a set of leaves (no jit wrapper;
    the single-device entry - the mesh path gathers members distributedly in
    parallel.steps.make_cluster_step and joins at cluster_round0_members).

    bin_ranges: optional precomputed (order, node_start, node_end) from
    cluster.bin_sort - the driver hoists the 10M-read argsort out of the
    per-block loop)."""
    # range-based membership (O(NL*D*M), not O(NL*B)): bit-identical to the
    # dense member_table (tests/test_scale_paths.py); width capped at B so
    # small runs keep their dense-era shapes
    from rambl_tpu.pipeline.cluster import bin_sort, member_table_ranges

    if bin_ranges is None:
        order, nstart, nend = bin_sort(bins, anc_path.shape[0])
    else:
        order, nstart, nend = bin_ranges
    midx, mvalid = member_table_ranges(
        order, nstart, nend, leaves, anc_path, depth,
        min(cfg.max_bin_reads, bins.shape[0]), cfg.bin_share_depth)
    # member read tensors; ref_col may arrive int16 (streaming retention) -
    # widen only AFTER the member gather so the full-read-range array never
    # materializes in int32 (config-3: 10M reads x 128 cols)
    if packed16 is not None:
        # one int16 row gather instead of two (config.packed_member_gather):
        # p = (rc+1)*8+q, exact for rc in [-1, 4094], q in [0, 7]. Unpack
        # AFTER the gather where blocks are (NL, M, L); bitwise identical.
        pm = packed16[midx].astype(jnp.int32)            # (NL, M, L)
        qm = (pm % 8).astype(query.dtype)
        rcm = pm // 8 - 1
    else:
        qm = query[midx]                                 # (NL, M, L)
        rcm = ref_col[midx].astype(jnp.int32)
    return cluster_round0_members(
        qm, rcm, bins[midx], mvalid, counts, span_diff, read_count,
        leaves, anc_path, depth, cfg, node2slot=node2slot, spawn=spawn)


_cluster_consensus_round0 = functools.partial(
    jax.jit, static_argnames=("cfg", "spawn"))(cluster_round0_core)
_bin_sort_jit = functools.partial(
    jax.jit, static_argnames=("n_nodes",))(bin_sort)


@jax.jit
def _pack_retention(query, ref_col):
    """(query int8, ref_col int16) -> packed int16, (rc+1)*8+q (see
    config.packed_member_gather). One elementwise pass, hoisted per round."""
    return ((ref_col.astype(jnp.int32) + 1) * 8
            + query.astype(jnp.int32)).astype(jnp.int16)




# --------------------------------------------------------------------------
# host driver
# --------------------------------------------------------------------------

def _pad_batches(reads, lens, batch):
    B = reads.shape[0]
    nb = -(-B // batch)
    pad = nb * batch - B
    if pad:
        reads = np.concatenate([reads, np.full((pad, reads.shape[1]), 4, np.int8)])
        lens = np.concatenate([lens, np.zeros((pad,), np.int32)])
    return reads, lens, nb, B


def align_step_inputs(index, ref_seqs, ref_lens, tables, col_maps=None):
    """Device-resident arguments of _align_bin_batch after the (reads, lens)
    batch: (bucket_start, entries, ref_seqs, ref_taxon, anc_path, depth,
    col_map), with the entry rows padded as every stream pads them."""
    from rambl_tpu.index.colmap import build_col_maps

    t_prep = time.time()
    table = SeedTable.from_index(index)
    # pad the entry chunk rows to a bucket multiple: pad rows (all -1) sit
    # beyond every CSR bucket range and are never scanned, so rounds with
    # drifting index sizes share one compiled executable
    nr = table.entries.shape[0]
    nr_pad = max(4096 // 32, -(-nr // 2048) * 2048)
    if nr_pad != nr:
        pad = jnp.full((nr_pad - nr, 128), -1, jnp.int32)
        table = table._replace(entries=jnp.concatenate([table.entries, pad]))
    ref_seqs_d = jnp.asarray(ref_seqs)
    anc = jnp.asarray(tables.anc_path)
    dep = jnp.asarray(tables.depth)
    rt = jnp.asarray(tables.ref_taxon)
    if _STAGE_TIMING:
        jax.block_until_ready(table.entries)
        print(f"[stage] align_prep_table +{time.time() - t_prep:.0f}s",
              file=sys.stderr, flush=True)
        t_prep = time.time()
    col_map = jnp.asarray(
        col_maps if col_maps is not None else build_col_maps(
            np.asarray(ref_seqs), np.asarray(ref_lens),
            np.asarray(tables.ref_taxon)))
    if _STAGE_TIMING:
        jax.block_until_ready(col_map)
        print(f"[stage] align_prep_colmap +{time.time() - t_prep:.0f}s",
              file=sys.stderr, flush=True)
    return (table.bucket_start, table.entries, ref_seqs_d, rt, anc, dep,
            col_map)


def _stream_align(reads, lens, index, ref_seqs, ref_lens, tables, cfg,
                  mesh=None, col_maps=None):
    """Batch-stream the jitted align+bin step; accumulate node pileups.

    Returns device arrays (query, projected ref_col, bins, score, ref,
    strand) for the real reads plus device pileup accumulators.

    With `mesh` the stream runs under shard_map: reads shard over 'data',
    the seed table is replicated (or bucket-range ring-sharded when
    cfg.shard_index), and the pileup accumulators are psum-merged ONCE at
    the end of the stream - bit-identical to the single-device path
    (integer scatter-adds commute; tests/test_distributed.py).
    """
    if cfg.sw_rows and int(np.max(lens, initial=0)) > cfg.sw_rows:
        from rambl_tpu.utils.errors import UserError

        raise UserError(
            f"cfg.sw_rows={cfg.sw_rows} < longest read "
            f"{int(np.max(lens))}: the truncated SW wavefront is only exact "
            "when every real read fits (ops/sw_pallas.py)")
    if mesh is not None:
        return _stream_align_mesh(
            reads, lens, index, ref_seqs, ref_lens, tables, cfg, mesh,
            col_maps=col_maps)
    step_args = align_step_inputs(index, ref_seqs, ref_lens, tables,
                                  col_maps)
    n_nodes = tables.n_nodes
    ref_len = ref_seqs.shape[1]

    padded, plens, nb, B = _pad_batches(reads, lens, cfg.batch_size)
    dense = n_nodes <= cfg.pileup_slot_nodes
    if dense:
        counts = jnp.zeros((n_nodes, ref_len * 4), jnp.int32)
        span_diff = jnp.zeros((n_nodes, ref_len + 1), jnp.int32)
    else:
        # slot-compacted mode: the dense accumulators are never allocated;
        # the caller scatters into active-node slots after this pass
        counts = span_diff = None
    read_count = jnp.zeros((n_nodes,), jnp.int32)

    # per-read outputs stay ON DEVICE (no per-batch host fetch - the host
    # round trip would serialize the stream); downstream clustering consumes
    # them on device, only `bins` is fetched once for gene bookkeeping.
    # PP stage pipelining (SURVEY.md section 2.3): batch i+1's H2D transfer
    # is issued (async device_put) while batch i's align executes, so the
    # PCIe copy never sits between dispatches
    def _put(i):
        sl = slice(i * cfg.batch_size, (i + 1) * cfg.batch_size)
        return jax.device_put(padded[sl]), jax.device_put(plens[sl])

    # retention buffers, filled IN PLACE (donated dynamic_update_slice): a
    # list + concatenate would double peak memory at config-3 scale (10M
    # reads). ref_col is retained as int16 - projected anchor columns are
    # < ref_len_max <= 32767 so the round-trip is exact; consumers widen
    # inside their jits (node_pileup / cluster_round0_core).
    BT = nb * cfg.batch_size
    L = padded.shape[1]
    compact = ref_len <= 32767
    bufs = {
        "query": jnp.zeros((BT, L), jnp.int8),
        "ref_col": jnp.zeros((BT, L), jnp.int16 if compact else jnp.int32),
        "bins": jnp.zeros((BT,), jnp.int32),
        "score": jnp.zeros((BT,), jnp.int32),
        "ref": jnp.zeros((BT,), jnp.int32),
        "strand": jnp.zeros((BT,), jnp.int8),
    }
    nxt = _put(0)
    for i in range(nb):
        cur, nxt = nxt, (_put(i + 1) if i + 1 < nb else None)
        q, rc, b, sc, rf, st = _align_bin_batch(
            cur[0], cur[1], *step_args, cfg, index.n_bits)
        if dense:
            counts, span_diff, read_count = _pileup_accum(
                q, rc, b, counts, span_diff, read_count, cfg, n_nodes, ref_len
            )
        else:
            read_count = _read_count_accum(b, read_count, n_nodes)
        if compact:
            rc = rc.astype(jnp.int16)
        for k, v in zip(("query", "ref_col", "bins", "score", "ref", "strand"),
                        (q, rc, b, sc, rf, st)):
            bufs[k] = _fill_rows(bufs[k], v, i * cfg.batch_size)
    merged = {k: (v if BT == B else v[:B]) for k, v in bufs.items()}
    return merged, counts, span_diff, read_count


def _pad_entry_rows(ent, bucket=65536):
    """Pad packed entry CHUNK ROWS (ops.seed.pack_entries (rows, 128)
    layout; all -1 = inert, pad keys never match) to a bucket-of-entries
    multiple along the row axis so rounds with drifting index sizes share
    one executable."""
    from rambl_tpu.ops.seed import _ENTRIES_PER_ROW

    rb = max(1, bucket // _ENTRIES_PER_ROW)
    nr = ent.shape[-2]
    target = max(4096 // _ENTRIES_PER_ROW, -(-nr // rb) * rb)
    if target == nr:
        return ent
    pad_shape = ent.shape[:-2] + (target - nr, 128)
    return np.concatenate(
        [np.asarray(ent), np.full(pad_shape, -1, np.int32)], axis=-2)


def _stream_align_mesh(reads, lens, index, ref_seqs, ref_lens, tables, cfg,
                       mesh, col_maps=None):
    """shard_map variant of _stream_align (see its docstring).

    Scale-shaped retention (VERDICT r2 #4): query/ref_col/bins are retained
    as (nb, batch, ...) buffers SHARDED P(None, 'data', ...) and written in
    place by a donated fill step - each device permanently holds ~B/N read
    rows and the full per-read tensors never replicate (a list +
    concatenate + put_replicated path would hold every read's int32 ref_col
    on every device). ref_col narrows to int16 when the coordinate range
    fits, exactly as the single-device stream. The node-space pileup merge
    is ONE psum after the whole stream (BASELINE.json:5) instead of one per
    batch; with cfg.shard_positions it rides psum_scatter and each device
    keeps 1/N of the columns (BASELINE config 5).

    Returns merged = {"query", "ref_col": (nb, bs, L) sharded retention,
    "bins_sh": (nb, bs) sharded, "bins"/"score"/"ref"/"strand": (B,)
    replicated small vectors}; plus the merged pileup accumulators."""
    from rambl_tpu.index.colmap import build_col_maps
    from rambl_tpu.parallel.mesh import put_replicated, put_sharded
    from rambl_tpu.parallel.ring import build_ring_shards
    from rambl_tpu.parallel.steps import (
        RETAIN2,
        RETAIN3,
        make_align_bin_step,
        make_pileup_merge_step,
        make_read_count_step,
        make_retain_step,
    )

    n_dev = mesh.devices.size
    if cfg.batch_size % n_dev != 0:
        from rambl_tpu.utils.errors import UserError

        raise UserError(
            f"batch_size {cfg.batch_size} must divide the {n_dev}-device mesh")

    if cfg.shard_index:
        shards = build_ring_shards(index, n_dev)
        targs = (
            put_sharded(shards["bucket_start"], mesh),
            put_sharded(_pad_entry_rows(shards["entries"], 8192), mesh),
        )
    else:
        ent = _pad_entry_rows(pack_entries_np(index))
        targs = (
            put_replicated(np.asarray(index.bucket_start), mesh),
            put_replicated(ent, mesh),
        )
    col_map = (col_maps if col_maps is not None else build_col_maps(
        np.asarray(ref_seqs), np.asarray(ref_lens),
        np.asarray(tables.ref_taxon)))
    repl = [put_replicated(np.asarray(x), mesh) for x in (
        ref_seqs, tables.ref_taxon, tables.anc_path, tables.depth, col_map)]

    n_nodes = tables.n_nodes
    ref_len = ref_seqs.shape[1]
    padded, plens, nb, B = _pad_batches(reads, lens, cfg.batch_size)
    bs = cfg.batch_size
    L = padded.shape[1]
    step = make_align_bin_step(mesh, cfg, index.n_bits, ring=cfg.shard_index)

    def _put(i):
        sl = slice(i * bs, (i + 1) * bs)
        return put_sharded(padded[sl], mesh), put_sharded(plens[sl], mesh)

    from jax.sharding import NamedSharding

    sh3 = NamedSharding(mesh, RETAIN3)
    sh2 = NamedSharding(mesh, RETAIN2)
    compact = ref_len <= 32767
    qbuf = jax.device_put(jnp.zeros((nb, bs, L), jnp.int8), sh3)
    rbuf = jax.device_put(
        jnp.zeros((nb, bs, L), jnp.int16 if compact else jnp.int32), sh3)
    bbuf = jax.device_put(jnp.zeros((nb, bs), jnp.int32), sh2)
    fill = make_retain_step(mesh)

    small = {k: [] for k in ("bins", "score", "ref", "strand")}
    nxt = _put(0)
    for i in range(nb):
        cur, nxt = nxt, (_put(i + 1) if i + 1 < nb else None)
        q, rc, b, sc, rf, st = step(cur[0], cur[1], *targs, *repl)
        qbuf, rbuf, bbuf = fill(qbuf, rbuf, bbuf, q, rc, b, jnp.int32(i))
        for k, v in zip(("bins", "score", "ref", "strand"), (b, sc, rf, st)):
            small[k].append(v)

    dense = n_nodes <= cfg.pileup_slot_nodes
    if dense:
        pstep = make_pileup_merge_step(
            mesh, n_nodes, ref_len, shard_positions=cfg.shard_positions)
        counts, span_diff, read_count = pstep(qbuf, rbuf, bbuf)
        if cfg.shard_positions:
            # width contract (steps.make_pileup_merge_step): pad columns are
            # always zero; consumers want (n_nodes, ref_len + 1). The odd
            # width no longer divides the mesh, so replicate first (span_diff
            # is the small diff vector, n_nodes x ref_len+1 int32; `counts`
            # stays column-sharded until its consumer gathers it).
            from jax.sharding import NamedSharding, PartitionSpec

            span_diff = jax.device_put(
                span_diff, NamedSharding(mesh, PartitionSpec()))
            span_diff = span_diff[:, : ref_len + 1]
    else:
        counts = span_diff = None
        read_count = make_read_count_step(mesh, n_nodes)(bbuf)

    # the small (B,) per-read vectors replicate (host bookkeeping + the
    # replicated-bins member index rule in the cluster step); pad rows trim
    cat = {k: (jnp.concatenate(v) if nb > 1 else v[0])
           for k, v in small.items()}
    merged = {k: put_replicated(v, mesh)[:B] for k, v in cat.items()}
    merged["query"] = qbuf
    merged["ref_col"] = rbuf
    merged["bins_sh"] = bbuf
    return merged, counts, span_diff, read_count


def pack_entries_np(index):
    """Packed (rows, 128) int32 entry chunk rows from a SeedIndex (host
    side; ops.seed.pack_entries layout)."""
    from rambl_tpu.ops.seed import pack_entries

    return pack_entries(index.entry_key, index.entry_ref, index.entry_pos)


def _genes_from_consensus(called, emit, nk, kact, leaves, n_mem, cfg,
                          round_idx, orig_taxon_of_node=None, mh=None):
    """Host compaction of consensus tensors into Gene records (oracle order).

    mh: optional MinorHap tensors (already host-fetched, leaf-sliced) - one
    extra frequency-phased gene per qualifying leaf, cluster id
    cfg.max_clusters_per_bin (after all real clusters, as in the oracle)."""
    genes: List[Gene] = []
    called = np.asarray(called)
    emit = np.asarray(emit)
    nk = np.asarray(nk)
    kact = np.asarray(kact)
    n_mem = np.asarray(n_mem)
    for li, leaf in enumerate(np.asarray(leaves).tolist()):
        if n_mem[li] < cfg.min_cluster_reads:
            continue
        taxon = (int(leaf) if orig_taxon_of_node is None
                 else int(orig_taxon_of_node[leaf]))
        for k in range(int(kact[li])):
            if nk[li, k] < cfg.min_cluster_reads:
                continue
            em = emit[li, k]
            seq = called[li, k][em].astype(np.int8)
            if seq.shape[0] == 0:
                continue
            off = int(np.argmax(em))  # first emitted column
            genes.append(Gene(seq=seq, n_reads=int(nk[li, k]), leaf=int(leaf),
                              cluster=k, round_born=round_idx, taxon=taxon,
                              offset=off))
        # max(1, ...) mirrors the oracle's guard: minorhap_min_cols == 0 with
        # zero qualifying columns must not emit a bogus backbone-duplicate gene
        if mh is not None and int(mh.n_cols[li]) >= max(1, cfg.minorhap_min_cols):
            em = np.asarray(mh.emit[li])
            seq = np.asarray(mh.called[li])[em].astype(np.int8)
            nk_mh = int(mh.n_reads[li])
            if seq.shape[0] and nk_mh >= cfg.min_cluster_reads:
                genes.append(Gene(
                    seq=seq, n_reads=nk_mh, leaf=int(leaf),
                    cluster=cfg.max_clusters_per_bin, round_born=round_idx,
                    taxon=taxon, offset=int(np.argmax(em))))
    return genes


def _dedupe_cap(genes: List[Gene], cfg) -> List[Gene]:
    bykey = {}
    for g in genes:
        kk = g.key()
        if kk not in bykey or g.n_reads > bykey[kk].n_reads:
            if kk in bykey:
                g = dataclasses.replace(g, n_reads=max(g.n_reads, bykey[kk].n_reads))
            bykey[kk] = g
    out = list(bykey.values())
    out.sort(key=lambda g: (-g.n_reads, g.leaf, g.cluster))
    return out[: cfg.max_genes]


def assemble_round_jax(reads, lens, ref_seqs, ref_lens, tables, cfg,
                       round_idx=0, orig_taxon_of_node=None, index=None,
                       n_bits=None, aux_out=None, mesh=None, col_maps=None):
    """Device version of oracle.pipeline.assemble_round.

    `index` lets cohort runs share one prebuilt Greengenes index across
    samples (BASELINE.json config 4); `n_bits` pins the hash-table geometry
    so successive rounds reuse one compiled align executable. `aux_out`, if a
    dict, receives the node-space pileup accumulator ("node_counts") for the
    final polish pass (see polish_jax). `mesh` runs the whole round under
    shard_map (align/pileup data-parallel, clustering leaf-sharded),
    bit-identical to the single-device path.
    """
    clock = _StageClock()
    if index is None:
        index = build_seed_index(ref_seqs, ref_lens, k=cfg.k, n_bits=n_bits)
    clock.mark("index")
    rec, counts, span_diff, read_count = _stream_align(
        reads, lens, index, ref_seqs, ref_lens, tables, cfg, mesh=mesh,
        col_maps=col_maps,
    )
    clock.mark("align", rec["query"], counts, read_count)
    node2slot_d = None
    if counts is None:
        # slot-compacted active-node mode (n_nodes > cfg.pileup_slot_nodes):
        # active leaves chosen by chain read count, slots for nodes on their
        # ancestor chains that hold reads; one scatter pass builds the
        # compacted accumulators. Inactive leaves produce no genes in the
        # dense path either (n_mem < min_cluster_reads), so outputs match.
        rc_host = np.asarray(read_count)
        anc = tables.anc_path
        leaves_all = np.unique(tables.ref_taxon)
        dd = np.arange(anc.shape[1])
        dl = tables.depth[leaves_all][:, None]
        usem = (dd[None, :] <= dl) & (dd[None, :] >= dl - cfg.bin_share_depth)
        n_mem_leaf = (rc_host[anc[leaves_all]] * usem).sum(axis=1)
        leaves = leaves_all[n_mem_leaf >= cfg.min_cluster_reads]
        # Collapse ZERO-EXCLUSIVE duplicate leaves (config 3: 8533 active
        # leaves for 500 present refs).
        # A leaf with no reads binned AT it draws members and pileups solely
        # from its ancestor-window nodes; leaves sharing that exact node set
        # (and depth) are bitwise-identical clustering problems with
        # can_seed all-false, so they emit byte-identical genes that
        # _dedupe_cap collapses to the LOWEST leaf id anyway. Keep only that
        # representative: output-identical (dedupe keeps first-by-leaf on
        # ties; np.unique gives ascending ids), ~NL/4 of the cluster work.
        excl0 = rc_host[leaves] == 0
        if excl0.any():
            dlv0 = tables.depth[leaves][:, None]
            win0 = (dd[None, :] <= dlv0) & (dd[None, :] >= dlv0
                                            - cfg.bin_share_depth)
            ch0 = anc[leaves]
            sig = np.where(win0 & (rc_host[ch0] > 0), ch0, -1)
            sig = np.concatenate([np.sort(sig, axis=1),
                                  tables.depth[leaves][:, None]], axis=1)
            _, first_idx = np.unique(sig[excl0], axis=0, return_index=True)
            keep = ~excl0
            keep[np.nonzero(excl0)[0][first_idx]] = True
            leaves = leaves[keep]
        stats0 = dict(round=round_idx,
                      aligned=int((np.asarray(rec["bins"]) >= 0).sum()),
                      n_leaves=int(leaves.size), genes=0)
        if leaves.size == 0:
            return [], stats0
        # slots for every chain node inside the share window with any reads
        dlv = tables.depth[leaves][:, None]
        win = (dd[None, :] <= dlv) & (dd[None, :] >= dlv - cfg.bin_share_depth)
        need = np.zeros(tables.n_nodes, bool)
        chain_nodes = anc[leaves]
        need[chain_nodes[win]] = True
        need &= rc_host > 0
        ids = np.nonzero(need)[0].astype(np.int32)
        node2slot = np.full(tables.n_nodes, -1, np.int32)
        node2slot[ids] = np.arange(ids.size, dtype=np.int32)
        n_slots = max(64, -(-max(ids.size, 1) // 64) * 64)
        node2slot_d = jnp.asarray(node2slot)
        if mesh is not None:
            from rambl_tpu.parallel.mesh import put_replicated
            from rambl_tpu.parallel.steps import make_slot_pileup_step

            counts, span_diff = make_slot_pileup_step(
                mesh, n_slots, ref_seqs.shape[1])(
                    rec["query"], rec["ref_col"], rec["bins_sh"],
                    put_replicated(node2slot, mesh))
        else:
            counts, span_diff = _slot_pileup(
                jnp.asarray(rec["query"]), jnp.asarray(rec["ref_col"]),
                jnp.asarray(rec["bins"]), node2slot_d, n_slots,
                ref_seqs.shape[1])
        if aux_out is not None:
            aux_out["slot_counts"] = (counts, node2slot)
        clock.mark("slot_pileup", counts)
    else:
        leaves = np.unique(tables.ref_taxon)
        if aux_out is not None:
            aux_out["node_counts"] = counts
    # pad the leaf list to a bucket size so successive rounds (whose leaf
    # counts drift) reuse one compiled executable; duplicate pad leaves
    # produce byte-identical genes that dedupe away. On a mesh the bucket
    # also divides the device count (leaf-sharded EP cluster step).
    # cfg.cluster_leaf_block bounds the per-call leaf count: the per-leaf
    # member tensors are (NL, max_bin_reads, ...) and at full-DB scale NL
    # can reach thousands - leaves are independent, so blocking is
    # bitwise-neutral; every block pads to one shared bucket size.
    NL = leaves.size
    m = 8 if mesh is None else int(np.lcm(8, mesh.devices.size))
    blk = cfg.cluster_leaf_block if cfg.cluster_leaf_block > 0 else NL
    blk = max(m, -(-blk // m) * m)
    bucket = min(blk, max(m, -(-NL // m) * m))

    def _cluster_block(lb, spawn):
        lp = np.concatenate([lb, np.full(bucket - lb.size, lb[0],
                                         leaves.dtype)])
        if mesh is not None:
            from rambl_tpu.parallel.mesh import put_replicated
            from rambl_tpu.parallel.steps import make_cluster_step

            cstep = make_cluster_step(mesh, cfg,
                                      slots=node2slot_d is not None,
                                      spawn=spawn)
            cargs = [
                rec["query"], rec["ref_col"],        # sharded retention
                jnp.asarray(rec["bins"]), counts, span_diff, read_count,
                put_replicated(lp, mesh),            # leaves: replicated,
                                                     # sliced per device in
                                                     # the step (EP shard)
                put_replicated(tables.anc_path, mesh),
                put_replicated(tables.depth, mesh),
            ]
            if node2slot_d is not None:
                cargs.append(node2slot_d)
            return cstep(*cargs)
        return _cluster_consensus_round0(
            jnp.asarray(rec["query"]), jnp.asarray(rec["ref_col"]),
            jnp.asarray(rec["bins"]), counts, span_diff, read_count,
            jnp.asarray(lp), jnp.asarray(tables.anc_path),
            jnp.asarray(tables.depth), cfg, node2slot_d, spawn=spawn,
            bin_ranges=bin_ranges, packed16=packed16,
        )

    # SPLIT by exclusivity: leaves with no reads binned AT them have an
    # all-false can_seed mask, so DP-means provably assigns everything to
    # cluster 0 - they run the LIGHT path (no member sort, no features, no
    # DP; spawn=False), bitwise identical (cluster_round0_members docstring).
    # Results are re-merged into ascending leaf order below, so gene order
    # (and dedupe tie-breaking) is unchanged.
    rc_leaf = np.asarray(read_count)[leaves]
    sets = [(leaves[rc_leaf > 0], True), (leaves[rc_leaf == 0], False)]
    # hoist the B-read argsort out of the block loop
    bin_ranges = (None if mesh is not None else
                  _bin_sort_jit(jnp.asarray(rec["bins"]), tables.n_nodes))
    # hoist the packed member-gather retention (one int16 gather per block
    # instead of int8+int16; config.packed_member_gather). Engaged only
    # when the extra (B, L) int16 buffer fits and the pack is exact.
    packed16 = None
    if (mesh is None and cfg.packed_member_gather
            and rec["query"].shape[0] <= cfg.packed_member_gather_max_reads
            and cfg.ref_len_max <= 4094):
        packed16 = _pack_retention(jnp.asarray(rec["query"]),
                                   jnp.asarray(rec["ref_col"]))
    parts = []
    proc_leaves = []
    for lset, spawn in sets:
        for s in range(0, lset.size, blk):
            lb = lset[s: s + blk]
            cons_b, kact_b, n_mem_b, mh_b = _cluster_block(lb, spawn)
            n = lb.size
            proc_leaves.append(lb)
            parts.append((
                [np.asarray(x)[:n] for x in cons_b],
                np.asarray(kact_b)[:n], np.asarray(n_mem_b)[:n],
                [np.asarray(x)[:n] for x in mh_b],
            ))
    clock.mark("cluster")
    from rambl_tpu.pipeline.consensus import ConsensusOut, MinorHap

    leaves_proc = np.concatenate(proc_leaves) if proc_leaves else leaves
    order = np.argsort(leaves_proc, kind="stable")   # restore ascending ids
    cons = ConsensusOut(*(np.concatenate([p[0][i] for p in parts])[order]
                          for i in range(3)))
    kact = np.concatenate([p[1] for p in parts])[order]
    n_mem = np.concatenate([p[2] for p in parts])[order]
    mh = MinorHap(*(np.concatenate([p[3][i] for p in parts])[order]
                    for i in range(4)))
    genes = _genes_from_consensus(
        cons.called, cons.emit, cons.n_reads, kact, leaves_proc[order],
        n_mem, cfg, round_idx, orig_taxon_of_node, mh=mh,
    )
    stats = dict(
        round=round_idx,
        aligned=int((rec["bins"] >= 0).sum()),
        n_leaves=int(leaves.size),
        genes=0,
    )
    genes = _dedupe_cap(genes, cfg)
    stats["genes"] = len(genes)
    clock.mark("genes_host")
    clock.into(stats)
    return genes, stats


def _pad_panel_bucket(pseqs, plens, ptab, cfg):
    """Pad a panel to a gene-count bucket (shared compiled executables across
    rounds; pad refs are all-N and inert). Returns (pseqs, plens, ptab, G)."""
    G = pseqs.shape[0]
    gb = max(32, -(-G // 32) * 32)
    if gb != G:
        pseqs = np.concatenate(
            [pseqs, np.full((gb - G, pseqs.shape[1]), 4, np.int8)])
        plens = np.concatenate([plens, np.zeros(gb - G, np.int32)])
        ptab = TaxonomyTables(
            anc_path=ptab.anc_path, depth=ptab.depth,
            ref_taxon=np.concatenate(
                [ptab.ref_taxon, np.full(gb - G, ptab.ref_taxon[0], np.int32)]),
            n_nodes=ptab.n_nodes,
        )
    return pseqs, plens, ptab, G


def _panel_bits(cfg):
    return max(8, int(np.ceil(np.log2(2 * cfg.max_genes * cfg.ref_len_max + 1))))


def leaf_counts_dict(reads, lens, ref_seqs, ref_lens, tables,
                     cfg: PipelineConfig, taxa, node_counts=None,
                     slot_counts=None, shared_index=None, mesh=None,
                     col_maps=None):
    """{taxon: (ref_len, 4) np.int32} leaf-EXCLUSIVE round-0 pileups for the
    given taxa (oracle.polish.leaf_exclusive_counts semantics). The node-space
    accumulator built during the discovery round IS the per-leaf exclusive
    pileup (reads scatter at their exact bin node; ancestor chaining only
    happens later), so when the caller retained it (dense `node_counts` or
    slot-compacted `slot_counts`) no extra device work is needed; otherwise
    one align stream vs the original index recomputes it bit-identically.
    Shared by the polish pass and cohort covariation phasing."""
    ref_len = ref_seqs.shape[1]
    taxa = np.unique(np.asarray(taxa)).astype(np.int64)
    if node_counts is None and slot_counts is None:
        index = shared_index if shared_index is not None else build_seed_index(
            ref_seqs, ref_lens, k=cfg.k)
        rec, counts, _, read_count = _stream_align(
            reads, lens, index, ref_seqs, ref_lens, tables, cfg, mesh=mesh,
            col_maps=col_maps)
        if counts is not None:
            node_counts = np.asarray(counts)
        else:
            # slot-mode recompute: only the requested taxa need counts
            rc_host = np.asarray(read_count)
            ids = taxa[rc_host[taxa] > 0].astype(np.int32)
            node2slot = np.full(tables.n_nodes, -1, np.int32)
            node2slot[ids] = np.arange(ids.size, dtype=np.int32)
            n_slots = max(64, -(-max(ids.size, 1) // 64) * 64)
            if mesh is not None:
                from rambl_tpu.parallel.mesh import put_replicated
                from rambl_tpu.parallel.steps import make_slot_pileup_step

                counts_s, _ = make_slot_pileup_step(mesh, n_slots, ref_len)(
                    rec["query"], rec["ref_col"], rec["bins_sh"],
                    put_replicated(node2slot, mesh))
            else:
                counts_s, _ = _slot_pileup(
                    jnp.asarray(rec["query"]), jnp.asarray(rec["ref_col"]),
                    jnp.asarray(rec["bins"]), jnp.asarray(node2slot), n_slots,
                    ref_len)
            slot_counts = (counts_s, node2slot)
    if node_counts is not None:
        node_counts = np.asarray(node_counts)
        if node_counts.ndim == 2:    # flat node_pileup rows -> host 3D view
            node_counts = node_counts.reshape(-1, ref_len, 4)
        return {int(l): node_counts[int(l)] for l in taxa}
    counts_s, node2slot = slot_counts
    counts_s = np.asarray(counts_s)
    if counts_s.ndim == 2:           # flat node_pileup rows -> host 3D view
        counts_s = counts_s.reshape(-1, ref_len, 4)
    zeros = np.zeros((ref_len, 4), np.int32)
    return {
        int(l): (counts_s[node2slot[int(l)]]
                 if node2slot[int(l)] >= 0 else zeros)
        for l in taxa
    }


def polish_jax(reads, lens, genes, ref_seqs, ref_lens, tables,
               cfg: PipelineConfig, node_counts=None, slot_counts=None,
               shared_index=None, mesh=None, col_maps=None):
    """Device polish pass (see oracle.polish): leaf-exclusive re-vote of the
    final panel from round-0 node pileups (evidence via leaf_counts_dict).
    Returns (genes, n_changed)."""
    from rambl_tpu.oracle.polish import anchor_seqs_of, apply_polish

    if not genes:
        return genes, 0
    # retained dense accumulators cover every leaf; slot/recompute paths only
    # need the gene taxa (apply_polish looks up nothing else)
    taxa = (np.unique(tables.ref_taxon) if node_counts is not None
            else np.unique([g.taxon for g in genes]))
    counts_dict = leaf_counts_dict(
        reads, lens, ref_seqs, ref_lens, tables, cfg, taxa=taxa,
        node_counts=node_counts, slot_counts=slot_counts,
        shared_index=shared_index, mesh=mesh, col_maps=col_maps)
    anchor = anchor_seqs_of(ref_seqs, ref_lens, tables.ref_taxon)
    return apply_polish(genes, counts_dict, anchor, cfg)


def assemble_cohort(samples, ref_seqs, ref_lens, tables: TaxonomyTables,
                    cfg: PipelineConfig, mesh=None, col_maps=None):
    """Multi-sample cohort assembly with a SHARED reference index
    (BASELINE.json config 4: 'multi-sample cohort with shared sharded index').

    samples: list of (reads, lens). The round-0 Greengenes index is built once
    and reused; each sample runs its own refinement loop (panel indexes are
    per-sample); finally CROSS-SAMPLE ABUNDANCE-COVARIATION PHASING
    (oracle/cohort.py) separates co-binned strains that no single sample can:
    per-leaf variant columns cluster by their per-sample minor-allele
    frequency vectors (exact chi-square DP-means) and each column group emits
    a strain gene. The phasing consumes the same leaf-exclusive round-0
    pileups the polish pass uses, retained from each sample's discovery round
    (or recomputed bit-identically), so the device path shares the oracle's
    host logic verbatim. Returns one AssemblyResult per sample.
    """
    from rambl_tpu.oracle.cohort import cohort_phase
    from rambl_tpu.oracle.polish import anchor_seqs_of

    shared_index = build_seed_index(ref_seqs, ref_lens, k=cfg.k)
    do_phase = cfg.cohort_phase and len(samples) >= 2
    results, retained = [], []
    for reads, lens in samples:
        aux = {} if do_phase else None
        results.append(assemble_jax(
            reads, lens, ref_seqs, ref_lens, tables, cfg,
            shared_index=shared_index, mesh=mesh, aux_out=aux,
            col_maps=col_maps))
        if do_phase:
            # host-fetch the retained accumulators now so device buffers
            # do not pile up across samples
            retained.append(dict(
                node_counts=(None if aux.get("node_counts") is None
                             else np.asarray(aux["node_counts"])),
                slot_counts=(None if aux.get("slot_counts") is None
                             else (np.asarray(aux["slot_counts"][0]),
                                   aux["slot_counts"][1])),
            ))
    if not do_phase:
        return results
    taxa = np.unique(np.asarray(
        [g.taxon for r in results for g in r.genes], dtype=np.int64))
    if taxa.size == 0:
        return results
    counts_list = [
        leaf_counts_dict(reads, lens, ref_seqs, ref_lens, tables, cfg,
                         taxa=taxa, shared_index=shared_index, mesh=mesh,
                         col_maps=col_maps, **retained[j])
        for j, (reads, lens) in enumerate(samples)
    ]
    anchor = anchor_seqs_of(ref_seqs, ref_lens, tables.ref_taxon)
    geneses = cohort_phase([r.genes for r in results], counts_list, anchor, cfg)
    return [dataclasses.replace(r, genes=g)
            for r, g in zip(results, geneses)]


def assemble_jax(reads, lens, ref_seqs, ref_lens, tables: TaxonomyTables,
                 cfg: PipelineConfig, shared_index=None, initial_panel=None,
                 mesh=None, checkpoint_path=None, aux_out=None,
                 col_maps=None, initial_aux=None):
    """Device version of oracle.pipeline.assemble (same convergence loop:
    every round is a full discovery round; the panel maps genes back to
    their provenance taxa - see oracle.pipeline.panel_tables).

    initial_panel resumes from a checkpointed panel (discovery skipped).
    mesh runs every stage (align/pileup/cluster/polish) under shard_map over
    the 'data' axis - the product-level multi-device path, bitwise equal to
    single-device (tests/test_distributed.py).
    checkpoint_path, if given, atomically saves the loop panel after EVERY
    round (fault tolerance, SURVEY.md section 5: a crash/kill anywhere
    leaves the last round boundary on disk; deterministic rounds make the
    resumed continuation bitwise - tests/test_faults.py).
    aux_out, if a dict, receives the retained round-0 pileup accumulators
    ("node_counts" dense or "slot_counts") for callers that need the
    leaf-exclusive evidence again (cohort covariation phasing); empty on
    resumed runs (the discovery round was skipped) unless initial_aux
    restores them.
    initial_aux: round-0 evidence restored from the checkpoint sidecar
    (utils.checkpoint.load_aux_evidence) - a resumed run's polish then skips
    the round-0 re-stream, bitwise unchanged (tests/test_faults.py)."""
    from rambl_tpu.oracle.pipeline import (
        AssemblyResult,
        pad_panel,
        panel_tables,
    )

    from rambl_tpu.utils.checkpoint import save_checkpoint

    def _ckpt(genes, round_idx, stats):
        if checkpoint_path:
            save_checkpoint(checkpoint_path, cfg, genes, round_idx, stats)

    round_stats = []
    aux = {} if (cfg.polish or aux_out is not None) else None
    if initial_panel is None:
        genes, stats = assemble_round_jax(
            reads, lens, ref_seqs, ref_lens, tables, cfg, round_idx=0,
            index=shared_index, aux_out=aux, mesh=mesh, col_maps=col_maps,
        )
        round_stats.append(stats)
        _ckpt(genes, 0, round_stats)
        if checkpoint_path and aux:
            from rambl_tpu.utils.checkpoint import save_aux_evidence

            save_aux_evidence(checkpoint_path + ".aux", cfg, aux)
    else:
        genes = list(initial_panel)
        # resumed: reuse checkpointed round-0 evidence when provided, else
        # polish re-streams round 0 bit-identically
        aux = dict(initial_aux) if initial_aux else None
        round_stats.append(dict(round=0, resumed=True, genes=len(genes),
                                aux_restored=bool(initial_aux)))
    seen = {tuple(sorted(g.key() for g in genes))}
    converged = False
    for it in range(1, cfg.max_assembly_iters):
        if not genes:
            break
        # pad the panel ref count to a bucket so every round's align step
        # reuses one compiled executable (pad refs are all-N: no k-mers, no
        # candidates, no reads - outputs are unchanged); fixed hash geometry
        # for all panel rounds (one align compile)
        pseqs, plens, ptab, _ = _pad_panel_bucket(
            *pad_panel(genes, ref_seqs.shape[1]), panel_tables(genes, tables),
            cfg)
        genes, stats = assemble_round_jax(
            reads, lens, pseqs, plens, ptab, cfg, round_idx=it,
            n_bits=_panel_bits(cfg), mesh=mesh,
        )
        round_stats.append(stats)
        _ckpt(genes, it, round_stats)
        new_key = tuple(sorted(g.key() for g in genes))
        # fixpoint OR cycle (deterministic rounds): stop on any repeat
        if new_key in seen:
            converged = True
            break
        seen.add(new_key)
    n_rounds = len(round_stats)
    panel = list(genes)
    if aux_out is not None and aux:
        aux_out.update(aux)
    if cfg.polish and genes:
        t_pol = time.time()
        genes, n_changed = polish_jax(
            reads, lens, genes, ref_seqs, ref_lens, tables, cfg,
            node_counts=(aux or {}).get("node_counts"),
            slot_counts=(aux or {}).get("slot_counts"),
            shared_index=shared_index, mesh=mesh, col_maps=col_maps)
        pstats = dict(round="polish", changed=n_changed)
        if _STAGE_TIMING:
            pstats["t_polish"] = round(time.time() - t_pol, 2)
        round_stats.append(pstats)
    return AssemblyResult(genes=genes, n_rounds=n_rounds,
                          converged=converged, round_stats=round_stats,
                          panel=panel)
