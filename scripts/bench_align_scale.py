"""Full production align+bin step at config-3 index scale, phase-ablated.

Where round-0 align at config-3 index scale costs more than the isolated
big-index ops (probe, window gather, col_map) add up to, the cost lives in
the FULL fused executable. This times
_align_bin_batch exactly as the production stream runs it (tables as
arguments, pipelined dispatches, scalar-reduced) and walks the prefix
ablation until the per-batch cost appears.

  PYTHONPATH=. python scripts/bench_align_scale.py [B]
"""

import functools
import pickle
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.index.colmap import build_col_maps
from rambl_tpu.ops.seed import (
    SeedTable,
    gather_windows_jax,
    revcomp_jax,
    seed_candidates_jax,
)
from rambl_tpu.pipeline.align import align_batch, align_from_candidates
from rambl_tpu.utils.cache import enable_compile_cache


def reduced(f):
    def g(*args):
        out = f(*args)
        return sum(jnp.sum(x.astype(jnp.int32) if x.dtype == bool else x)
                   for x in jax.tree_util.tree_leaves(out))
    return jax.jit(g)


def timed(name, f, a0, a1, reps=8):
    out = f(*a0)
    np.asarray(out)
    t0 = time.time()
    outs = [f(*(a0 if i % 2 == 0 else a1)) for i in range(reps)]
    for o in outs:
        np.asarray(o)
    dt = (time.time() - t0) / reps
    print(f"{name}: {dt * 1e3:8.1f} ms/batch pipelined", flush=True)
    return dt


def main():
    enable_compile_cache()
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    cfg = PipelineConfig(batch_size=B, max_genes=2048,
                         max_clusters_per_bin=16, max_assembly_iters=4,
                         bin_share_depth=3, cluster_leaf_block=512,
                         sw_rows=104)
    cache = f"/tmp/config3_cache_10000000_100000_k{cfg.k}_v3_seed13.pkl"
    t0 = time.time()
    with open(cache, "rb") as f:
        ds, index = pickle.load(f)
    print(f"cache loaded {time.time() - t0:.0f}s", flush=True)
    from rambl_tpu.index.taxonomy import build_taxonomy_tables
    from rambl_tpu.pipeline.assemble import (
        _align_bin_batch,
        _pad_entry_rows,
        pack_entries_np,
    )

    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    col_map = build_col_maps(ds.ref_seqs, ds.ref_lens, tax.ref_taxon)
    ent = _pad_entry_rows(pack_entries_np(index))
    args_tbl = (jnp.asarray(index.bucket_start), jnp.asarray(ent))
    refs_d = jnp.asarray(ds.ref_seqs)
    rt = jnp.asarray(tax.ref_taxon)
    anc = jnp.asarray(tax.anc_path)
    dep = jnp.asarray(tax.depth)
    cm_d = jnp.asarray(col_map)
    a0 = (jnp.asarray(ds.reads[:B]), jnp.asarray(ds.read_lens[:B]))
    a1 = (jnp.asarray(ds.reads[B : 2 * B]), jnp.asarray(ds.read_lens[B : 2 * B]))
    print(f"B={B} entries={index.n_entries} col_map {cm_d.nbytes / 1e9:.2f} GB",
          flush=True)

    # the exact production step
    step = functools.partial(_align_bin_batch, cfg=cfg, n_bits=index.n_bits)
    timed("FULL _align_bin_batch    ",
          reduced(step),
          a0 + args_tbl + (refs_d, rt, anc, dep, cm_d),
          a1 + args_tbl + (refs_d, rt, anc, dep, cm_d))

    # prefix 1: seeding both strands
    def seed2(r, l, bs, ent):
        tbl = SeedTable(bs, ent, index.n_bits)
        rc = revcomp_jax(r, l)
        cf = seed_candidates_jax(r, l, tbl, cfg)
        cr = seed_candidates_jax(rc, l, tbl, cfg)
        return cf["cand_ref"], cr["cand_ref"]

    timed("A seed both strands      ", reduced(seed2),
          a0 + args_tbl, a1 + args_tbl)

    # prefix 2: + window gather
    def upto_windows(r, l, bs, ent):
        tbl = SeedTable(bs, ent, index.n_bits)
        rc = revcomp_jax(r, l)
        cf = seed_candidates_jax(r, l, tbl, cfg)
        cr = seed_candidates_jax(rc, l, tbl, cfg)
        cref = jnp.concatenate([cf["cand_ref"], cr["cand_ref"]], axis=1)
        cws = jnp.concatenate([cf["cand_wstart"], cr["cand_wstart"]], axis=1)
        return gather_windows_jax(refs_d, cref, cws, cfg.window_len, cfg)

    timed("B + window gather        ", reduced(upto_windows),
          a0 + args_tbl, a1 + args_tbl)

    # prefix 3: full align_batch (score + traceback), no bin/colmap
    def upto_align(r, l, bs, ent):
        tbl = SeedTable(bs, ent, index.n_bits)
        res = align_batch(r, l, tbl, refs_d, cfg)
        return res.score, res.ref, res.ref_col

    timed("C + score+traceback      ", reduced(upto_align),
          a0 + args_tbl, a1 + args_tbl)

    # D: the FULL production stream loop shape - step + donated retention
    # fills + read_count accum + fresh H2D per batch, 16 batches, one sync
    from rambl_tpu.pipeline.assemble import _fill_rows, _read_count_accum

    nb = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    # retention buffers at FULL production size (10M rows): donated
    # dynamic_update_slice cost must be O(batch), not O(buffer) - if this
    # differs from the small-buffer run, donation is copying
    rows = int(sys.argv[2]) if len(sys.argv) > 2 else ds.reads.shape[0]
    L = ds.reads.shape[1]
    step_j = jax.jit(step)
    host_batches = [(ds.reads[i * B : (i + 1) * B],
                     ds.read_lens[i * B : (i + 1) * B]) for i in range(nb)]

    def stream_once():
        bufs = {
            "query": jnp.zeros((rows, L), jnp.int8),
            "ref_col": jnp.zeros((rows, L), jnp.int16),
            "bins": jnp.zeros((rows,), jnp.int32),
            "score": jnp.zeros((rows,), jnp.int32),
            "ref": jnp.zeros((rows,), jnp.int32),
            "strand": jnp.zeros((rows,), jnp.int8),
        }
        read_count = jnp.zeros((tax.n_nodes,), jnp.int32)
        nxt = (jax.device_put(host_batches[0][0]),
               jax.device_put(host_batches[0][1]))
        for i in range(nb):
            cur = nxt
            nxt = ((jax.device_put(host_batches[i + 1][0]),
                    jax.device_put(host_batches[i + 1][1]))
                   if i + 1 < nb else None)
            q, rc, b, sc, rf, st2 = step_j(
                cur[0], cur[1], *args_tbl, refs_d, rt, anc, dep, cm_d)
            read_count = _read_count_accum(b, read_count, tax.n_nodes)
            rc = rc.astype(jnp.int16)
            for k, v in zip(("query", "ref_col", "bins", "score", "ref",
                             "strand"), (q, rc, b, sc, rf, st2)):
                bufs[k] = _fill_rows(bufs[k], v, jnp.int32(i * B))
        jax.block_until_ready((bufs["query"], read_count))
        return bufs

    stream_once()  # warm compiles
    t0 = time.time()
    stream_once()
    dt = (time.time() - t0) / nb
    print(f"D full stream loop       : {dt * 1e3:8.1f} ms/batch", flush=True)


if __name__ == "__main__":
    main()
