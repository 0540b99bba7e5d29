"""Ring-sharded seed index: the sequence-parallel / ring-attention analogue
(SURVEY.md section 2.3 "SP/CP" row).

When the Greengenes seed table does not fit per-device, its hash buckets are
range-sharded over the 'data' axis. Reads stay on their home device; the index
SHARDS rotate around the ring (lax.ppermute), one hop per step, so after
n_shards steps every device has probed every bucket range - communication
overlaps with probe compute, and each k-mer's bucket lives in exactly one
shard so the per-seed hit slots fill exactly once. The result is bit-identical
to the replicated lookup (tested in tests/test_distributed.py).

Host-side prep: build_ring_shards slices the CSR table by bucket range and
pads entry arrays to a common length. The rotation is one lax.ppermute,
which XLA hands to NCCL on GPUs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.index.builder import SeedIndex
from rambl_tpu.ops.seed import (
    BIGK,
    hash_kmer_jax,
    probe,
    query_kmers_jax,
    revcomp_jax,
    select_candidates,
)
from rambl_tpu.parallel.mesh import DATA_AXIS


def build_ring_shards(index: SeedIndex, n_shards: int):
    """Slice the CSR table into n_shards bucket ranges (host side).

    Returns dict of stacked arrays with leading dim n_shards:
      bucket_start (n_shards, P/n + 1) ABSOLUTE offsets,
      entries (n_shards, rows, 128) packed chunk rows (ops.seed.pack_entries
      layout; pad slots carry key -1), rows common across shards.
    Feed shard s to device s (shard_map in_specs P('data') splits dim 0).
    """
    from rambl_tpu.ops.seed import _ENTRIES_PER_ROW, pack_entries

    P = index.n_buckets
    Pn = -(-P // n_shards)  # ceil; trailing shards may be padded with empty
    slices = []
    emax = 1
    for s in range(n_shards):
        lo_b = min(s * Pn, P)
        hi_b = min((s + 1) * Pn, P)
        lo_e = int(index.bucket_start[lo_b])
        hi_e = int(index.bucket_start[hi_b])
        emax = max(emax, hi_e - lo_e)
        slices.append((lo_b, hi_b, lo_e, hi_e))
    rows = -(-emax // _ENTRIES_PER_ROW)
    bs = np.zeros((n_shards, Pn + 1), np.int32)
    ent = np.full((n_shards, rows, 128), -1, np.int32)
    for s, (lo_b, hi_b, lo_e, hi_e) in enumerate(slices):
        seg = index.bucket_start[lo_b : hi_b + 1]
        bs[s, : seg.shape[0]] = seg
        bs[s, seg.shape[0] :] = seg[-1] if seg.size else 0  # empty pad buckets
        packed = pack_entries(index.entry_key[lo_e:hi_e],
                              index.entry_ref[lo_e:hi_e],
                              index.entry_pos[lo_e:hi_e])
        ent[s, : packed.shape[0]] = packed
    return dict(bucket_start=bs, entries=ent)


def _ring_probe(keys, valid, bucket_start, entries,
                cfg: PipelineConfig, n_bits: int):
    """Probe all shards by rotating them around the ring.

    Call INSIDE shard_map: each device holds one bucket-range shard (the
    per-device slice of the build_ring_shards arrays, leading dim stripped).
    """
    n = jax.lax.axis_size(DATA_AXIS)
    perm = [(i, (i + 1) % n) for i in range(n)]
    me = jax.lax.axis_index(DATA_AXIS)
    Pn = bucket_start.shape[0] - 1
    bucket = hash_kmer_jax(keys, n_bits)

    def body(step, state):
        bs, ent, ckey = state
        shard_id = jax.lax.rem(me - step + n, n)
        ck = probe(keys, valid, bucket, bs, ent, cfg, bucket_lo=shard_id * Pn)
        ckey = jnp.where(ck != BIGK, ck, ckey)
        bs, ent = jax.lax.ppermute((bs, ent), DATA_AXIS, perm)  # i -> i+1
        return (bs, ent, ckey)

    from rambl_tpu.ops.seed import probe_slots

    slots = probe_slots(cfg, entries.shape)
    ckey0 = jnp.full(keys.shape + (slots,), BIGK, jnp.int32)
    state = jax.lax.fori_loop(0, n, body, (bucket_start, entries, ckey0))
    return state[2]


def ring_align_batch(reads, read_lens, bucket_start, entries,
                     ref_seqs, cfg: PipelineConfig, n_bits: int):
    """align_batch with ring-sharded seeding. Call inside shard_map.

    Bit-identical to pipeline.align.align_batch with the replicated table.
    """
    from rambl_tpu.pipeline.align import align_from_candidates, check_sw_rows

    check_sw_rows(read_lens, cfg)  # no-op under tracing (ADVICE r2)
    # shard arrays arrive stacked (n_shards, ...) and sharded over dim 0 ->
    # locally (1, ...); strip the leading dim
    if bucket_start.ndim == 2:
        bucket_start = bucket_start[0]
        entries = entries[0]

    rc_reads = revcomp_jax(reads, read_lens)

    def cands_for(q):
        keys, valid = query_kmers_jax(q, read_lens, cfg)
        ckey = _ring_probe(keys, valid, bucket_start, entries, cfg, n_bits)
        return select_candidates(ckey, cfg)

    return align_from_candidates(
        reads, rc_reads, cands_for(reads), cands_for(rc_reads), ref_seqs, cfg
    )
