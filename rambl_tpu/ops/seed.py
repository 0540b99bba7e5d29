"""Seeding + candidate voting as jitted JAX.

Bit-identical to rambl_tpu.oracle.seed (same deterministic rules; tested in
tests/test_ops_parity.py). The CSR seed table is consumed by pure gathers:
bucket offsets -> first `cap` entries -> key compare -> diagonal-bin votes ->
two-key lax.sort for (votes desc, key asc) top-C selection. No pointer chasing
- dense gathers only (SURVEY.md section 7.4.3).

The index arrays are passed as explicit tensors so they can be device_put with
a NamedSharding (replicated, or bucket-range sharded for the ring path).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rambl_tpu.config import PipelineConfig

_HASH_MULT = jnp.uint32(2654435769)


class SeedTable(NamedTuple):
    """Device-resident CSR seed table (see index.builder.SeedIndex).

    Entries are packed as FULL-LANE chunk rows (pack_entries): each (128,)
    int32 row holds 32 consecutive CSR entries field-major
    [keys(32) | refs(32) | pos(32) | pad(32)], so a capped bucket probe is a
    2-row gather of perfectly tiled 512-byte lines and field extraction is a
    static slice, in place of random narrow-row gathers over the ~2.5 GB
    full-Greengenes table.
    """

    bucket_start: jax.Array   # (P+1,) int32
    entries: jax.Array        # (rows, 128) int32 chunk rows (see above),
                              # or legacy (n_entries, 4) (key, ref, pos, 0)
    n_bits: int               # static

    @staticmethod
    def from_index(index) -> "SeedTable":
        return SeedTable(
            bucket_start=jnp.asarray(index.bucket_start),
            entries=jnp.asarray(pack_entries(
                index.entry_key, index.entry_ref, index.entry_pos)),
            n_bits=index.n_bits,
        )


def pack_entries(key, ref, pos):
    """Pack CSR entry columns into (rows, 128) int32 full-lane chunk rows:
    row r holds entries [32r, 32r+32) as [keys | refs | pos | zeros], 32
    lanes per field. Pad entry slots carry key = -1 (never equal to a valid
    >= 0 query key). See SeedTable docstring for why this layout."""
    import numpy as np

    n = key.shape[0]
    rows = -(-max(n, 1) // _ENTRIES_PER_ROW)
    out = np.zeros((rows, 128), np.int32)
    m = rows * _ENTRIES_PER_ROW

    def field(col, fill):
        buf = np.full(m, fill, np.int32)
        buf[:n] = col
        return buf.reshape(rows, _ENTRIES_PER_ROW)

    out[:, 0:32] = field(key, -1)
    out[:, 32:64] = field(ref, 0)
    out[:, 64:96] = field(pos, 0)
    return out


def hash_kmer_jax(keys, n_bits: int):
    h = (keys.astype(jnp.uint32) * _HASH_MULT) >> jnp.uint32(32 - n_bits)
    return h.astype(jnp.int32)


def query_kmers_jax(reads, read_lens, cfg: PipelineConfig):
    """(B, Lmax) int8 -> (keys (B, Q) int32, valid (B, Q) bool)."""
    pos = jnp.arange(0, cfg.read_len_max - cfg.k + 1, cfg.seed_stride, dtype=jnp.int32)
    keys = jnp.zeros((reads.shape[0], pos.shape[0]), jnp.int32)
    valid = jnp.ones(keys.shape, bool)
    for j in range(cfg.k):
        c = jnp.take(reads, pos + j, axis=1).astype(jnp.int32)
        valid &= c < 4
        keys = (keys << 2) | (c & 0x3)
    valid &= (pos[None, :] + cfg.k) <= read_lens[:, None]
    return keys, valid


BIGK = jnp.int32(2 ** 31 - 1)

# 32 entries per full-lane (128 x int32) chunk row: the granularity at
# which `probe` gathers the packed table (pack_entries layout)
_ENTRIES_PER_ROW = 32


def probe_slots(cfg: PipelineConfig, entries_shape) -> int:
    """Slot count of the (B, Q, slots) ckey array `probe` returns.

    The chunk-row path scans whole 32-entry rows covering the capped bucket
    window, so it emits ceil(cap/32)+1 rows worth of slots; the legacy
    (n, 4) path emits exactly cap. Ring accumulators (parallel.ring) must
    size their carry with this."""
    if len(entries_shape) == 2 and entries_shape[1] == 128:
        nspan = -(-cfg.bucket_cap // _ENTRIES_PER_ROW) + 1
        return nspan * _ENTRIES_PER_ROW
    return cfg.bucket_cap


def probe(keys, valid, bucket, bucket_start, entries,
          cfg: PipelineConfig, bucket_lo=0):
    """Probe a (possibly bucket-range-sharded) seed table.

    keys/valid: (B, Q) query k-mer keys + validity; bucket: (B, Q) global
    bucket ids (hash of keys). bucket_start is the CSR slice covering buckets
    [bucket_lo, bucket_lo + n_local] with ABSOLUTE offsets; entries is the
    matching packed (n, 4) slice (local entry index = offset -
    bucket_start[0]). Buckets outside the local range yield no hits, enabling
    ring-sharded lookups (parallel.ring).

    Returns ckey (B, Q, probe_slots(cfg, entries.shape)) int32 candidate
    vote keys; BIGK = miss. Extra slots (chunk-row path) are always BIGK,
    so downstream vote counting (select_candidates sorts the flattened
    keys) is bitwise unchanged - each real hit occupies exactly one slot
    either way.

    Layout: with the (rows, 128) pack_entries table, the capped scan
    [start, start+cap) is covered by ceil(cap/32)+1 consecutive full-lane
    rows; level 1 gathers those ROWS (512-byte aligned lines - the
    per-entry 16-byte row gather over the ~2.5 GB config-3 table dominated
    round-0 align), level 2 masks each slot by its position relative to the
    bucket start and field extraction is a static lane slice. No fine
    select passes are needed because the vote key is position-independent.
    """
    pos = jnp.arange(0, cfg.read_len_max - cfg.k + 1, cfg.seed_stride, dtype=jnp.int32)
    cap = cfg.bucket_cap
    n_local = bucket_start.shape[0] - 1

    local_b = bucket - bucket_lo                           # (B, Q)
    in_range = (local_b >= 0) & (local_b < n_local)
    lb = jnp.clip(local_b, 0, n_local - 1)
    base = bucket_start[0]
    start = jnp.take(bucket_start, lb) - base              # (B, Q)
    count = jnp.take(bucket_start, lb + 1) - base - start

    EPR = _ENTRIES_PER_ROW
    if entries.ndim == 2 and entries.shape[1] == 128:
        nrows = entries.shape[0]
        nspan = -(-cap // EPR) + 1
        # clip keeps the span in range; the window still covers the whole
        # capped scan because a clipped start lies in the last nspan rows
        # and the window then ends at the table end (>= any real entry)
        r0 = jnp.clip(start // EPR, 0, max(nrows - nspan, 0))
        g = jnp.take(entries,
                     r0[..., None] + jnp.arange(nspan, dtype=jnp.int32),
                     axis=0)                               # (B, Q, nspan, 128)
        S = nspan * EPR
        ekey = g[..., 0:EPR].reshape(keys.shape + (S,))
        eref = g[..., EPR : 2 * EPR].reshape(keys.shape + (S,))
        epos = g[..., 2 * EPR : 3 * EPR].reshape(keys.shape + (S,))
        # slot s holds entry index r0*EPR + s == the (r0*EPR + s - start)-th
        # entry of the bucket; the capped scan keeps 0 <= that < min(count,cap)
        sl = jnp.arange(S, dtype=jnp.int32)
        delta = start - r0 * EPR                           # (B, Q) >= 0
        rel = sl[None, None, :] - delta[..., None]
        in_bucket = (rel >= 0) & (rel < jnp.minimum(count, cap)[..., None])
    else:
        n_entries = entries.shape[0]
        slot = jnp.arange(cap, dtype=jnp.int32)
        eidx = start[..., None] + slot                     # (B, Q, cap)
        in_bucket = slot[None, None, :] < count[..., None]
        eidx = jnp.clip(eidx, 0, max(n_entries - 1, 0))
        g = jnp.take(entries, eidx, axis=0)                # (B, Q, cap, 4)
        ekey, eref, epos = g[..., 0], g[..., 1], g[..., 2]

    hit = (
        in_range[..., None]
        & in_bucket
        & (ekey == keys[..., None])
        & valid[..., None]
    )
    diag = epos - pos[None, :, None]
    dbin = (diag + cfg.read_len_max) // cfg.diag_bin
    ckey = eref * cfg.n_diag_bins + dbin                   # (B, Q, slots) int32
    return jnp.where(hit, ckey, BIGK)


def select_candidates(ckey, cfg: PipelineConfig):
    """Vote counting + deterministic top-C from probe keys (B, Q, cap).

    Run lengths of the sorted key rows come from cummax/roll scans (pure
    vector ops) - no per-element binary searches, whose gathers dominated
    seeding cost in the first implementation.
    """
    B = ckey.shape[0]
    flat = ckey.reshape(B, -1)
    N = flat.shape[1]
    flat = jnp.sort(flat, axis=1)
    # first-of-run positions own the run; others contribute votes only
    is_first = jnp.concatenate(
        [jnp.ones((B, 1), bool), flat[:, 1:] != flat[:, :-1]], axis=1
    )
    idx = jax.lax.broadcasted_iota(jnp.int32, (B, N), 1)
    # next run start after each position: reverse cummin of first-positions
    firsts = jnp.where(is_first, idx, jnp.int32(N))
    next_start = jnp.concatenate(
        [
            jax.lax.cummin(firsts[:, ::-1], axis=1)[:, ::-1][:, 1:],
            jnp.full((B, 1), N, jnp.int32),
        ],
        axis=1,
    )
    votes = jnp.where(
        is_first & (flat != BIGK), next_start - idx, 0
    ).astype(jnp.int32)

    # order by (votes desc, key asc): lexicographic two-key sort
    neg_votes = -votes
    sorted_nv, sorted_key = jax.lax.sort((neg_votes, flat), num_keys=2)
    C = cfg.max_candidates
    cand_votes = -sorted_nv[:, :C]
    cand_key = sorted_key[:, :C]
    cand_valid = cand_votes > 0

    cand_ref = jnp.where(cand_valid, cand_key // cfg.n_diag_bins, 0).astype(jnp.int32)
    cand_dbin = jnp.where(cand_valid, cand_key % cfg.n_diag_bins, 0).astype(jnp.int32)
    cand_wstart = (
        cand_dbin * cfg.diag_bin
        - cfg.read_len_max
        + cfg.diag_bin // 2
        - cfg.window_margin
    ).astype(jnp.int32)
    return dict(
        cand_ref=cand_ref,
        cand_wstart=cand_wstart,
        cand_votes=cand_votes,
        cand_valid=cand_valid,
    )


def seed_candidates_jax(reads, read_lens, table: SeedTable, cfg: PipelineConfig):
    """Top-C candidate windows per read; bit-identical to oracle.seed.

    Returns dict of (B, C) arrays: cand_ref, cand_wstart, cand_votes,
    cand_valid.
    """
    keys, valid = query_kmers_jax(reads, read_lens, cfg)   # (B, Q)
    bucket = hash_kmer_jax(keys, table.n_bits)
    ckey = probe(keys, valid, bucket, table.bucket_start, table.entries, cfg)
    return select_candidates(ckey, cfg)


# above this many bytes the (R * n_diag_bins, W) strided table switches to
# the two-level row-gather (a full-Greengenes table would be ~2 GB; the
# two-level path holds only the (R, ref_len+pad) padded panel)
_STRIDED_TABLE_MAX = 256 * 1024 * 1024


def _gather_windows_twolevel(ref_seqs, cand_ref, cand_wstart, W: int,
                             cfg: PipelineConfig):
    """Scale-proof on-grid window gather (BASELINE config 3/5 index sizes).

    The padded reference panel is viewed as 128-col chunks
    ((R * n_chunk_cols, 128) after one reshape); each candidate window spans
    at most `span` consecutive chunks, so level 1 is ONE contiguous-row
    gather of those chunk rows (row gathers move contiguous bytes; element
    gathers do not - scripts/bench_gather_variants.py) and level 2 selects
    the window among the 128/diag_bin possible in-chunk offsets with static
    masked slices (the window start is on the diag_bin grid). Traffic is
    ~N * span * 128 bytes gathered + 8 select passes over (N, W) - the
    previous formulation's coarse stage was ~18 masked passes over the
    FULL (N, 281) sub-rows plus an (N, RLpad) row gather. Bit-identical to
    the strided table (same padded array, same on-grid starts;
    tests/test_ops_parity.py::test_gather_windows_twolevel_parity)."""
    R, RL = ref_seqs.shape
    nd = cfg.n_diag_bins
    db = cfg.diag_bin
    s0 = -cfg.read_len_max + db // 2 - cfg.window_margin
    CH = 128                         # lane-width chunks
    fine_n = CH // db                # in-chunk grid offsets (8 for db=16)
    span = -(-((CH - db) + W) // CH)       # chunks covering any window

    pad_lo = max(0, -s0)
    # the in-chunk offset selection below assumes db-aligned absolute
    # starts: fine = (off % CH) // db only reproduces the window start when
    # off = pad_lo + s0 + idx*db is a db multiple (true whenever s0 <= 0;
    # ADVICE r4: fail loudly if a future config breaks it rather than
    # silently gathering shifted windows)
    assert (pad_lo + s0) % db == 0, (
        f"two-level window gather needs (pad_lo + s0) % diag_bin == 0, got "
        f"pad_lo={pad_lo} s0={s0} diag_bin={db}")
    # pad high enough that the last window's chunk span stays in range
    off_max = pad_lo + s0 + (nd - 1) * db
    need = (off_max // CH + span) * CH
    pad_hi = max(0, need - (pad_lo + RL), (nd - 1) * db + s0 + W - RL)
    rlpad = pad_lo + RL + pad_hi
    if rlpad % CH:
        pad_hi += CH - rlpad % CH
        rlpad = pad_lo + RL + pad_hi
    padded = jnp.concatenate([
        jnp.full((R, pad_lo), 4, jnp.int8), ref_seqs,
        jnp.full((R, pad_hi), 4, jnp.int8)], axis=1)
    nchunks = rlpad // CH
    tbl = padded.reshape(R * nchunks, CH)

    shape = cand_ref.shape
    flat_ref = jnp.clip(cand_ref, 0, R - 1).reshape(-1)
    idx = jnp.clip((cand_wstart - s0) // db, 0, nd - 1).reshape(-1)
    off = pad_lo + s0 + idx * db                          # absolute start
    c0 = off // CH
    fine = (off % CH) // db                               # 0..fine_n-1
    base = flat_ref * nchunks + c0                        # (N,)
    g = jnp.take(tbl, base[:, None] + jnp.arange(span, dtype=jnp.int32),
                 axis=0)                                  # (N, span, CH)
    g = g.reshape(-1, span * CH)
    out = jnp.zeros((g.shape[0], W), jnp.int8)
    for f in range(fine_n):
        out = out + jnp.where((fine == f)[:, None],
                              g[:, f * db: f * db + W], 0)
    return out.reshape(shape + (W,))


def gather_windows_jax(ref_seqs, cand_ref, cand_wstart, W: int,
                       cfg: PipelineConfig | None = None):
    """(R, ref_len) int8 refs -> (B, C, W) int8 windows (out of range -> 4).

    When cfg is given, window starts are assumed on the diag-bin grid
    (cand_wstart = dbin * diag_bin + s0, exactly what select_candidates
    emits), and the gather runs against an in-graph strided table
    (R, n_diag_bins, W): a contiguous-row gather instead of a 10M-element
    scatter-gather (scripts/bench_gather_variants.py compares them); XLA
    fuses the table build, so no persistent memory is held. Bitwise
    identical for on-grid starts; off-grid callers must pass cfg=None.
    """
    R, RL = ref_seqs.shape
    if cfg is not None:
        nd = cfg.n_diag_bins
        s0 = -cfg.read_len_max + cfg.diag_bin // 2 - cfg.window_margin
        if R * nd * W <= _STRIDED_TABLE_MAX:
            pad_lo = max(0, -s0)
            pad_hi = max(0, (nd - 1) * cfg.diag_bin + s0 + W - RL)
            padded = jnp.concatenate([
                jnp.full((R, pad_lo), 4, jnp.int8), ref_seqs,
                jnp.full((R, pad_hi), 4, jnp.int8)], axis=1)
            # window i starts at global column s0 + i*diag_bin, i.e. padded
            # column pad_lo + s0 + i*diag_bin (correct for either sign of s0;
            # with s0 <= 0, pad_lo == -s0 and this is i*diag_bin as before)
            tbl = jnp.stack(
                [padded[:, pad_lo + s0 + i * cfg.diag_bin:
                        pad_lo + s0 + i * cfg.diag_bin + W]
                 for i in range(nd)], axis=1).reshape(R * nd, W)
            idx = jnp.clip((cand_wstart - s0) // cfg.diag_bin, 0, nd - 1)
            flat = jnp.clip(cand_ref, 0, R - 1) * nd + idx
            return jnp.take(tbl, flat, axis=0)
        # full-Greengenes scale: the table would be GBs - use the two-level
        # row gather (bit-identical; no silent throughput cliff, VERDICT r1)
        return _gather_windows_twolevel(ref_seqs, cand_ref, cand_wstart, W, cfg)
    cols = cand_wstart[..., None] + jnp.arange(W, dtype=jnp.int32)
    in_range = (cols >= 0) & (cols < ref_seqs.shape[1])
    g = ref_seqs[cand_ref[..., None], jnp.clip(cols, 0, ref_seqs.shape[1] - 1)]
    return jnp.where(in_range, g, jnp.int8(4))


def roll_rows(x, shift):
    """Left-roll each row of (B, L) by its own shift (mod L) with a barrel
    shifter: log2(L) masked STATIC rolls instead of a per-row dynamic
    gather (take_along_axis on (B, L)); the barrel is a handful of vector
    selects."""
    L = x.shape[1]
    s = shift.astype(jnp.int32)
    sh = 1
    while sh < L:
        x = jnp.where((s & sh)[:, None] != 0, jnp.roll(x, -sh, axis=1), x)
        sh <<= 1
    return x


def revcomp_jax(reads, read_lens):
    """Batched reverse-complement keeping right padding, matches io.pack.

    Complement is pure arithmetic (3 - code for ACGT, everything else -> 4,
    as the old 5-entry table with clipped indexing mapped it); the per-row
    reversal is a static flip + barrel roll by (L - len) (roll_rows)."""
    B, L = reads.shape
    c = jnp.where(reads < 4, 3 - reads, jnp.int8(4)).astype(jnp.int8)
    out = roll_rows(c[:, ::-1], L - read_lens)
    ok = jnp.arange(L, dtype=jnp.int32)[None, :] < read_lens[:, None]
    return jnp.where(ok, out, jnp.int8(4))
