"""Jitted align step: seed -> candidates -> score -> best -> traceback.

The device replacement for the whole `bwa mem` + BAM stage (SURVEY.md
section 3.1/3.4): a batch of padded reads goes in, dense alignment-record
tensors come out. No SAM/BAM, no subprocess, no host roundtrip.

Two-pass structure exactly as the oracle (oracle.align.align_reads):
score all 2C candidate pairs, select the best deterministically
(max score, tie -> lowest pair index, fwd before rc), then rerun the DP with
direction emission for the winning pair only and trace back.

Everything in here is pure jnp on static shapes: safe under jit, shard_map
and (batch-dim) sharding.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rambl_tpu.config import PipelineConfig
from rambl_tpu.ops.seed import (
    SeedTable,
    gather_windows_jax,
    revcomp_jax,
    seed_candidates_jax,
)
from rambl_tpu.ops.sw import sw_align, sw_score, sw_traceback


class AlignRecords(NamedTuple):
    """Dense per-read alignment records (device-side, static shapes)."""

    score: jax.Array       # (B,) int32
    ref: jax.Array         # (B,) int32, -1 if unaligned
    strand: jax.Array      # (B,) int8
    ref_col: jax.Array     # (B, L) int32 global ref column per query pos, -1
    query: jax.Array       # (B, L) int8 aligned-orientation codes
    pair_score: jax.Array  # (B, 2C) int32
    pair_ref: jax.Array    # (B, 2C) int32
    pair_valid: jax.Array  # (B, 2C) bool

    @property
    def aligned(self) -> jax.Array:
        return self.ref >= 0


def mapping_quality(res: "AlignRecords") -> jax.Array:
    """Per-read mapping-confidence margin: the MAPQ equivalent (SURVEY.md
    section 3.2 "compute MAPQ, emit SAM record").

    Integer-exact: best pair score minus the best score among valid pairs to
    a DIFFERENT reference (alternate windows/strands on the same ref are the
    same mapping, as bwa mem treats overlapping alt hits). A read with no
    competing reference keeps its full score as margin; unaligned reads get 0.
    Downstream filtering: margin 0 == multi-mapped across refs (binning's
    bin_score_delta multi-hit voting already consumes these pairs directly).
    """
    second = jnp.max(
        jnp.where(res.pair_valid & (res.pair_ref != res.ref[:, None]),
                  res.pair_score, 0),
        axis=1,
    )
    return jnp.where(res.aligned, res.score - second, 0).astype(jnp.int32)


def check_sw_rows(read_lens, cfg: PipelineConfig) -> None:
    """cfg.sw_rows exactness guard at align entry points (ADVICE r2).

    Row truncation is only exact when every real read fits in the truncated
    DP (proof in ops/sw_pallas.sw_score_pallas). Enforced here whenever the
    lengths are concrete (direct/script callers); traced callers are covered
    by the host-boundary check in pipeline/assemble._stream_align."""
    if not cfg.sw_rows or isinstance(read_lens, jax.core.Tracer):
        return
    ml = int(jnp.max(read_lens)) if read_lens.size else 0
    if ml > cfg.sw_rows:
        from rambl_tpu.utils.errors import UserError

        raise UserError(
            f"cfg.sw_rows={cfg.sw_rows} < longest read {ml}: the truncated "
            "SW wavefront is only exact when every real read fits "
            "(ops/sw_pallas.py)")


def score_fn(platform: str):
    """The pass-1 SW score implementation for a JAX platform: the Pallas
    kernel on a GPU, the plain scan on the CPU (the test platform). Both
    take (q, w, sc, rows=) and are bit-identical (tests/test_sw_pallas.py)."""
    if platform == "gpu":
        from rambl_tpu.ops.sw_pallas import sw_score_pallas

        return sw_score_pallas
    if platform == "cpu":
        return sw_score
    raise ValueError(f"no SW score implementation for platform {platform!r}")


def align_batch(
    reads: jax.Array,
    read_lens: jax.Array,
    table: SeedTable,
    ref_seqs: jax.Array,
    cfg: PipelineConfig,
) -> AlignRecords:
    check_sw_rows(read_lens, cfg)
    rc_reads = revcomp_jax(reads, read_lens)
    cands_f = seed_candidates_jax(reads, read_lens, table, cfg)
    cands_r = seed_candidates_jax(rc_reads, read_lens, table, cfg)
    return align_from_candidates(
        reads, rc_reads, cands_f, cands_r, ref_seqs, cfg
    )


def align_from_candidates(
    reads: jax.Array,
    rc_reads: jax.Array,
    cands_f: dict,
    cands_r: dict,
    ref_seqs: jax.Array,
    cfg: PipelineConfig,
) -> AlignRecords:
    """Score/select/trace given fwd+rc candidates (shared by the replicated
    and ring-sharded seeding paths)."""
    B, L = reads.shape
    W = cfg.window_len
    C = cfg.max_candidates
    sc = cfg.scoring

    cref = jnp.concatenate([cands_f["cand_ref"], cands_r["cand_ref"]], axis=1)
    cws = jnp.concatenate([cands_f["cand_wstart"], cands_r["cand_wstart"]], axis=1)
    cval = jnp.concatenate([cands_f["cand_valid"], cands_r["cand_valid"]], axis=1)

    wins = gather_windows_jax(ref_seqs, cref, cws, W, cfg)     # (B, 2C, W)
    q_pairs = jnp.concatenate(
        [
            jnp.broadcast_to(reads[:, None, :], (B, C, L)),
            jnp.broadcast_to(rc_reads[:, None, :], (B, C, L)),
        ],
        axis=1,
    )                                                           # (B, 2C, L)

    # pass 1: score all pairs with the platform's SW implementation
    score, p_ie, p_je = score_fn(jax.default_backend())(
        q_pairs.reshape(B * 2 * C, L), wins.reshape(B * 2 * C, W), sc,
        rows=cfg.sw_rows,
    )
    score = score.reshape(B, 2 * C)
    p_ie = p_ie.reshape(B, 2 * C)
    p_je = p_je.reshape(B, 2 * C)
    score = jnp.where(cval, score, 0)

    # best pair: max score, tie -> lowest pair index
    key = score * (2 * C) + (2 * C - 1 - jnp.arange(2 * C, dtype=jnp.int32))
    best_pair = jnp.argmax(key, axis=1).astype(jnp.int32)
    bidx = jnp.arange(B, dtype=jnp.int32)
    best_score = score[bidx, best_pair]

    aligned = best_score >= cfg.min_score
    strand = (best_pair >= C).astype(jnp.int8)
    bref = cref[bidx, best_pair]
    bws = cws[bidx, best_pair]

    # pass 2: per-query-position window columns for the best pair.
    # Most alignments are GAPLESS, and a gapless optimum is provably what the
    # locked traceback follows (diag is preferred on ties, and every cell on a
    # score-tight gapless path satisfies H == Hdiag + sub), so their columns
    # come straight from the end cell: walk the diagonal back until the suffix
    # substitution sum hits the best score. Only reads with no such walk carry
    # gaps and go through the direction-matrix traceback, compacted to a
    # capped sub-batch (full-batch fallback keeps exactness on cap overflow).
    qb = jnp.where(strand[:, None] == 1, rc_reads, reads)
    wb = wins[bidx, best_pair]
    ie = p_ie[bidx, best_pair]
    je = p_je[bidx, best_pair]

    kk = jnp.arange(L, dtype=jnp.int32)
    kmax = jnp.minimum(ie, je)                              # (B,)
    # qi[k] = qb[ie-1-k] (and wj[k] = wb[je-1-k]) via static flip + barrel
    # roll instead of a per-row take_along_axis (ops/seed.roll_rows).
    # Indices wrap mod L/W where a clip would clamp;
    # both regions lie at kk >= kmax and are masked to neg_inf below.
    from rambl_tpu.ops.seed import roll_rows

    qi = roll_rows(qb[:, ::-1], L - ie)
    wj = roll_rows(wb[:, ::-1], W - je)[:, :L]
    sub = jnp.where(
        (qi == wj) & (qi < 4) & (wj < 4), sc.match, sc.mismatch
    ).astype(jnp.int32)
    sub = jnp.where(kk[None, :] < kmax[:, None], sub, sc.neg_inf)
    S = jnp.cumsum(sub, axis=1)                             # suffix sums
    hit = (S == best_score[:, None]) & (kk[None, :] < kmax[:, None])
    gapless = hit.any(axis=1) & (best_score > 0)
    n = jnp.argmax(hit, axis=1).astype(jnp.int32) + 1       # path length
    in_span = (kk[None, :] >= (ie - n)[:, None]) & (kk[None, :] <= (ie - 1)[:, None])
    rc_analytic = jnp.where(
        in_span & gapless[:, None], (je - ie)[:, None] + kk[None, :], -1
    )

    needs_tb = (best_score > 0) & ~gapless
    cap = max(128, B // 8)

    def _dirs_trace(q_s, w_s):
        _, ie_s, je_s, dirs_s = sw_align(q_s, w_s, sc)
        return sw_traceback(dirs_s, ie_s, je_s, L, W)

    order = jnp.argsort(jnp.where(needs_tb, 0, 1) * B + bidx)
    sel = order[:cap]

    def compact_tb(_):
        rc_s = _dirs_trace(qb[sel], wb[sel])
        upd = jnp.where(needs_tb[sel, None], rc_s, rc_analytic[sel])
        return rc_analytic.at[sel].set(upd)

    def full_tb(_):
        rc_f = _dirs_trace(qb, wb)
        return jnp.where(needs_tb[:, None], rc_f, rc_analytic)

    if cap >= B:
        rc_local = full_tb(0)
    else:
        rc_local = jax.lax.cond(needs_tb.sum() <= cap, compact_tb, full_tb, 0)

    gcol = jnp.where(rc_local >= 0, rc_local + bws[:, None], -1)
    gcol = jnp.where((gcol >= 0) & (gcol < ref_seqs.shape[1]), gcol, -1)

    return AlignRecords(
        score=jnp.where(aligned, best_score, 0),
        ref=jnp.where(aligned, bref, -1),
        strand=jnp.where(aligned, strand, jnp.int8(0)),
        ref_col=jnp.where(aligned[:, None], gcol, -1),
        query=qb,
        pair_score=score,
        pair_ref=cref,
        pair_valid=cval & (score >= cfg.min_score),
    )
