"""Pallas kernel (Triton route, for GPUs): affine-gap Smith-Waterman score.

The pass-1 score over every (read, candidate window) pair - the hot loop of
the align step. Bit-identical to ops.sw.sw_score (same recurrence, the same
best-cell key H * 32768 - (i * (W + 1) + j) and tie-breaks), tested in
interpret mode in tests/test_sw_pallas.py and compiled on the card by
chip_smoke.py.

Layout (inter-task parallelism, the CUDASW++ pattern): each program owns a
block of `block` alignments, one per lane. The query is cut into strips of
`strip` rows; for each strip a loop walks the window columns j = 1..W with the
strip's H and E (the horizontal gap state) held in registers, so a cell costs
a dozen integer ops and no memory traffic. Only the strip's bottom row (H and
the vertical gap F, one int32 each per column) crosses to the next strip
through a (W, B) buffer. The whole L x W rectangle is valid, so no cell is
masked. The plain ops.sw scan instead writes its (pairs, L+1) state to device
memory at every anti-diagonal step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from rambl_tpu.config import ScoringParams
from rambl_tpu.ops.sw import _NONE, _TIE, decode_best

_W_PAD = 9            # window N/pad code: never equals a query code
_Q_PAD = 8            # query N/pad code: never equals a window code


_STRIP_MAX = 36       # rows held in registers per strip (H100: 35-row
                      # strips beat 32 and 52 at sw_rows 104; PERF.md)


def strips(L: int, strip: int = 0) -> tuple[int, ...]:
    """Static row-strip sizes covering L query rows: `strip` rows each, or
    with strip 0 the fewest strips of at most _STRIP_MAX rows, balanced."""
    if not strip:
        n = -(-L // _STRIP_MAX)
        return tuple(L // n + (i < L % n) for i in range(n))
    return (strip,) * (L // strip) + ((L % strip,) if L % strip else ())


def _score_kernel(q_ref, w_ref, best_ref, bh_ref, bf_ref, *,
                  sc: ScoringParams, L: int, W: int, strip: int):
    """q_ref (L, blk) int8, w_ref (W, blk) int8 -> best_ref (blk,) int32.

    bh_ref/bf_ref (W, blk) int32 carry H and F of a strip's last row to the
    next strip (H(i0-1, j) and F(i0-1, j) for the strip starting at row i0).
    """
    blk = best_ref.shape[0]
    neg = jnp.full((blk,), sc.neg_inf, jnp.int32)
    zero = jnp.zeros((blk,), jnp.int32)
    none = jnp.full((blk,), _NONE, jnp.int32)
    go_ge = sc.gap_open + sc.gap_extend
    ge = sc.gap_extend
    parts = strips(L, strip)

    best = none
    i0 = 0
    for n, R in enumerate(parts):
        first, last = n == 0, n == len(parts) - 1
        q = [q_ref[i0 + r, :].astype(jnp.int32) for r in range(R)]

        def column(j, carry, q=q, R=R, first=first, last=last):
            hl, el, bk, hdiag = carry        # H(i, j-1), E(i, j-1), row keys
            wj = w_ref[j, :].astype(jnp.int32)
            if first:                        # DP border row 0
                hup, fup = zero, neg
            else:
                hup, fup = bh_ref[j, :], bf_ref[j, :]
            hb = hup
            hl2, el2, bk2 = [], [], []
            for r in range(R):
                s = jnp.where(q[r] == wj, sc.match, sc.mismatch)
                e = jnp.maximum(hl[r] - go_ge, el[r] - ge)
                f = jnp.maximum(hup - go_ge, fup - ge)
                h = jnp.maximum(jnp.maximum(hdiag + s, 0), jnp.maximum(e, f))
                # per-row key H * _TIE - j; the row part i * (W + 1) is
                # subtracted once per strip (max commutes with it)
                bk2.append(jnp.maximum(bk[r], h * _TIE - (j + 1)))
                hdiag = hl[r]
                hl2.append(h)
                el2.append(e)
                hup, fup = h, f
            if not last:
                bh_ref[j, :] = hup
                bf_ref[j, :] = fup
            return tuple(hl2), tuple(el2), tuple(bk2), hb

        init = ((zero,) * R, (neg,) * R, (none,) * R, zero)
        _, _, bk, _ = jax.lax.fori_loop(0, W, column, init)
        for r in range(R):
            best = jnp.maximum(best, bk[r] - (i0 + r + 1) * (W + 1))
        i0 += R
    best_ref[:] = best


@functools.partial(jax.jit, static_argnames=(
    "sc", "rows", "block", "strip", "interpret"))
def sw_score_pallas(q: jax.Array, w: jax.Array, sc: ScoringParams,
                    rows: int = 0, block: int = 128, strip: int = 0,
                    interpret: bool = False):
    """Drop-in for ops.sw.sw_score. q: (B, L) int8, w: (B, W) int8 ->
    (score, i_end, j_end) each (B,) int32 (1-based end cell, 0 = none).

    Any B: the batch is padded to a multiple of `block` with pad rows that
    score 0. rows (0 = L): compute only the first `rows` query rows. Exact
    whenever every real read fits (all q[:, rows:] are pad): a pad-row cell's
    H comes from some real-row H minus at least one gap penalty, since pad
    never matches, so it is strictly below that real H; the best cell is
    always in a real row.
    """
    B, L = q.shape
    W = w.shape[1]
    if rows and rows < L:
        q = q[:, :rows]
        L = rows
    # the decode mis-reads silently if pos = i*(W+1)+j can reach _TIE
    assert L * (W + 1) + W < _TIE, (
        f"best-key overflow: L={L}, W={W}; shrink read_len_max/window_margin")
    nb = -(-B // block)
    pad = nb * block - B
    # batch-last layout: one (block,) row load per query row / window column
    qT = jnp.pad(jnp.where(q < 4, q, _Q_PAD).astype(jnp.int8),
                 ((0, pad), (0, 0)), constant_values=_Q_PAD).T
    wT = jnp.pad(jnp.where(w < 4, w, _W_PAD).astype(jnp.int8),
                 ((0, pad), (0, 0)), constant_values=_W_PAD).T
    kern = functools.partial(_score_kernel, sc=sc, L=L, W=W, strip=strip)
    bnd = pl.BlockSpec((W, block), lambda t: (0, t))
    best, _, _ = pl.pallas_call(
        kern,
        grid=(nb,),
        in_specs=[pl.BlockSpec((L, block), lambda t: (0, t)), bnd],
        out_specs=[pl.BlockSpec((block,), lambda t: (t,)), bnd, bnd],
        out_shape=[jax.ShapeDtypeStruct((nb * block,), jnp.int32),
                   jax.ShapeDtypeStruct((W, nb * block), jnp.int32),
                   jax.ShapeDtypeStruct((W, nb * block), jnp.int32)],
        compiler_params=plt.CompilerParams(num_warps=block // 32,
                                           num_stages=1),
        interpret=interpret,
        name="sw_score",
    )(qT, wT)
    return decode_best(best[:B], W)
