"""Banded affine-gap Smith-Waterman as jitted JAX (anti-diagonal lax.scan).

Bit-identical to the NumPy spec in rambl_tpu.oracle.sw (tested in
tests/test_ops_parity.py): same recurrence, same locked tie-breaking
(diag > E > F > zero; open >= extend; best cell = max H then smallest i, j).

Dataflow (SURVEY.md section 7.4.5): state arrays indexed by query position i,
advanced over anti-diagonals d = i + j, batch as the leading axis - cells of
one anti-diagonal have no mutual dependencies. This is the CPU (test
platform) score pass and, on every platform, the dirs-emitting second pass
over the compacted gapped sub-batch; on a GPU the score pass is the Pallas
kernel in ops.sw_pallas.

Direction bits are emitted per anti-diagonal as a (B, L) uint8 row: for cell
(i, j), dirs[i + j - 2, b, i - 1] has bits [0:2]=H-choice, bit2=E-open,
bit3=F-open. `sw_traceback` consumes this layout directly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from rambl_tpu.config import ScoringParams

CH_ZERO, CH_DIAG, CH_E, CH_F = 0, 1, 2, 3

_TIE = 32768  # best-cell packing: key = H * _TIE - (i * (W + 1) + j)
_NONE = -(1 << 30)  # key of "no cell yet"


def _sub(q, wj, sc: ScoringParams):
    return jnp.where((q == wj) & (q < 4) & (wj < 4), sc.match, sc.mismatch).astype(
        jnp.int32
    )


def _scan_body(sc: ScoringParams, L: int, W: int, want_dirs: bool, carry, d):
    """One anti-diagonal step. carry = (H1, H2, E1, F1, best); all (B, L+1)."""
    H1, H2, E1, F1, best, q, w = carry
    B = q.shape[0]
    NEG = sc.neg_inf
    go, ge = sc.gap_open, sc.gap_extend

    ii = jnp.arange(1, L + 1, dtype=jnp.int32)          # (L,)
    j = d - ii                                          # (L,) 1-based window col
    valid = (j >= 1) & (j <= W)
    jc = jnp.clip(j - 1, 0, W - 1)
    wj = jnp.take(w, jc, axis=1)                        # (B, L)
    s = _sub(q, wj, sc)

    Hdiag = H2[:, 0:L]
    Hup = H1[:, 0:L]
    Fup = F1[:, 0:L]
    Hleft = H1[:, 1 : L + 1]
    Eleft = E1[:, 1 : L + 1]

    e_open = Hleft - (go + ge)
    e_ext = Eleft - ge
    Enew = jnp.maximum(e_open, e_ext)
    eopen = (e_open >= e_ext).astype(jnp.uint8)
    f_open = Hup - (go + ge)
    f_ext = Fup - ge
    Fnew = jnp.maximum(f_open, f_ext)
    fopen = (f_open >= f_ext).astype(jnp.uint8)
    diag = Hdiag + s
    Hnew = jnp.maximum(0, jnp.maximum(diag, jnp.maximum(Enew, Fnew)))
    ch = jnp.where(
        Hnew == 0,
        CH_ZERO,
        jnp.where(Hnew == diag, CH_DIAG, jnp.where(Hnew == Enew, CH_E, CH_F)),
    ).astype(jnp.uint8)

    vm = valid[None, :]
    Hnew = jnp.where(vm, Hnew, 0)
    Enew = jnp.where(vm, Enew, NEG)
    Fnew = jnp.where(vm, Fnew, NEG)

    cell_key = Hnew * _TIE - (ii * (W + 1) + j)[None, :]
    cell_key = jnp.where(vm & (Hnew > 0), cell_key, _NONE)
    best = jnp.maximum(best, cell_key.max(axis=1))

    zcol = jnp.zeros((B, 1), jnp.int32)
    ncol = jnp.full((B, 1), NEG, jnp.int32)
    H2n = H1
    H1n = jnp.concatenate([zcol, Hnew], axis=1)
    E1n = jnp.concatenate([ncol, Enew], axis=1)
    F1n = jnp.concatenate([ncol, Fnew], axis=1)

    out = None
    if want_dirs:
        out = jnp.where(vm, ch | (eopen << 2) | (fopen << 3), 0).astype(jnp.uint8)
    return (H1n, H2n, E1n, F1n, best, q, w), out


def _sw(q, w, sc: ScoringParams, want_dirs: bool):
    B, L = q.shape
    W = w.shape[1]
    NEG = sc.neg_inf
    H1 = jnp.zeros((B, L + 1), jnp.int32)
    H2 = jnp.zeros((B, L + 1), jnp.int32)
    E1 = jnp.full((B, L + 1), NEG, jnp.int32)
    F1 = jnp.full((B, L + 1), NEG, jnp.int32)
    best = jnp.full((B,), _NONE, jnp.int32)
    qi = q.astype(jnp.int32)
    wi = w.astype(jnp.int32)

    body = functools.partial(_scan_body, sc, L, W, want_dirs)
    ds = jnp.arange(2, L + W + 1, dtype=jnp.int32)
    carry, dirs = jax.lax.scan(body, (H1, H2, E1, F1, best, qi, wi), ds)
    return (*decode_best(carry[4], W), dirs)


def decode_best(best, W: int):
    """Best-cell key -> (score, i_end, j_end), each (B,) int32; a key with
    no positive-H cell (score <= 0) decodes to zeros."""
    score = -(-best // _TIE)          # ceil: best = H*_TIE - r, 0 < r < _TIE
    r = score * _TIE - best
    none = score <= 0
    z = jnp.int32(0)
    return (jnp.where(none, z, score).astype(jnp.int32),
            jnp.where(none, z, r // (W + 1)).astype(jnp.int32),
            jnp.where(none, z, r % (W + 1)).astype(jnp.int32))


def sw_score(q, w, sc: ScoringParams, rows: int = 0):
    """Score-only pass. q: (B, L) int8, w: (B, W) int8 ->
    (score, i_end, j_end) each (B,) int32 (1-based end cell).

    rows (0 = L): DP over the first `rows` query rows only, exact whenever
    every real read fits (proof in ops/sw_pallas.sw_score_pallas)."""
    if rows and rows < q.shape[1]:
        q = q[:, :rows]
    s, ie, je, _ = _sw(q, w, sc, want_dirs=False)
    return s, ie, je


def sw_align(q, w, sc: ScoringParams):
    """Full pass with direction bits.

    Returns (score, i_end, j_end, dirs) with dirs (L+W-1, B, L) uint8 in
    anti-diagonal-major layout (see module docstring).
    """
    return _sw(q, w, sc, want_dirs=True)


def sw_traceback(dirs, i_end, j_end, L: int, W: int):
    """Vectorized traceback -> ref_col (B, L) int32 (window col per query
    position, -1 when clipped/inserted). Matches oracle.traceback_batch.

    The scan only walks the path and EMITS (query pos, window col) per step;
    the ref_col tensor is built by a single scatter at the end. (A per-step
    .at[].set inside the scan carried a full (B, L) buffer through every
    iteration and dominated align-path time.)
    """
    B = i_end.shape[0]
    bidx = jnp.arange(B, dtype=jnp.int32)

    def body(state, _):
        i, j, st = state
        d = i + j
        p = dirs[jnp.clip(d - 2, 0, dirs.shape[0] - 1), bidx, jnp.clip(i - 1, 0, L - 1)]
        p = jnp.where((i > 0) & (j > 0), p, 0)
        ch = (p & 0x3).astype(jnp.int32)
        eop = (p >> 2) & 1
        fop = (p >> 3) & 1

        act_m = st == 0
        act_e = st == 1
        act_f = st == 2

        m_diag = act_m & (ch == CH_DIAG)
        emit_i = jnp.where(m_diag, i - 1, L)  # L = no-emit slot
        emit_j = j - 1

        ni = i - m_diag.astype(jnp.int32) - act_f.astype(jnp.int32)
        nj = j - m_diag.astype(jnp.int32) - act_e.astype(jnp.int32)

        nst = jnp.where(act_m & (ch == CH_ZERO), 3, st)
        nst = jnp.where(act_m & (ch == CH_E), 1, nst)
        nst = jnp.where(act_m & (ch == CH_F), 2, nst)
        nst = jnp.where(act_e, jnp.where(eop == 1, 0, 1), nst)
        nst = jnp.where(act_f, jnp.where(fop == 1, 0, 2), nst)
        nst = jnp.where((ni <= 0) | (nj <= 0), 3, nst).astype(jnp.int8)
        return (ni, nj, nst), (emit_i.astype(jnp.int32), emit_j.astype(jnp.int32))

    i0 = i_end.astype(jnp.int32)
    j0 = j_end.astype(jnp.int32)
    st0 = jnp.where((i0 > 0) & (j0 > 0), 0, 3).astype(jnp.int8)

    # while_loop with early exit: typical paths are ~L+gaps steps, far below
    # the worst-case L+W bound, and the per-step dirs gather is the cost.
    T = L + W + 2
    ei0 = jnp.full((T, B), L, jnp.int32)   # L = no-emit slot
    ej0 = jnp.zeros((T, B), jnp.int32)

    def cond(state):
        t, i, j, st, _, _ = state
        return (t < T) & jnp.any(st != 3)

    def wbody(state):
        t, i, j, st, ei, ej = state
        (ni, nj, nst), (emit_i, emit_j) = body((i, j, st), None)
        ei = jax.lax.dynamic_update_index_in_dim(ei, emit_i, t, 0)
        ej = jax.lax.dynamic_update_index_in_dim(ej, emit_j, t, 0)
        return (t + 1, ni, nj, nst, ei, ej)

    _, _, _, _, emit_i, emit_j = jax.lax.while_loop(
        cond, wbody, (jnp.int32(0), i0, j0, st0, ei0, ej0)
    )
    # one scatter: (T, B) emissions -> (B, L+1) with dump column L
    ref_col = jnp.full((B, L + 1), -1, jnp.int32)
    ref_col = ref_col.at[bidx[None, :], emit_i].set(emit_j)
    return ref_col[:, :L]
