"""Reference-to-anchor column maps: one coordinate system per leaf bin.

Pileups merge reads aligned to DIFFERENT references of the same leaf (strain
refs in round 0, variant panel genes later). Raw positions are only colinear
until the first indel difference between references - beyond it the merged
pileup smears by +-1 and the deletion rule starts dropping interior columns
(this was the dominant consensus-corruption mode; see git history).

Fix: per leaf, the lowest-index reference is the ANCHOR; every other
reference gets a column map to the anchor's coordinates via banded global
alignment (host NumPy, exact, deterministic), and every read's columns are
projected through its best reference's map right after alignment. Columns
inserted relative to the anchor map to -1 (their bases are dropped from
pileups, exactly like read insertions).

The row recurrence uses linear gap costs so each DP row is computable with a
prefix-max scan (no in-row dependency): with t[j] = max(diag, up) the row is
max_k<=j (t[k] - g*(j-k)) = accum-max(t[k] + g*k) - g*j.
"""

from __future__ import annotations

import numpy as np

MATCH = 2
MISMATCH = -3
GAP = -4  # linear


def anchor_of_leaf(ref_taxon: np.ndarray) -> np.ndarray:
    """(n_refs,) index of each ref's leaf anchor (lowest ref index per leaf)."""
    anchors = {}
    out = np.zeros_like(ref_taxon)
    for r, t in enumerate(ref_taxon.tolist()):
        if t not in anchors:
            anchors[t] = r
        out[r] = anchors[t]
    return out


def _nw_map(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Global alignment of b onto a; returns (len(b),) int32 map b-pos ->
    a-pos (-1 = inserted relative to a). Linear gap costs, deterministic
    tie-break: diag > up (gap in a / insertion) > left (gap in b)."""
    La, Lb = len(a), len(b)
    D = np.zeros((Lb + 1, La + 1), np.int32)
    D[0, :] = GAP * np.arange(La + 1)
    D[:, 0] = GAP * np.arange(Lb + 1)
    sub = np.where(b[:, None] == a[None, :], MATCH, MISMATCH)
    jj = np.arange(La + 1, dtype=np.int64)
    for i in range(1, Lb + 1):
        diag = D[i - 1, :-1] + sub[i - 1]
        up = D[i - 1, 1:] + GAP
        t = np.maximum(diag, up)
        t0 = np.concatenate(([D[i, 0]], t))
        row = np.maximum.accumulate(t0 + (-GAP) * jj) + GAP * jj
        D[i] = row
    # traceback
    out = np.full((Lb,), -1, np.int32)
    i, j = Lb, La
    while i > 0 and j > 0:
        if D[i, j] == D[i - 1, j - 1] + sub[i - 1, j - 1]:
            out[i - 1] = j - 1
            i -= 1
            j -= 1
        elif D[i, j] == D[i - 1, j] + GAP:
            i -= 1   # insertion in b relative to a -> -1 stays
        else:
            j -= 1   # deletion: a column skipped
    return out


_NW_LIB = None


def _nw_native():
    """Lazy-loaded native batched NW (native/nw.cpp), None if unavailable.

    Same integer DP and tie-breaks as _nw_map (parity in tests/
    test_polish.py::test_nw_map_batch_parity runs both paths); built the
    same way as the native loader (make -C native, atomic rename)."""
    global _NW_LIB
    if _NW_LIB is not None:
        return _NW_LIB or None
    import ctypes
    import os

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "native", "librambl_nw.so")
    if not os.path.exists(path):
        import subprocess
        try:
            subprocess.run(["make", "-C", os.path.dirname(path)],
                           capture_output=True, timeout=120, check=False)
        except (OSError, subprocess.TimeoutExpired):
            pass
    if not os.path.exists(path):
        _NW_LIB = False
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.nw_map_batch.restype = ctypes.c_int
        _NW_LIB = lib
    except OSError:
        _NW_LIB = False
    return _NW_LIB or None


def _nw_map_batch_native(a_list, b_list, lib):
    import ctypes
    import os

    n = len(a_list)
    La = np.asarray([len(a) for a in a_list], np.int64)
    Lb = np.asarray([len(b) for b in b_list], np.int64)
    astr = max(int(La.max()), 1)
    bstr = max(int(Lb.max()), 1)
    a_pad = np.full((n, astr), 5, np.int8)
    b_pad = np.full((n, bstr), 6, np.int8)
    for i in range(n):
        a_pad[i, : La[i]] = a_list[i]
        b_pad[i, : Lb[i]] = b_list[i]
    out = np.empty((n, bstr), np.int32)
    threads = min(max(os.cpu_count() or 1, 1), 8)
    lib.nw_map_batch(
        a_pad.ctypes.data_as(ctypes.c_void_p), La.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(astr),
        b_pad.ctypes.data_as(ctypes.c_void_p), Lb.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(bstr),
        ctypes.c_int64(n), ctypes.c_int32(MATCH), ctypes.c_int32(MISMATCH),
        ctypes.c_int32(GAP), ctypes.c_int32(threads),
        out.ctypes.data_as(ctypes.c_void_p))
    return [out[i, : Lb[i]].copy() for i in range(n)]


def _nw_map_batch(a_list, b_list, budget_bytes=400 << 20, native=True):
    """Batched _nw_map over (a_i, b_i) pairs; returns list of (len(b_i),)
    int32 maps, each BITWISE equal to _nw_map(a_i, b_i). Dispatches to the
    native C++ tier (native/nw.cpp) when built; the vectorized numpy path
    below is the always-available fallback.

    The polish pass runs one global NW per gene (1754 genes at config 3);
    this vectorizes the row recurrence and the traceback across a chunk of
    genes - same integer DP, same tie-breaks, element-wise over the gene
    axis, so every map is unchanged. The DP tables are int16 when the score
    range provably fits (|D| <= -GAP*(La+Lb), intermediates bounded by
    |D| - GAP*(La+1)), halving the dominant memory traffic."""
    n = len(a_list)
    if n == 0:
        return []
    if native:
        lib = _nw_native()
        if lib is not None:
            return _nw_map_batch_native(a_list, b_list, lib)
    La = np.asarray([len(a) for a in a_list], np.int64)
    Lb = np.asarray([len(b) for b in b_list], np.int64)
    out: list = [None] * n
    order = np.argsort(La + Lb, kind="stable")  # like sizes share a chunk
    Lam_all = int(La.max())
    Lbm_all = int(Lb.max())
    # distinct pad codes: padded tails can never compare equal
    a_pad = np.full((n, Lam_all), 5, np.int8)
    b_pad = np.full((n, Lbm_all), 6, np.int8)
    for i in range(n):
        a_pad[i, : La[i]] = a_list[i]
        b_pad[i, : Lb[i]] = b_list[i]

    done = 0
    while done < n:
        # greedy chunk under the D-table byte budget
        g0 = done
        sel = [order[g0]]
        Lam = int(La[order[g0]])
        Lbm = int(Lb[order[g0]])
        while done + len(sel) < n:
            cand = order[g0 + len(sel)]
            lam = max(Lam, int(La[cand]))
            lbm = max(Lbm, int(Lb[cand]))
            if (len(sel) + 1) * (lbm + 1) * (lam + 1) * 4 > budget_bytes:
                break
            sel.append(cand)
            Lam, Lbm = lam, lbm
        done += len(sel)
        sel = np.asarray(sel)
        g = sel.size
        exact16 = -GAP * (Lam + Lbm) + (-GAP) * (Lam + 1) < 32000
        dt = np.int16 if exact16 else np.int32
        A = a_pad[sel, :Lam]
        Bq = b_pad[sel, :Lbm]
        D = np.zeros((g, Lbm + 1, Lam + 1), dt)
        jj = np.arange(Lam + 1, dtype=dt)
        D[:, 0, :] = (GAP * jj).astype(dt)
        D[:, :, 0] = (GAP * np.arange(Lbm + 1, dtype=dt))[None, :]
        mg = dt(-GAP)
        gp = dt(GAP)
        for i in range(1, Lbm + 1):
            sub_row = np.where(Bq[:, i - 1 : i] == A, dt(MATCH), dt(MISMATCH))
            diag = D[:, i - 1, :-1] + sub_row
            up = D[:, i - 1, 1:] + gp
            t = np.maximum(diag, up)
            t0 = np.concatenate([D[:, i, :1], t], axis=1)
            D[:, i] = np.maximum.accumulate(t0 + mg * jj, axis=1) + gp * jj
        # lockstep vectorized traceback (same decisions as _nw_map's loop)
        res = np.full((g, Lbm), -1, np.int32)
        ii = Lb[sel].copy()
        jm = La[sel].copy()
        gi = np.arange(g)
        active = (ii > 0) & (jm > 0)
        while active.any():
            i1 = np.maximum(ii - 1, 0)
            j1 = np.maximum(jm - 1, 0)
            d = D[gi, ii, jm]
            sub = np.where(Bq[gi, i1] == A[gi, j1], dt(MATCH), dt(MISMATCH))
            diag_ok = active & (d == D[gi, i1, j1] + sub)
            up_ok = active & ~diag_ok & (d == D[gi, i1, jm] + gp)
            left = active & ~diag_ok & ~up_ok
            res[gi[diag_ok], ii[diag_ok] - 1] = jm[diag_ok] - 1
            ii = ii - (diag_ok | up_ok)
            jm = jm - (diag_ok | left)
            active = (ii > 0) & (jm > 0)
        for k, gsel in enumerate(sel.tolist()):
            out[gsel] = res[k, : Lb[gsel]].copy()
    return out


def build_col_maps(ref_seqs: np.ndarray, ref_lens: np.ndarray,
                   ref_taxon: np.ndarray) -> np.ndarray:
    """(n_refs, ref_len_max) int32: per-ref column -> LEAF-ANCHOR column
    (-1 = unmapped). Identity for anchors and equal-sequence refs.

    Per-leaf anchors keep every taxon's own coordinates lossless (a global
    template would drop taxon-specific insertions and distort divergent
    variable regions). Cross-taxon consistency for tree-shared reads is
    provided by OFFSET-PRESERVING PANELS instead: every consensus gene
    records the anchor column of its first base (Gene.offset) and is placed
    at that offset in the next round's reference array, so all panel
    coordinates remain mutually aligned without any projection loss.
    """
    n_refs, Lmax = ref_seqs.shape
    anchors = anchor_of_leaf(np.asarray(ref_taxon))
    cmap = np.full((n_refs, Lmax), -1, np.int32)
    ident = np.arange(Lmax, dtype=np.int32)
    for r in range(n_refs):
        Lr = int(ref_lens[r])
        ar = int(anchors[r])
        if ar == r:
            cmap[r, :Lr] = ident[:Lr]
            continue
        La = int(ref_lens[ar])
        if Lr == La and np.array_equal(ref_seqs[r, :Lr], ref_seqs[ar, :La]):
            cmap[r, :Lr] = ident[:Lr]
            continue
        cmap[r, :Lr] = _nw_map(ref_seqs[ar, :La], ref_seqs[r, :Lr])
    return cmap
