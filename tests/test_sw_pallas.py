"""SW paths == NumPy oracle, bitwise.

The score cases run the Pallas kernel (ops/sw_pallas.py) in interpret mode on
the CPU; test_compiled_parity runs it compiled on a GPU (marker `gpu`, skips
without one; chip_smoke.py makes the same check at real widths). The dirs
cases run the plain dirs pass + traceback (ops/sw.py) that the align step
uses for gapped reads on every platform.
"""

import jax
import numpy as np
import pytest

from rambl_tpu.config import ScoringParams
from rambl_tpu.oracle.sw import sw_batch, traceback_batch
from rambl_tpu.ops.sw import sw_align, sw_traceback
from rambl_tpu.ops.sw_pallas import strips, sw_score_pallas

SC = ScoringParams()


def _gapped_cases(seed, B, L, W):
    """Random q/w with planted homology including indels (gapped paths)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, L)).astype(np.int8)
    w = rng.integers(0, 5, (B, W)).astype(np.int8)
    for b in range(B):
        n = min(L, W) - 6
        frag = q[b, 1 : 1 + n].copy()
        if b % 3 == 1 and n > 8:           # deletion in the window copy
            frag = np.concatenate([frag[: n // 2], frag[n // 2 + 1 :]])
        if b % 3 == 2 and n > 8:           # insertion in the window copy
            frag = np.concatenate(
                [frag[: n // 2], rng.integers(0, 4, 1).astype(np.int8), frag])
        m = min(frag.shape[0], W - 2)
        w[b, 2 : 2 + m] = frag[:m]
    return q, w


def _short_reads(seed, B, L, W, max_len=40):
    """Reads of 8..max_len bases padded to L with code 4, half with homology
    (some with a mid mismatch) planted in the window."""
    rng = np.random.default_rng(seed)
    q = np.full((B, L), 4, np.int8)
    lens = rng.integers(8, max_len + 1, B)
    for b in range(B):
        q[b, : lens[b]] = rng.integers(0, 4, lens[b])
    w = rng.integers(0, 5, (B, W)).astype(np.int8)
    for b in range(0, B, 2):
        n = int(lens[b]) - 4
        w[b, 3 : 3 + n] = q[b, 1 : 1 + n]
        if b % 4 == 0 and n > 10:
            w[b, 3 + n // 2] = (q[b, 1 + n // 2] + 1) % 4
    return q, w


def _assert_score(ref, got):
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("seed,L,W", [(0, 32, 48), (1, 16, 24), (2, 64, 80)])
def test_interpret_parity(seed, L, W):
    rng = np.random.default_rng(seed)
    B = 128
    q = rng.integers(0, 5, (B, L)).astype(np.int8)
    w = rng.integers(0, 5, (B, W)).astype(np.int8)
    for b in range(0, B, 3):  # plant homology in a third of rows
        n = min(L, W) - 4
        w[b, 2 : 2 + n] = q[b, 1 : 1 + n]
    ref = sw_batch(q, w, SC, want_dirs=False)[:3]
    # strip 12: several strips and a remainder strip cross the (W, B)
    # boundary buffer
    _assert_score(ref, sw_score_pallas(q, w, SC, strip=12, interpret=True))


def test_all_n_scores_zero():
    q = np.full((128, 16), 4, np.int8)
    w = np.full((128, 24), 4, np.int8)
    s, ie, je = sw_score_pallas(q, w, SC, interpret=True)
    assert (np.asarray(s) == 0).all()
    assert (np.asarray(ie) == 0).all() and (np.asarray(je) == 0).all()


def test_multi_tile_batches():
    rng = np.random.default_rng(3)
    B, L, W = 256, 24, 32
    q = rng.integers(0, 5, (B, L)).astype(np.int8)
    w = rng.integers(0, 5, (B, W)).astype(np.int8)
    ref = sw_batch(q, w, SC, want_dirs=False)[:3]
    _assert_score(ref, sw_score_pallas(q, w, SC, block=64, strip=8,
                                       interpret=True))


def test_ragged_batch_padding():
    # B not a multiple of the block: pad rows must not leak into real rows
    q, w = _gapped_cases(8, 100, 20, 28)
    ref = sw_batch(q, w, SC, want_dirs=False)[:3]
    _assert_score(ref, sw_score_pallas(q, w, SC, block=64, strip=7,
                                       interpret=True))


def test_strip_partition():
    assert strips(104, 32) == (32, 32, 32, 8)
    assert strips(64, 32) == (32, 32)
    assert strips(5, 32) == (5,)
    assert sum(strips(104, 12)) == 104


@pytest.mark.parametrize("seed,L,W", [(5, 32, 48), (6, 24, 24)])
def test_align_pallas_dirs_parity(seed, L, W):
    # the dirs pass + traceback the align step runs for gapped reads ==
    # the oracle (score/end cell AND the traced ref_col path); the score
    # kernel picks the same end cell
    q, w = _gapped_cases(seed, 128, L, W)
    s_np, ie_np, je_np, dp = sw_batch(q, w, SC)
    rc_np = traceback_batch(dp, ie_np, je_np, L)
    s0, ie0, je0, dirs0 = sw_align(q, w, SC)
    rc0 = sw_traceback(dirs0, ie0, je0, L, W)
    _assert_score((s_np, ie_np, je_np), (s0, ie0, je0))
    np.testing.assert_array_equal(rc_np, np.asarray(rc0))
    _assert_score((s_np, ie_np, je_np),
                  sw_score_pallas(q, w, SC, strip=10, interpret=True))


def test_align_pallas_rows_truncation():
    # reads <= 40 bases in a 64-row pad layout: the rows=48 score pass (the
    # end cell the gapless path reads) equals the full-L dirs pass, and the
    # traceback equals the oracle's
    B, L, W = 128, 64, 80
    q, w = _short_reads(7, B, L, W)
    s_np, ie_np, je_np, dp = sw_batch(q, w, SC)
    rc_np = traceback_batch(dp, ie_np, je_np, L)
    s0, ie0, je0, dirs0 = sw_align(q, w, SC)
    rc0 = sw_traceback(dirs0, ie0, je0, L, W)
    _assert_score((s_np, ie_np, je_np), (s0, ie0, je0))
    np.testing.assert_array_equal(rc_np, np.asarray(rc0))
    _assert_score((s_np, ie_np, je_np),
                  sw_score_pallas(q, w, SC, rows=48, strip=16,
                                  interpret=True))


def test_rows_truncation_exact():
    # rows=48 over 64-padded queries whose real reads are <= 40 long: the
    # truncated DP must equal the FULL DP (incl. tie-break positions)
    # because pad-row cells can never win (see sw_score_pallas docstring)
    q, w = _short_reads(4, 256, 64, 80)
    ref = sw_batch(q, w, SC, want_dirs=False)[:3]
    _assert_score(ref, sw_score_pallas(q, w, SC, rows=48, interpret=True))


@pytest.mark.gpu
def test_compiled_parity(gpu):
    # the kernel as compiled for the card, at the align step's widths
    B, L, W = 1024, 128, 160
    q, w = _short_reads(9, B, L, W, max_len=100)
    ref = sw_batch(q, w, SC, want_dirs=False)[:3]
    got = jax.jit(sw_score_pallas, static_argnames=("sc", "rows"))(
        jax.device_put(q, gpu), jax.device_put(w, gpu), sc=SC, rows=104)
    _assert_score(ref, got)
