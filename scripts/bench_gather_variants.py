"""Window-gather strategies on the GPU: element gather vs strided-row gather
vs one-hot matmul.

  PYTHONPATH=. python scripts/bench_gather_variants.py [B]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.data.simulate import toy_dataset
from rambl_tpu.ops.seed import gather_windows_jax


def t(name, f, *args, n=3):
    g = jax.jit(f)
    np.asarray(g(*args))
    t0 = time.time()
    for _ in range(n):
        np.asarray(g(*args))
    print(f"{name}: {(time.time() - t0) / n * 1e3:8.1f} ms", flush=True)


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    cfg = PipelineConfig()
    ds = toy_dataset(n_reads=B)
    refs = jnp.asarray(ds.ref_seqs)
    R, RL = refs.shape
    W = cfg.window_len
    nd = cfg.n_diag_bins
    s0 = -cfg.read_len_max + cfg.diag_bin // 2 - cfg.window_margin
    rng = np.random.default_rng(0)
    P = 2 * cfg.max_candidates
    cand_ref = jnp.asarray(rng.integers(0, R, (B, P)).astype(np.int32))
    dbin = jnp.asarray(rng.integers(0, nd, (B, P)).astype(np.int32))
    cand_ws = dbin * cfg.diag_bin + s0
    print(f"B={B} P={P} R={R} nd={nd} W={W}", flush=True)

    def s(x):
        return jnp.sum(x.astype(jnp.int32))

    # current: element gather
    t("element gather ", lambda cr, cw: s(gather_windows_jax(refs, cr, cw, W)),
      cand_ref, cand_ws)

    # strided-row gather: (R, nd, W) built in-graph, then row gather
    def strided(cr, db):
        pad_lo = -s0
        pad_hi = max(0, (nd - 1) * cfg.diag_bin + s0 + W - RL)
        padded = jnp.concatenate([
            jnp.full((R, pad_lo), 4, jnp.int8), refs,
            jnp.full((R, pad_hi), 4, jnp.int8)], axis=1)
        tbl = jnp.stack(
            [padded[:, i * cfg.diag_bin: i * cfg.diag_bin + W]
             for i in range(nd)], axis=1)              # (R, nd, W)
        flat = tbl.reshape(R * nd, W)
        return s(jnp.take(flat, cr * nd + db, axis=0))
    t("strided row gthr", strided, cand_ref, dbin)

    # strided-row gather with table prebuilt OUTSIDE the jit
    pad_lo = -s0
    pad_hi = max(0, (nd - 1) * cfg.diag_bin + s0 + W - RL)
    padded = np.concatenate([
        np.full((R, pad_lo), 4, np.int8), np.asarray(refs),
        np.full((R, pad_hi), 4, np.int8)], axis=1)
    tbl_host = np.stack(
        [padded[:, i * cfg.diag_bin: i * cfg.diag_bin + W]
         for i in range(nd)], axis=1).reshape(R * nd, W)
    tbl_dev = jnp.asarray(tbl_host)
    t("prebuilt row gthr",
      lambda cr, db: s(jnp.take(tbl_dev, cr * nd + db, axis=0)),
      cand_ref, dbin)

    # one-hot matmul gather (bf16)
    def onehot_mm(cr, db):
        idx = cr * nd + db                                  # (B, P)
        oh = (idx[..., None] ==
              jnp.arange(R * nd, dtype=jnp.int32)).astype(jnp.bfloat16)
        out = jax.lax.dot_general(
            oh.reshape(B * P, R * nd), tbl_dev.astype(jnp.bfloat16),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
        return s(out.astype(jnp.int32))
    t("one-hot matmul  ", onehot_mm, cand_ref, dbin)


if __name__ == "__main__":
    main()
