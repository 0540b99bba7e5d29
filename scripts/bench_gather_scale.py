"""Window-gather at config-3 index scale (full-Greengenes-sized panel):
strided table is infeasible (~2 GB), so compare the element gather (the old
silent fallback) against the two-level row gather on a real-size random
panel. Run on the GPU:

  PYTHONPATH=. python scripts/bench_gather_scale.py [R] [B]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.ops.seed import _gather_windows_twolevel, gather_windows_jax


def t(name, f, *args, n=3):
    g = jax.jit(f)
    np.asarray(g(*args))
    t0 = time.time()
    for _ in range(n):
        np.asarray(g(*args))
    print(f"{name}: {(time.time() - t0) / n * 1e3:8.1f} ms", flush=True)


def main():
    R = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 8192
    cfg = PipelineConfig(ref_len_max=2048)
    W = cfg.window_len
    nd = cfg.n_diag_bins
    s0 = -cfg.read_len_max + cfg.diag_bin // 2 - cfg.window_margin
    rng = np.random.default_rng(0)
    refs = jnp.asarray(rng.integers(0, 4, (R, cfg.ref_len_max)).astype(np.int8))
    P = 2 * cfg.max_candidates
    cand_ref = jnp.asarray(rng.integers(0, R, (B, P)).astype(np.int32))
    dbin = jnp.asarray(rng.integers(0, nd, (B, P)).astype(np.int32))
    cand_ws = dbin * cfg.diag_bin + s0
    print(f"R={R} RL={cfg.ref_len_max} B={B} P={P} nd={nd} W={W} "
          f"table would be {R * nd * W / 1e9:.2f} GB", flush=True)

    def s(x):
        return jnp.sum(x.astype(jnp.int32))

    t("element gather  ",
      lambda cr, cw: s(gather_windows_jax(refs, cr, cw, W, None)),
      cand_ref, cand_ws)
    t("two-level gather",
      lambda cr, cw: s(_gather_windows_twolevel(refs, cr, cw, W, cfg)),
      cand_ref, cand_ws)

    # parity spot check on a small slice (full check is in tests)
    a = np.asarray(gather_windows_jax(refs[:512], cand_ref % 512, cand_ws, W, None))
    b = np.asarray(_gather_windows_twolevel(refs[:512], cand_ref % 512, cand_ws, W, cfg))
    np.testing.assert_array_equal(a, b)
    print("parity ok", flush=True)


if __name__ == "__main__":
    main()
