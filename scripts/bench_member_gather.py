"""Cluster member-gather variants at config-3 scale (VERDICT r4 weak #7).

The round-0 cluster stage gathers (NL, M) member rows out of the (10M, L)
retention (query int8 + ref_col int16). This measures, on the GPU, what
that gather costs in isolation and
what the candidate reformulations buy:

  A  query[midx] + ref_col[midx]      (the current pattern)
  B  one packed int32 gather           (rc*8+q packed host-side; halves the
                                        row-descriptor count, unpack = 2
                                        vector ops)
  C  10M-row permutation gather        (the bin-sorted-retention reorder's
                                        cost; amortizes over ~8 blocks)
  D  contiguous-range dynamic slices   (what bin-sorted retention enables:
                                        D=4 ranges x M rows per leaf)
  E  one packed int16 gather           ((rc+1)*8+q <= 16391 fits int16 since
                                        ref_len_max=2048, q in 0..4: ONE
                                        gather, 256B rows vs A's 384B)
  F  E with row-sorted indices         (ascending per leaf ~= the clustered
                                        positions bin-sorted retention would
                                        gather; measures locality benefit)

  PYTHONPATH=. python scripts/bench_member_gather.py
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from rambl_tpu.utils.cache import enable_compile_cache


def fetch(out):
    return jax.block_until_ready(out)


def timed(name, f, args_list, reps=4):
    fetch(f(*args_list[0]))
    t0 = time.time()
    outs = [f(*args_list[i % len(args_list)]) for i in range(reps)]
    for o in outs:
        fetch(o)
    dt = (time.time() - t0) / reps
    print(f"{name}: {dt * 1e3:9.1f} ms", flush=True)
    return dt


def main():
    enable_compile_cache()
    B, L = 10_000_000, 128
    NL, M, D = 512, 4096, 4
    rng = np.random.default_rng(0)
    # pass the big arrays as ARGUMENTS, never closure constants: captured
    # constants are inlined into the executable (3.8 GB per variant)
    q = jax.device_put(rng.integers(0, 5, (B, L)).astype(np.int8))
    rc = jax.device_put(rng.integers(-1, 2047, (B, L)).astype(np.int16))
    jax.block_until_ready((q, rc))
    midx0 = jnp.asarray(rng.integers(0, B, (NL, M)).astype(np.int32))
    midx1 = jnp.asarray(rng.integers(0, B, (NL, M)).astype(np.int32))
    print(f"retention {B}x{L}: query int8 + ref_col int16 "
          f"({(B * L * 3) / 1e9:.1f} GB)", flush=True)

    gA = jax.jit(lambda q, rc, mi: (jnp.sum(q[mi].astype(jnp.int32)),
                                    jnp.sum(rc[mi].astype(jnp.int32))))
    timed("A query+rc row gathers  ", gA, [(q, rc, midx0), (q, rc, midx1)])

    # B: packed single int32 gather
    packed = jax.jit(lambda rc, q: (rc.astype(jnp.int32) + 1) * 8
                     + q.astype(jnp.int32))(rc, q)
    jax.block_until_ready(packed)
    gB = jax.jit(lambda p, mi: jnp.sum(p[mi]))
    timed("B packed int32 gather   ", gB, [(packed, midx0), (packed, midx1)])

    perm0 = jnp.asarray(rng.permutation(B).astype(np.int32))
    timed("C 10M-row perm reorder  ", gA, [(q, rc, perm0)], reps=2)

    starts0 = jnp.asarray(rng.integers(0, B - M, (NL, D)).astype(np.int32))
    starts1 = jnp.asarray(rng.integers(0, B - M, (NL, D)).astype(np.int32))

    def ranges(q, rc, st):
        def leaf(s):
            sl = [jax.lax.dynamic_slice(q, (s[d], 0), (M, L))
                  for d in range(D)]
            r = [jax.lax.dynamic_slice(rc, (s[d], 0), (M, L))
                 for d in range(D)]
            return (sum(jnp.sum(x.astype(jnp.int32)) for x in sl)
                    + sum(jnp.sum(x.astype(jnp.int32)) for x in r))
        return jnp.sum(jax.lax.map(leaf, st))

    gD = jax.jit(ranges)
    timed("D contiguous range reads", gD, [(q, rc, starts0), (q, rc, starts1)])

    # E: int16 packed single gather (the production-shaped candidate:
    # (rc+1)*8+q, unpack after the member gather where blocks are small)
    packed16 = jax.jit(lambda rc, q: ((rc.astype(jnp.int32) + 1) * 8
                                      + q.astype(jnp.int32)).astype(jnp.int16)
                       )(rc, q)
    jax.block_until_ready(packed16)
    del packed
    gE = jax.jit(lambda p, mi: jnp.sum(p[mi].astype(jnp.int32)))
    timed("E packed int16 gather   ", gE, [(packed16, midx0),
                                           (packed16, midx1)])

    # F: same gather with ascending per-leaf indices - the locality the
    # bin-sorted-position formulation would give (each leaf's rows fall in
    # <=D contiguous runs; sorted random rows are the conservative model)
    midx0s = jnp.sort(midx0, axis=1)
    midx1s = jnp.sort(midx1, axis=1)
    timed("F E w/ sorted row idx   ", gE, [(packed16, midx0s),
                                           (packed16, midx1s)])

    timed("G A w/ sorted row idx   ", gA, [(q, rc, midx0s), (q, rc, midx1s)])


if __name__ == "__main__":
    main()
