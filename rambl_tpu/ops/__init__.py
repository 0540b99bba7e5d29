"""Device ops: the jitted replacement for BWA/samtools' C hot loops.

Two implementation tiers share one interface and bit-identical semantics:

- `rambl_tpu.ops.sw` / `seed`: pure-jnp (lax.scan) versions that compile on
  any backend - the CPU test tier, and on every platform the dirs-emitting
  second SW pass;
- `rambl_tpu.ops.sw_pallas`: the hand-written Pallas kernel (Triton route)
  for the SW score pass on a GPU.

`rambl_tpu.pipeline.align.score_fn` picks the score pass by platform.
"""

from rambl_tpu.ops.sw import sw_score, sw_align, sw_traceback  # noqa: F401
from rambl_tpu.ops.seed import seed_candidates_jax  # noqa: F401
