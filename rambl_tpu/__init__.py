"""rambl_tpu — a full-length 16S rRNA gene assembly engine in JAX, for GPUs.

A from-scratch rebuild of the capabilities of homopolymer/RAMBL (a
Python/BWA/SAMtools pipeline; see SURVEY.md) as jitted device code:

- BWA-MEM subprocess alignment   -> hashed k-mer seeding + affine-gap
                                    Smith-Waterman (a Pallas kernel for the
                                    score pass, `rambl_tpu.ops`)
- samtools sort/index/mpileup    -> dense on-device alignment tensors + scatter-add
                                    pileup (`rambl_tpu.pipeline.consensus`)
- taxonomic binning (python)     -> vectorized LCA segment-reduce
                                    (`rambl_tpu.pipeline.binning`)
- DP-means clustering (python)   -> batched deterministic EM with cross-host psum
                                    (`rambl_tpu.pipeline.cluster`)
- single-node orchestration      -> `jax.sharding.Mesh` + `shard_map` data-parallel
                                    streaming with psum/all_gather merges
                                    (`rambl_tpu.parallel`)

The pure-NumPy oracle in `rambl_tpu.oracle` is the executable specification:
every device component must match it bit-for-bit (SURVEY.md section 4.2).
"""

__version__ = "0.1.0"

from rambl_tpu.config import PipelineConfig, ScoringParams, PRESETS  # noqa: F401
