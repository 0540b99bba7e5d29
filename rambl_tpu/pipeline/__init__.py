"""Jitted pipeline stages (single-chip and shard_map distributed).

Mirrors rambl_tpu.oracle stage for stage with bit-identical outputs; the
oracle is the spec, this package is the device execution path
(SURVEY.md section 3.4 target stack).
"""

from rambl_tpu.pipeline.align import (  # noqa: F401
    align_batch,
    AlignRecords,
    mapping_quality,
)
