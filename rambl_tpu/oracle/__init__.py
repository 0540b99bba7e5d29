"""Pure-NumPy oracle: the executable specification of the pipeline.

Every deterministic rule (scoring, tie-breaking, traceback preference,
candidate ordering, cluster spawning) is locked here; the jitted device path in
`rambl_tpu.pipeline` must reproduce these outputs bit-for-bit
(SURVEY.md section 4.2 / 7.4.1).
"""

from rambl_tpu.oracle.sw import (  # noqa: F401
    sw_scalar,
    sw_batch,
    traceback_batch,
)
