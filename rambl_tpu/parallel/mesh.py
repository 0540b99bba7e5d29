"""Device mesh helpers (SURVEY.md section 3.5 init stack)."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def init_distributed() -> bool:
    """Multi-host init (SURVEY.md section 3.5 init stack).

    MUST be called before ANY backend query (jax.devices / process_count /
    device_put initialize the local backend, after which
    jax.distributed.initialize is rejected) - so this function must not
    itself touch the backend before initializing. Gated on the coordinator
    env vars JAX supports (JAX_COORDINATOR_ADDRESS, or the cluster
    auto-detection when RAMBL_DISTRIBUTED=1) so single-process runs are a
    no-op. Returns True when distributed mode is active.
    """
    import os

    want = bool(os.environ.get("JAX_COORDINATOR_ADDRESS")
                or os.environ.get("RAMBL_DISTRIBUTED"))
    if not want:
        return False
    try:  # pragma: no cover - needs a real multi-host cluster
        jax.distributed.initialize()
    except RuntimeError:
        pass  # already initialized (idempotent callers)
    return True


def broadcast_host_config(payload: bytes, is_source: Optional[bool] = None) -> bytes:
    """Broadcast small host-side metadata (config JSON, index fingerprint)
    from process 0 to every process, so all hosts run the identical pipeline
    (SURVEY.md section 3.5: multihost_utils broadcast of config/index
    metadata). Single-process: identity."""
    if jax.process_count() == 1:
        return payload
    from jax.experimental import multihost_utils  # pragma: no cover

    arr = np.frombuffer(payload, np.uint8)
    n = np.asarray([arr.size], np.int32)
    n = multihost_utils.broadcast_one_to_all(n, is_source)
    buf = np.zeros(int(n[0]), np.uint8)
    if arr.size == int(n[0]):
        buf[:] = arr
    out = multihost_utils.broadcast_one_to_all(buf, is_source)
    return bytes(np.asarray(out))


def sync_host_config(cfg):
    """Adopt process 0's PipelineConfig on every process (SURVEY.md
    section 3.5: broadcast config metadata at init). Multi-host JAX is SPMD -
    a host whose flags drifted (stale launch script, different preset) would
    otherwise run a silently different pipeline until some collective shape
    mismatches. Process 0's config wins; a drift is reported loudly.
    Single-process: identity. Returns the (possibly replaced) config."""
    if jax.process_count() == 1:
        return cfg
    import sys  # pragma: no cover - exercised via fakes in tests

    from rambl_tpu.config import PipelineConfig

    payload = cfg.to_json().encode()
    got = broadcast_host_config(payload, jax.process_index() == 0)
    if got != payload:
        print(f"warning: process {jax.process_index()} config differs from "
              "process 0; adopting process 0's config", file=sys.stderr)
    return PipelineConfig.from_json(got.decode())


def assert_hosts_agree(tag: str, payload: bytes) -> None:
    """Raise if this process' payload differs from process 0's - used for
    the reference/index fingerprint: every host must consume IDENTICAL input
    data or the psum-merged pileups are garbage. No-op single-process."""
    if jax.process_count() == 1:
        return
    got = broadcast_host_config(payload, jax.process_index() == 0)
    if got != payload:
        raise ValueError(
            f"multi-host mismatch: {tag} on process {jax.process_index()} "
            "differs from process 0 (all hosts must load identical inputs)")


def data_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1D mesh over the data axis (all visible devices by default)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (DATA_AXIS,), devices=np.asarray(devices))


def shard_spec(batch_dims: int = 1) -> P:
    """PartitionSpec sharding dim 0 over 'data', rest replicated."""
    return P(DATA_AXIS, *([None] * (batch_dims - 1))) if batch_dims else P()


def put_sharded(x, mesh: Mesh):
    """device_put with dim-0 'data' sharding."""
    spec = P(DATA_AXIS, *([None] * (np.ndim(x) - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def put_replicated(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))
