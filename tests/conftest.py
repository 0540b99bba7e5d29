"""Test configuration: force an 8-device CPU JAX backend.

Per SURVEY.md section 4.2, every shard_map/psum/ring path is exercised on fake
CPU devices (`--xla_force_host_platform_device_count=8`); GPU runs happen via
chip_smoke.py and bench.py, not pytest. The one exception is the `gpu` marker:
tests that need the card skip here and run on a GPU machine with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`.

Env vars must be set before jax is imported anywhere, hence this conftest.
"""

import os

# the CPU unless the caller names platforms (JAX_PLATFORMS=cuda,cpu for the
# gpu-marked tests)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from rambl_tpu.config import PipelineConfig  # noqa: E402
from rambl_tpu.data.simulate import simulate_dataset  # noqa: E402
from rambl_tpu.index.builder import build_seed_index  # noqa: E402
from rambl_tpu.index.taxonomy import build_taxonomy_tables  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. Decided
    here, at run time, never at import (every xdist worker must collect the
    same tests)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU "
                    "(JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu)")
    return devs[0]


@pytest.fixture(scope="session")
def cfg():
    return PipelineConfig()


@pytest.fixture(scope="session")
def small_ds():
    """Small mock community shared across tests (5 species x 2 strains)."""
    return simulate_dataset(
        n_species=5, refs_per_species=2, n_reads=600, seed=1, skewed_abundance=False
    )


@pytest.fixture(scope="session")
def small_index(small_ds, cfg):
    return build_seed_index(small_ds.ref_seqs, small_ds.ref_lens, k=cfg.k)


@pytest.fixture(scope="session")
def small_tax(small_ds):
    return build_taxonomy_tables(
        small_ds.tax_parent, small_ds.tax_depth, small_ds.ref_taxon
    )
