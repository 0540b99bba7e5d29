"""Host-only builder for the config-3/5 dataset+index caches (no device use).

The scale runs (run_config3.py / run_config5.py) spend ~15 min on
deterministic host work (10-20M-read simulation + 150M-entry index build)
before touching the chip; this script produces exactly the pickles they
look for so that a scale run can start on the GPU immediately. Run it in the
background while the GPU is busy with something else (one JAX process per
card - this one never initializes a backend).

  PYTHONPATH=. python scripts/build_scale_caches.py [config3|config5|both]
"""

import os
import pickle
import sys
import time

import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.data.simulate import _gen_reads, simulate_dataset
from rambl_tpu.index.builder import build_seed_index

_GEN_V = 3  # v3: scrambled within-bucket entry order (unbiased capped scans)


def build_config3(n_reads=10_000_000, n_refs=100_000):
    k = PipelineConfig().k
    cache = f"/tmp/config3_cache_{n_reads}_{n_refs}_k{k}_v{_GEN_V}_seed13.pkl"
    if os.path.exists(cache):
        print(f"config3 cache exists: {cache}", flush=True)
        return
    t0 = time.time()
    ds = simulate_dataset(
        n_species=n_refs // 5, refs_per_species=5, n_reads=n_reads,
        seed=13, leaf_per_ref=True, n_present=500,
    )
    print(f"config3 dataset in {time.time() - t0:.0f}s", flush=True)
    t1 = time.time()
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=k)
    print(f"config3 index ({index.n_entries} entries) in "
          f"{time.time() - t1:.0f}s", flush=True)
    with open(cache + ".tmp", "wb") as f:
        pickle.dump((ds, index), f, protocol=4)
    os.rename(cache + ".tmp", cache)
    print(f"wrote {cache} ({os.path.getsize(cache) / 1e9:.1f} GB)", flush=True)


def build_config5(n_reads=20_000_000, n_refs=100_000):
    k = PipelineConfig().k
    cache = f"/tmp/config5_cache_{n_reads}_{n_refs}_k{k}_v{_GEN_V}_seed13.pkl"
    if os.path.exists(cache):
        print(f"config5 cache exists: {cache}", flush=True)
        return
    t0 = time.time()
    ds = simulate_dataset(
        n_species=n_refs // 5, refs_per_species=5, n_reads=1, seed=13,
        leaf_per_ref=True, n_present=500,
    )
    chunk = 5_000_000
    reads = np.empty((n_reads, 128), np.int8)
    lens = np.empty((n_reads,), np.int32)
    for i, lo in enumerate(range(0, n_reads, chunk)):
        hi = min(lo + chunk, n_reads)
        rng = np.random.default_rng(977 + 13 * i)
        r, l, _, _, _ = _gen_reads(rng, ds.ref_seqs, ds.ref_lens,
                                   ds.abundance, hi - lo, 100, 128,
                                   0.004, 0.0005)
        reads[lo:hi] = r
        lens[lo:hi] = l
        print(f"config5 reads {hi}/{n_reads} at {time.time() - t0:.0f}s",
              flush=True)
    t1 = time.time()
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=k)
    print(f"config5 index in {time.time() - t1:.0f}s", flush=True)
    with open(cache + ".tmp", "wb") as f:
        pickle.dump((ds, reads, lens, index), f, protocol=4)
    os.rename(cache + ".tmp", cache)
    print(f"wrote {cache} ({os.path.getsize(cache) / 1e9:.1f} GB)", flush=True)


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "both"
    if what in ("config3", "both"):
        build_config3()
    if what in ("config5", "both"):
        build_config5()
