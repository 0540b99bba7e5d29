"""Measure PP H2D overlap at config-3 batch size (VERDICT r3 weak #6).

SURVEY.md section 8 marks PP (stage pipelining) as partial: the stream
prefetches batch i+1's H2D transfer (async device_put) while batch i's align
executes, and the claim "device-side double buffering is not needed at
current occupancy" had no recorded measurement. This benchmark produces that
measurement at the config-3 shape (batch 16000 x 128 int8 reads over
PCIe):

  resident : reads already on device - align-only upper bound (no H2D at all)
  prefetch : the production pattern (_stream_align: put batch i+1, then
             dispatch batch i)
  inline   : device_put immediately before each dispatch (no overlap window)

If prefetch ~= resident, the H2D transfer is fully hidden behind align
compute and device-side double buffering would buy nothing. If prefetch is
materially slower than resident but faster than inline, the overlap window
is too short and a device-side double buffer is the next lever.

Usage: PYTHONPATH=. \
           python scripts/bench_h2d_overlap.py [batch] [n_batches]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.data.simulate import toy_dataset
from rambl_tpu.index.builder import build_seed_index
from rambl_tpu.index.colmap import build_col_maps
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.ops.seed import SeedTable
from rambl_tpu.pipeline.assemble import _align_bin_batch
from rambl_tpu.utils.cache import enable_compile_cache


def fetch(out):
    return np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:4].sum()


def main():
    enable_compile_cache()
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16000
    nb = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    cfg = PipelineConfig(batch_size=batch, sw_rows=104)
    ds = toy_dataset(n_reads=batch * nb)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    table = SeedTable.from_index(index)
    refs = jnp.asarray(ds.ref_seqs)
    rt = jnp.asarray(tax.ref_taxon)
    anc = jnp.asarray(tax.anc_path)
    dep = jnp.asarray(tax.depth)
    cmap = jnp.asarray(build_col_maps(ds.ref_seqs, ds.ref_lens,
                                      tax.ref_taxon))

    def step(r, l):
        return _align_bin_batch(r, l, table.bucket_start, table.entries,
                                refs, rt, anc, dep, cmap, cfg, index.n_bits)

    host = [(ds.reads[i * batch:(i + 1) * batch],
             ds.read_lens[i * batch:(i + 1) * batch]) for i in range(nb)]
    mb = batch * host[0][0].shape[1] / 1e6
    print(f"batch {batch} x {nb} batches, {mb:.1f} MB int8 reads per batch")

    # compile + warm
    fetch(step(jax.device_put(host[0][0]), jax.device_put(host[0][1])))

    def run_resident():
        dev = [(jax.device_put(r), jax.device_put(l)) for r, l in host]
        for r, l in dev:
            jax.block_until_ready(r)
        t0 = time.time()
        outs = [step(r, l) for r, l in dev]
        for o in outs:
            fetch(o)
        return time.time() - t0

    def run_prefetch():
        t0 = time.time()
        nxt = (jax.device_put(host[0][0]), jax.device_put(host[0][1]))
        outs = []
        for i in range(nb):
            cur, nxt = nxt, ((jax.device_put(host[i + 1][0]),
                              jax.device_put(host[i + 1][1]))
                             if i + 1 < nb else None)
            outs.append(step(*cur))
        for o in outs:
            fetch(o)
        return time.time() - t0

    def run_inline():
        t0 = time.time()
        outs = []
        for r, l in host:
            rd, ld = jax.device_put(r), jax.device_put(l)
            jax.block_until_ready(rd)       # close the overlap window
            outs.append(step(rd, ld))
        for o in outs:
            fetch(o)
        return time.time() - t0

    for name, fn in (("resident", run_resident), ("prefetch", run_prefetch),
                     ("inline", run_inline)):
        best = min(fn() for _ in range(3))
        print(f"  {name:9s}: {best:6.2f}s total = "
              f"{best / nb * 1000:7.1f} ms/batch "
              f"({batch * nb / best:.0f} reads/s)")


if __name__ == "__main__":
    main()
