"""Run the config-4 cohort once and pickle every intermediate the impure-gene
diagnosis needs (scripts/diagnose_impure.py iterates on the cached state
instead of re-running the ~20 min CPU cohort assembly each time).

Usage: JAX_PLATFORMS=cpu PYTHONPATH=. \
           python scripts/cache_config4_state.py [out.pkl]
"""

import pickle
import sys
import time

from rambl_tpu.config import PipelineConfig
from rambl_tpu.data.simulate import simulate_cohort
from rambl_tpu.index.builder import build_seed_index
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.pipeline.assemble import assemble_cohort, leaf_counts_dict


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/c4_state.pkl"
    n_species, n_samples = 8, 5
    reads_per_sample = n_species * 640
    co = simulate_cohort(n_species=n_species, refs_per_species=5,
                         n_samples=n_samples,
                         reads_per_sample=reads_per_sample, seed=11)
    ds = co.ds
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    cfg = PipelineConfig(max_assembly_iters=4, batch_size=2048, max_genes=128,
                         sw_rows=104)
    t0 = time.time()
    results = assemble_cohort(co.samples, ds.ref_seqs, ds.ref_lens, tax, cfg)
    print(f"cohort assembly: {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    shared_index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    import numpy as np

    taxa = np.unique(tax.ref_taxon)
    counts_list = [
        leaf_counts_dict(reads, lens, ds.ref_seqs, ds.ref_lens, tax, cfg,
                         taxa=taxa, shared_index=shared_index)
        for reads, lens in co.samples
    ]
    print(f"leaf counts: {time.time() - t0:.0f}s", flush=True)
    with open(out, "wb") as f:
        pickle.dump(dict(
            co_true_ref=co.true_ref, samples=co.samples,
            ds=ds, cfg=cfg,
            results=[(list(r.genes),) for r in results],
            counts_list=counts_list,
            tax_parent=ds.tax_parent, tax_depth=ds.tax_depth,
            ref_taxon_nodes=ds.ref_taxon,
        ), f)
    print(f"state -> {out}")


if __name__ == "__main__":
    main()
