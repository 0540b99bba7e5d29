"""Driver config 2: small mock community, ~20 taxa, 1M reads, single host.

Runs the full device assembly end-to-end on the local GPU and reports
wall-clock, reads/s, genes assembled/hour and truth recovery.
"""

import sys
import time

import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.data.simulate import simulate_dataset
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.io.pack import decode_seq
from rambl_tpu.pipeline.assemble import assemble_jax


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    t0 = time.time()
    ds = simulate_dataset(
        n_species=20, refs_per_species=5, n_reads=n_reads, seed=7,
    )
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    print(f"simulated {n_reads} reads vs {ds.n_refs} refs in "
          f"{time.time() - t0:.0f}s", flush=True)

    import os

    # 100 refs x (variant + minorhap) genes saturate 128 (recovery-capped)
    max_genes = int(os.environ.get("RAMBL_MAX_GENES", "256"))
    cfg = PipelineConfig(batch_size=16384, max_genes=max_genes,
                         max_clusters_per_bin=8, max_assembly_iters=4,
                         sw_rows=104)
    t1 = time.time()
    res = assemble_jax(ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens,
                       tax, cfg)
    wall = time.time() - t1
    for s in res.round_stats:
        print(s, flush=True)

    def kmers(s, k=25):
        return set(s[i : i + k] for i in range(len(s) - k + 1))

    refk = [kmers(decode_seq(ds.ref_seqs[r, : ds.ref_lens[r]]))
            for r in range(ds.n_refs)]
    recovered = set()
    for g in res.genes:
        gk = kmers(decode_seq(g.seq))
        best = max(range(ds.n_refs), key=lambda r: len(gk & refk[r]))
        cont = len(gk & refk[best]) / max(len(gk), 1)
        if cont > 0.95:
            recovered.add(best)
    n_full = len(res.full_length(cfg))
    aligns = sum(s.get("aligned", 0) for s in res.round_stats)
    print(f"wall {wall:.0f}s | rounds {res.n_rounds} converged {res.converged}")
    print(f"genes {len(res.genes)} full-length {n_full} "
          f"recovered>{95}% {len(recovered)}/{ds.n_refs}")
    print(f"effective alignment throughput {aligns / wall:.0f} reads/s "
          f"(incl all stages)")
    print(f"genes assembled/hour {len(res.genes) / (wall / 3600):.0f}")


if __name__ == "__main__":
    main()
