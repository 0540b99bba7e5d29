"""Assembly-quality benchmark: recovery of known truth across scenarios.

Tracks the biological quality metric over rounds of development (the driver's
perf bench tracks throughput; this tracks 'identical 16S assemblies',
BASELINE.json:5 - measured against simulated truth since the reference demo
data is unavailable, SURVEY.md section 4.3).

Metrics per scenario:
  recovered  - refs with a gene at >95% 25-mer containment, among refs with
               >=5x simulated coverage;
  mean_cont  - mean containment of each detectable ref's best matching gene;
  genes      - panel size (over-splitting indicator).

Run on CPU (oracle) or GPU (device path, --jax).
"""

import sys

import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.data.simulate import simulate_dataset
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.io.pack import decode_seq

SCENARIOS = [
    # name, kwargs
    ("uniform-2strain", dict(n_species=5, refs_per_species=2, n_reads=1500,
                             seed=1, skewed_abundance=False)),
    ("skewed-2strain", dict(n_species=5, refs_per_species=2, n_reads=1500,
                            seed=2, skewed_abundance=True)),
    ("single-strain", dict(n_species=8, refs_per_species=1, n_reads=2000,
                           seed=3, skewed_abundance=False)),
    ("deep-uniform", dict(n_species=3, refs_per_species=1, n_reads=3000,
                          seed=4, skewed_abundance=False)),
]


def kmers(s, k=25):
    return set(s[i : i + k] for i in range(len(s) - k + 1))


def main():
    use_jax = "--jax" in sys.argv
    if use_jax:
        from rambl_tpu.pipeline.assemble import assemble_jax as assemble
    else:
        from rambl_tpu.oracle.pipeline import assemble

    cfg = PipelineConfig(max_assembly_iters=4, batch_size=512)
    total_rec = total_det = 0
    for name, kw in SCENARIOS:
        ds = simulate_dataset(**kw)
        tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
        res = assemble(ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax, cfg)
        refk = [kmers(decode_seq(ds.ref_seqs[r, : ds.ref_lens[r]]))
                for r in range(ds.n_refs)]
        cov = np.bincount(ds.true_ref, minlength=ds.n_refs) * 100 / ds.ref_lens
        detectable = np.nonzero(cov >= 5)[0]
        best_cont = {int(r): 0.0 for r in detectable}
        for g in res.genes:
            gk = kmers(decode_seq(g.seq))
            best = max(range(ds.n_refs), key=lambda r: len(gk & refk[r]))
            c = len(gk & refk[best]) / max(len(gk), 1)
            if best in best_cont:
                best_cont[best] = max(best_cont[best], c)
        rec = sum(1 for c in best_cont.values() if c > 0.95)
        mc = np.mean(list(best_cont.values())) if best_cont else 0.0
        total_rec += rec
        total_det += len(detectable)
        print(f"{name:18s}: recovered {rec}/{len(detectable)} "
              f"mean_cont {mc:.3f} genes {len(res.genes)} "
              f"rounds {res.n_rounds} conv {res.converged}", flush=True)
    print(f"TOTAL recovered {total_rec}/{total_det}")


if __name__ == "__main__":
    main()
