"""Config-4 quality run: multi-sample cohort with cross-sample covariation
phasing (BASELINE.json config 4).

The scenario is the measured single-sample WALL shape (SURVEY.md section 8 /
scripts/run_config2.py): 5 strains per species leaf at ~40x per-sample leaf
depth with lognormal abundances - single-sample frequency phasing recovers
essentially only dominant strains (19/100 at config-2 scale; a frequency-band
generalization was prototyped, measured useless, and removed). Here the SAME
community is sequenced in N samples whose strain abundances vary per sample,
and cohort covariation phasing (oracle/cohort.py) clusters variant columns by
their cross-sample frequency vectors.

Reports per-mode recovery (refs with a gene at >95% 25-mer containment among
detectable refs) for: each sample alone (the wall), cohort WITHOUT phasing
(same thing, shared index), cohort WITH phasing.

Usage: PYTHONPATH=. python scripts/run_config4.py
       [n_species] [n_samples] [reads_per_sample]
"""

import sys
import time

import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.data.simulate import simulate_cohort
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.io.pack import decode_seq


def kmers(s, k=25):
    return set(s[i: i + k] for i in range(len(s) - k + 1))


def recovery(ds, results, cov_min=5.0, true_refs=None):
    refk = [kmers(decode_seq(ds.ref_seqs[r, : ds.ref_lens[r]]))
            for r in range(ds.n_refs)]
    # detectable = refs with >= cov_min x coverage pooled over the cohort
    cov = np.zeros(ds.n_refs)
    for tr in true_refs:
        cov += np.bincount(tr, minlength=ds.n_refs)
    cov = cov * 100 / ds.ref_lens
    detectable = np.nonzero(cov >= cov_min)[0]
    best = {int(r): 0.0 for r in detectable}
    for res in results:
        for g in res.genes:
            gk = kmers(decode_seq(g.seq))
            r = max(range(ds.n_refs), key=lambda x: len(gk & refk[x]))
            if r in best:
                best[r] = max(best[r], len(gk & refk[r]) / max(len(gk), 1))
    rec = sum(1 for c in best.values() if c > 0.95)
    return rec, len(detectable), float(np.mean(list(best.values()) or [0.0]))


def main():
    n_species = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    n_samples = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    reads_per_sample = (int(sys.argv[3]) if len(sys.argv) > 3
                        else n_species * 640)   # ~40x leaf depth per sample
    co = simulate_cohort(n_species=n_species, refs_per_species=5,
                         n_samples=n_samples,
                         reads_per_sample=reads_per_sample, seed=11)
    ds = co.ds
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    cfg = PipelineConfig(max_assembly_iters=4, batch_size=2048, max_genes=128)
    import dataclasses

    from rambl_tpu.pipeline.assemble import assemble_cohort

    t0 = time.time()
    res_off = assemble_cohort(co.samples, ds.ref_seqs, ds.ref_lens, tax,
                              dataclasses.replace(cfg, cohort_phase=False))
    t_off = time.time() - t0
    rec0, det, mc0 = recovery(ds, res_off, true_refs=co.true_ref)
    print(f"cohort WITHOUT phasing: {rec0}/{det} recovered "
          f"(mean cont {mc0:.3f})  [{t_off:.0f}s]", flush=True)

    t0 = time.time()
    res_on = assemble_cohort(co.samples, ds.ref_seqs, ds.ref_lens, tax, cfg)
    t_on = time.time() - t0
    rec1, det, mc1 = recovery(ds, res_on, true_refs=co.true_ref)
    print(f"cohort WITH phasing:    {rec1}/{det} recovered "
          f"(mean cont {mc1:.3f})  [{t_on:.0f}s]", flush=True)
    print(f"phasing overhead: {t_on - t_off:+.0f}s; "
          f"genes/sample {[len(r.genes) for r in res_on]}")


if __name__ == "__main__":
    main()
