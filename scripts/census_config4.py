"""Config-4 miss census (VERDICT r2 #5): classify every strain the cohort
covariation phasing fails to recover at the wall shape.

For each detectable-but-missed strain, decide WHERE the pipeline lost it:

  no-backbone        leaf produced no gene at all (nothing to phase onto)
  few-true-cols      the strain simply has < cohort_min_cols private-minor
                     columns in the pooled pileup (information-theoretically
                     invisible to column phasing)
  cols-not-qualifying its private columns exist but fail the qualifying
                     gates (depth / min_abs / frac / unique-second / <=1/2),
                     with a breakdown of which gate
  grouped-wrongly    columns qualify but phase_columns splits them across
                     groups or merges them with another strain's
  emitted-low-support a clean group existed but per-sample support stayed
                     below min_cluster_reads everywhere
  emitted-impure     a gene was emitted from its group but containment < .95
                     (wrong bases: backbone errors / reversion handling)

Strains in the cohort simulator are SNP-only mutants of the species lineage
(data/simulate.py scale=0.15 substitutions), so strain coordinates == anchor
pileup coordinates and truth columns are directly comparable.

Usage: PYTHONPATH=. python scripts/census_config4.py
       [n_species] [n_samples] [reads_per_sample]
"""

from __future__ import annotations

import dataclasses
import sys
import time
from collections import Counter

import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.data.simulate import simulate_cohort
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.io.pack import decode_seq
from rambl_tpu.oracle.cohort import phase_columns, qualifying_columns


def kmers(s, k=25):
    return set(s[i: i + k] for i in range(len(s) - k + 1))


def main():
    n_species = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    n_samples = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    reads_per_sample = (int(sys.argv[3]) if len(sys.argv) > 3
                        else n_species * 640)
    co = simulate_cohort(n_species=n_species, refs_per_species=5,
                         n_samples=n_samples,
                         reads_per_sample=reads_per_sample, seed=11)
    ds = co.ds
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    cfg = PipelineConfig(max_assembly_iters=4, batch_size=2048, max_genes=128,
                         sw_rows=104)

    from rambl_tpu.index.builder import build_seed_index
    from rambl_tpu.pipeline.assemble import assemble_cohort, leaf_counts_dict

    t0 = time.time()
    results = assemble_cohort(co.samples, ds.ref_seqs, ds.ref_lens, tax, cfg)
    print(f"cohort assembly: {time.time() - t0:.0f}s", flush=True)

    # detectability + best containment per ref
    refk = [kmers(decode_seq(ds.ref_seqs[r, : ds.ref_lens[r]]))
            for r in range(ds.n_refs)]
    cov = np.zeros(ds.n_refs)
    for tr in co.true_ref:
        cov += np.bincount(tr, minlength=ds.n_refs)
    cov = cov * 100 / ds.ref_lens
    detectable = np.nonzero(cov >= 5.0)[0]
    best = {int(r): 0.0 for r in detectable}
    for res in results:
        for g in res.genes:
            gk = kmers(decode_seq(g.seq))
            r = max(range(ds.n_refs), key=lambda x: len(gk & refk[x]))
            if r in best:
                best[r] = max(best[r], len(gk & refk[r]) / max(len(gk), 1))
    rec = [r for r, c in best.items() if c > 0.95]
    missed = [r for r, c in best.items() if c <= 0.95]
    print(f"recovered {len(rec)}/{len(detectable)}; census of {len(missed)} "
          f"misses:", flush=True)

    # reproduce the phasing inputs (deterministic)
    shared_index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    taxa = np.unique(tax.ref_taxon)
    counts_list = [
        leaf_counts_dict(reads, lens, ds.ref_seqs, ds.ref_lens, tax, cfg,
                         taxa=taxa, shared_index=shared_index)
        for reads, lens in co.samples
    ]
    leaf_genes = Counter()
    for res in results:
        for g in res.genes:
            leaf_genes[int(g.taxon)] += 1

    buckets = Counter()
    for r in missed:
        t = int(tax.ref_taxon[r])
        stack = np.stack([counts_list[j].get(t, np.zeros(
            (ds.ref_seqs.shape[1], 4), np.int64)).astype(np.int64)
            for j in range(n_samples)])
        if leaf_genes[t] == 0:
            buckets["no-backbone"] += 1
            print(f"  ref {r} (leaf {t}, cov {cov[r]:5.1f}x, cont "
                  f"{best[r]:.3f}): no-backbone", flush=True)
            continue
        cols, b1, b2, m, tt = qualifying_columns(stack, cfg)
        pool = stack.sum(axis=0)
        tot = pool.sum(axis=1)
        pb1 = np.argmax(pool, axis=1)
        L = int(ds.ref_lens[r])
        rseq = ds.ref_seqs[r, :L]
        # the strain's private-minor truth columns: base differs from the
        # pooled major where there is depth
        tv = np.nonzero((rseq != pb1[:L]) & (tot[:L] > 0))[0]
        if tv.size < max(1, cfg.cohort_min_cols):
            buckets["few-true-cols"] += 1
            print(f"  ref {r} (leaf {t}, cov {cov[r]:5.1f}x, cont "
                  f"{best[r]:.3f}): few-true-cols ({tv.size})", flush=True)
            continue
        colset = {int(c): i for i, c in enumerate(cols.tolist())}
        qual_r = [c for c in tv.tolist()
                  if c in colset and int(b2[colset[c]]) == int(rseq[c])]
        if len(qual_r) < max(1, cfg.cohort_min_cols):
            # which gate killed the non-qualifying truth columns?
            gates = Counter()
            srt = np.sort(pool, axis=1)
            for c in tv.tolist():
                if c in colset:
                    gates["qual-but-other-allele"] += 1
                    continue
                minor = srt[c, -2]
                if tot[c] < cfg.min_coverage:
                    gates["depth"] += 1
                elif minor < cfg.cohort_min_abs:
                    gates["min_abs"] += 1
                elif minor * cfg.cohort_frac_den < cfg.cohort_frac_num * max(
                        int(tot[c]), 1):
                    gates["frac"] += 1
                elif 2 * minor > tot[c]:
                    gates["major-side"] += 1
                elif srt[c, -2] == srt[c, -3]:
                    gates["non-unique-2nd"] += 1
                else:
                    gates["cap/other"] += 1
            buckets["cols-not-qualifying"] += 1
            print(f"  ref {r} (leaf {t}, cov {cov[r]:5.1f}x, cont "
                  f"{best[r]:.3f}): cols-not-qualifying "
                  f"(true {tv.size}, qual {len(qual_r)}; gates "
                  f"{dict(gates)})", flush=True)
            continue
        assign = phase_columns(m, tt, cfg)
        gids = [int(assign[colset[c]]) for c in qual_r]
        gcnt = Counter(gids)
        g_best, g_hits = gcnt.most_common(1)[0]
        own = np.nonzero(assign == g_best)[0]
        purity = g_hits / max(own.size, 1)
        coverage = g_hits / len(qual_r)
        supp = np.sort(m[own], axis=0)[(own.size - 1) // 2]
        if coverage < 0.6 or purity < 0.6:
            buckets["grouped-wrongly"] += 1
            print(f"  ref {r} (leaf {t}, cov {cov[r]:5.1f}x, cont "
                  f"{best[r]:.3f}): grouped-wrongly (qual {len(qual_r)}, "
                  f"best grp {g_best}: cover {coverage:.2f} purity "
                  f"{purity:.2f}, grp sizes {dict(gcnt)})", flush=True)
        elif int(supp.max(initial=0)) < cfg.min_cluster_reads:
            buckets["emitted-low-support"] += 1
            print(f"  ref {r} (leaf {t}, cov {cov[r]:5.1f}x, cont "
                  f"{best[r]:.3f}): emitted-low-support (max/sample "
                  f"{int(supp.max(initial=0))})", flush=True)
        else:
            buckets["emitted-impure"] += 1
            print(f"  ref {r} (leaf {t}, cov {cov[r]:5.1f}x, cont "
                  f"{best[r]:.3f}): emitted-impure (cover {coverage:.2f} "
                  f"purity {purity:.2f}, own {own.size} cols)", flush=True)

    print("census:", dict(buckets), flush=True)


if __name__ == "__main__":
    main()
