"""Base-level diagnosis of config-4 'emitted-impure' misses (census r4).

The census says the column phasing itself is mostly PERFECT (cover 1.00,
purity 1.00) yet the emitted genes sit at ~0.80-0.88 containment, with
near-identical containment across the strains of one leaf - i.e. a SHARED
set of wrong bases per leaf. This tool loads the cached cohort state
(scripts/cache_config4_state.py) and classifies every wrong base of every
best-gene-vs-true-ref pair:

  qual-own-col       column qualified, assigned to this gene's group, minor
                     substituted - but still wrong (b2 != true base)
  qual-other-group   column qualified but its minor went to another group
                     (so this gene kept the pooled major)
  gate-depth/min_abs/frac/major-side/non-unique-2nd/cap
                     the true variant column never qualified (which gate)
  reversion-applied  a reversion group's allele was substituted here and is
                     wrong for this strain
  backbone           ref agrees with NEITHER pooled major nor any gate
                     bucket (wrong backbone base / polish effect)

Usage: JAX_PLATFORMS=cpu PYTHONPATH=. \
           python scripts/diagnose_impure.py [/tmp/c4_state.pkl]
"""

import pickle
import sys
from collections import Counter

import numpy as np

from rambl_tpu.io.pack import decode_seq
from rambl_tpu.oracle.cohort import phase_columns, qualifying_columns


def kmers(s, k=25):
    return set(s[i: i + k] for i in range(len(s) - k + 1))


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/c4_state.pkl"
    with open(path, "rb") as f:
        st = pickle.load(f)
    ds, cfg = st["ds"], st["cfg"]
    counts_list = st["counts_list"]
    geneses = [r[0] for r in st["results"]]
    n_samples = len(geneses)
    from rambl_tpu.index.taxonomy import build_taxonomy_tables

    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)

    refk = [kmers(decode_seq(ds.ref_seqs[r, : ds.ref_lens[r]]))
            for r in range(ds.n_refs)]
    cov = np.zeros(ds.n_refs)
    for tr in st["co_true_ref"]:
        cov += np.bincount(tr, minlength=ds.n_refs)
    cov = cov * 100 / ds.ref_lens
    detectable = np.nonzero(cov >= 5.0)[0]
    best = {int(r): (0.0, None) for r in detectable}
    # best gene of the ref's OWN leaf (the recovery metric assigns genes to
    # their max-overlap ref, but for diagnosis we must compare a ref against
    # a gene in ITS leaf's coordinate system)
    best_own = {int(r): (0.0, None) for r in detectable}
    for genes in geneses:
        for g in genes:
            gk = kmers(decode_seq(g.seq))
            r = max(range(ds.n_refs), key=lambda x: len(gk & refk[x]))
            if r in best:
                c = len(gk & refk[r]) / max(len(gk), 1)
                if c > best[r][0]:
                    best[r] = (c, g)
            for r2 in np.nonzero(tax.ref_taxon == int(g.taxon))[0].tolist():
                if r2 in best_own:
                    c2 = len(gk & refk[r2]) / max(len(gk), 1)
                    if c2 > best_own[r2][0]:
                        best_own[r2] = (c2, g)
    missed = [r for r, (c, _) in best.items() if c <= 0.95 and c > 0.5]
    print(f"diagnosing {len(missed)} missed refs (cont .5-.95)")
    best = best_own

    total = Counter()
    for r in missed:
        contain, g = best[r]
        if g is None:
            continue
        t = int(tax.ref_taxon[r])
        stack = np.stack([counts_list[j].get(t, np.zeros(
            (ds.ref_seqs.shape[1], 4), np.int64)).astype(np.int64)
            for j in range(n_samples)])
        cols, b1, b2, m, tt = qualifying_columns(stack, cfg)
        assign = phase_columns(m, tt, cfg) if cols.size else np.zeros(0, int)
        colset = {int(c): i for i, c in enumerate(cols.tolist())}
        pool = stack.sum(axis=0)
        tot = pool.sum(axis=1)
        srt = np.sort(pool, axis=1)
        pb1 = np.argmax(pool, axis=1)

        L = int(ds.ref_lens[r])
        rseq = ds.ref_seqs[r, :L]
        gseq = np.asarray(g.seq)
        # genes can carry interior emit holes: map gene positions onto anchor
        # columns with the SAME exact NW map the cohort emitter uses
        # (substitution-only strains share the anchor coordinate system)
        from rambl_tpu.index.colmap import _nw_map, anchor_of_leaf

        anc_r = int(anchor_of_leaf(tax.ref_taxon)[r])
        aseq = ds.ref_seqs[anc_r, : int(ds.ref_lens[anc_r])]
        gcols = _nw_map(aseq, gseq)
        pairs = [(i, int(gcols[i])) for i in range(gseq.shape[0])
                 if 0 <= int(gcols[i]) < L]
        wrong_pairs = [(i, c) for i, c in pairs if gseq[i] != rseq[c]]
        n_dropped = int((np.asarray(
            [c for _, c in pairs]) >= 0).sum()) if pairs else 0
        # this gene's own group = majority group over its correct own columns
        pos_of_col = {c: i for i, c in pairs}
        own_cols = [int(cols[ci]) for ci in range(cols.size)
                    if int(cols[ci]) in pos_of_col
                    and gseq[pos_of_col[int(cols[ci])]] == b2[ci]]
        own_groups = Counter(int(assign[colset[c]]) for c in own_cols
                             if c in colset)
        gid = own_groups.most_common(1)[0][0] if own_groups else -1
        kinds = Counter()
        for i, c in wrong_pairs:
            trueb = int(rseq[c])
            if c in colset:
                ci = colset[c]
                if int(b2[ci]) == trueb:
                    kinds["qual-other-group" if int(assign[ci]) != gid
                          else "qual-own-col"] += 1
                elif int(b1[ci]) == trueb:
                    # true base is the pooled major but the gene carries the
                    # minor here: a substitution applied that this strain
                    # does not have (own group impurity or reversion rule)
                    kinds["substituted-not-ours"] += 1
                else:
                    kinds["qual-wrong-allele"] += 1
                continue
            # not a qualifying column: which gate?
            minor = int(srt[c, -2])
            if trueb == int(pb1[c]):
                kinds["backbone"] += 1     # ref == pooled major, gene differs
            elif int(tot[c]) < cfg.min_coverage:
                kinds["gate-depth"] += 1
            elif minor < cfg.cohort_min_abs:
                kinds["gate-min_abs"] += 1
            elif minor * cfg.cohort_frac_den < cfg.cohort_frac_num * max(
                    int(tot[c]), 1):
                kinds["gate-frac"] += 1
            elif 2 * minor > int(tot[c]):
                kinds["gate-major-side"] += 1
            elif srt[c, -2] == srt[c, -3]:
                kinds["gate-non-unique-2nd"] += 1
            else:
                kinds["gate-cap/other"] += 1
        n_holes = gseq.shape[0] - len(pairs)
        missing_anchor = L - len(pairs)
        kinds["emit-holes"] = n_holes
        kinds["missing-cols"] = missing_anchor
        total.update(kinds)
        print(f"  ref {r} (leaf {t}, cont {contain:.3f}, grp {gid}): "
              f"{len(wrong_pairs)} wrong bases, {n_holes} gene-only pos, "
              f"{missing_anchor} anchor cols absent: {dict(kinds)}")
    print("TOTAL:", dict(total.most_common()))


if __name__ == "__main__":
    main()
