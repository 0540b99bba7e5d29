"""Demonstrate which residual config-4 wrong bases are information-
theoretically invisible to cross-sample column-frequency phasing
(VERDICT r4 next-round #5 "done" clause).

For every wrong base of every missed strain (cached state from
scripts/cache_config4_state.py), decide what a PERFECT column-frequency
method could have done:

  invisible/minor-is-not-true   the column's pooled second allele is not the
                                strain's true base: NO method that assigns
                                the pooled minor to a group can emit the
                                true base here (only read-level linkage
                                could), regardless of grouping quality
  invisible/not-qualifying      the true variant column never met the
                                qualifying gates (pooled depth / min_abs /
                                frac): the variant is statistically
                                indistinguishable from sequencing error at
                                cohort scale
  ambiguous/group-margin        column qualified with the right minor but
                                its frequency vector is AT LEAST AS CLOSE
                                (exact chi-square) to the group it joined
                                as to the strain's own emitting group: the
                                assignment is ambiguous under any
                                vector-distance rule
  fixable/group-margin          the vector is strictly closer to the
                                strain's own group than to the joined one:
                                a better grouping pass could fix this base
  linkage-only/reversion        a reversion substitution that is wrong for
                                this strain: deciding which strains carry a
                                dominant's private allele needs read-level
                                linkage, which pileup phasing does not have

Usage: JAX_PLATFORMS=cpu PYTHONPATH=. \
           python scripts/demonstrate_c4_ambiguity.py [/tmp/c4_state_r5.pkl]
"""

import pickle
import sys
from collections import Counter

import numpy as np

from rambl_tpu.index.colmap import _nw_map
from rambl_tpu.io.pack import decode_seq
from rambl_tpu.oracle.cohort import (
    _group_dist,
    _pick_backbone,
    cohort_genes_for_leaf,
    phase_columns,
    qualifying_columns,
)
from rambl_tpu.oracle.polish import anchor_seqs_of


def kmers(s, k=25):
    return set(s[i: i + k] for i in range(len(s) - k + 1))


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/c4_state_r5.pkl"
    with open(path, "rb") as f:
        st = pickle.load(f)
    ds, cfg = st["ds"], st["cfg"]
    counts_list = st["counts_list"]
    geneses = [r[0] if isinstance(r, tuple) else r.genes
               for r in st["results"]]
    from rambl_tpu.index.taxonomy import build_taxonomy_tables

    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    anchors = anchor_seqs_of(ds.ref_seqs, ds.ref_lens, tax.ref_taxon)
    ref_taxon = np.asarray(ds.ref_taxon)
    S = len(counts_list)

    # detectable refs + their best phased gene (same scoring as run_config4)
    cov = np.zeros(ds.n_refs)
    for s in range(S):
        pass
    total = Counter()
    for r in range(ds.n_refs):
        if ds.abundance[r] <= 0:
            continue
        t = int(ref_taxon[r])
        stack = np.stack([counts_list[s][t] for s in range(S)])
        bb = _pick_backbone(geneses, t)
        if bb is None:
            continue
        genes = cohort_genes_for_leaf(stack, bb, anchors[t], cfg)
        if not genes:
            continue
        ref = np.asarray(ds.ref_seqs[r, : ds.ref_lens[r]])
        refk = kmers(decode_seq(ref))
        scored = [(len(kmers(decode_seq(seq)) & refk)
                   / max(len(kmers(decode_seq(seq))), 1), seq, g)
                  for seq, off, sup, g in genes]
        cont, seq, grp = max(scored, key=lambda x: x[0])
        if cont >= 0.95 or cont < 0.5:
            continue
        # wrong bases in anchor coordinates
        aseq = anchors[t]
        gm = _nw_map(aseq, seq)
        rm = _nw_map(aseq, ref)
        ref_at = {int(c): int(ref[i]) for i, c in enumerate(rm) if c >= 0}
        cols, b1, b2, m, tt = qualifying_columns(stack, cfg)
        assign = phase_columns(m, tt, cfg)
        col_ix = {int(c): i for i, c in enumerate(cols.tolist())}
        # the strain's own emitting group = grp (the best gene's group)
        per = Counter()
        for i, c in enumerate(gm.tolist()):
            if c < 0 or c not in ref_at:
                continue
            if int(seq[i]) == ref_at[c]:
                continue
            # wrong base at anchor column c
            ci = col_ix.get(c)
            if ci is None:
                per["invisible/not-qualifying"] += 1
                continue
            if int(b2[ci]) != ref_at[c] and int(b1[ci]) != ref_at[c]:
                per["invisible/minor-is-not-true"] += 1
                continue
            g_joined = int(assign[ci])
            if g_joined == grp and int(b2[ci]) == ref_at[c]:
                # has the right minor in the right group yet wrong: a
                # reversion substitution overwrote it
                per["linkage-only/reversion"] += 1
                continue
            # distance of this column to its joined group vs the strain's
            # emitting group (leave-own-out where applicable)
            def dist_to(g):
                sel = assign == g
                M = m[sel].sum(axis=0).astype(np.int64)
                T = tt[sel].sum(axis=0).astype(np.int64)
                if g == g_joined:
                    M = M - m[ci]
                    T = T - tt[ci]
                if int(T.sum()) == 0:
                    return None
                return _group_dist(m[ci].astype(np.int64),
                                   tt[ci].astype(np.int64), M, T,
                                   cfg.cohort_min_depth)
            d_own = dist_to(grp)
            d_joined = dist_to(g_joined)
            if d_own is None or d_joined is None:
                per["ambiguous/group-margin"] += 1
            elif d_joined <= d_own:
                per["ambiguous/group-margin"] += 1
            else:
                per["fixable/group-margin"] += 1
        if per:
            print(f"ref {r} leaf {t} cont {cont:.3f}: {dict(per)}",
                  flush=True)
            total.update(per)
    print("\nTOTAL:", dict(total), flush=True)
    n_fix = total.get("fixable/group-margin", 0)
    n_all = sum(total.values())
    print(f"{n_all - n_fix}/{n_all} residual wrong bases are invisible or "
          f"ambiguous to column-frequency phasing; {n_fix} are potentially "
          f"fixable by a better grouping pass", flush=True)


if __name__ == "__main__":
    main()
