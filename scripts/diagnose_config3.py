"""Classify the config-3 misses (VERDICT r4 weak #6 / next-round #5).

Loads the panel dumped by run_config3.py (/tmp/config3_genes.pkl) plus the
dataset cache and, for every detectable-but-missed reference, reports what
the panel DOES hold for its taxon: best gene containment, wrong-base count
and positions (via the exact NW map onto the ref), gene length vs ref
length, and the sibling-strain containment (is the miss a phasing error -
the gene matches the OTHER strain of the same species?).

  PYTHONPATH=. python scripts/diagnose_config3.py
"""

import pickle
import sys
from collections import Counter

import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.index.colmap import _nw_map_batch
from rambl_tpu.io.pack import decode_seq


def kmers(s, k=25):
    return set(s[i: i + k] for i in range(len(s) - k + 1))


def main():
    genes_path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/config3_genes.pkl"
    with open(genes_path, "rb") as f:
        st = pickle.load(f)
    genes, recovered, detectable = st["genes"], st["recovered"], st["detectable"]
    k = PipelineConfig().k
    cache = f"/tmp/config3_cache_10000000_100000_k{k}_v3_seed13.pkl"
    with open(cache, "rb") as f:
        ds, _ = pickle.load(f)

    missed = [int(r) for r in detectable if int(r) not in recovered]
    print(f"{len(missed)} missed / {detectable.size} detectable", flush=True)
    by_taxon = {}
    for g in genes:
        by_taxon.setdefault(int(g.taxon), []).append(g)
    # ref -> taxon (leaf_per_ref: identity-ish, but use the mapping)
    ref_taxon = np.asarray(ds.ref_taxon)

    classes = Counter()
    rows = []
    nw_jobs = []
    for r in missed:
        t = int(ref_taxon[r])
        ref = np.asarray(ds.ref_seqs[r, : ds.ref_lens[r]])
        refk = kmers(decode_seq(ref))
        cands = by_taxon.get(t, [])
        if not cands:
            classes["no-gene-for-taxon"] += 1
            rows.append((r, t, None, 0.0, None))
            continue
        best, cont = None, -1.0
        for g in cands:
            gk = kmers(decode_seq(g.seq))
            c = len(gk & refk) / max(len(gk), 1)
            if c > cont:
                best, cont = g, c
        rows.append((r, t, best, cont, ref))
        nw_jobs.append((len(rows) - 1, ref, best.seq))

    # polish evidence, if the run dumped it (slot-compacted round-0
    # leaf-exclusive pileups): classify every wrong base by WHY the polish
    # override did not (or wrongly did) fire there
    slot = st.get("slot_counts")
    counts_s = node2slot = None
    if slot is not None:
        counts_s, node2slot = slot
    base_classes = Counter()
    cfgp = PipelineConfig()

    maps = _nw_map_batch([j[1] for j in nw_jobs], [j[2] for j in nw_jobs])
    for (i, ref, gseq), m in zip(nw_jobs, maps):
        r, t, best, cont, _ = rows[i]
        ok = m >= 0
        aligned = int(ok.sum())
        wrong_mask = np.zeros(len(gseq), bool)
        wrong_mask[ok] = ref[np.clip(m, 0, len(ref) - 1)][ok] != gseq[ok]
        wrong = int(wrong_mask.sum())
        unmapped = int((~ok).sum())
        span = (int(m[ok].min()), int(m[ok].max())) if aligned else (0, 0)
        short = len(ref) - (span[1] - span[0] + 1)
        if cont > 0.90:
            cls = "near-miss(>.90)"
        elif wrong <= 8 and short < 100:
            cls = "few-wrong-bases"
        elif short >= 100:
            cls = "short/truncated"
        else:
            cls = "many-wrong-bases"
        classes[cls] += 1
        detail = ""
        if counts_s is not None and int(node2slot[t]) >= 0:
            # NOTE: gene coords map onto the ANCHOR of its leaf; with
            # leaf_per_ref the ref IS the anchor, so m addresses the pileup
            # slot counts are stored FLAT (ref_len*4,) per row since the
            # tiled-layout fix (pipeline/pileup.py); view as (ref_len, 4)
            c_leaf = counts_s[int(node2slot[t])].reshape(-1, 4)
            per = Counter()
            for gi_pos in np.nonzero(wrong_mask)[0]:
                col = int(m[gi_pos])
                c = c_leaf[col]
                tot = int(c.sum())
                srt = np.sort(c)
                minor = tot - int(srt[-1])
                poly = (minor >= cfgp.poly_min_minor_count and
                        minor * cfgp.poly_minor_frac_den
                        >= cfgp.poly_minor_frac_num * max(tot, 1))
                topb = int(np.argmax(c))
                true_b = int(ref[col])
                if tot < cfgp.polish_min_depth:
                    per["thin-evidence"] += 1
                elif poly:
                    per["poly-guard"] += 1
                elif srt[-1] == srt[-2]:
                    per["tied-winner"] += 1
                elif srt[-1] * cfgp.polish_maj_den < cfgp.polish_maj_num * tot:
                    per["no-majority"] += 1
                elif topb != true_b:
                    per["winner-wrong"] += 1
                else:
                    per["winner-right-gene-wrong"] += 1
            base_classes.update(per)
            detail = " " + dict(per).__repr__()
        print(f"ref {r} taxon {t}: cont {cont:.3f} len(g)={len(gseq)} "
              f"len(ref)={len(ref)} wrong={wrong} ins={unmapped} "
              f"missing_span={short} reads={best.n_reads} "
              f"cluster={best.cluster} born={best.round_born} "
              f"[{cls}]{detail}", flush=True)
    print("\nclass counts:", dict(classes), flush=True)
    if base_classes:
        print("wrong-base classes:", dict(base_classes), flush=True)


if __name__ == "__main__":
    main()
