"""Final polish pass (oracle): leaf-exclusive re-voting from round-0 evidence.

The assembly loop's consensus votes come from LCA-shared bin members: reads
from OTHER taxa that tie across the tree are members of every descendant leaf
and can outvote a leaf's own reads at its private conserved-region columns.
Small variant clusters have ~1x per-column depth, so polymorphic columns fall
back to the mixed bin pileup - a coin flip between equal-abundance strains
(see scripts/diagnose_quality.py for the error census that motivated this).

Polish re-votes every gene column against the cleanest evidence available:
reads binned EXACTLY at a leaf when aligned to the original reference index
(round-0 semantics). Such reads carry at least one taxon-distinguishing base,
so cross-taxon conserved-region contamination is excluded by construction -
and, unlike re-aligning against the panel itself, a read whose private
mutation the panel got WRONG still binned correctly against the original
reference, so its corrective vote is not lost to a cross-gene tie.

Coordinates: each gene is globally NW-aligned (index.colmap._nw_map - exact,
deterministic host DP) onto its leaf ANCHOR's original reference sequence,
mapping every gene base to the round-0 pileup column directly. The previous
offset+i contiguity assumption broke whenever call_consensus dropped an
INTERIOR column (zero coverage / deletion rule): every base after the first
hole read a shifted pileup column and polish confidently "corrected" the
whole tail (measured: 74/100 -> 28/100 recovery at the config-3 shape).

Override rule: a gene base changes only on DEEP, DECISIVE evidence - depth >=
polish_min_depth, a unique winning base holding >= polish_maj_num /
polish_maj_den of the votes, at that gene's own taxon. Mixed strain columns
(~50/50 between variants) never reach the bar and stay untouched; columns
corrupted by contamination or bin-majority coin flips are repaired.

HOLE REPAIR (cfg.polish_fill_holes): consensus emit can drop INTERIOR
columns whose per-sample coverage dips below the emit gates; every such hole
plants ~2(k-1) foreign k-mers at its junction, and the config-4 census
measured exactly this as the dominant miss class (genes with ZERO wrong
bases at 0.87 containment, 60-150 interior columns absent). Polish re-opens
those columns: a hole fills with the exclusive-pileup winner when depth >=
polish_min_depth, else with the leaf ANCHOR's reference base - the
reference-guided gap fill the reference pipeline gets for free because its
candidate sequences START as full-length database references. Substitution
polish itself never changes offsets or lengths; hole repair inserts interior
bases only (first/last mapped columns never move), so panel offsets stay
valid. Deterministic and integer-exact throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from rambl_tpu.config import PipelineConfig
from rambl_tpu.index.builder import build_seed_index
from rambl_tpu.index.colmap import build_col_maps
from rambl_tpu.index.taxonomy import TaxonomyTables
from rambl_tpu.oracle.align import align_reads
from rambl_tpu.oracle.binning import bin_reads
from rambl_tpu.oracle.cluster import bin_pileup


def leaf_exclusive_counts(
    reads: np.ndarray,
    read_lens: np.ndarray,
    ref_seqs: np.ndarray,
    ref_lens: np.ndarray,
    tables: TaxonomyTables,
    cfg: PipelineConfig,
    col_maps: Optional[np.ndarray] = None,
) -> Dict[int, np.ndarray]:
    """{leaf: (ref_len, 4) int32} pileup of reads binned EXACTLY at each leaf
    vs the ORIGINAL reference index (same hash geometry as round 0, so the
    alignments are bit-identical to the discovery round's). col_maps
    overrides the NW anchor maps (MSA coordinates; index.greengenes)."""
    index = build_seed_index(ref_seqs, ref_lens, k=cfg.k)
    res = align_reads(reads, read_lens, ref_seqs, index, cfg)
    bins = bin_reads(res, tables, cfg)
    col_map = (col_maps if col_maps is not None
               else build_col_maps(ref_seqs, ref_lens, tables.ref_taxon))
    refc = np.clip(res.ref, 0, ref_seqs.shape[0] - 1)
    rc = res.ref_col
    proj = np.where(
        rc >= 0,
        col_map[refc[:, None], np.clip(rc, 0, ref_seqs.shape[1] - 1)],
        -1,
    ).astype(np.int32)
    counts: Dict[int, np.ndarray] = {}
    for leaf in np.unique(tables.ref_taxon).tolist():
        sel = bins == leaf
        counts[int(leaf)] = bin_pileup(
            res.query[sel], proj[sel], ref_seqs.shape[1])
    return counts


def anchor_seqs_of(ref_seqs: np.ndarray, ref_lens: np.ndarray,
                   ref_taxon: np.ndarray) -> Dict[int, np.ndarray]:
    """{taxon: anchor ref sequence (unpadded int8)} - the lowest-index
    reference per leaf, i.e. the leaf's pileup coordinate system
    (index.colmap.anchor_of_leaf)."""
    out: Dict[int, np.ndarray] = {}
    for r, t in enumerate(np.asarray(ref_taxon).tolist()):
        if int(t) not in out:
            out[int(t)] = np.asarray(ref_seqs[r, : int(ref_lens[r])])
    return out


def fill_gene_holes(g, c_leaf: np.ndarray, aseq: np.ndarray,
                    cfg: PipelineConfig, gcols: Optional[np.ndarray] = None):
    """Canonicalize a gene into the anchor-column coordinate model (module
    docstring). Returns (gene, n_changed); unchanged when already canonical.

    Two defects measured by the config-4 census are repaired:
    - INTERIOR HOLES (anchor columns strictly between the gene's first and
      last mapped columns with no gene base): filled from the leaf-exclusive
      pileup winner at depth >= polish_min_depth (ties -> lowest base, as
      everywhere), else from the anchor's reference base.
    - UNPLACEABLE BASES (gene positions the exact NW map assigns no anchor
      column): dropped. The pipeline's entire evidence model lives in anchor
      columns - pileups cannot support an insertion, so such bases are
      always consensus artifacts (measured: later-round duplicated single
      bases near panel-gene holes), and every one plants up to 2(k-1)
      foreign k-mers.
    - EDGE TRUNCATION (cfg.polish_extend_edges): anchor columns outward of
      the gene span whose leaf-exclusive depth stays >= polish_min_depth
      get the pileup winner appended/prepended (stopping at the first
      shallow or polymorphic column - evidence only, never the anchor
      base). The r5 config-4 census measured EVERY remaining absent column
      as an edge truncation (consensus emit gates clip low-coverage ends).
      A left extension shifts Gene.offset accordingly."""
    from rambl_tpu.index.colmap import _nw_map

    ref_len = c_leaf.shape[0]
    A = aseq.shape[0]
    if gcols is None:
        gcols = _nw_map(aseq, g.seq)
    mapped = gcols[gcols >= 0]
    if mapped.size < 2:
        return g, 0
    first, last = int(mapped.min()), int(mapped.max())
    have = np.zeros(ref_len, bool)
    have[np.clip(mapped, 0, ref_len - 1)] = True
    holes = [c for c in range(first + 1, last) if not have[c] and c < A]
    n_ins = int((gcols < 0).sum())
    tot = c_leaf.sum(axis=1)
    top = np.argmax(c_leaf, axis=1)

    left_ext: List[int] = []
    right_ext: List[int] = []
    if cfg.polish_extend_edges:
        srt = np.sort(c_leaf, axis=1)
        minor = tot - srt[:, -1]
        is_poly = (minor >= cfg.poly_min_minor_count) & (
            minor.astype(np.int64) * cfg.poly_minor_frac_den
            >= cfg.poly_minor_frac_num * np.maximum(tot, 1).astype(np.int64))

        def edge_base(c):
            # same rule as the interior hole fill: deep decisive exclusive
            # evidence wins, the leaf anchor's reference base otherwise (the
            # reference pipeline's candidates START as full-length DB refs,
            # so its uncovered edges are reference bases by construction -
            # module docstring). Conserved edges are where reads multi-map
            # away from the leaf (measured: exclusive depth ~0-3 at the
            # first ~30 columns at config-4 shape), and conserved columns
            # are strain-independent, so the anchor base is the right call.
            if (int(tot[c]) >= cfg.polish_min_depth and not is_poly[c]
                    and srt[c, -1] > srt[c, -2]):
                return int(top[c])
            return int(aseq[c])

        left_ext = [edge_base(c) for c in range(0, first)]
        right_ext = [edge_base(c) for c in range(last + 1, min(A, ref_len))]
    if not holes and not n_ins and not left_ext and not right_ext:
        return g, 0
    fill = {c: int(top[c]) if int(tot[c]) >= cfg.polish_min_depth
            else int(aseq[c]) for c in holes}
    out: List[int] = list(left_ext)
    hi = 0
    for i in range(g.seq.shape[0]):
        gc = int(gcols[i])
        if gc < 0:
            continue                      # unplaceable base: drop
        while hi < len(holes) and holes[hi] < gc:
            out.append(fill[holes[hi]])
            hi += 1
        out.append(int(g.seq[i]))
    out.extend(right_ext)
    seq = np.asarray(out, np.int8)
    g2 = dataclasses.replace(
        g, seq=seq,
        offset=g.offset - len(left_ext)) if left_ext else \
        dataclasses.replace(g, seq=seq)
    return g2, len(holes) + n_ins + len(left_ext) + len(right_ext)


def apply_polish(genes: List, counts: Dict[int, np.ndarray],
                 anchor_seqs: Dict[int, np.ndarray], cfg: PipelineConfig):
    """Override gene bases where the leaf-exclusive vote is deep and decisive.

    anchor_seqs: {taxon: anchor reference sequence} - each gene is NW-mapped
    onto its anchor to address the round-0 pileup columns exactly (robust to
    interior emit holes and cross-round offset drift).
    Returns (new_genes, n_changed).

    The per-gene NW maps run through colmap._nw_map_batch (vectorized across
    genes, bitwise equal to _nw_map); maps are recomputed after
    substitution polish ONLY for genes whose sequence changed (identical
    input implies identical map, so reuse is exact)."""
    from rambl_tpu.index.colmap import _nw_map_batch

    live = [gi for gi, g in enumerate(genes)
            if counts.get(int(g.taxon)) is not None
            and anchor_seqs.get(int(g.taxon)) is not None]
    maps = _nw_map_batch(
        [anchor_seqs[int(genes[gi].taxon)] for gi in live],
        [genes[gi].seq for gi in live])
    gcols_of = dict(zip(live, maps))

    out = []
    changed = 0
    hole_jobs = []  # (out index, c_leaf, aseq, map valid?) for pass 2
    for gi, g in enumerate(genes):
        c_leaf = counts.get(int(g.taxon))
        aseq = anchor_seqs.get(int(g.taxon))
        if c_leaf is None or aseq is None:
            out.append(g)
            continue
        ref_len = c_leaf.shape[0]
        L = g.seq.shape[0]
        gcols = gcols_of[gi]                                 # global coords
        c = c_leaf[np.clip(gcols, 0, ref_len - 1)]           # (L, 4)
        tot = c.sum(axis=1)
        srt = np.sort(c, axis=1)
        top = np.argmax(c, axis=1).astype(np.int8)           # ties -> lowest
        # VARIANT columns belong to the loop's clustering, not to polish: a
        # column polymorphic within the leaf's own reads (same thresholds as
        # cluster.polymorphic_cols) must keep each variant gene's call, or a
        # 2:1-abundance strain pair would have the minor gene overwritten
        minor = tot - srt[:, -1]
        # integer-exact fraction test: minor/max(tot,1) >= num/den
        is_poly = (minor >= cfg.poly_min_minor_count) & (
            minor.astype(np.int64) * cfg.poly_minor_frac_den
            >= cfg.poly_minor_frac_num * np.maximum(tot, 1).astype(np.int64))
        ok = (
            (gcols >= 0)
            & (gcols < ref_len)
            & ~is_poly
            & (tot >= cfg.polish_min_depth)
            & (srt[:, -1] > srt[:, -2])
            & (srt[:, -1] * cfg.polish_maj_den >= cfg.polish_maj_num * tot)
        )
        seq = np.where(ok, top, g.seq).astype(np.int8)
        nch = int((seq != g.seq).sum())
        g2 = dataclasses.replace(g, seq=seq) if nch else g
        changed += nch
        if cfg.polish_fill_holes:
            hole_jobs.append((len(out), c_leaf, aseq, nch == 0))
        out.append(g2)
    if hole_jobs:
        # hole_jobs[k] is the k-th live gene; substitution-unchanged genes
        # reuse their pass-1 map (same sequence -> same map, exact)
        redo = [(oi, aseq) for oi, _, aseq, unchanged in hole_jobs
                if not unchanged]
        remaps = _nw_map_batch([aseq for _, aseq in redo],
                               [out[oi].seq for oi, _ in redo])
        fresh = {oi: m for (oi, _), m in zip(redo, remaps)}
        for k, (oi, c_leaf, aseq, unchanged) in enumerate(hole_jobs):
            gcols = gcols_of[live[k]] if unchanged else fresh[oi]
            out[oi], nfill = fill_gene_holes(out[oi], c_leaf, aseq, cfg,
                                             gcols=gcols)
            changed += nfill
    return out, changed


def polish_genes(
    reads: np.ndarray,
    read_lens: np.ndarray,
    ref_seqs: np.ndarray,
    ref_lens: np.ndarray,
    genes: List,
    tables: TaxonomyTables,
    cfg: PipelineConfig,
    counts: Optional[Dict[int, np.ndarray]] = None,
    col_maps: Optional[np.ndarray] = None,
):
    """Leaf-exclusive polish of the final panel. `counts` may be supplied by
    a caller that retained the round-0 node pileups (the device path does);
    otherwise they are recomputed bit-identically. Returns (genes, changed)."""
    if not genes:
        return genes, 0
    if counts is None:
        counts = leaf_exclusive_counts(
            reads, read_lens, ref_seqs, ref_lens, tables, cfg,
            col_maps=col_maps)
    anchor = anchor_seqs_of(ref_seqs, ref_lens, tables.ref_taxon)
    return apply_polish(genes, counts, anchor, cfg)
