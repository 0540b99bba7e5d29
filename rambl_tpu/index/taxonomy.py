"""Taxonomy tensors: vectorized LCA for read binning.

The reference assigns reads to Greengenes taxonomy-tree nodes in per-read
Python (SURVEY.md L5, hot loop #2). Device binning replaces the tree walk
with dense ancestor-path tables:

- `anc_path[node, d]` = ancestor of `node` at depth d (root=depth 0), padded by
  repeating the node itself below its depth. LCA of a set of nodes is then the
  deepest depth at which all paths agree - a pure vector reduction, no pointer
  chasing. Binning becomes gather + all-equal-reduce + select
  (SURVEY.md section 2.2 "Taxonomic binning").
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_DEPTH = 10  # Greengenes has 7 ranks + root; +1 for panel-gene leaves, +1 slack


@dataclasses.dataclass
class TaxonomyTables:
    anc_path: np.ndarray     # (n_nodes, MAX_DEPTH) int32 ancestor at each depth
    depth: np.ndarray        # (n_nodes,) int32
    ref_taxon: np.ndarray    # (n_refs,) int32 leaf node per reference id
    n_nodes: int

    def lca_pair(self, a: int, b: int) -> int:
        """Host-side scalar LCA (for tests)."""
        pa, pb = self.anc_path[a], self.anc_path[b]
        da, db = int(self.depth[a]), int(self.depth[b])
        lca = 0
        for d in range(min(da, db) + 1):
            if pa[d] == pb[d]:
                lca = int(pa[d])
            else:
                break
        return lca


def build_taxonomy_tables(
    tax_parent: np.ndarray, tax_depth: np.ndarray, ref_taxon: np.ndarray
) -> TaxonomyTables:
    n = tax_parent.shape[0]
    anc = np.zeros((n, MAX_DEPTH), dtype=np.int32)
    # Fill by walking up; depths are small (<= 7) so this is cheap on host.
    for node in range(n):
        d = int(tax_depth[node])
        path = []
        cur = node
        while True:
            path.append(cur)
            if cur == 0:
                break
            cur = int(tax_parent[cur])
        path = path[::-1]  # root ... node
        for dd in range(MAX_DEPTH):
            anc[node, dd] = path[min(dd, len(path) - 1)]
    return TaxonomyTables(
        anc_path=anc,
        depth=np.asarray(tax_depth, dtype=np.int32),
        ref_taxon=np.asarray(ref_taxon, dtype=np.int32),
        n_nodes=n,
    )


def lca_of_set(tables: TaxonomyTables, nodes: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Vectorized LCA over sets of nodes.

    nodes: (..., C) int32 candidate taxon ids; valid: (..., C) bool.
    Returns (...,) int32 LCA (root 0 if nothing valid in a row).

    Invalid slots are neutral: their path is replaced by the first valid
    node's path so they never break agreement.
    """
    nodes = np.asarray(nodes)
    valid = np.asarray(valid)
    paths = tables.anc_path[nodes]                      # (..., C, D)
    depths = tables.depth[nodes]                        # (..., C)
    # first valid node per row (or 0)
    any_valid = valid.any(axis=-1)
    first_idx = np.argmax(valid, axis=-1)               # 0 if none valid
    first_path = np.take_along_axis(
        paths, first_idx[..., None, None].repeat(MAX_DEPTH, -1), axis=-2
    ).squeeze(-2)                                       # (..., D)
    use = valid[..., None]                              # (..., C, 1)
    eff_paths = np.where(use, paths, first_path[..., None, :])
    agree = (eff_paths == first_path[..., None, :]).all(axis=-2)  # (..., D)
    min_depth = np.where(valid, depths, 10 ** 9).min(axis=-1)
    min_depth = np.minimum(min_depth, MAX_DEPTH - 1)
    # deepest d <= min_depth with agreement at all depths <= d
    dd = np.arange(MAX_DEPTH)
    prefix_agree = np.cumprod(agree, axis=-1).astype(bool)        # (..., D)
    ok = prefix_agree & (dd <= min_depth[..., None])
    best_d = np.where(ok, dd, -1).max(axis=-1)
    best_d = np.maximum(best_d, 0)
    lca = np.take_along_axis(first_path, best_d[..., None], axis=-1).squeeze(-1)
    return np.where(any_valid, lca, 0).astype(np.int32)
