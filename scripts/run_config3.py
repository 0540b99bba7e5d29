"""Driver config 3: human-gut-shaped metagenome - ~10M reads vs a
full-Greengenes-sized index (~100k refs), single host (BASELINE.json:9).

Shape choices match a real Greengenes DB through the CLI: every reference is
its own OTU leaf (identity column maps, as _load_taxonomy produces), the
sample contains a few hundred present taxa with lognormal abundance, and the
index holds all 100k refs. Exercises: the two-level window gather (the
strided table would be ~2.2 GB), slot-compacted node pileups, int16
streaming retention, and DP-means at scale.

  PYTHONPATH=. python scripts/run_config3.py [n_reads] [n_refs]
"""

import faulthandler
import os
import pickle
import signal
import sys
import time

import numpy as np

faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps all stacks

from rambl_tpu.config import PipelineConfig
from rambl_tpu.data.simulate import simulate_dataset
from rambl_tpu.index.builder import build_seed_index
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.io.pack import decode_seq
from rambl_tpu.pipeline.assemble import assemble_jax
from rambl_tpu.utils.cache import enable_compile_cache


def main():
    enable_compile_cache()
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    n_refs = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
    n_present = 500
    # dataset + index cache: simulation (~10 min) and index build (~5 min)
    # are deterministic in (n_reads, n_refs, seed, k, generator version) -
    # skip them on reruns. k + a version tag are part of the key (ADVICE r4:
    # a later change to k or simulate_dataset must not silently reuse a
    # stale index); bump _GEN_V when the simulator changes.
    _GEN_V = 3
    cache = (f"/tmp/config3_cache_{n_reads}_{n_refs}"
             f"_k{PipelineConfig().k}_v{_GEN_V}_seed13.pkl")
    t0 = time.time()
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            ds, index = pickle.load(f)
        print(f"loaded cached dataset+index from {cache} "
              f"in {time.time() - t0:.0f}s", flush=True)
    else:
        ds = simulate_dataset(
            n_species=n_refs // 5, refs_per_species=5, n_reads=n_reads,
            seed=13, leaf_per_ref=True, n_present=n_present,
        )
        index = None
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    print(f"dataset: {n_reads} reads vs {ds.n_refs} refs "
          f"({n_present} present, {tax.n_nodes} taxonomy nodes) in "
          f"{time.time() - t0:.0f}s", flush=True)

    # batch divides n_reads when possible (no pad tail -> no retention slice)
    batch = 16000 if n_reads % 16000 == 0 else 16384
    # max_genes > n_present: 500 present refs saturated 256 slots in the
    # first r3 run (recovery capped at 129/500 by the panel cap alone); the
    # r4 run saturated 1024 too (396/500) - RAMBL_MAX_GENES overrides
    max_genes = int(os.environ.get("RAMBL_MAX_GENES", "1024"))
    cfg = PipelineConfig(batch_size=batch, max_genes=max_genes,
                         max_clusters_per_bin=16, max_assembly_iters=4,
                         bin_share_depth=3, cluster_leaf_block=512,
                         sw_rows=104)
    t1 = time.time()
    if index is None:
        index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
        with open(cache, "wb") as f:
            pickle.dump((ds, index), f, protocol=4)
    print(f"index: {index.n_entries} entries, 2^{index.n_bits} buckets, "
          f"built in {time.time() - t1:.0f}s", flush=True)

    t2 = time.time()
    aux = {}
    res = assemble_jax(ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens,
                       tax, cfg, shared_index=index, aux_out=aux)
    wall = time.time() - t2
    for s in res.round_stats:
        print(s, flush=True)

    def kmers(s, k=25):
        return set(s[i: i + k] for i in range(len(s) - k + 1))

    present = np.nonzero(ds.abundance > 0)[0]
    # recovery counted against the detectable present refs (>= ~3x depth)
    depth = np.bincount(ds.true_ref, minlength=ds.n_refs) * 100.0
    detectable = present[depth[present] >= 3 * ds.ref_lens[present]]
    refk = {int(r): kmers(decode_seq(ds.ref_seqs[r, : ds.ref_lens[r]]))
            for r in present}
    recovered = set()
    for g in res.genes:
        gk = kmers(decode_seq(g.seq))
        best = max(refk, key=lambda r: len(gk & refk[r]))
        cont = len(gk & refk[best]) / max(len(gk), 1)
        if cont > 0.95:
            recovered.add(best)
    n_full = len(res.full_length(cfg))
    # dump the panel + round-0 evidence for offline miss diagnosis
    # (scripts/diagnose_config3.py; the slot counts let the wrong-base
    # classifier read the exact polish evidence without a 10M-read realign)
    slot = aux.get("slot_counts")
    with open("/tmp/config3_genes.pkl", "wb") as f:
        pickle.dump(dict(genes=res.genes, recovered=recovered,
                         detectable=detectable, stats=res.round_stats,
                         slot_counts=(None if slot is None else
                                      (np.asarray(slot[0]), slot[1]))), f)
    aligns = sum(s.get("aligned", 0) for s in res.round_stats)
    print(f"wall {wall:.0f}s | rounds {res.n_rounds} converged {res.converged}")
    print(f"genes {len(res.genes)} full-length {n_full} | "
          f"recovered>95% {len(recovered & set(int(x) for x in detectable))}"
          f"/{detectable.size} detectable ({present.size} present)")
    print(f"effective throughput {aligns / wall:.0f} reads/s (all stages, "
          f"{aligns} alignments)")
    print(f"genes assembled/hour {len(res.genes) / (wall / 3600):.0f}")


if __name__ == "__main__":
    main()
