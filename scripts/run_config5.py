"""Config-5-shaped single-host run (VERDICT r2 #8; BASELINE.json:11).

The full config 5 is >=100M reads on N>=2 hosts with a sharded index and
cross-host psum merges. This script checks that the memory/throughput
model holds past config 3 on one device: a
20-30M-read gut-shaped job against the 100k-ref index, streaming retention,
slot pileups, per-round checkpoints, and a REAL mid-run resume (phase A runs
the discovery round with a checkpoint and stops; phase B resumes from disk
and finishes - the bitwise-continuation contract of tests/test_faults.py at
scale).

Memory model (why the default is 20M, not 50M): single-device streaming
retains query int8 + ref_col int16 + 3 small vectors ~ 3.9 B/read-column
byte = ~0.41 GB per 1M reads at L=128, plus the ~3.3 GB packed entry table
for 100k refs and the pileup accumulators, so the device's memory sets the
single-device read ceiling. Past that, retention must shard: the mesh path
holds ~B/N rows per device (parallel/steps.py RETAIN3), which is exactly
the >=100M design.

  PYTHONPATH=. python scripts/run_config5.py \
      [n_reads] [n_refs]
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
from rambl_tpu.data.simulate import _gen_reads, simulate_dataset
from rambl_tpu.index.builder import build_seed_index
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.utils.cache import enable_compile_cache


def main():
    enable_compile_cache()
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000_000
    n_refs = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
    n_present = 500
    t0 = time.time()
    # community/taxonomy from the config-3 generator; reads regenerated in
    # chunks (one 50M float64 error mask would eat ~40 GB host RAM).
    # Deterministic in (n_reads, n_refs, k, generator version): cache
    # dataset + index for reruns (key includes k + a version tag per
    # ADVICE r4; bump _GEN_V when the simulator changes).
    _GEN_V = 3
    cache = (f"/tmp/config5_cache_{n_reads}_{n_refs}"
             f"_k{PipelineConfig().k}_v{_GEN_V}_seed13.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            ds, reads, lens, index = pickle.load(f)
        print(f"loaded cached dataset+index in {time.time() - t0:.0f}s",
              flush=True)
    else:
        ds = simulate_dataset(
            n_species=n_refs // 5, refs_per_species=5, n_reads=1, seed=13,
            leaf_per_ref=True, n_present=n_present,
        )
        chunk = 5_000_000
        reads = np.empty((n_reads, 128), np.int8)
        lens = np.empty((n_reads,), np.int32)
        for i, lo in enumerate(range(0, n_reads, chunk)):
            hi = min(lo + chunk, n_reads)
            rng = np.random.default_rng(977 + 13 * i)
            r, l, _, _, _ = _gen_reads(rng, ds.ref_seqs, ds.ref_lens,
                                       ds.abundance, hi - lo, 100, 128,
                                       0.004, 0.0005)
            reads[lo:hi] = r
            lens[lo:hi] = l
        index = None
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    print(f"dataset: {n_reads} reads vs {ds.n_refs} refs in "
          f"{time.time() - t0:.0f}s", flush=True)

    batch = 16000 if n_reads % 16000 == 0 else 16384
    # max_genes=512 saturated in the r4 run (507/512 full-length = cap-bound,
    # VERDICT r4 weak #4: a quality-blind scale proof); default to the same
    # 2048 cap the clean config-3 runs use, overridable like run_config3.
    max_genes = int(os.environ.get("RAMBL_MAX_GENES", "2048"))
    cfg = PipelineConfig(batch_size=batch, max_genes=max_genes,
                         max_clusters_per_bin=16, max_assembly_iters=3,
                         bin_share_depth=3, cluster_leaf_block=512,
                         sw_rows=104)
    t1 = time.time()
    if index is None:
        index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
        with open(cache, "wb") as f:
            pickle.dump((ds, reads, lens, index), f, protocol=4)
    print(f"index: {index.n_entries} entries, 2^{index.n_bits} buckets, "
          f"built in {time.time() - t1:.0f}s", flush=True)

    from rambl_tpu.pipeline.assemble import assemble_jax
    from rambl_tpu.utils.checkpoint import load_aux_evidence, load_checkpoint

    ckpt = "/tmp/config5.ckpt"
    # phase A: discovery round only, checkpointed ("crash" after round 0)
    import dataclasses

    cfgA = dataclasses.replace(cfg, max_assembly_iters=1)
    t2 = time.time()
    resA = assemble_jax(reads, lens, ds.ref_seqs, ds.ref_lens, tax, cfgA,
                        shared_index=index, checkpoint_path=ckpt)
    tA = time.time() - t2
    print(f"phase A (discovery + checkpoint): {tA:.0f}s, "
          f"{len(resA.panel)} panel genes", flush=True)

    # phase B: resume from disk, finish the loop. The .aux sidecar restores
    # the round-0 polish evidence so phase B's polish skips the full
    # round-0 re-stream (bitwise identical either way).
    header, panel = load_checkpoint(ckpt)
    aux = load_aux_evidence(ckpt + ".aux", cfgA)
    print(f"resume: {len(panel)} panel genes, aux evidence "
          f"{'RESTORED' if aux else 'absent (will re-stream)'}", flush=True)
    t3 = time.time()
    res = assemble_jax(reads, lens, ds.ref_seqs, ds.ref_lens, tax, cfg,
                       shared_index=index, initial_panel=panel,
                       initial_aux=aux)
    tB = time.time() - t3
    wall = tA + tB
    for s in res.round_stats:
        print(s, flush=True)

    aligns = sum(s.get("aligned", 0) for s in res.round_stats) + \
        sum(s.get("aligned", 0) for s in resA.round_stats)
    n_full = len(res.full_length(cfg))
    print(f"phase B (resumed): {tB:.0f}s | total wall {wall:.0f}s")
    print(f"genes {len(res.genes)} full-length {n_full} | rounds "
          f"{res.n_rounds} (resumed from round {header['round']})")

    # recovery vs the detectable present refs (same rule as run_config3;
    # reads here were generated at 100x mean but in chunks, so recompute
    # detectability from actual per-ref depth is unavailable - use the
    # abundance-expected depth instead, matching the simulator's sampling)
    from rambl_tpu.io.pack import decode_seq

    def kmers(s, k=25):
        return set(s[i: i + k] for i in range(len(s) - k + 1))

    present = np.nonzero(ds.abundance > 0)[0]
    p = ds.abundance[present] / ds.abundance.sum()
    exp_depth = p * n_reads * 100.0  # expected bases per ref
    detectable = present[exp_depth >= 3 * ds.ref_lens[present]]
    refk = {int(r): kmers(decode_seq(ds.ref_seqs[r, : ds.ref_lens[r]]))
            for r in present}
    recovered = set()
    for g in res.genes:
        gk = kmers(decode_seq(g.seq))
        best = max(refk, key=lambda r: len(gk & refk[r]))
        if len(gk & refk[best]) / max(len(gk), 1) > 0.95:
            recovered.add(best)
    print(f"recovered>95% {len(recovered & set(int(x) for x in detectable))}"
          f"/{detectable.size} detectable ({present.size} present)")
    print(f"effective throughput {aligns / wall:.0f} reads/s "
          f"(all stages, {aligns} alignments)")
    print(f"genes assembled/hour {len(res.genes) / (wall / 3600):.0f}")


if __name__ == "__main__":
    main()
