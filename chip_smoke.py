#!/usr/bin/env python
"""Smoke run of the assembly pipeline on an NVIDIA GPU.

    python chip_smoke.py           # one card: phases 1-4 below
    python chip_smoke.py --four    # four cards: the mesh path only

Phases on one card, in one process (one JAX process per card):
  1. device: fail unless JAX's first device is a GPU; print its kind, the JAX
     version and the card's name and power limit;
  2. SW parity at the align step's widths (gut preset: read_len_max 128,
     window 160, sw_rows 104, one pass-1 batch of 131,072 pairs): the score
     path the align step runs on this platform, bitwise against the NumPy
     oracle, and the dirs pass + traceback against the oracle's; prints the
     memory analysis of the compiled align step;
  3. toy end to end: `cli simulate`, then `cli assemble --preset toy` on the
     GPU and with `--oracle`; the gene FASTA files must be byte-identical;
  4. deployment size: the gut preset against the full 100k-reference index
     on the device, 500 present taxa, the read count cut (--reads); prints
     wall time, genes, recovery and device memory for the record.

With --four: assemble_jax on a 4-device 'data' mesh, with the replicated and
with the ring-sharded index (shard_positions on), each bitwise against the
1-device result on device 0; prints every device's memory stats.

Any failure exits nonzero before the last line. The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Outputs go to chiprun_out/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from rambl_tpu.config import PRESETS  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- phase 1 --

def phase_device(n_cards: int):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform!r}")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found "
                         f"{len(devs)}")
    log(f"[1] device_kind: {devs[0].device_kind} x{len(devs)} | "
        f"jax {jax.__version__}")
    for line in smi.strip().splitlines()[:n_cards]:
        log(f"[1] nvidia-smi: {line.strip()}")
    return devs


# ---------------------------------------------------------------- phase 2 --

def make_pairs(n: int, L: int, W: int, read_len: int, seed: int):
    """(q (n, L), w (n, W)) int8 code pairs shaped like the align step's:
    100bp reads drawn from their window with 2% substitutions, every fifth
    with a 2-base deletion or a 3-base insertion, every fourth unrelated to
    its window, rare N codes, pad code 4 beyond the read."""
    rng = np.random.default_rng(seed)
    span = read_len + 8
    w = rng.integers(0, 4, (n, W)).astype(np.int8)
    off = rng.integers(0, W - span + 1, n)
    frag = w[np.arange(n)[:, None], off[:, None] + np.arange(span)]
    src = np.broadcast_to(np.arange(read_len), (n, read_len)).copy()
    k = rng.integers(10, read_len - 10, n)[:, None]
    dele = (np.arange(n) % 5 == 1)[:, None]
    ins = (np.arange(n) % 5 == 2)[:, None]
    src = np.where(dele & (src >= k), src + 2, src)
    ins_pos = ins & (src >= k) & (src < k + 3)
    src = np.where(ins & (src >= k + 3), src - 3, src)
    r = frag[np.arange(n)[:, None], np.clip(src, 0, span - 1)]
    noise = rng.integers(0, 4, r.shape).astype(np.int8)
    r = np.where(ins_pos | (rng.random(r.shape) < 0.02), noise, r)
    r[np.arange(n) % 4 == 3] = noise[np.arange(n) % 4 == 3]
    r[rng.random(r.shape) < 0.002] = 4
    w[rng.random(w.shape) < 0.002] = 4
    q = np.full((n, L), 4, np.int8)
    q[:, :read_len] = r
    return q, w


def _equal(tag, ref, got, names=("score", "i_end", "j_end")):
    for name, a, b in zip(names, ref, got):
        a, b = np.asarray(a), np.asarray(b)
        if not np.array_equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{tag}: {name} differs at {bad} of "
                                 f"{a.size} entries")


def phase_kernels(cfg, platform: str):
    import jax

    from rambl_tpu.oracle.sw import sw_batch, traceback_batch
    from rambl_tpu.ops.sw import sw_align, sw_score, sw_traceback
    from rambl_tpu.pipeline.align import score_fn

    L, W, sc = cfg.read_len_max, cfg.window_len, cfg.scoring
    n = cfg.batch_size * 2 * cfg.max_candidates
    q, w = make_pairs(n, L, W, 100, seed=cfg.seed)
    chk = np.arange(0, n, n // 4096)          # 4096 pairs over every block
    ref = sw_batch(q[chk], w[chk], sc, want_dirs=False)[:3]
    qd, wd = jax.device_put(q), jax.device_put(w)

    score = jax.jit(score_fn(platform), static_argnames=("sc", "rows"))
    scan = jax.jit(sw_score, static_argnames=("sc", "rows"))
    t0 = time.time()
    got = jax.block_until_ready(score(qd, wd, sc=sc, rows=cfg.sw_rows))
    log(f"[2] SW score ({score_fn(platform).__module__}) {n} pairs: "
        f"compile+run {time.time() - t0:.3f}s")
    _equal("SW score vs oracle", ref, (np.asarray(x)[chk] for x in got))
    t0 = time.time()
    plain = jax.block_until_ready(scan(qd, wd, sc=sc, rows=cfg.sw_rows))
    log(f"[2] plain scan {n} pairs: compile+run {time.time() - t0:.3f}s")
    _equal("SW score vs plain scan, whole batch", plain, got)
    log(f"[2] SW score == oracle on {chk.size} pairs, == scan on {n} "
        "pairs (tolerance 0)")

    cap = max(128, cfg.batch_size // 8)     # pass-2 compacted sub-batch
    sel = chk[:cap]
    s_np, ie_np, je_np, dp = sw_batch(q[sel], w[sel], sc)
    rc_np = traceback_batch(dp, ie_np, je_np, L)
    s, ie, je, dirs = jax.jit(sw_align, static_argnames="sc")(
        qd[sel], wd[sel], sc)
    rc = jax.jit(sw_traceback, static_argnames=("L", "W"))(
        dirs, ie, je, L, W)
    _equal("dirs pass vs oracle", (s_np, ie_np, je_np), (s, ie, je))
    _equal("traceback vs oracle", (rc_np,), (rc,), names=("ref_col",))
    log(f"[2] dirs pass + traceback == oracle on {cap} pairs (tolerance 0)")


def align_step_memory(cfg, index, ds, tax, col_maps):
    """Compile the align step at the run's shapes; print its memory
    analysis. Returns the compile time (the first batch's compile)."""
    import jax
    import jax.numpy as jnp

    from rambl_tpu.pipeline.assemble import _align_bin_batch, align_step_inputs

    args = align_step_inputs(index, ds.ref_seqs, ds.ref_lens, tax, col_maps)
    reads = jnp.asarray(ds.reads[: cfg.batch_size])
    lens = jnp.asarray(ds.read_lens[: cfg.batch_size])
    t0 = time.time()
    compiled = _align_bin_batch.lower(
        reads, lens, *args, cfg=cfg, n_bits=index.n_bits).compile()
    dt = time.time() - t0
    log(f"[2] align step compile (first batch): {dt:.1f}s")
    log(f"[2] align step memory_analysis: {compiled.memory_analysis()}")
    del args, reads, lens
    return dt


# ---------------------------------------------------------------- phase 3 --

def phase_toy_cli():
    from rambl_tpu import cli

    d = os.path.join(OUT, "toy")
    os.makedirs(d, exist_ok=True)
    rc = cli.main(["simulate", "--out", d, "--species", "4", "--strains",
                   "2", "--reads", "1200", "--seed", "11"])
    assert rc == 0, f"cli simulate exit {rc}"
    common = ["assemble", "--reads", os.path.join(d, "reads.fastq"),
              "--reference", os.path.join(d, "refs.fasta"),
              "--taxonomy", os.path.join(d, "taxonomy.tsv"),
              "--preset", "toy"]
    out = {}
    for tag, extra in (("gpu", []), ("oracle", ["--oracle"])):
        t0 = time.time()
        path = os.path.join(d, f"genes.{tag}.fasta")
        rc = cli.main(common + ["--out", path, "--metrics",
                                os.path.join(d, f"metrics.{tag}.jsonl")]
                      + extra)
        assert rc == 0, f"cli assemble ({tag}) exit {rc}"
        with open(path, "rb") as f:
            out[tag] = f.read()
        log(f"[3] cli assemble --preset toy ({tag}): {time.time() - t0:.1f}s,"
            f" {out[tag].count(b'>')} genes")
    if out["gpu"] != out["oracle"]:
        raise AssertionError("toy assembly: GPU genes differ from --oracle")
    log("[3] toy gene FASTA byte-identical to --oracle")


# ---------------------------------------------------------------- phase 4 --

def _recovery(ds, genes, k=25):
    """(recovered, detectable): detectable present refs (>= 3x depth) with a
    gene of > 95% 25-mer containment in them (the best-matching ref)."""
    from rambl_tpu.io.pack import decode_seq

    present = np.nonzero(ds.abundance > 0)[0]
    depth = np.bincount(ds.true_ref, minlength=ds.n_refs) * 100.0
    detectable = set(int(r) for r in
                     present[depth[present] >= 3 * ds.ref_lens[present]])
    owners = defaultdict(list)
    for r in present:
        s = decode_seq(ds.ref_seqs[r, : ds.ref_lens[r]])
        for km in {s[i: i + k] for i in range(len(s) - k + 1)}:
            owners[km].append(int(r))
    recovered = set()
    for g in genes:
        s = decode_seq(g.seq)
        gk = {s[i: i + k] for i in range(len(s) - k + 1)}
        hits = defaultdict(int)
        for km in gk:
            for r in owners.get(km, ()):
                hits[r] += 1
        if hits:
            best = max(sorted(hits), key=lambda r: hits[r])
            if hits[best] / max(len(gk), 1) > 0.95:
                recovered.add(best)
    return len(recovered & detectable), len(detectable)


def gut_problem(n_reads: int, n_refs: int = 100_000, n_present: int = 500):
    from rambl_tpu.data.simulate import simulate_dataset
    from rambl_tpu.index.builder import build_seed_index
    from rambl_tpu.index.colmap import build_col_maps
    from rambl_tpu.index.taxonomy import build_taxonomy_tables

    # the gut preset with the leaf blocking of scripts/run_config3.py
    # (bitwise-neutral: leaves are independent)
    cfg = dataclasses.replace(PRESETS["gut"], cluster_leaf_block=512)
    t0 = time.time()
    ds = simulate_dataset(n_species=n_refs // 5, refs_per_species=5,
                          n_reads=n_reads, seed=13, leaf_per_ref=True,
                          n_present=n_present)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    log(f"[4] dataset: {n_reads} reads (cut from the preset's ~10M) vs "
        f"{ds.n_refs} refs, {n_present} present, {tax.n_nodes} taxonomy "
        f"nodes: {time.time() - t0:.1f}s")
    t0 = time.time()
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    log(f"[4] index: {index.n_entries} entries, 2^{index.n_bits} buckets: "
        f"{time.time() - t0:.1f}s")
    t0 = time.time()
    col_maps = build_col_maps(ds.ref_seqs, ds.ref_lens, tax.ref_taxon)
    log(f"[4] column maps: {time.time() - t0:.1f}s")
    return cfg, ds, tax, index, col_maps


def phase_deployment(cfg, ds, tax, index, col_maps, dev):
    from rambl_tpu.pipeline.assemble import assemble_jax

    t0 = time.time()
    res = assemble_jax(ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens,
                       tax, cfg, shared_index=index, col_maps=col_maps)
    wall = time.time() - t0
    for s in res.round_stats:
        log(f"[4] round {s}")
    rec, det = _recovery(ds, res.genes)
    mem = dev.memory_stats() or {}
    log(f"[4] gut preset, {ds.n_reads} reads: wall {wall:.1f}s | rounds "
        f"{res.n_rounds} converged {res.converged} | genes {len(res.genes)}"
        f" full-length {len(res.full_length(cfg))} | recovered>95% "
        f"{rec}/{det} detectable | peak_bytes_in_use "
        f"{mem.get('peak_bytes_in_use')} of bytes_limit "
        f"{mem.get('bytes_limit')}")
    if not res.genes:
        raise AssertionError("gut run assembled no genes")


# ----------------------------------------------------------------- --four --

def _gene_keys(res):
    return [(g.seq.tobytes(), g.n_reads, g.taxon) for g in res.genes]


def phase_four(devs, n_reads: int = 32768, n_species: int = 40):
    import jax

    from rambl_tpu.data.simulate import simulate_dataset
    from rambl_tpu.index.taxonomy import build_taxonomy_tables
    from rambl_tpu.parallel.mesh import data_mesh
    from rambl_tpu.pipeline.assemble import assemble_jax

    cfg = dataclasses.replace(PRESETS["deep"], batch_size=16384,
                              shard_index=False, shard_positions=False)
    ds = simulate_dataset(n_species=n_species, refs_per_species=5,
                          n_reads=n_reads, seed=5,
                          n_present=min(60, n_species))
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    log(f"[4x] deep preset (batch 16384): {ds.n_reads} reads vs "
        f"{ds.n_refs} refs")
    args = (ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax)

    mesh = data_mesh(4)
    runs = {}
    for tag, c in (("replicated index", cfg),
                   ("ring-sharded index + shard_positions",
                    dataclasses.replace(cfg, shard_index=True,
                                        shard_positions=True))):
        t0 = time.time()
        runs[tag] = assemble_jax(*args, c, mesh=mesh)
        log(f"[4x] mesh 4, {tag}: {time.time() - t0:.1f}s, "
            f"{len(runs[tag].genes)} genes")
    # the mesh runs come first so each device's peak is the mesh's own: the
    # retention and index shards must land on all four, not on device 0
    peaks = []
    for d in devs[:4]:
        m = d.memory_stats() or {}
        peaks.append(m.get("peak_bytes_in_use", 0))
        log(f"[4x] {d}: bytes_in_use {m.get('bytes_in_use')} "
            f"peak_bytes_in_use {m.get('peak_bytes_in_use')}")
    if min(peaks[1:]) < max(peaks[0], 1) // 10:
        raise AssertionError(f"mesh data not spread over 4 devices: {peaks}")
    t0 = time.time()
    with jax.default_device(devs[0]):
        one = assemble_jax(*args, cfg)
    log(f"[4x] 1 device: {time.time() - t0:.1f}s, {len(one.genes)} genes")
    for tag, res in runs.items():
        if (_gene_keys(res) != _gene_keys(one)
                or res.n_rounds != one.n_rounds):
            raise AssertionError(f"mesh ({tag}) differs from 1 device")
        log(f"[4x] mesh 4, {tag}: bitwise == 1 device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-device mesh path and its "
                         "1-device comparison")
    ap.add_argument("--reads", type=int, default=1_000_000,
                    help="phase 4 read count (the index stays full size)")
    args = ap.parse_args(argv)
    os.makedirs(OUT, exist_ok=True)
    from rambl_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    n = 4 if args.four else 1
    devs = phase_device(n)
    if args.four:
        phase_four(devs)
    else:
        cfg = PRESETS["gut"]
        phase_kernels(cfg, devs[0].platform)
        gcfg, ds, tax, index, col_maps = gut_problem(args.reads)
        align_step_memory(gcfg, index, ds, tax, col_maps)
        phase_toy_cli()
        phase_deployment(gcfg, ds, tax, index, col_maps, devs[0])
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": n}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
