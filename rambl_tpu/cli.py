"""rambl_tpu command line (SURVEY.md L1 replacement).

Subcommands:
  simulate  - generate a mock community (FASTA refs + FASTQ reads + truth)
  assemble  - run the full device assembly pipeline on reads vs a reference DB
  bench     - alignment/SW microbenchmarks on the local GPU

`assemble` consumes a reference FASTA with a Greengenes-style taxonomy TSV
(name<TAB>k__...;p__...;...) or falls back to one leaf per reference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from rambl_tpu.utils.errors import UserError
from rambl_tpu.config import PRESETS, PipelineConfig
from rambl_tpu.io.fasta import read_fasta, read_fastq, write_fasta, write_fastq
from rambl_tpu.io.pack import decode_seq, encode_batch
from rambl_tpu.index.taxonomy import TaxonomyTables, build_taxonomy_tables


def _load_taxonomy(path: Optional[str], ref_names: List[str]):
    """Greengenes-style taxonomy file -> tree tensors; None -> flat leaves.

    Real-Greengenes semantics live in index.greengenes.load_gg_taxonomy
    (empty-rank placeholders like ``g__; s__`` truncate the lineage); plain
    TSVs without placeholders parse identically."""
    if path is None:
        n = len(ref_names)
        parent = np.zeros((n + 1,), np.int32)
        depth = np.concatenate([[0], np.ones(n)]).astype(np.int32)
        ref_taxon = np.arange(1, n + 1, dtype=np.int32)
        return build_taxonomy_tables(parent, depth, ref_taxon)
    from rambl_tpu.index.greengenes import load_gg_taxonomy

    return load_gg_taxonomy(path, ref_names)


def _write_taxonomy(path: str, ds, ref_ids) -> None:
    with open(path, "w") as f:
        for i in ref_ids:
            node = int(ds.ref_taxon[i])
            chain = []
            while node != 0:
                chain.append(ds.tax_name[node])
                node = int(ds.tax_parent[node])
            f.write(ds.ref_names[i] + "\t" + ";".join(reversed(chain)) + "\n")


def cmd_simulate(args) -> int:
    from rambl_tpu.data.simulate import simulate_cohort, simulate_dataset

    os.makedirs(args.out, exist_ok=True)
    if args.samples > 1:
        # cohort mode (BASELINE config 4): one community, per-sample strain
        # abundances, one FASTQ per sample
        co = simulate_cohort(
            n_species=args.species, refs_per_species=args.strains,
            n_samples=args.samples, reads_per_sample=args.reads,
            seed=args.seed)
        ds = co.ds
        for j, (reads, lens) in enumerate(co.samples):
            write_fastq(
                os.path.join(args.out, f"reads.sample{j}.fastq"),
                [(f"s{j}r{i}", decode_seq(reads[i, : lens[i]]),
                  "I" * int(lens[i])) for i in range(reads.shape[0])])
        truth = {"true_ref": [t.tolist() for t in co.true_ref],
                 "abundance": co.abundance.tolist()}
        n_reads = sum(r.shape[0] for r, _ in co.samples)
    else:
        ds = simulate_dataset(
            n_species=args.species, refs_per_species=args.strains,
            n_reads=args.reads, seed=args.seed,
        )
        write_fastq(
            os.path.join(args.out, "reads.fastq"),
            [(n, decode_seq(ds.reads[i, : ds.read_lens[i]]), ds.read_quals[i])
             for i, n in enumerate(ds.read_names)],
        )
        truth = {"true_ref": ds.true_ref.tolist(),
                 "true_pos": ds.true_pos.tolist(),
                 "true_strand": ds.true_strand.tolist()}
        n_reads = ds.n_reads
    # --db-refs anchors: the reference DB holds only each species' first
    # strain (the real Greengenes shape - sample strains are NOT in the DB
    # and co-bin to their species OTU; this is where DP-means/minorhap/
    # cohort phasing must separate them). The full strain truth always goes
    # to strains.fasta for quality evaluation.
    all_refs = ds.ref_fasta()
    if args.db_refs == "anchors":
        keep = [i for i in range(ds.n_refs)
                if ds.ref_names[i].endswith("_strain0")]
    else:
        keep = list(range(ds.n_refs))
    write_fasta(os.path.join(args.out, "refs.fasta"),
                [all_refs[i] for i in keep])
    write_fasta(os.path.join(args.out, "strains.fasta"), all_refs)
    _write_taxonomy(os.path.join(args.out, "taxonomy.tsv"), ds, keep)
    with open(os.path.join(args.out, "truth.json"), "w") as f:
        json.dump(truth, f)
    print(f"wrote {len(keep)} refs / {n_reads} reads "
          f"({max(args.samples, 1)} sample(s)) to {args.out}")
    return 0


def cmd_assemble(args) -> int:
    from rambl_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
    from rambl_tpu.utils.metrics import MetricsLogger

    cfg = PRESETS[args.preset] if args.preset else PipelineConfig()
    if args.config:
        with open(args.config) as f:
            cfg = PipelineConfig.from_json(f.read())

    from rambl_tpu.io.loader import load_fasta_codes, load_fastq_codes, native_available

    refs = read_fasta(args.reference)  # names needed for taxonomy mapping
    ref_names = [n for n, _ in refs]
    ref_seqs, ref_lens = encode_batch([s for _, s in refs], cfg.ref_len_max)
    samples = [load_fastq_codes(p, cfg.read_len_max) for p in args.reads]
    tables = _load_taxonomy(args.taxonomy, ref_names)

    col_maps = None
    if args.msa:
        # the database's own pre-aligned (PyNAST) columns replace pairwise-NW
        # anchor maps for every round against the original references - exact
        # by construction (index/greengenes.py)
        from rambl_tpu.index.greengenes import col_maps_from_msa, load_gg_msa

        msa_cols = load_gg_msa(args.msa, ref_names, cfg.ref_len_max)
        col_maps = col_maps_from_msa(msa_cols, ref_lens, tables.ref_taxon)

    metrics = MetricsLogger(args.metrics)
    metrics.log("load", refs=len(refs), samples=len(samples),
                reads=sum(int(r.shape[0]) for r, _ in samples),
                native_loader=native_available(),
                preset=args.preset or "default")

    initial_panel = None
    if args.resume_from:
        from rambl_tpu.utils.checkpoint import config_fingerprint

        header, initial_panel = load_checkpoint(args.resume_from)
        if header["fingerprint"] != config_fingerprint(cfg):
            print("warning: checkpoint config fingerprint differs from the "
                  "active config; resuming anyway", file=sys.stderr)
        metrics.log("resume", round=header["round"], genes=len(initial_panel))

    mesh = None
    if args.mesh:
        import hashlib

        from rambl_tpu.parallel.mesh import (
            assert_hosts_agree,
            data_mesh,
            init_distributed,
            sync_host_config,
        )

        init_distributed()
        mesh = data_mesh(args.mesh if args.mesh > 0 else None)
        # multi-host init contract (SURVEY.md section 3.5): process 0's
        # config wins everywhere, and every host must hold the identical
        # reference DB (the seed index is derived from it deterministically)
        cfg = sync_host_config(cfg)
        assert_hosts_agree("reference FASTA", hashlib.sha256(
            ref_seqs.tobytes() + ref_lens.tobytes()).digest())
        metrics.log("mesh", devices=int(mesh.devices.size))

    if len(samples) > 1 and (args.resume_from or args.checkpoint):
        # the cohort paths (oracle and device) run the multi-sample loop with
        # cross-sample phasing and do not thread initial_panel/checkpoint
        # through; silently ignoring --resume-from would break the documented
        # bitwise-resume contract, so refuse loudly (ADVICE r2)
        print("error: --checkpoint/--resume-from are not supported with "
              "multi-sample (cohort) input; run per-sample or drop the flag",
              file=sys.stderr)
        return 2
    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
    if args.oracle and len(samples) > 1:
        from rambl_tpu.oracle.cohort import assemble_cohort as oracle_cohort

        results = oracle_cohort(samples, ref_seqs, ref_lens, tables, cfg,
                                col_maps=col_maps)
    elif args.oracle:
        from rambl_tpu.oracle.pipeline import assemble

        results = [assemble(samples[0][0], samples[0][1], ref_seqs, ref_lens,
                            tables, cfg, initial_panel=initial_panel,
                            col_maps=col_maps)]
    elif len(samples) > 1:
        from rambl_tpu.pipeline.assemble import assemble_cohort

        results = assemble_cohort(samples, ref_seqs, ref_lens, tables, cfg,
                                  mesh=mesh, col_maps=col_maps)
    else:
        from rambl_tpu.pipeline.assemble import assemble_jax

        # per-round checkpoints: a crash/kill anywhere leaves the last round
        # boundary resumable (--resume-from); the final save below overwrites
        results = [assemble_jax(samples[0][0], samples[0][1], ref_seqs,
                                ref_lens, tables, cfg,
                                initial_panel=initial_panel, mesh=mesh,
                                checkpoint_path=args.checkpoint,
                                col_maps=col_maps)]
    if args.profile:
        import jax

        jax.profiler.stop_trace()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
    for si, result in enumerate(results):
        for s in result.round_stats:
            metrics.log("round", sample=si, **s)
        genes = result.genes
        full = result.full_length(cfg)
        metrics.log("done", sample=si, genes=len(genes),
                    full_length=len(full), rounds=result.n_rounds,
                    converged=result.converged)
        out = args.out if len(results) == 1 else (
            args.out + f".sample{si}.fasta")
        write_fasta(out, [
            (f"gene{i}|reads={g.n_reads}|taxon={g.taxon}|len={g.seq.shape[0]}",
             decode_seq(g.seq))
            for i, g in enumerate(genes)
        ])
        if args.checkpoint:
            ck = args.checkpoint if len(results) == 1 else (
                args.checkpoint + f".sample{si}")
            # checkpoint the PRE-polish loop panel: resume continues the loop,
            # and the loop must never see polished genes (bitwise continuation)
            save_checkpoint(ck, cfg, result.panel, result.n_rounds,
                            result.round_stats)
        print(f"sample {si}: {len(genes)} genes ({len(full)} full-length) -> {out}")
    return 0


def cmd_bench(args) -> int:
    import bench

    bench.main()
    return 0


def main(argv=None) -> int:
    from rambl_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="rambl_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("simulate", help="generate a mock community")
    s.add_argument("--out", required=True)
    s.add_argument("--species", type=int, default=20)
    s.add_argument("--strains", type=int, default=5)
    s.add_argument("--reads", type=int, default=10_000,
                   help="reads (per sample in cohort mode)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--samples", type=int, default=1,
                   help=">1 = cohort: per-sample abundances + FASTQs")
    s.add_argument("--db-refs", choices=("all", "anchors"), default="all",
                   help="'anchors' writes only each species' first strain to "
                        "refs.fasta (real-DB shape: sample strains co-bin to "
                        "their species OTU); full truth -> strains.fasta")
    s.set_defaults(fn=cmd_simulate)

    a = sub.add_parser("assemble", help="assemble full-length 16S genes")
    a.add_argument("--reads", required=True, nargs="+",
                   help="FASTQ[.gz]; several = cohort with shared index")
    a.add_argument("--reference", required=True, help="reference FASTA[.gz]")
    a.add_argument("--taxonomy", help="taxonomy TSV (name<TAB>lineage;...); "
                   "Greengenes empty ranks (g__; s__) truncate the lineage")
    a.add_argument("--msa", help="pre-aligned reference FASTA[.gz] (PyNAST/"
                   "Greengenes): its columns replace pairwise-NW anchor maps")
    a.add_argument("--out", required=True, help="output FASTA")
    a.add_argument("--preset", choices=sorted(PRESETS))
    a.add_argument("--config", help="PipelineConfig JSON file")
    a.add_argument("--oracle", action="store_true",
                   help="run the NumPy oracle instead of the device path")
    a.add_argument("--metrics", help="JSONL metrics output path")
    a.add_argument("--checkpoint", help="write final panel checkpoint here")
    a.add_argument("--resume-from", help="panel checkpoint to resume from: "
                   "skips discovery, continues assembly rounds on its panel")
    a.add_argument("--profile", help="dump a jax.profiler trace to this dir")
    a.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="run every stage under shard_map on an N-device "
                   "'data' mesh (-1 = all visible devices); bitwise equal "
                   "to the single-device path")
    a.set_defaults(fn=cmd_assemble)

    b = sub.add_parser("bench", help="run microbenchmarks")
    b.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, UserError) as e:
        # bad input paths / malformed inputs / config-guard violations are
        # user errors, not crashes: clean message, nonzero exit; any OTHER
        # exception (incl. bare ValueError from internal shape logic)
        # propagates as a crash with its traceback (ADVICE r4). Set
        # RAMBL_DEBUG=1 to get the full traceback here too.
        if os.environ.get("RAMBL_DEBUG"):
            raise
        if isinstance(e, FileNotFoundError):
            # open() raises with (errno, strerror) + filename; the native
            # loader raises with the path as the sole arg
            what = e.filename if e.filename else (
                e.args[0] if len(e.args) == 1 else str(e))
            print(f"rambl_tpu: file not found: {what}", file=sys.stderr)
        else:
            print(f"rambl_tpu: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
