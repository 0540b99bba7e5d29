"""SW score on the GPU: the Pallas kernel against XLA's plain scan.

Times, at the gut preset's batch shape (16,384 reads, 4 candidates per
strand, so 131,072 pairs of 128 x 160 with sw_rows 104):
  1. the align step (pipeline.align.align_batch, jitted) end to end, once
     with each score implementation, in the order kernel, scan, scan,
     kernel, each a median of warm block_until_ready runs;
  2. the score pass alone for a few kernel geometries (strip, block);
  3. from a profiler trace of each align-step variant: device busy time per
     step and the SW kernel's own time, with the heaviest device ops.
Prints the card's name and power limit first. Fails without a GPU.

  python scripts/bench_sw.py [--refs 10000] [--trace-dir .traces/bench_sw]
"""

import argparse
import functools
import glob
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from rambl_tpu.config import PRESETS  # noqa: E402
from rambl_tpu.data.simulate import simulate_dataset  # noqa: E402
from rambl_tpu.index.builder import build_seed_index  # noqa: E402
from rambl_tpu.ops.seed import SeedTable  # noqa: E402
from rambl_tpu.ops.sw import sw_score  # noqa: E402
from rambl_tpu.ops.sw_pallas import sw_score_pallas  # noqa: E402
from rambl_tpu.pipeline import align  # noqa: E402


def median_time(f, args, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def align_fn(impl, table, refs, cfg, batch):
    """The align step compiled with its pass-1 score running `impl` (the
    choice is made while tracing, so each variant is compiled here)."""
    align.score_fn = lambda platform: impl
    return jax.jit(functools.partial(align.align_batch, table=table,
                                     ref_seqs=refs, cfg=cfg)).lower(
                                         *batch).compile()


def device_events(trace_dir):
    """(start_ns, duration_ns, name) of every op on the GPU streams."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    ev = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                ev += [(e.start_ns, e.duration_ns, e.name)
                       for e in line.events]
    return ev


def busy_ns(ev):
    """Length of the union of the event intervals."""
    total, end = 0.0, -1.0
    for s, d, _ in sorted(ev):
        if s + d <= end:
            continue
        total += s + d - max(s, end)
        end = s + d
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--refs", type=int, default=10_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--trace-dir", default=".traces/bench_sw")
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_sw: needs a GPU, found {dev.platform!r}")
    print(f"card: {smi} | {dev.device_kind} | jax {jax.__version__}",
          flush=True)

    cfg = PRESETS["gut"]
    B = cfg.batch_size
    ds = simulate_dataset(n_species=a.refs // 5, refs_per_species=5,
                          n_reads=2 * B, seed=13, leaf_per_ref=True,
                          n_present=min(500, a.refs))
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    table = SeedTable.from_index(index)
    refs = jax.device_put(ds.ref_seqs)
    batches = [(jax.device_put(ds.reads[i * B:(i + 1) * B]),
                jax.device_put(ds.read_lens[i * B:(i + 1) * B]))
               for i in range(2)]
    print(f"align step: {B} reads x {2 * cfg.max_candidates} candidates, "
          f"index of {ds.n_refs} refs ({index.n_entries} entries)",
          flush=True)

    impls = {"kernel": sw_score_pallas, "scan": sw_score}
    fns, outs = {}, {}
    for k, v in impls.items():
        t0 = time.time()
        fns[k] = align_fn(v, table, refs, cfg, batches[0])
        outs[k] = jax.block_until_ready(fns[k](*batches[0]))
        print(f"align step [{k}] compile+first: {time.time() - t0:.1f}s",
              flush=True)
    for x, y in zip(jax.tree_util.tree_leaves(outs["kernel"]),
                    jax.tree_util.tree_leaves(outs["scan"])):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    res = defaultdict(list)
    for k in ("kernel", "scan", "scan", "kernel"):
        med, ts = median_time(fns[k], batches[1], a.reps)
        res[k].append(med)
        print(f"align step [{k}] median {med * 1e3:.3f} ms over {a.reps}: "
              f"{' '.join(f'{t * 1e3:.3f}' for t in ts)}", flush=True)
    for k, v in res.items():
        print(f"align step [{k}]: {np.mean(v) * 1e3:.3f} ms/batch = "
              f"{B / np.mean(v):.0f} reads/s", flush=True)

    # the score pass alone, a few kernel geometries
    from chip_smoke import make_pairs

    n = B * 2 * cfg.max_candidates
    q, w = make_pairs(n, cfg.read_len_max, cfg.window_len, 100, seed=0)
    q, w = jax.device_put(q), jax.device_put(w)
    cells = n * cfg.sw_rows * cfg.window_len
    for name, f in [("scan", functools.partial(sw_score, sc=cfg.scoring,
                                               rows=cfg.sw_rows))] + [
            (f"kernel strip={s} block={b}",
             functools.partial(sw_score_pallas, sc=cfg.scoring,
                               rows=cfg.sw_rows, strip=s, block=b))
            for s, b in ((0, 128), (32, 128), (35, 128), (36, 128),
                         (40, 128), (35, 256))]:
        f = jax.jit(f)
        jax.block_until_ready(f(q, w))
        med, _ = median_time(f, (q, w), a.reps)
        print(f"score pass [{name}] {n} pairs: {med * 1e3:.3f} ms = "
              f"{cells / med / 1e9:.1f} GCUPS", flush=True)

    # device time from a profiler trace of each align-step variant
    for k, f in fns.items():
        d = os.path.join(a.trace_dir, k)
        with jax.profiler.trace(d):
            for _ in range(3):
                jax.block_until_ready(f(*batches[1]))
        ev = device_events(d)
        per = defaultdict(float)
        for _, dur, name in ev:
            per[name] += dur
        sw = sum(v for nm, v in per.items() if "sw_score" in nm)
        print(f"trace [{k}]: device busy {busy_ns(ev) / 3e6:.3f} ms/step, "
              f"SW kernel {sw / 3e6:.3f} ms/step", flush=True)
        for nm, v in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {v / 3e6:9.3f} ms/step  {nm[:100]}", flush=True)


if __name__ == "__main__":
    main()
