"""Stage-level checkpoint / resume (SURVEY.md section 5).

The reference's implicit "checkpointing" is its SAM/BAM/FASTA temp files; here
pipeline state (gene panel with provenance, round cursor, config fingerprint)
serializes explicitly at round boundaries. Determinism (tests
test_determinism.py) makes resume bitwise-reproducing: re-running round t from
a checkpoint yields the same panel as an uninterrupted run.

Format: a single .npz (numpy, host-side - the panel is tiny) + a JSON header.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np

from rambl_tpu.config import PipelineConfig

if TYPE_CHECKING:  # Gene imports lazily inside load_checkpoint: a module-
    # level import was a real cycle (utils.__init__ -> checkpoint ->
    # oracle.pipeline -> oracle.align -> io -> utils.errors -> utils.__init__)
    from rambl_tpu.oracle.pipeline import Gene

FORMAT_VERSION = 2  # v2: gene meta gained the panel offset column


def config_fingerprint(cfg: PipelineConfig) -> str:
    return hashlib.sha256(cfg.to_json().encode()).hexdigest()[:16]


def save_checkpoint(path: str, cfg: PipelineConfig, genes: "List[Gene]",
                    round_idx: int, round_stats: Optional[list] = None) -> None:
    header = dict(
        format=FORMAT_VERSION,
        config=json.loads(cfg.to_json()),
        fingerprint=config_fingerprint(cfg),
        round=round_idx,
        n_genes=len(genes),
        round_stats=round_stats or [],
    )
    arrays = {"__lens__": np.array([g.seq.shape[0] for g in genes], np.int32)}
    if genes:
        arrays["seqs"] = np.concatenate([g.seq for g in genes]).astype(np.int8)
        arrays["meta"] = np.array(
            [[g.n_reads, g.leaf, g.cluster, g.round_born, g.taxon, g.offset]
             for g in genes],
            np.int32,
        )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, header=np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)  # atomic


def save_aux_evidence(path: str, cfg: PipelineConfig, aux: dict) -> None:
    """Sidecar store of the retained round-0 leaf-exclusive pileup
    accumulators (the polish/cohort evidence, ~160 MB slot-compacted at
    config-3 scale). Saved ONCE after the discovery round so a resumed run's
    polish reuses them instead of re-streaming all of round 0.
    Counts are deterministic in the inputs, so the restored evidence is
    bitwise the uninterrupted run's."""
    arrays = {}
    if aux.get("node_counts") is not None:
        arrays["node_counts"] = np.asarray(aux["node_counts"])
    elif aux.get("slot_counts") is not None:
        counts_s, node2slot = aux["slot_counts"]
        arrays["slot_counts"] = np.asarray(counts_s)
        arrays["node2slot"] = np.asarray(node2slot)
    else:
        return
    header = dict(format=FORMAT_VERSION, fingerprint=config_fingerprint(cfg))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, header=np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)  # atomic


def load_aux_evidence(path: str, cfg: PipelineConfig) -> Optional[dict]:
    """Load the save_aux_evidence sidecar; None if absent, raises on a
    config-fingerprint mismatch (evidence from a different run must never
    silently polish this one)."""
    if not os.path.exists(path):
        return None
    z = np.load(path)
    header = json.loads(bytes(z["header"]).decode())
    if header["fingerprint"] != config_fingerprint(cfg):
        raise ValueError(
            f"aux evidence at {path} was written under a different config "
            f"(fingerprint {header['fingerprint']} != "
            f"{config_fingerprint(cfg)})")
    if "node_counts" in z:
        return dict(node_counts=z["node_counts"])
    return dict(slot_counts=(z["slot_counts"], z["node2slot"]))


def load_checkpoint(path: str) -> "Tuple[dict, List[Gene]]":
    from rambl_tpu.oracle.pipeline import Gene

    z = np.load(path)
    header = json.loads(bytes(z["header"]).decode())
    if header["format"] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {header['format']}")
    genes: "List[Gene]" = []
    lens = z["__lens__"]
    if lens.size:
        seqs = z["seqs"]
        meta = z["meta"]
        off = 0
        for i, L in enumerate(lens):
            seq = seqs[off : off + L].copy()
            off += int(L)
            n_reads, leaf, cluster, born, taxon, offset = (
                int(x) for x in meta[i])
            genes.append(Gene(seq=seq, n_reads=n_reads, leaf=leaf,
                              cluster=cluster, round_born=born, taxon=taxon,
                              offset=offset))
    return header, genes
