"""Seed-table index builder: the device-side replacement for `bwa index`.

The reference builds a BWT/FM-index with suffix-array sampling (SURVEY.md
section 2.2 item 1, BWA in C). FM-index backward search is pointer-chasing and
hostile to accelerator memory (SURVEY.md section 7.4.3), so the index is a
*hashed k-mer seed table laid out as dense int32 tensors*:

- all k-mers of every reference sequence are enumerated on the host (NumPy),
- keys are hashed into P = 2^b buckets (multiplicative hash),
- entries are stored CSR-style: `bucket_start[P+1]` offsets into flat
  `entry_key/entry_ref/entry_pos` arrays, ordered within a bucket by
  (key, scramble(ref, pos), ref, pos) where scramble is a deterministic
  32-bit mix. The SCRAMBLE term is load-bearing for output quality: the
  probe scans only the first `bucket_cap` entries of a k-mer's run, and a
  plain (key, ref, pos) order made that truncation systematically keep the
  LOWEST ref ids - any ref whose k-mer is carried by >= cap lower-id refs
  became invisible to seeding there. Measured at config-3 scale (r5): reads
  straddling a conserved 16S block lost their true high-id ref from the
  candidate list entirely, aligned CLIPPED to ref 0 (which is index-
  privileged in every conserved bucket), and the 28 highest-abundance
  references were missed with ~70-column corrupted consensus zones. The
  scrambled order makes the capped scan an unbiased deterministic sample of
  the k-mer's carriers instead.

Device-side lookup (rambl_tpu.ops.seed / oracle.seed) is then pure
gather + compare over dense arrays, with no pointer chasing.
The table is replicated across devices when it fits, or sharded by bucket
range with ring rotation of read blocks (SURVEY.md section 2.3 "TP/SP").
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Knuth multiplicative hashing constant (2^32 / golden ratio), as used by many
# open-addressing schemes; applied to the 2k-bit k-mer key.
_HASH_MULT = np.uint64(2654435769)


def hash_kmer(keys: np.ndarray, n_bits: int) -> np.ndarray:
    """Multiplicative hash of k-mer keys into [0, 2^n_bits). int64-safe."""
    k = np.asarray(keys).astype(np.uint64)
    h = (k * _HASH_MULT) & np.uint64(0xFFFFFFFF)
    return (h >> np.uint64(32 - n_bits)).astype(np.int64)


@dataclasses.dataclass
class SeedIndex:
    k: int
    n_bits: int                 # log2 number of buckets
    bucket_start: np.ndarray    # (P+1,) int32 CSR offsets
    entry_key: np.ndarray       # (n_entries,) int32 k-mer key (2k bits, k<=15)
    entry_ref: np.ndarray       # (n_entries,) int32 reference id
    entry_pos: np.ndarray       # (n_entries,) int32 position on reference
    n_refs: int
    max_bucket: int             # largest bucket size (diagnostic)

    @property
    def n_buckets(self) -> int:
        return 1 << self.n_bits

    @property
    def n_entries(self) -> int:
        return int(self.entry_key.shape[0])

    def arrays(self) -> dict:
        return dict(
            bucket_start=self.bucket_start,
            entry_key=self.entry_key,
            entry_ref=self.entry_ref,
            entry_pos=self.entry_pos,
        )

    def padded_entries(self, cap: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense (P, cap) views of the first `cap` entries of every bucket.

        This is the layout the jitted lookup consumes: a plain 2D gather by
        bucket id, no CSR indirection on device. Returns (keys, refs, pos) with
        key == -1 marking empty slots.
        """
        P = self.n_buckets
        keys = np.full((P, cap), -1, dtype=np.int32)
        refs = np.zeros((P, cap), dtype=np.int32)
        pos = np.zeros((P, cap), dtype=np.int32)
        counts = np.diff(self.bucket_start)
        take = np.minimum(counts, cap)
        for b in np.nonzero(take)[0]:
            s = self.bucket_start[b]
            t = take[b]
            keys[b, :t] = self.entry_key[s : s + t]
            refs[b, :t] = self.entry_ref[s : s + t]
            pos[b, :t] = self.entry_pos[s : s + t]
        return keys, refs, pos


def build_seed_index(
    ref_seqs: np.ndarray,
    ref_lens: np.ndarray,
    k: int = 15,
    n_bits: int | None = None,
) -> SeedIndex:
    """Build the CSR seed table from padded int8 reference codes.

    k <= 15 keeps keys within int32 (2k = 30 bits). Bucket count defaults to
    ~2x the entry count rounded up to a power of two (load factor ~0.5).
    """
    assert k <= 15, "k-mer keys must fit int32"
    # Batched extraction: all refs' windows at once (row-chunked to bound the
    # (chunk, Lmax-k+1) int64 temporaries at ~a few hundred MB). 100k
    # Greengenes-sized refs: ~6s vs ~90s for the per-ref Python loop.
    R, Lmax = ref_seqs.shape
    lens = np.asarray(ref_lens, dtype=np.int64)
    n_win = max(Lmax - k + 1, 0)
    all_keys, all_refs, all_pos = [], [], []
    chunk = max(1, (64 << 20) // max(n_win, 1))      # ~256 MB of int32 keys
    for r0 in range(0, R, chunk) if n_win > 0 else ():
        r1 = min(r0 + chunk, R)
        codes = np.asarray(ref_seqs[r0:r1])
        # 2k <= 30 bits: accumulate keys in int32 (half the bandwidth)
        key = np.zeros((r1 - r0, n_win), dtype=np.int32)
        for j in range(k):
            np.left_shift(key, 2, out=key)
            np.bitwise_or(key, (codes[:, j : j + n_win] & 0x3).astype(np.int32),
                          out=key)
        # a window is valid iff it contains no N (code 4): one cumsum over the
        # N indicator replaces k boolean passes
        ncum = np.cumsum(codes >= 4, axis=1, dtype=np.int32)
        nbad = ncum[:, k - 1 : k - 1 + n_win].copy()
        nbad[:, 1:] -= ncum[:, : n_win - 1]
        valid = nbad == 0
        # windows past each ref's length are invalid
        valid &= np.arange(n_win)[None, :] <= (lens[r0:r1, None] - k)
        rr, pp = np.nonzero(valid)
        # int32 throughout the build: keys are <= 30 bits, ref/pos fit easily
        # - the full-Greengenes build moves ~150M entries through concat,
        # hash, sort and permute, so every dropped byte is ~150 MB of traffic
        all_keys.append(key[rr, pp])
        all_refs.append((rr + r0).astype(np.int32))
        all_pos.append(pp.astype(np.int32))
    keys = np.concatenate(all_keys) if all_keys else np.zeros(0, np.int32)
    refs = np.concatenate(all_refs) if all_refs else np.zeros(0, np.int32)
    pos = np.concatenate(all_pos) if all_pos else np.zeros(0, np.int32)

    n_entries = keys.shape[0]
    if n_bits is None:
        # cap at 2^27 buckets: a full-Greengenes index (~150M entries) would
        # otherwise allocate a 2+ GB bucket_start array for marginal benefit
        # (the capped bucket scan tolerates load factors > 1)
        n_bits = min(27, max(8, int(np.ceil(np.log2(max(n_entries, 1) * 2 + 1)))))

    # Sort by (bucket, key, scramble(ref,pos), ref, pos): deterministic
    # UNBIASED capped scans (module docstring - a (ref, pos) suffix order
    # made bucket_cap truncation drop every high-id ref of a popular k-mer).
    # Two stable radix passes: first by the scramble mix (entries are
    # enumerated in (ref, pos) order, so stability supplies the (ref, pos)
    # tiebreak), then by the packed (bucket, key) int64 (bucket <= 27 bits,
    # key 2k <= 30 bits) - numpy's stable int sort is radix (~8s/pass vs
    # ~160s lexsort at 150M entries). bucket and key come back out of the
    # SORTED packed value (shift/mask) instead of two more 150M gathers; the
    # hash itself runs in uint32 (mod-2^32 by construction, hash_kmer parity
    # asserted in tests).
    scr = refs.astype(np.uint32)
    np.multiply(scr, np.uint32(2246822519), out=scr)
    scr ^= pos.astype(np.uint32)
    np.multiply(scr, _HASH_MULT.astype(np.uint32), out=scr)
    pre = np.argsort(scr.view(np.int32), kind="stable")
    del scr
    keys = keys[pre]
    refs = refs[pre]
    pos = pos[pre]
    del pre
    if n_bits + 2 * k <= 62:
        h = keys.astype(np.uint32)
        np.multiply(h, _HASH_MULT.astype(np.uint32), out=h)
        b = (h >> np.uint32(32 - n_bits)).astype(np.int64)
        del h
        packed = np.bitwise_or(np.left_shift(b, 2 * k, out=b),
                               keys.astype(np.int64), out=b)
        order = np.argsort(packed, kind="stable")
        del packed, b
        keys = keys[order]
        refs = refs[order]
        pos = pos[order]
        del order
        # the bucket of each sorted entry: one uint32 multiply pass over the
        # sorted int32 keys, far cheaper than gathering an int64 bucket array
        h = keys.astype(np.uint32)
        np.multiply(h, _HASH_MULT.astype(np.uint32), out=h)
        bucket = (h >> np.uint32(32 - n_bits)).astype(np.int32)
        del h
    else:
        bucket = hash_kmer(keys.astype(np.int64), n_bits)
        order = np.argsort(
            np.bitwise_or(bucket.astype(np.int64) << (2 * k),
                          keys.astype(np.int64)), kind="stable")
        bucket, keys, refs, pos = (bucket[order], keys[order], refs[order],
                                   pos[order])

    P = 1 << n_bits
    counts = np.bincount(bucket, minlength=P)
    bucket_start = np.zeros(P + 1, dtype=np.int32)
    np.cumsum(counts, out=bucket_start[1:])

    return SeedIndex(
        k=k,
        n_bits=n_bits,
        bucket_start=bucket_start,
        entry_key=keys.astype(np.int32),
        entry_ref=refs.astype(np.int32),
        entry_pos=pos.astype(np.int32),
        n_refs=int(ref_seqs.shape[0]),
        max_bucket=int(counts.max()) if P else 0,
    )
