"""Host-side fragment model.

A fragment is one sequencing read (or merged read pair / supplementary
grouping) projected onto SNP space: a sparse map SNP position -> allele
index, with per-site base qualities. Mirrors the reference Frag
(the reference's src/types_structs.rs:68-112) but stores the SNP profile as
sorted numpy arrays once frozen, so blocks of fragments can be packed into
dense device tensors without per-read Python overhead.

SNP positions are 1-indexed (VCF record order), matching the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

SNP_MAX = np.iinfo(np.uint32).max
_I64_MAX = int(np.iinfo(np.int64).max)  # hoisted: np.iinfo is not free


class Frag:
    """Site profiles live in ONE of two representations:

    - dict mode (`_seq_dict` et al. are dicts): the mutable ingest form,
      used by the pure-Python BAM path, pair/supplementary merging, and
      the legacy frags.txt reader.
    - array mode (`_arr_*` are sorted numpy arrays, dicts are None): the
      native fast-ingest form — most reads never need per-site Python
      dicts (building them used to dominate ingest wall time), so the
      `seq_dict`/`qual_dict`/`snp_pos_to_seq_pos` properties materialize
      dicts lazily on first access and the arrays become stale.
    """

    __slots__ = (
        "id",
        "counter_id",
        "_seq_dict",
        "_qual_dict",
        "first_position",
        "last_position",
        "seq_string",
        "qual_string",
        "is_paired",
        "_sp2sp",
        "first_pos_base",
        "last_pos_base",
        "snps",
        "alleles",
        "quals",
        "weights",
        "_arr_snps",
        "_arr_alleles",
        "_arr_quals",
        "_arr_qpos",
    )

    def __init__(self, read_id: str, counter_id: int, is_paired: bool):
        self.id = read_id
        self.counter_id = counter_id
        # Sparse SNP profile, mutable during ingest (types_structs.rs:72-76).
        self._seq_dict: Optional[Dict[int, int]] = {}
        self._qual_dict: Optional[Dict[int, int]] = {}
        self.first_position = SNP_MAX  # 1-indexed SNP counter
        self.last_position = 0
        # Raw read payloads; index 0/1 = first/second of pair
        # (types_structs.rs:77-78).
        self.seq_string = [b"", b""]
        self.qual_string = [b"", b""]  # phred+33 bytes
        self.is_paired = is_paired
        # SNP position -> (pair index, position in read sequence)
        # (types_structs.rs:80).
        self._sp2sp: Optional[Dict[int, Tuple[int, int]]] = {}
        self.first_pos_base = _I64_MAX
        self.last_pos_base = _I64_MAX
        # Frozen arrays (built by freeze()).
        self.snps: Optional[np.ndarray] = None
        self.alleles: Optional[np.ndarray] = None
        self.quals: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None
        # Array-mode site profile (set by set_site_arrays).
        self._arr_snps: Optional[np.ndarray] = None
        self._arr_alleles: Optional[np.ndarray] = None
        self._arr_quals: Optional[np.ndarray] = None
        self._arr_qpos: Optional[np.ndarray] = None

    def set_site_arrays(self, snps: np.ndarray, alleles: np.ndarray,
                        quals: np.ndarray, qpos: np.ndarray) -> None:
        """Enter array mode: sorted per-site arrays (ascending 1-based
        SNP counters), pair index implicitly 0."""
        self._seq_dict = None
        self._qual_dict = None
        self._sp2sp = None
        self._arr_snps = snps
        self._arr_alleles = alleles
        self._arr_quals = quals
        self._arr_qpos = qpos
        if len(snps):
            self.first_position = int(snps[0])
            self.last_position = int(snps[-1])

    def _materialize(self) -> None:
        snps = self._arr_snps.tolist()
        if self._seq_dict is None:
            self._seq_dict = dict(zip(snps, self._arr_alleles.tolist()))
        if self._qual_dict is None:
            self._qual_dict = dict(zip(snps, self._arr_quals.tolist()))
        if self._sp2sp is None:
            self._sp2sp = {p: (0, q) for p, q in
                           zip(snps, self._arr_qpos.tolist())}
        self._arr_snps = None
        self._arr_alleles = None
        self._arr_quals = None
        self._arr_qpos = None

    @property
    def seq_dict(self) -> Dict[int, int]:
        if self._seq_dict is None:
            self._materialize()
        return self._seq_dict

    @seq_dict.setter
    def seq_dict(self, d: Dict[int, int]) -> None:
        self._seq_dict = d

    @property
    def qual_dict(self) -> Dict[int, int]:
        if self._qual_dict is None:
            self._materialize()
        return self._qual_dict

    @qual_dict.setter
    def qual_dict(self, d: Dict[int, int]) -> None:
        self._qual_dict = d

    @property
    def snp_pos_to_seq_pos(self) -> Dict[int, Tuple[int, int]]:
        if self._sp2sp is None:
            self._materialize()
        return self._sp2sp

    @snp_pos_to_seq_pos.setter
    def snp_pos_to_seq_pos(self, d: Dict[int, Tuple[int, int]]) -> None:
        self._sp2sp = d

    def set_calls(self, snp_pos: np.ndarray, calls: np.ndarray) -> None:
        """Overwrite allele calls at the given (existing) SNP counters —
        the realignment write-back — without forcing dict mode."""
        if self._seq_dict is not None:
            self._seq_dict.update(
                zip((int(p) for p in snp_pos),
                    (int(b) for b in calls)))
        else:
            idx = np.searchsorted(self._arr_snps, snp_pos)
            self._arr_alleles[idx] = calls

    # Ordering: (self.first, other.last, self.counter) vs
    # (other.first, self.last, other.counter) — start ascending, end
    # DESCENDING, then counter_id (types_structs.rs:87-93).
    def sort_key(self) -> Tuple[int, int, int]:
        return (self.first_position, -self.last_position, self.counter_id)

    def add_site(self, snp_pos: int, allele: int, qual: int,
                 pair: int, seq_pos: int) -> None:
        self.seq_dict[snp_pos] = allele
        self.qual_dict[snp_pos] = qual
        self.snp_pos_to_seq_pos[snp_pos] = (pair, seq_pos)
        if snp_pos < self.first_position:
            self.first_position = snp_pos
        if snp_pos > self.last_position:
            self.last_position = snp_pos

    def freeze(self, use_qual_weights: bool = True) -> None:
        """Convert the sparse site profile to sorted arrays for tensor
        packing."""
        if self._seq_dict is None:
            # Array mode: already sorted ascending (native extraction
            # walks alignment columns in genome order).
            self.snps = self._arr_snps.astype(np.int64, copy=False)
            self.alleles = self._arr_alleles.astype(np.int8)
            self.quals = self._arr_quals
            self.weights = phred_weight(self.quals, use_qual_weights)
            return
        if not self.seq_dict:
            self.snps = np.empty(0, dtype=np.int64)
            self.alleles = np.empty(0, dtype=np.int8)
            self.quals = np.empty(0, dtype=np.uint8)
            self.weights = np.empty(0, dtype=np.float32)
            return
        snps = np.fromiter(self.seq_dict.keys(), dtype=np.int64,
                           count=len(self.seq_dict))
        order = np.argsort(snps, kind="stable")
        self.snps = snps[order]
        alleles = np.fromiter(self.seq_dict.values(), dtype=np.int8,
                              count=len(self.seq_dict))
        self.alleles = alleles[order]
        quals = np.fromiter((self.qual_dict[int(p)] for p in self.snps),
                            dtype=np.uint8, count=len(self.snps))
        self.quals = quals
        self.weights = phred_weight(quals, use_qual_weights)

    @property
    def num_sites(self) -> int:
        if self._seq_dict is None:
            return len(self._arr_snps)
        return len(self._seq_dict)

    def __repr__(self) -> str:
        return (f"Frag({self.id!r}, n={self.num_sites}, "
                f"span={self.first_position}-{self.last_position})")


def phred_weight(quals: np.ndarray, use_qual: bool = True) -> np.ndarray:
    """Allele weight = probability the base call is correct.

    1 - 10^(-q/10), computed in float32 like the reference
    (utils_frags.rs:702-711, which uses f32 before widening).
    """
    if not use_qual:
        return np.ones_like(quals, dtype=np.float32)
    q = quals.astype(np.float32)
    return (1.0 - np.power(np.float32(10.0), q / np.float32(-10.0))).astype(
        np.float32)


def sort_and_renumber(frags) -> list:
    """Canonical fragment ordering + contiguous counter ids.

    Mirrors the main binary's sort + renumber step (bin/floria.rs:289-293): sort
    by (first asc, last desc, counter asc) then rewrite counter_id to the
    vector index so partitions can be stored as index sets.
    """
    frags = list(frags)
    if len(frags) > 512:
        # Vectorized sort: same (first asc, last desc, counter asc) key
        # as Frag.sort_key without a Python key call per frag.
        first = np.fromiter((f.first_position for f in frags), np.int64,
                            count=len(frags))
        last = np.fromiter((f.last_position for f in frags), np.int64,
                           count=len(frags))
        cid = np.fromiter((f.counter_id for f in frags), np.int64,
                          count=len(frags))
        order = np.lexsort((cid, -last, first))
        frags = [frags[i] for i in order]
    else:
        frags = sorted(frags, key=Frag.sort_key)
    for i, frag in enumerate(frags):
        frag.counter_id = i
    return frags
