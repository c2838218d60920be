"""Evaluation of phasing outputs against simulated truth.

Measures what the reference paper reports qualitatively: how accurately
vartigs reproduce strain haplotypes (switch-free allele accuracy against
the best-matching strain) and how strain-pure haplosets are.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

import numpy as np

from .simulate import SimTruth


@dataclasses.dataclass
class VartigEval:
    num_vartigs: int
    weighted_accuracy: float        # span-weighted best-strain accuracy
    total_span: int
    covered_fraction: float         # fraction of SNPs covered >= 1x


@dataclasses.dataclass
class HaplosetEval:
    num_groups: int
    weighted_purity: float          # size-weighted majority-strain share
    n50_reads: int


def parse_vartigs(path: str) -> List[Tuple[Dict[str, str], str]]:
    out = []
    with open(path) as fh:
        lines = [line.rstrip("\n") for line in fh]
    for i in range(0, len(lines) - 1, 2):
        header, seq = lines[i], lines[i + 1]
        fields = dict(kv.split(":", 1) for kv in header.split("\t")[1:])
        out.append((fields, seq))
    return out


def evaluate_vartigs(path: str, truth: SimTruth) -> VartigEval:
    vartigs = parse_vartigs(path)
    num_snps = truth.strain_alleles.shape[1]
    covered = np.zeros(num_snps, bool)
    accs, spans = [], []
    for fields, seq in vartigs:
        m = re.match(r"(\d+)-(\d+)", fields["SNPRANGE"])
        left = int(m.group(1))
        calls = np.frombuffer(seq.encode(), dtype=np.uint8)
        idx = np.arange(len(calls)) + left - 1
        ok = calls != ord("?")
        if not ok.any():
            continue
        covered[idx[ok]] = True
        alleles = calls[ok] - ord("0")
        best = 0.0
        for k in range(truth.strain_alleles.shape[0]):
            best = max(best, float(
                (truth.strain_alleles[k, idx[ok]] == alleles).mean()))
        accs.append(best)
        spans.append(int(ok.sum()))
    if not accs:
        return VartigEval(0, 0.0, 0, 0.0)
    return VartigEval(
        num_vartigs=len(accs),
        weighted_accuracy=float(np.average(accs, weights=spans)),
        total_span=int(np.sum(spans)),
        covered_fraction=float(covered.mean()))


def parse_haplosets(path: str) -> List[List[str]]:
    groups: List[List[str]] = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                groups.append([])
            elif line and groups:
                groups[-1].append(line.split("\t")[0])
    return groups


def evaluate_haplosets(path: str, truth: SimTruth) -> HaplosetEval:
    groups = parse_haplosets(path)
    purities, sizes = [], []
    for reads in groups:
        strains = [truth.read_strains[r] for r in reads
                   if r in truth.read_strains]
        if len(strains) < 2:
            continue
        counts = np.bincount(strains)
        purities.append(counts.max() / len(strains))
        sizes.append(len(strains))
    if not sizes:
        return HaplosetEval(0, 0.0, 0)
    order = np.argsort(sizes)[::-1]
    cum = np.cumsum(np.asarray(sizes)[order])
    n50 = int(np.asarray(sizes)[order][
        np.searchsorted(cum, cum[-1] / 2)])
    return HaplosetEval(
        num_groups=len(sizes),
        weighted_purity=float(np.average(purities, weights=sizes)),
        n50_reads=n50)
