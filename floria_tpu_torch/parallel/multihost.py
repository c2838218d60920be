"""Multi-process execution: contigs sharded over processes (port of
floria_tpu/parallel/multihost.py).

Each process phases its share of the contigs (the BAM is scanned by every
process, only its contigs are decoded into fragments) on its own devices
and writes its own per-contig output directories; per-contig outputs are
independent. Only the summary TSV is shared: each process appends to
contig_ploidy_info.<rank>.tsv and rank 0 merges them after a barrier.

No data crosses processes, so there is no process group: the barrier is
a torch.distributed.TCPStore that rank 0 hosts at --coordinator. The
store also tells the ranks that share a host how many they are, and they
split its cores between their torch intra-op pools and their host worker
budgets (-t, which sizes the native realignment and ingest pools):
oversubscribed OpenMP pools made two CPU ranks on one 8-core host phase
~25x slower.
"""

from __future__ import annotations

import datetime
import glob
import hashlib
import json
import logging
import os
import socket
from typing import List, Optional

import torch

from .. import constants
from ..native import BUILD_DIR
from ..options import Options

log = logging.getLogger("floria_tpu")

# Rank skew at the barrier is normal at hundreds of contigs per shard.
STORE_TIMEOUT = datetime.timedelta(hours=6)
_BARRIER = "floria_tpu_tsv_merge"


def initialize_distributed(coordinator: Optional[str],
                           num_processes: Optional[int],
                           process_id: int):
    """The run's TCPStore, hosted by rank 0 at `coordinator` (host:port);
    None when single-process. Raises without a coordinator."""
    if num_processes is None or num_processes <= 1:
        return None
    if not coordinator:
        raise ValueError("--num-processes > 1 needs --coordinator "
                         "host:port (rank 0 hosts the store there)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} outside "
                         f"0..{num_processes - 1}")
    from torch.distributed import TCPStore

    host, port = coordinator.rsplit(":", 1)
    return TCPStore(host, int(port), world_size=num_processes,
                    is_master=process_id == 0, timeout=STORE_TIMEOUT)


def _share_host_cores(store, options: Options, num_processes: int,
                      process_id: int) -> None:
    """Divide this process's torch intra-op threads and its host worker
    budget (options.num_threads, which pipeline.run hands to the native
    pools) by the number of ranks on its host (each rank publishes its
    host name)."""
    host = socket.gethostname()
    store.set(f"host/{process_id}", host)
    local = sum(store.get(f"host/{k}").decode() == host
                for k in range(num_processes))
    torch.set_num_threads(max(1, torch.get_num_threads() // local))
    options.num_threads = max(1, options.num_threads // local)


def contigs_for_process(contigs: List[str], process_id: int,
                        num_processes: int,
                        weights: Optional[List[float]] = None
                        ) -> List[str]:
    """Deterministic contig shard for one process.

    Without weights: round-robin by index. With per-contig work weights
    (SNP counts): LPT greedy, contigs in descending weight order, each to
    the currently lightest shard, ties broken by (weight, index) and the
    lowest process id, so every process computes the same partition.
    Within a shard the original contig order is kept."""
    if weights is None:
        return [c for i, c in enumerate(contigs)
                if i % num_processes == process_id]
    if len(weights) != len(contigs):
        raise ValueError("weights/contigs length mismatch")
    order = sorted(range(len(contigs)),
                   key=lambda i: (-float(weights[i]), i))
    load = [0.0] * num_processes
    count = [0] * num_processes
    assign: List[List[int]] = [[] for _ in range(num_processes)]
    for i in order:
        p = min(range(num_processes),
                key=lambda q: (load[q], count[q], q))
        load[p] += float(weights[i])
        count[p] += 1
        assign[p].append(i)
    return [contigs[i] for i in sorted(assign[process_id])]


def run_multihost(options: Options, num_processes: int, process_id: int,
                  coordinator: Optional[str] = None, *, device) -> None:
    """Phase this process's contig shard on `device` (a device or a block
    mesh), then merge the summary TSVs on rank 0 after a barrier. A rank
    that fails once the store is up still reaches the barrier, so no
    rank waits for it, and raises; rank 0 then raises too, without
    merging."""
    store = initialize_distributed(coordinator, num_processes, process_id)
    from ..ingest import bam as bamlib
    from ..pipeline import run

    failed = None
    try:
        if store is not None:
            _share_host_cores(store, options, num_processes, process_id)
        all_contigs = bamlib.get_contigs_to_phase(options.bam_file)
        weights = None
        if num_processes > 1:
            # Work-aware sharding by per-contig SNP count; every rank
            # derives the same weights from the same VCF.
            counts = _contig_snp_counts(options.vcf_file)
            weights = [counts.get(c, 0) for c in all_contigs]
        mine = contigs_for_process(all_contigs, process_id, num_processes,
                                   weights)
        if options.list_to_phase:
            mine = [c for c in mine if c in options.list_to_phase]
        options.list_to_phase = mine
        # Each process appends to its own summary TSV: concurrent appends
        # to one file would interleave rows.
        if num_processes > 1:
            options.ploidy_tsv = f"contig_ploidy_info.{process_id}.tsv"
        os.makedirs(options.out_dir, exist_ok=True)
        tsv_path = os.path.join(options.out_dir, options.ploidy_tsv)
        if not os.path.exists(tsv_path):
            with open(tsv_path, "w") as fh:
                fh.write(constants.CONTIG_PLOIDY_HEADER)
        # An empty list_to_phase means "every contig" to the pipeline: a
        # rank with no contig of its own phases nothing.
        if mine:
            run(options, device=device)
    except Exception as e:
        failed = e
    all_ok = _barrier(store, num_processes, process_id, failed is not None)
    if failed is not None:
        raise failed
    if not all_ok:
        raise RuntimeError("another rank failed; contig_ploidy_info.tsv "
                           "was not merged")
    if process_id == 0 and num_processes > 1:
        _merge_ploidy_tsvs(options, all_contigs)


def _contig_snp_counts(vcf_file: str) -> dict:
    """{contig: SNP count} for the whole VCF, cached in a sidecar under
    the port's build directory, valid while the VCF's mtime and size
    hold."""
    st = os.stat(vcf_file)
    cache_dir = os.path.join(BUILD_DIR, "cache")
    key = hashlib.sha1(os.path.abspath(vcf_file).encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"vcfsnps_{key}.json")
    try:
        with open(path) as fh:
            sc = json.load(fh)
        if sc["mtime_ns"] == st.st_mtime_ns and sc["size"] == st.st_size:
            return sc["num_snps"]
    except (OSError, ValueError, KeyError):
        pass
    from ..ingest.vcf import read_vcf

    profile = read_vcf(vcf_file)  # unrestricted: reusable for any BAM
    counts = {c: cv.num_snps for c, cv in profile.contigs.items()}
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump({"mtime_ns": st.st_mtime_ns, "size": st.st_size,
                       "num_snps": counts}, fh)
        os.replace(tmp, path)
    except OSError as e:
        log.debug("SNP-count sidecar not written (%s)", e)
    return counts


def _barrier(store, num_processes: int, process_id: int,
             failed: bool) -> bool:
    """Wait until every rank has finished phasing; True when none failed.

    Each rank adds its failure flag, then one to an arrival counter; the
    rank that brings it to num_processes sets the "done" key every rank
    waits on. Rank 0 hosts the store, so it leaves only after every rank
    has passed that wait (a second counter)."""
    if store is None:
        return not failed
    store.add(f"{_BARRIER}/failed", int(failed))
    if store.add(f"{_BARRIER}/arrived", 1) == num_processes:
        store.set(f"{_BARRIER}/done", "1")
    store.wait([f"{_BARRIER}/done"])
    all_ok = store.add(f"{_BARRIER}/failed", 0) == 0
    if store.add(f"{_BARRIER}/passed", 1) == num_processes:
        store.set(f"{_BARRIER}/all_passed", "1")
    if process_id == 0:
        store.wait([f"{_BARRIER}/all_passed"])
    return all_ok


def _merge_ploidy_tsvs(options: Options,
                       contig_order: List[str]) -> None:
    """Merge per-process TSVs into one, rows in contig order."""
    rows = {}
    for path in glob.glob(os.path.join(options.out_dir,
                                       "contig_ploidy_info.*.tsv")):
        with open(path) as fh:
            for line in fh:
                if line.startswith("contig\t") or not line.strip():
                    continue
                rows[line.split("\t", 1)[0]] = line
    with open(os.path.join(options.out_dir,
                           "contig_ploidy_info.tsv"), "w") as out:
        out.write(constants.CONTIG_PLOIDY_HEADER)
        for contig in contig_order:
            if contig in rows:
                out.write(rows[contig])
