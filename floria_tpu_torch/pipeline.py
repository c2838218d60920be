"""Per-contig pipeline orchestration on torch (port of
floria_tpu/pipeline.py).

ingest -> realign (native C++ Gotoh, or the device NW for large
partitions) -> (hybrid polish) -> (monomorphic filter) -> block phasing
on the device -> hap-graph -> LP flow -> widest paths -> final
assignment -> SNP-less gap reads -> outputs.
Contigs run in groups: realignment jobs and SNP-block instances of a
whole group share one flush and one set of device batches. Every host
stage is the port's copy of floria_tpu's, unchanged; the phasing dispatch
and the realigner run on torch.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

from . import fragops, threads, timing
from .frag import Frag, sort_and_renumber
from .graph.edges import update_hap_graph
from .graph.flow import solve_lp_graph
from .graph.hapnode import FragCsr, HapNode, assign_ids, build_hap_node
from .graph.paths import get_disjoint_paths
from .ingest import bam as bamlib
from .ingest.fasta import FastaFile
from .ingest.vcf import VcfProfile, read_vcf
from .ingest.fragments import collect_contig_records, finalize_frags
from .kernels.realign import RealignPool, flush_pool
from .options import Options
from .out.writers import write_outputs
from .parallel.mesh import make_block_mesh
from .phase.local import LocalBlockResult, phase_contigs_blocks
from .post.finalize import process_reads_for_final_parts
from .post.snpless import frags_in_snpless_gaps

log = logging.getLogger("floria_tpu")


def open_bam(path: str, restrict=None):
    """Native-accelerated BAM when the C++ runtime is available, pure
    Python otherwise."""
    try:
        from .ingest.fastingest import FastBam
        return FastBam(path, restrict=restrict)
    except Exception as e:
        log.debug("native BAM path unavailable (%s); using pure decoder",
                  e)
        return bamlib.BamFile(path)


@dataclasses.dataclass
class _ContigState:
    contig: str
    out_dir: str
    cv: object
    ref_seq: Optional[bytes]
    final_frags: List[Frag]
    frags_without_snps: List[Frag]
    short_frags: List[Frag]
    debug_dir: Optional[str]


def _warm_imports() -> None:
    """Pre-import scipy's LP stack on a daemon thread: the first linprog
    otherwise pays its import inside the join stage."""
    def _load():
        try:
            from scipy import sparse  # noqa: F401
            from scipy.optimize import linprog  # noqa: F401
        except ImportError:
            pass

    threading.Thread(target=_load, daemon=True).start()


def run(options: Options, *, device) -> None:
    """Phase every eligible contig of options.bam_file on `device`, a
    device or a block mesh (parallel/mesh.py make_block_mesh, which also
    reads options.num_devices). Block phasing shards over the mesh;
    realignment runs on its first device."""
    mesh = make_block_mesh(options.num_devices, device=device)
    options.validate()
    threads.set_num_threads(options.num_threads)
    timing.reset()
    _warm_imports()
    t0 = time.time()
    log.info("Preprocessing VCF/Reference")
    contigs = bamlib.get_contigs_to_phase(options.bam_file)
    main_bam = open_bam(options.bam_file,
                        restrict=options.list_to_phase or None)
    short_bam = (open_bam(options.short_bam_file)
                 if options.short_bam_file else None)
    vcf_profile = read_vcf(options.vcf_file, contigs)
    fasta = (FastaFile(options.reference_fasta)
             if options.reference_fasta else None)

    eligible = []
    warn_first = True
    for contig in contigs:
        if options.list_to_phase and contig not in options.list_to_phase:
            continue
        if (contig not in vcf_profile
                or vcf_profile.get(contig).num_snps
                < options.snp_count_filter):
            if warn_first:
                log.warning(
                    "A contig (%s) is not present or has < %d variants.",
                    contig, options.snp_count_filter)
            warn_first = False
            continue
        eligible.append(contig)

    batch = max(1, options.contig_batch)
    # Depth-1 group pipelining: each group's join/outputs run on a worker
    # thread while the next group ingests and phases; joins chain in
    # group order so outputs land as in the sequential loop. Off under
    # --keep-going, whose per-group retry needs errors in their group.
    pipelined = not options.keep_going
    prev_join = None
    try:
        for lo in range(0, len(eligible), batch):
            group = eligible[lo:lo + batch]
            try:
                prev_join = _run_group(group, main_bam, short_bam,
                                       vcf_profile, fasta, options, mesh,
                                       prev_join=prev_join,
                                       async_join=pipelined)
            except Exception:
                if not options.keep_going or len(group) == 1:
                    if not options.keep_going:
                        raise
                    log.exception(
                        "Contig %s failed; --keep-going continues.",
                        group[0])
                    continue
                for contig in group:
                    try:
                        _run_group([contig], main_bam, short_bam,
                                   vcf_profile, fasta, options, mesh)
                    except Exception:
                        log.exception(
                            "Contig %s failed; --keep-going continues.",
                            contig)
        if prev_join is not None:
            prev_join()
            prev_join = None
    except BaseException:
        # Drain the previous group's pending join so teardown cannot cut
        # its writer thread mid-file.
        if prev_join is not None:
            try:
                prev_join()
            except Exception:
                log.exception("Deferred join failed during unwind.")
        raise
    log.info("Total time taken is %.2fs", time.time() - t0)


def _run_group(group: List[str], main_bam, short_bam,
               vcf_profile: VcfProfile, fasta: Optional[FastaFile],
               options: Options, mesh, prev_join=None,
               async_join: bool = False):
    """Process one contig group; with async_join the join/outputs run on
    a worker thread and a wait-callable is returned."""
    t0 = time.time()
    device = mesh[0]
    pool = RealignPool() if fasta is not None else None
    collected = []
    for contig in group:
        cv = vcf_profile.get(contig)
        ref_seq = fasta.fetch(contig) if fasta is not None else None
        contig_out_dir = os.path.join(options.out_dir, contig)
        if os.path.exists(contig_out_dir):
            done = os.path.join(contig_out_dir, f"{contig}.vartigs")
            if options.resume and os.path.exists(done):
                log.info("Contig %s already phased; --resume skips it.",
                         contig)
                continue
            if options.overwrite:
                shutil.rmtree(contig_out_dir, ignore_errors=True)
        log.info("Reading and realigning inputs for contig %s.", contig)
        col_t = time.time()
        id_map = collect_contig_records(main_bam, short_bam, cv, options,
                                        ref_seq, contig,
                                        realign_pool=pool, device=device)
        timing.add("ingest.collect", time.time() - col_t)
        collected.append((contig, contig_out_dir, cv, ref_seq, id_map))
    if pool is not None:
        flush_t = time.time()
        flush_pool(pool, device=device)
        timing.add("realign_dispatch", time.time() - flush_t)

    states: List[_ContigState] = []
    fin_t = time.time()
    for contig, contig_out_dir, cv, ref_seq, id_map in collected:
        all_frags, frags_without_snps = finalize_frags(id_map, cv,
                                                       options)
        log.info("Number of reads passing filtering: %d (%s)",
                 len(all_frags), contig)
        if not all_frags:
            continue
        os.makedirs(contig_out_dir, exist_ok=True)
        all_frags = sort_and_renumber(all_frags)
        for f in all_frags:
            f.freeze()
        for f in frags_without_snps:
            f.freeze()

        short_frags: List[Frag] = []
        if options.hybrid:
            final_frags, short_frags = fragops.hybrid_correction(
                all_frags)
            final_frags = sort_and_renumber(final_frags)
        else:
            final_frags = all_frags
        if options.ignore_monomorphic:
            final_frags = fragops.remove_monomorphic_allele(
                final_frags, options.epsilon)
        debug_dir = (os.path.join(contig_out_dir, "local_parts")
                     if log.isEnabledFor(logging.DEBUG) else None)
        states.append(_ContigState(
            contig=contig, out_dir=contig_out_dir, cv=cv,
            ref_seq=ref_seq, final_frags=final_frags,
            frags_without_snps=frags_without_snps,
            short_frags=short_frags, debug_dir=debug_dir))
    if not states:
        return prev_join
    timing.add("ingest.finalize", time.time() - fin_t)
    log.info("Reading inputs, realigning time taken %.2fs",
             time.time() - t0)
    timing.add("ingest_realign", time.time() - t0)

    phasing_t = time.time()
    results_by_contig = phase_contigs_blocks(
        [(st.contig, st.final_frags, st.cv.genome_pos, st.debug_dir)
         for st in states], options, device=mesh)
    log.info("Phasing time taken %.2fs", time.time() - phasing_t)
    timing.add("phasing", time.time() - phasing_t)

    if prev_join is not None:
        prev_join()

    def _join_all():
        join_t = time.time()
        for st in states:
            _finish_contig(st, results_by_contig.get(st.contig, []),
                           options)
        timing.add("join_outputs", time.time() - join_t)

    if not async_join:
        _join_all()
        return None

    box: Dict[str, BaseException] = {}

    def _worker():
        try:
            _join_all()
        except BaseException as e:  # re-raised at the wait point
            box["err"] = e

    th = threading.Thread(target=_worker, daemon=True)
    th.start()

    def _wait():
        th.join()
        if "err" in box:
            raise box["err"]

    return _wait


def _finish_contig(st: _ContigState, results: List[LocalBlockResult],
                   options: Options) -> None:
    """Host join of one contig: hap-graph, LP flow, widest paths, final
    read assignment and outputs (the reference's, unchanged)."""
    contig = st.contig
    final_frags = st.final_frags
    snp_to_genome_pos = st.cv.genome_pos
    contig_len = (len(st.ref_seq) if st.ref_seq is not None
                  else int(snp_to_genome_pos[-1]) + 1)

    if not results:
        write_outputs([], [], st.out_dir, contig, final_frags,
                      snp_to_genome_pos, options, st.frags_without_snps,
                      contig_len)
        return

    graph_t = time.time()
    csr = FragCsr(final_frags)
    hap_graph: List[List[HapNode]] = []
    for res in results:
        column = len(hap_graph)
        block_nodes = []
        for row, ids in enumerate(res.part_frag_ids):
            block_nodes.append(build_hap_node(final_frags, ids,
                                              res.snp_range, column, row,
                                              csr=csr))
        hap_graph.append(block_nodes)
    assign_ids(hap_graph)
    update_hap_graph(hap_graph, final_frags, csr=csr)
    timing.add("join.hap_graph", time.time() - graph_t)

    lp_t = time.time()
    flow_vec = solve_lp_graph(hap_graph)
    log.info("Flow solved in time %.2fs", time.time() - lp_t)
    timing.add("join.lp", time.time() - lp_t)

    paths_t = time.time()
    haplogroups = get_disjoint_paths(hap_graph, flow_vec)
    timing.add("join.paths", time.time() - paths_t)
    if log.isEnabledFor(logging.DEBUG):
        from .graph.paths import write_pet_graph_dot
        write_pet_graph_dot(hap_graph,
                            os.path.join(st.out_dir, "pet_graph.dot"))
    if options.do_binning:
        from .post.binning import bin_haplogroups
        haplogroups = bin_haplogroups(
            haplogroups, st.cv, options.block_length,
            debug_path=os.path.join(st.out_dir, "debug_clusters.txt"))

    combined = list(final_frags)
    for f in st.short_frags:
        f.counter_id = len(combined)
        combined.append(f)
    csr_all = csr if not st.short_frags else FragCsr(combined)

    final_t = time.time()
    parts, ranges = process_reads_for_final_parts(
        haplogroups, combined, st.short_frags, options, csr=csr_all)
    snpless = frags_in_snpless_gaps(ranges, snp_to_genome_pos,
                                    st.frags_without_snps,
                                    options.block_length, final_frags)
    timing.add("join.final_parts", time.time() - final_t)

    write_t = time.time()
    write_outputs(parts, ranges, st.out_dir, contig, combined,
                  snp_to_genome_pos, options, snpless, contig_len,
                  csr=csr_all)
    timing.add("join.write", time.time() - write_t)
