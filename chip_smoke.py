#!/usr/bin/env python3
"""Smoke test of the hadoop_bam_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--reads 2000000]

Phases (any failure raises and exits non-zero):

1. environment: torch / CUDA / triton / nvcc versions and the card;
2. kernel build: nvcc for every CUDA source of the port, all at once,
   and the host C++ library;
3. K1 (fixed-field gather) on the card against its plain PyTorch version
   at the span-mode geometry (D = 16 MiB, N = 262,144), with its time;
4. K2 (seq/qual stats) on the card against its plain version at the
   default payload geometry (65,536 rows of 96 + 160 bytes of real
   reads), on random bytes (all 16 codes), odd widths, base addresses off
   16 bytes, n = 1 and n off a stage's rows, twice in a row, and the
   2^24-bases histogram case; its ptxas line, launch geometry and time,
   and its time on the same rows through the direct path and with every
   length 0;
5. the native plane's main path: a synthetic paired-end BAM
   (``--reads`` 151-bp reads, made from ``--seed``) through
   ``open_bam(path, config=native).flagstat()``, ``.seq_stats()`` and the
   span-mode ``.flagstat(mode="span")`` on cuda:0, checked against the
   generator's own counts, with each kernel's launch count from that run;
6. K7+K8 (LZ77 resolve + pack) against its plain version and zlib's
   bytes, each case twice in a row: the BAM's first 63 BGZF blocks and
   one run-length block at B = 64, P = 65,536 (full and narrow token
   rows), the main path's chunk (the first 17 blocks in 32 rows of
   narrow token rows, pad rows uninitialised) and the same blocks stored,
   and a chunk on each smaller rung (8 KiB, 1 KiB); its launch and ptxas
   lines, its time at the 64-block, 17-block and stored chunks beside
   the plain version's, its bound and doubling passes, at each cluster
   width with a phase split (``k7_times``);
7. K9 (record walk) against its plain version on a 64-block chunk of the
   BAM and on a cut final record, start past the buffer, stop mid-chunk,
   a block_size below 32, one past the buffer, and more records than R,
   and on the tiled walk's edge cases (``synth.walk_cases``), each twice
   in a row; its time at that chunk and at the main path's usual
   17-block chunk, with |C|, tiles, rounds and its ptxas lines;
8. K10p (payload gather) against its plain version on that chunk's walk
   and on the edge rows of ``synth.payload_rows`` (in ``buf`` and in a
   view 3 bytes off 16, and at n_all -1, 0, 1, R and R + 7), each at
   strides (96, 160) and (17, 33) with the allocator poisoned first; its
   launch and ptxas lines, and ``k10p_times``: its time at the 64-block
   and the main path's 17-block chunk beside its bound and plain
   version's, with n_all = 0, with L2 flushed before each launch (by a
   read and by a write of another buffer), inside
   the device plane's step on the 17-block chunk, the store floor and
   the K10p -> K2 pair; then (8b) K1 and
   K2 at the shapes the device plane gives them (that chunk's walk
   offsets at ``records_cap`` rows, and its payload tiles) against their
   plain versions, with their times and bounds there;
9. the device decode plane's main path: what "auto" resolves to and
   ``probe_device_plane()``'s reading, then ``flagstat()`` and
   ``seq_stats()`` with ``inflate_backend="device"`` over the same BAM,
   checked against the generator's counts, with every kernel of that
   path launched, walls, rates and device-busy shares beside the native
   plane's, and the plane's host stages timed alone (the span plan at
   the plane's 512 KiB grain and at the native flagstat's 4 MiB);
10. resilience and intervals through the entry points, on the same BAM:
   (a) ``bam_intervals`` set to two regions (~10% and ~50% of the
   reads) on the native plane and with the device plane named (the
   gate sends it to the native plane), against the generator's interval
   truth; (b) seeded ``device.step`` faults on the device plane: the
   run demotes to the host planes with the whole-file truth, and after
   the breaker's cooldown (an injected clock) a run heals the device
   plane, launching every device-plane kernel; (c) seeded transient
   ``decode.native`` faults: retried, the truth, retries > 0; (d) a copy
   with one BGZF block flipped under ``skip_bad_spans``: equal counters
   and quarantine manifests (one span) on cuda:0 and on the CPU, and
   without it the CORRUPT class raised.  Each run's wall and reads/s;
11. span planning and the fused decode through the entry points, on a
   hard link to the same BAM (its sidecars never sit next to the file of
   phases 5-10) and on a coordinate-sorted copy of the same reads (a
   ``.bai`` indexes a sorted BAM; the host ``sort_bam`` of the BAM, whose
   digests are phase 16's oracle): (a) the ``.splitting-bai``
   (granularity 4096) and ``.bai`` writers, timed; (b) the native
   drivers and the device plane planned from the ``.splitting-bai``:
   the truth, plan walls against phase 9's guessed plan, span counts,
   the largest span in blocks and the spans past 64 blocks; (c) second
   calls hit the plan memo (warm walls), and a rewritten sidecar plans
   again; (b2) a splitting index coarser than the grains (every
   65,536th read): the device plane's and span mode's plans cut back
   within their grains (no device-plane span past 64 blocks), and both
   drivers equal the truth; (d) phase 10's two regions on the native
   plane with the ``.bai``: the interval truth, the compressed bytes
   read against the file size, the reference's trimmed plan and the
   spans the drivers cut it into, walls beside the same regions without
   it and phase 10 (a)'s, and each call's peak resident set size; (e) the three native drivers with ``use_fused_decode`` on and
   off in turns, each equal to the truth, and the share of spans that
   took the two-pass tail;
12. the read formats and the tensor feeds through the entry points:
   (a) a FASTQ of phase 5's reads (written with the BAM, one
   generation) through ``fastq_seq_stats_file``, equal to the BAM's
   ``seq_stats()`` (n_reads and base_hist exactly, the means within
   rtol 1e-6) and to the generator's counts; (b) a gzipped QSEQ of the
   first 200,000 of those reads against the generator's counts; (c)
   ``window_tensor_batches(window=1024)`` over a synthetic FASTA of two
   contigs of chr21's and chr22's GRCh38 lengths, each batch through
   ``read_stats_step``, the window count checked, and K2 against its
   plain version on every batch (``k2_window_check``: the (512, 1024)
   strides), timed there; (d) ``BamDataset.tensor_batches()`` over the
   BAM: 2,000,000 rows, through ``read_stats_step`` equal to
   ``seq_stats()``, with batches/s and GB/s delivered to the card; (e)
   ``unpack_step`` over one stacked span group equal to K1's plain
   version.  Walls, reads/s and profiled busy shares of (a) and (d);
13. coverage (K12) over a 15x BAM of mixed CIGARs through the ``.bai``,
   250 batched region queries (K13) on phase 11's sorted copy, and the
   span window's hang defence (``phase_coverage_query``);
14. the resident region server (``hadoop_bam_torch.serve.ServeLoop``):
   (a) K10i (``interval_cols``, which reads each record's prefix itself)
   bit for bit against its plain version at the 64- and 17-block chunks
   of a BAM of mixed CIGARs (the chunk, buf 3 bytes off 16, random
   n_cigar / l_read_name written into the prefixes with offsets cut by
   either end of the buffer, a 65-op row raising ``over``, pos at the
   int32 edges, n_all -1 / 0 / past R, each twice) and the whole serve
   step against ``resolve_walk_intervals_plain``, with its time and
   bound; (b) the first 200 of phase 13 (b)'s regions,
   one request at a time, at the default serve width (4,096-row tiles,
   512 MiB) with prefetch off: native plane cold then warm (counts equal
   to the engine's and the generator's; the warm pass decodes nothing on
   the host, in its own ``MetricsContext``), a profiled warm pass, then
   the device plane cold on a fresh loop (``serve.device_tile_builds``
   > 0; K7+K8, K9 and K10i once a build, no K1), and once more with
   every K10i launch held against its plain
   version; K10i then checked in the same seven cases and timed at the
   serve's own chunk shape (the R it launched most often: the ``.bai``
   chunks of 1-10 kb regions), and the tile filter timed alone on one
   [1, 4,096] tile group; (c) two tenants over TCP on port 0: 200 batch requests, then an
   interactive one that must be answered while batch answers are still
   to come;
15. the variant plane (``parallel/variant_pipeline.py``) over a call set
   with the genotype layout of the 1000 Genomes Project phase 3
   release (``synth.write_synthetic_vcf``: 2,504 samples, 50,000
   records, the last 5,000 on X, as BGZF BCF, raw BCF and a BGZF VCF
   of the first 10,000; 2% of sites not PASS and 0.5% of calls './.'
   added): (a) K11 (``variant_unpack``: one launch a span writes CHROM /
   POS, every GT group's dosages, the tile's pads and the flags from
   one packed metadata array) bit for bit against its plain version in
   every case of ``synth.UNPACK_CASES``, its prefix-only and one-group
   modes (``variant_prefix``, ``gt_dosage``) in every case of
   ``synth.prefix_rows`` and ``synth.GT_CASES``, and at the main path's
   chunk (the rows of a 64-block chunk of the BGZF BCF), with times and
   bound, ``device_variant_unpack`` split by kernel there, and K14
   (``variant_tile_stats``) timed there; (b) ``variant_stats_file`` on
   the host plane (BGZF BCF, BGZF VCF) and the device plane (BGZF BCF),
   each equal to the generator's truth, with walls, variants/s,
   profiled busy shares, launches (``variant_unpack`` once a span
   unpacked on the card) and the device plane's blocks and records
   through the card and through the host fixup; (c) the device plane
   again with every ``variant_unpack`` launch held against its plain
   version;
   (d) ``open_vcf(bcf).tensor_batches()`` at the host plane's span
   count, rows equal to the generator's, batches/s and GB/s delivered;
16. region queries and the mesh sort: (a) ``.tbi`` sidecars of phase
   15's BGZF BCF and BGZF VCF (``split.tabix.write_tabix``), timed, then
   200 regions of 1-5 kb a file in one ``QueryEngine`` batch on cuda:0
   (K13's overlap step) and 20 through ``VcfDataset.query``, each equal
   to the generator's full scan; (b) the main path's BAM sorted on
   cuda:0 by ``sort_bam_mesh`` with the index, bytes and spill
   (``SORT_ROUNDS`` rounds) exchanges, each output and its ``.bai`` and
   ``.sbi`` byte-identical to the port's host ``sort_bam`` (phase 11's
   sorted copy), K1 launched inside the index step; K15's index step (at
   the main path's shape) and bytes step (at a spill round's) equal to
   their CPU runs, and the index step timed beside K1's plain gather,
   one stable ``torch.sort`` of its keys and its bound;
17. duplicate marking (``prep.markdup_bam_mesh``): (a) K16a
   (``markdup_columns``, ``csrc/markdup_cols.cu``) bit for bit against
   its plain version on every ``synth.MARKDUP_CASES`` row (clips on
   either end, all-clip, no CIGAR, both strands, mate unmapped,
   secondary, supplementary, 0xFF qualities, pos near 0, wraps), pads
   and a CIGAR past the tile, on ``synth.MARKDUP_TILES`` (runs of
   400-600 bases, 30-40-byte names, R = 1, R = 7, R % 4 != 0) and on a
   tile past the persistent grid's first sweep, each staging whole
   rows, the tile's ``host_row_bytes`` and 48 bytes; (b)
   ``MKDUP_READS`` reads of
   ``synth.write_markdup_bam`` (about 10% of pairs copies of another,
   three read groups over two libraries) marked with
   ``library_from="rg"`` in rounds of ``MKDUP_ROUND``: every record's
   flag equal to the generator's truth, the co-written ``.bai`` serving
   a region with ``build_bai`` refused, the three stages' walls, the
   device-busy share of a profiled re-run; (b2)
   ``MKDUP_ORACLE_READS`` reads byte-identical (with ``.bai`` and
   ``.sbi``) to the port's ``markdup_bam_oracle`` in both library
   modes, one removing duplicates; K16a checked and timed at (b)'s
   round tile, and (c) K16b (``markdup_exchange_step``, torch ops) equal
   to its CPU run at (b)'s shape and timed beside one stable
   ``torch.sort`` of as many keys;
18. the cohort plane (``cohort/``): (a) K17a (``cohort_gwas_step``,
   ``csrc/cohort_stats.cu``) against its plain version in every
   ``synth.GWAS_CASES`` case, AF and call rate bit for bit, HWE and
   score within rtol 1e-5, atol 1e-6, and K17b (``cohort_slice_step``,
   ``hbam_cohort_slice`` in the same source) against
   ``cohort_slice_plain`` in every ``synth.SLICE_CASES`` case (keep,
   hits, af and af_n exactly, af_sum within rtol 1e-6); (b) ``COHORT_SAMPLES`` (2,504)
   single-sample call sets of ``synth.write_cohort`` over
   ``COHORT_SITES`` sites through a journaled
   ``open_cohort(manifest).gwas(y)`` equal to the generator's truth
   (HWE and score within 2e-4 of float64 NumPy), a profiled re-run and
   one ``tensor_batches`` pass from the journal; (c) a ``ServeLoop``
   over the same manifest: a cold slice, ``COHORT_SLICES`` warm
   gene-sized slices (10 kb-2 Mb) with no join and no host decode, one
   request over TCP, counts equal to the truth's; K17a's launches
   counted in (b) and K17b's in (c) (where K17a launches none), each
   from a count set to 0 just before; K17a timed at the main path's
   tile and at the full 3,352 x 2,504 tile with and without a
   phenotype, K17b at the serve's.

The plan memo would let a repeated call skip planning, so every timed
driver call of phases 5, 9 and 11 and of ``--times`` / ``--turns``
clears it first (``cold``): those walls stay comparable with trees that
had no memo; warm walls are phase 11 (c)'s.

The last lines are the kernels' JSON summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.

``--times KERNEL`` stops after the build: it only checks and times that
kernel at its shapes (``TIMES``: K9 and K10p at both chunk shapes, K7+K8
at its three chunks, K2 at phase 12's FASTA window shape
(``k2_window``); ``serve_tiles``: phase 14 on a sorted copy written
beside the BAM; ``interval_chain``: ``resolve_walk_intervals`` split
by kernel at a serve chunk and the 17- and 64-block chunks of a BAM of
mixed CIGARs written beside the BAM, for turns against a tree whose
chain still ran K1; ``interval_floor``: K10i alone at those chunks,
walked, with n_all = 0, and in turns against the memset scheme it
replaced, by the profiler and by one CUDA graph;
``device_plane``: the profiled device-plane
``seq_stats()`` by kernel; ``variant_gt``: K11 checked in phase 15
(a)'s cases, checked and timed at its chunk of a BCF of the phase's
layout written beside the BAM (K11 alone, and
``device_variant_unpack`` split by kernel), and that BCF's device-plane
pass with its unpack wall;
``variant_floor``: K11's launch at that chunk split by part (the
header's mode set to each part alone);
``variant_plane``: phase 15 alone; ``sort_query``: phase 16 alone
(its variant files written here); ``mkdup``: phase 17 alone;
``markdup_cols``: K16a alone, checked in phase 17 (a)'s cases, then
checked and timed at a round's tile of a ``write_markdup_bam`` file
written beside the BAM and at a round-sized tile of 30-40-byte read
names (``--tree``: in turns with an earlier tree);
``markdup_floor``: coalesced reads of that tile's rows cut to the
sectors and lines K16a reads, against K16a; ``cohort``: phase 18 alone;
``cohort_stats``: K17a and K17b alone, checked in phase 18 (a)'s cases
(an earlier tree: K17a's cases and K17b at its timing tile), then timed
at the full GWAS tile with and without a phenotype, at the main path's
200-row tile and K17b at the serve's tile, by the profiler, in a row by
events and with L2 flushed by a 64 MB write before each launch, with
each wrapper's host time; ``cohort_variants``: variants of this tree's
``csrc/cohort_stats.cu`` built into the build dir and launched through
the port's wrappers, checked and timed at the same tiles;
``native_plane``: the native plane's three
drivers of phase 5, warmed up, five rounds in turn; ``bai_regions``:
phase 11 (d)'s ``.bai`` runs on a sorted copy of the reads kept beside
the BAM, with walls and peak resident set sizes) and prints them as
one JSON line; with ``--tree DIR`` it
does so for the port in another checkout (an earlier tree unpacked by
``git archive``), so that two trees' kernels can be timed in turns on
the same card and inputs.  A timing run builds only kernels that are
missing or stale and reuses the BAM an earlier one wrote.

``--turns N --tree DIR [--tree DIR ...]`` times the native plane in
turns: N rounds of one ``--times native_plane`` process for this
checkout and for each tree, the order reversed every other round, and
prints every process's medians and each tree's per-round ratios to this
checkout's as one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet


_T0 = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("== phase"):     # where the time limit goes
        msg += f" (t = {time.perf_counter() - _T0:.1f} s)"
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cold() -> None:
    """Forget the port's memoized span plans, so that the next driver
    call plans again (a no-op for trees without the memo)."""
    from hadoop_bam_torch.split import planners
    clear = getattr(planners, "clear_plan_cache", None)
    if clear is not None:
        clear()


def run_text(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def card_line() -> str:
    return run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]).splitlines()[0]


def time_ms(torch, fn, flush, reps: int = 25) -> float:
    """Median CUDA-event time of one call of ``fn`` over ``reps`` runs
    after a warm-up (host launch overhead included); ``flush`` (a large
    tensor) is rewritten before each run so the inputs come from device
    memory, not L2."""
    if flush.device.type != "cuda":
        return float("nan")   # a rehearsal on the CPU measures nothing
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


FENCE = 16   # short spin kernels on each side of a profiled run


def _cuda_events(torch, fn, cpu: bool = False):
    """(wall s, the CUDA activity events of one run of ``fn`` in start
    order, whether the run was fenced whole) under torch.profiler.  The
    profiler drops the first device records of a session (two to six in
    most sessions of a smoke process, now and then nearly all), so the
    run is fenced by FENCE spin kernels (``torch.cuda._sleep``) on each
    side and only the events between the last leading and the first
    trailing spin are ``fn``'s; a side whose fence was lost whole leaves
    the run unfenced (its events are then all but the spins)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])

    def fence():
        for _ in range(FENCE):
            torch.cuda._sleep(20_000)   # ~10 us

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fence()
        fn()
        fence()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    spin = ["spin_kernel" in e.name for e in events]
    lead = next((i for i, x in enumerate(spin) if not x), len(spin))
    trail = next((i for i, x in enumerate(reversed(spin)) if not x),
                 len(spin))
    if lead and trail and lead < len(spin):
        return wall, events[lead:len(events) - trail], True
    return wall, [e for e, x in zip(events, spin) if not x], False


def _launches(events, kernel):
    """Events of ``kernel`` (a substring of its name), else all events."""
    return sum(kernel in e.name for e in events) if kernel else len(events)


def _whole(sessions, reps: int, kernel) -> list:
    """The sessions (launch count, reading) that recorded every launch:
    exactly ``reps`` of ``kernel``; without one, a multiple of ``reps``
    device events, as many as most such sessions recorded."""
    if kernel:
        return [s for s in sessions if s[0] == reps]
    full = [n for n, _ in sessions if n and n % reps == 0]
    if not full:
        return []
    mode = statistics.mode(full)
    return [s for s in sessions if s[0] == mode]


def device_ms(torch, calls, reps: int = 32, kernel=None) -> float:
    """Mean device time per call: the CUDA activity (kernels, memsets,
    copies) torch.profiler records over ``reps`` calls, cycling through
    ``calls`` (each over its own copy of the inputs, together larger than
    the 50 MB L2, so every call reads device memory), the median of three
    profiler sessions fenced whole (``_cuda_events``) that recorded every
    launch (``_whole``; ``kernel`` names the hand kernel each call
    launches once).  A session that lost launches reads low (K2 at
    0.0034-0.0169 ms under its bound of 0.0303 ms); such sessions are
    logged (an unfenced one with -1 launches) and dropped.  Unlike event
    timing around one call, host launch overhead does not count.  When
    six sessions give no whole reading (late in a long smoke process the
    profiler often loses a session's leading fence whole) it takes, for
    a hand kernel's calls (``kernel`` named), ``graph_ms`` (the calls in
    one CUDA graph, its replay timed by events: device time with no host
    launches), else or where the calls cannot be captured ``loop_ms`` (an
    upper bound), and says which, also in ``device_ms.how`` ("the
    profiler", "one CUDA graph" or "events in a row")."""
    device_ms.how = "the profiler"
    if not torch.cuda.is_available():
        return float("nan")   # a rehearsal on the CPU measures nothing
    for call in calls:
        call()
    torch.cuda.synchronize()
    sessions = []
    for _ in range(6):
        _, events, fenced = _cuda_events(torch, lambda: [
            calls[i % len(calls)]() for i in range(reps)], cpu=True)
        us = sum(e.time_range.elapsed_us() for e in events)
        sessions.append((_launches(events, kernel) if fenced else -1,
                         us / reps / 1e3))
        whole = _whole(sessions, reps, kernel)
        if len(whole) == 3:
            break
    if len(whole) < len(sessions):
        log(f"profiler sessions dropped, not whole ({reps} calls"
            f"{', kernel ' + kernel if kernel else ''}): "
            f"{[s for s in sessions if s not in whole]}; kept {whole}")
    if whole:
        return statistics.median(ms for _, ms in whole)
    ms = graph_ms(torch, calls) if kernel else float("nan")
    if ms == ms:
        log(f"torch.profiler gave no whole session in 6: the calls in one "
            f"CUDA graph by events instead ({ms:.4f} ms)")
        device_ms.how = "one CUDA graph"
        return ms
    log("torch.profiler gave no whole session in 6: the calls in a row "
        "by events instead (an upper bound)")
    device_ms.how = "events in a row"
    return loop_ms(torch, calls)


device_ms.how = "the profiler"


def loop_ms(torch, calls, reps: int = 48) -> float:
    """Mean ms per call from CUDA events around ``reps`` back-to-back
    calls cycling through ``calls`` (each over its own copy of the
    inputs): launches queue behind each other, so host launch overhead
    hides under the kernels unless they are shorter than it (then this
    is an upper bound).  A check on the profiler's per-kernel readings."""
    if not torch.cuda.is_available():
        return float("nan")
    for call in calls:
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        calls[i % len(calls)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, calls, reps: int = 32) -> float:
    """Mean device ms per call with the host's launch cost taken out:
    ``reps`` calls cycling through ``calls`` captured in one CUDA graph,
    its replay timed by CUDA events (the median of five replays).  For
    steps of several small torch kernels, whose calls in a row by events
    time the host.  NaN, logged, where the calls cannot be captured."""
    if not torch.cuda.is_available():
        return float("nan")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for call in calls:
                call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(reps):
                calls[i % len(calls)]()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times)
    except RuntimeError as e:
        log(f"graph_ms: the calls could not be captured ({e})")
        return float("nan")


def kernel_split(torch, calls, reps: int = 32, kernel=None) -> dict:
    """Mean device ms per call of each kernel (its function name) over
    ``reps`` calls cycling through ``calls``, from the first of five
    profiler sessions fenced whole that recorded every launch (each
    kernel a multiple of ``reps`` times, ``kernel`` exactly ``reps``);
    {} where there is no card or no such session."""
    if not torch.cuda.is_available():
        return {}
    for _ in range(5):
        _, events, fenced = _cuda_events(torch, lambda: [
            calls[i % len(calls)]() for i in range(reps)])
        sec, count = {}, {}
        for e in events:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0]
            sec[name] = sec.get(name, 0.0) + e.time_range.elapsed_us() / 1e6
            count[name] = count.get(name, 0) + 1
        if fenced and count and all(n % reps == 0 for n in count.values()) \
                and (not kernel or _launches(events, kernel) == reps):
            return {k: sec[k] * 1e3 / reps for k in sorted(sec)}
        log(f"kernel_split: a session lost launches ({count}), dropped")
    return {}


def device_busy(torch, fn):
    """(wall s, device-busy s, {kernel name: device s}) of one run of
    ``fn`` under torch.profiler (CUDA activity only)."""
    wall, events, _ = _cuda_events(torch, fn)
    busy, by_name = 0.0, {}
    for e in events:
        s = e.time_range.elapsed_us() / 1e6
        busy += s
        by_name[e.name] = by_name.get(e.name, 0.0) + s
    return wall, busy, by_name


def phase_env(torch) -> str:
    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton not installed")
    from hadoop_bam_torch.ops import kernels
    nvcc = kernels.nvcc_path()
    log(f"nvcc {nvcc}: {run_text([nvcc, '--version']).splitlines()[-1]}")
    log(f"g++: {run_text(['g++', '--version']).splitlines()[0]}")
    card = card_line()
    log(f"card: {card}; torch sees {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    return card


def phase_build(force: bool = True) -> None:
    log("== phase 2: kernel build")
    from hadoop_bam_torch.ops import kernels
    from hadoop_bam_torch.utils import native
    t0 = time.perf_counter()
    kernels.build(force=force)
    log(f"nvcc (all sources in parallel): {time.perf_counter() - t0:.2f} s")
    for name in kernels.KERNELS:
        for line in kernels.ptxas_report(name).splitlines():
            log(f"  {name}: {line.strip()}")
    t0 = time.perf_counter()
    native.load()
    log(f"host library ready: {time.perf_counter() - t0:.2f} s")


def make_bam(args):
    """The synthetic BAM, written under the (git-ignored) build dir."""
    from hadoop_bam_torch.synth import write_synthetic_bam
    from hadoop_bam_torch.utils.native import BUILD_DIR
    out = os.path.join(BUILD_DIR, "smoke")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"synth_{args.seed}_{args.reads}.bam")
    if args.times and os.path.exists(path):
        return path, None   # timing runs need no truth
    t0 = time.perf_counter()
    # --times runs earlier trees too, whose generator has no regions and
    # no FASTQ copy; phase 12 reads the FASTQ of the same generation
    extra = {} if args.times else {"regions": REGIONS,
                                   "fastq": fastq_path(path),
                                   "keep_columns": True}
    truth = write_synthetic_bam(path, args.reads, args.seed, **extra)
    log(f"synthesized {args.reads} reads (seed {args.seed}) -> "
        f"{os.path.getsize(path)} bytes in {time.perf_counter() - t0:.1f} s"
        + (f", and their FASTQ for phase 12 ({os.path.getsize(extra['fastq'])}"
           f" bytes)" if extra else ""))
    return path, truth


def fastq_path(path: str) -> str:
    """Phase 12's FASTQ of the BAM's reads, written beside it."""
    return os.path.splitext(path)[0] + ".fastq"


def phase_k1(torch, path, dev) -> dict:
    log("== phase 3: K1 unpack_fixed_fields vs plain")
    import numpy as np
    from hadoop_bam_torch.ops.unpack_bam import (
        FIXED_FIELDS, unpack_fixed_fields, unpack_fixed_fields_plain,
    )
    from hadoop_bam_torch.parallel.pipeline import (
        DecodeGeometry, decode_span_host,
    )
    from hadoop_bam_torch.split.planners import plan_bam_spans
    g = DecodeGeometry()
    src_size = os.path.getsize(path)
    spans = plan_bam_spans(path, num_spans=max(1, src_size // (2 << 20)))
    data, offs, _ = decode_span_host(path, spans[0], g)
    D, N = g.bytes_cap, g.records_cap
    host_data = np.zeros(D, np.uint8)
    host_data[:data.size] = data
    host_offs = np.zeros(N, np.int32)
    host_offs[:offs.size] = offs
    host_offs[-1] = D - 20            # the end clamp: 16 bytes past D
    d = torch.from_numpy(host_data).to(dev)
    o = torch.from_numpy(host_offs).to(dev)
    got = unpack_fixed_fields(d, o)
    want = unpack_fixed_fields_plain(d, o)
    sync(torch, dev)
    err = 0
    for name in FIXED_FIELDS:
        diff = (got[name].to(torch.int64) - want[name].to(torch.int64))
        err = max(err, int(diff.abs().max()))
        check(torch.equal(got[name], want[name]), f"K1 column {name}")
    log(f"{offs.size} real records + padding, N={N}, D={D}: every column "
        f"equal (max_abs_err {err})")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ev_ms = time_ms(torch, lambda: unpack_fixed_fields(d, o), flush)
    copies = [(d.clone(), o.clone()) for _ in range(4)]
    looped = loop_ms(torch, [lambda c=c: unpack_fixed_fields(*c)
                             for c in copies])
    ms = device_ms(torch, [lambda c=c: unpack_fixed_fields(*c)
                           for c in copies],
                   kernel="unpack_fixed_fields_kernel")
    plain_ms = device_ms(torch, [lambda c=c: unpack_fixed_fields_plain(*c)
                                 for c in copies])
    distinct = int(torch.unique(o).numel())
    nbytes = 4 * N + 36 * distinct + 48 * N
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    log(f"K1 device {ms:.4f} ms (plain {plain_ms:.4f} ms; one call timed "
        f"by events incl. launch overhead {ev_ms:.4f} ms; 48 calls in a "
        f"row {looped:.4f} ms a call), bound "
        f"{bound_ms:.4f} ms = {nbytes} B / 3.35 TB/s; no single PyTorch "
        f"call computes this function (library_ms null)")
    return {"name": "unpack_fixed_fields", "route": "cuda",
            "source": "hadoop_bam_torch/csrc/unpack_bam.cu",
            "replaces": "hadoop_bam_tpu/ops/unpack_bam.py:113",
            "max_abs_err": err, "ms": ms, "loop_ms": looped,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _k2_compare(torch, seq, qual, lengths) -> int:
    from hadoop_bam_torch.ops.seq_stats import (
        seq_qual_stats, seq_qual_stats_plain,
    )
    got = seq_qual_stats(seq, qual, lengths)
    want = seq_qual_stats_plain(seq, qual, lengths)
    sync(torch, seq.device)
    for k in ("gc", "mean_qual", "base_hist"):
        check(torch.equal(got[k], want[k]), f"K2 {k} bit-equal to plain")
    return int((got["base_hist"].to(torch.int64)
                - want["base_hist"].to(torch.int64)).abs().max())


def _k2_cases(torch, dev) -> int:
    """K2 against its plain version where the kernel's design could go
    wrong: random bytes (all 16 codes) at the default widths, odd widths,
    base addresses off 16 bytes (rows 1..n of a [n + 1, W] tile), n = 1,
    n off the rows of a stage, back-to-back launches."""
    import numpy as np
    from hadoop_bam_torch.ops.seq_stats import k2_launch, seq_qual_stats_plain
    rng = np.random.default_rng(7)
    err = 0
    for n, sb, qb, sliced in ((65_536, 96, 160, False), (100, 17, 33, False),
                              (4097, 76, 151, True), (1000, 96, 160, True),
                              (1, 96, 160, False), (1001, 96, 160, False),
                              (65, 96, 160, False)):
        k = 1 if sliced else 0
        seq = rng.integers(0, 256, (n + k, sb), dtype=np.uint8)
        qual = rng.integers(0, 256, (n + k, qb), dtype=np.uint8)
        lens = rng.integers(-2, 2 * sb + 9, n + k).astype(np.int32)
        lens[k:k + 4] = [2 * sb, 0, 1, qb + 1][:n]
        ts = [torch.from_numpy(a).to(dev)[k:] for a in (seq, qual, lens)]
        check(all(t.is_contiguous() for t in ts), "contiguous slices")
        for _ in range(2):
            err = max(err, _k2_compare(torch, *ts))
        codes = int(seq_qual_stats_plain(*ts)["base_hist"].count_nonzero())
        check(codes == 16 or n < 65, f"all 16 codes in the {n}-row case")
        go = k2_launch(n, sb, qb, tuple(t.data_ptr() for t in ts), 132)
        log(f"random {n} x ({sb}, {qb}){' at rows 1..n' if sliced else ''}"
            f": {codes} codes present, bit-equal twice in a row "
            f"({'TMA rings' if go.aligned else 'direct loads'}, base "
            f"addresses % 16 = {[t.data_ptr() % 16 for t in ts]})")
    return err


def k2_fixture(torch, path, dev):
    """The first tile of real reads at the default payload geometry, with
    edge lengths in its first rows: (geometry, lengths, seq, qual,
    lengths tensors on ``dev``)."""
    import numpy as np
    from hadoop_bam_torch.parallel.pipeline import (
        PayloadGeometry, decode_span_payload_host,
    )
    from hadoop_bam_torch.split.planners import plan_bam_spans
    g = PayloadGeometry()
    n = g.tile_records
    spans = plan_bam_spans(path, num_spans=max(1, os.path.getsize(path)
                                               // (8 << 20)))
    parts, have = [], 0
    for s in spans:
        prefix, seq, qual, _ = decode_span_payload_host(path, s, g)
        parts.append((prefix, seq, qual))
        have += prefix.shape[0]
        if have >= n:
            break
    prefix, seq, qual = (np.concatenate(x)[:n] for x in zip(*parts))
    check(seq.shape[0] == n, f"fixture holds {n} reads")
    l_seq = prefix[:, 20:24].copy().view("<i4")[:, 0]
    lens = np.minimum(l_seq, g.max_len).astype(np.int32)
    lens[:7] = [0, 1, 2, 3, 200, -4, 161]   # edge rows: empty, odd, > row
    return g, lens, *(torch.from_numpy(a).to(dev) for a in (seq, qual, lens))


def phase_k2(torch, path, dev) -> dict:
    log("== phase 4: K2 seq_qual_stats vs plain")
    import numpy as np
    from hadoop_bam_torch.ops import kernels
    from hadoop_bam_torch.ops.seq_stats import (
        k2_launch, seq_qual_stats, seq_qual_stats_plain,
    )
    g, lens, s_t, q_t, l_t = k2_fixture(torch, path, dev)
    n = g.tile_records
    err = _k2_compare(torch, s_t, q_t, l_t)
    log(f"{n} x ({g.seq_stride}, {g.qual_stride}) rows: gc, mean_qual "
        f"bit-equal, base_hist equal")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    go = k2_launch(n, g.seq_stride, g.qual_stride,
                   (s_t.data_ptr(), q_t.data_ptr(), l_t.data_ptr()), sms)
    log(f"K2 launch: {'TMA rings' if go.aligned else 'direct loads'}, "
        f"{go.tiles} tiles of {go.rows} rows on {go.grid} blocks of "
        f"{go.warps} warps, {go.smem} B shared memory per block")
    for line in kernels.ptxas_report("seq_stats").splitlines():
        log(f"  ptxas: {line.strip()}")
    err = max(err, _k2_cases(torch, dev))
    L = 16383
    big_s = torch.full((2048, (L + 1) // 2), 0x11, dtype=torch.uint8,
                       device=dev)
    big_q = torch.full((2048, L), 40, dtype=torch.uint8, device=dev)
    big_l = torch.full((2048,), L, dtype=torch.int32, device=dev)
    big_l[0] = L - 1
    total = 2048 * L - 1
    err = max(err, _k2_compare(torch, big_s, big_q, big_l))
    hist = seq_qual_stats(big_s, big_q, big_l)["base_hist"].cpu()
    check(int(hist[1]) == total and int(hist.sum()) == total,
          "histogram exact past 2^24 bases")
    log(f"2048 x ({(L + 1) // 2}, {L}) rows: {total} bases counted exactly")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ev_ms = time_ms(torch, lambda: seq_qual_stats(s_t, q_t, l_t), flush)
    copies = [(s_t.clone(), q_t.clone(), l_t.clone()) for _ in range(4)]
    calls = [lambda c=c: seq_qual_stats(*c) for c in copies]
    ms = device_ms(torch, calls, kernel="seq_stats_kernel")
    looped = loop_ms(torch, calls)
    plain_ms = device_ms(torch, [lambda c=c: seq_qual_stats_plain(*c)
                                 for c in copies])
    # the same rows through the direct path (rows 1..n of [n + 1, W]
    # copies: base addresses off 16 bytes), and through the TMA rings with
    # every length 0 (the bytes staged, nothing counted)
    off16 = [tuple(t.new_empty((n + 1,) + t.shape[1:])[1:].copy_(t)
                   for t in c) for c in copies]
    direct_ms = device_ms(torch, [lambda c=c: seq_qual_stats(*c)
                                  for c in off16], kernel="seq_stats_kernel")
    del off16
    staged_ms = device_ms(torch, [lambda c=c: seq_qual_stats(
        c[0], c[1], torch.zeros_like(c[2])) for c in copies],
        kernel="seq_stats_kernel")
    ln = np.maximum(lens.astype(np.int64), 0)
    nbytes = int(4 * n + np.minimum((ln + 1) // 2, g.seq_stride).sum()
                 + np.minimum(ln, g.qual_stride).sum() + 8 * n + 64)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    log(f"K2 device {ms:.4f} ms (plain {plain_ms:.4f} ms; one call timed "
        f"by events incl. launch overhead {ev_ms:.4f} ms), bound "
        f"{bound_ms:.4f} ms = {nbytes} B / 3.35 TB/s; no single PyTorch "
        f"call computes this function (library_ms null); the same rows "
        f"through the direct path {direct_ms:.4f} ms; through the TMA "
        f"rings with every length 0 (staged, nothing counted) "
        f"{staged_ms:.4f} ms")
    return {"name": "seq_qual_stats", "route": "cuda",
            "source": "hadoop_bam_torch/csrc/seq_stats.cu",
            "replaces": "hadoop_bam_tpu/ops/seq_pallas.py:127",
            "max_abs_err": err, "ms": ms, "loop_ms": looped,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def phase_main(torch, path, truth, card, dev):
    log("== phase 5: the native plane's main path on cuda:0")
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    size = os.path.getsize(path)
    ds = open_bam(path, config=HBamConfig(inflate_backend="native"))
    check(ds.device == dev, f"dataset device is {dev}")
    reset_launches()
    walls = {}
    cold()
    t0 = time.perf_counter()
    flag = ds.flagstat()
    walls["flagstat"] = time.perf_counter() - t0
    cold()
    t0 = time.perf_counter()
    stats = ds.seq_stats()
    walls["seq_stats"] = time.perf_counter() - t0
    cold()
    t0 = time.perf_counter()
    flag_span = ds.flagstat(mode="span")
    walls["flagstat_span"] = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items()
                if k in ("unpack_fixed_fields", "seq_qual_stats")}
    log(f"launches in the native plane's main path: {read_launches()}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched on the native plane's main path")
    check_truth(flag, stats, truth)
    check(flag_span == truth.flagstat, "span-mode flagstat matches")
    check(all(v > 0 for v in flag.values()), "every counter non-zero")
    log(f"flagstat / seq_stats / span flagstat equal the generator's counts "
        f"(mean_gc {stats['mean_gc']:.9f}, mean_qual "
        f"{stats['mean_qual']:.9f})")
    for name, wall in walls.items():
        log(f"{name}: {wall:.3f} s wall, {truth.n_reads / wall:,.0f} reads/s, "
            f"{size / wall / 1e6:.1f} compressed MB/s [{card}]")
    # a second, profiled run of each driver: the device's busy share
    for name, fn in (("flagstat", ds.flagstat),
                     ("seq_stats", ds.seq_stats),
                     ("flagstat_span", lambda: ds.flagstat(mode="span"))):
        log_busy(torch, name, fn, card)
    return launches, walls


# kernel function names of each hand kernel, as the profiler shows them
KERNEL_NAMES = {"K2": ("seq_stats_kernel",), "K7+K8": ("lz77_resolve",),
                "K9": ("walk_",), "K10p": ("payload_gather",)}


def kernel_totals(by_name) -> dict:
    """ms of device time of each hand kernel in a profile's
    {kernel name: device s}."""
    return {k: 1e3 * sum(v for n, v in by_name.items()
                         if any(p in n for p in pats))
            for k, pats in KERNEL_NAMES.items()}


def log_busy(torch, name, fn, card) -> None:
    """Profile one more run of a driver: device busy share, the totals of
    K2, K7+K8, K9 and K10p, and the four busiest kernels."""
    wall, busy, by_name = device_busy(torch, fn)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"{name} profiled: {wall:.3f} s wall, device busy {busy:.4f} s "
        f"({100 * busy / wall:.2f}%); "
        + "; ".join(f"{k} {v:.3f} ms"
                    for k, v in kernel_totals(by_name).items())
        + "; top: "
        + "; ".join(f"{k[:60]} {v * 1e3:.2f} ms" for k, v in top)
        + f" [{card}]")


def _wrappers():
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.ops.seq_stats import seq_qual_stats
    from hadoop_bam_torch.ops.unpack_bam import unpack_fixed_fields
    return {"resolve_pack": tid.resolve_pack,
            "walk_records_device": tid.walk_records_device,
            "unpack_fixed_fields": unpack_fixed_fields,
            "payload_gather": tid.payload_gather,
            "seq_qual_stats": seq_qual_stats}


def reset_launches() -> None:
    for w in _wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {k: w.launches for k, w in _wrappers().items()}


def first_blocks(path, n):
    """The BAM's first ``n`` BGZF blocks: (compressed bytes, block table
    as ops.inflate.block_table gives it)."""
    import numpy as np
    from hadoop_bam_torch.formats import bgzf
    with open(path, "rb") as f:
        raw = f.read(n * bgzf.MAX_BLOCK_SIZE)
    cols = {k: [] for k in ("coffset", "cdata_off", "cdata_len", "isize")}
    off = 0
    for _ in range(n):
        info = bgzf.parse_block_header(raw, off)
        for k, v in zip(cols, (info.coffset, info.cdata_offset,
                               info.cdata_size, info.isize)):
            cols[k].append(v)
        off = info.next_coffset
    table = {k: np.asarray(v, np.int64 if k in ("coffset", "cdata_off")
                           else np.int32) for k, v in cols.items()}
    return raw[:off], table


def tokenize(payloads, P, B):
    """Raw-DEFLATE byte strings tokenized natively at width P, padded to
    B rows: (tokens as int32 bits, n_tokens, isize) numpy arrays."""
    import zlib
    import numpy as np
    from hadoop_bam_torch.utils import native
    comps = []
    for d in payloads:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comps.append(co.compress(d) + co.flush())
    src = np.frombuffer(b"".join(comps), np.uint8)
    off = np.cumsum([0] + [len(c) for c in comps[:-1]]).astype(np.int64)
    ln = np.array([len(c) for c in comps], np.int32)
    return pad_tokens(native.deflate_tokenize_batch(src, off, ln, P), B)


def pad_tokens(out, B):
    import numpy as np
    toks, nt, ol = out[:3]
    n, P = toks.shape
    tok = np.zeros((B, P), np.int32)
    tok[:n] = toks.view(np.int32)
    pad = np.zeros(B, np.int32)
    nt_p, iz_p = pad.copy(), pad.copy()
    nt_p[:n], iz_p[:n] = nt, ol
    return tok, nt_p, iz_p


def _k7_check(torch, dev, tok, nt, iz, want: bytes, P=None) -> None:
    """K7+K8 on one chunk against its plain version and zlib's bytes,
    twice in a row; pad rows (isize 0) hold uninitialised tokens, as on
    the device plane."""
    import numpy as np
    from hadoop_bam_torch.ops import inflate_device as tid
    P = tok.shape[1] if P is None else P
    used = int(np.count_nonzero(iz))
    tokens = torch.empty(tok.shape, dtype=torch.int32, device=dev)
    tokens[:used] = torch.from_numpy(tok[:used]).to(dev)
    args = [tokens] + [torch.from_numpy(a).to(dev) for a in (nt, iz)]
    plain, plain_total = tid.pack_contiguous_plain(
        tid.resolve_tokens_plain(args[0], args[1], P), args[2])
    for _ in range(2):
        got, total = tid.resolve_pack(*args, P=P)
        sync(torch, dev)
        check(torch.equal(got, plain), "K7+K8 bit-equal to plain")
        check(int(total) == int(plain_total) == len(want), "K7+K8 total")
        host = got.cpu().numpy()
        check(host[:len(want)].tobytes() == want,
              "K7+K8 equal to zlib's bytes")
        check(not host[len(want):].any(), "K7+K8 zeros past the total")


def phase_k7(torch, path, dev) -> dict:
    log("== phase 6: K7+K8 resolve_pack vs plain and zlib")
    import zlib
    import numpy as np
    from hadoop_bam_torch.ops import inflate_device as tid
    raw, table = first_blocks(path, 63)
    data = [zlib.decompress(raw[o:o + n], wbits=-15) for o, n in
            zip(table["cdata_off"], table["cdata_len"])]
    chunks = k7_chunks(path)
    tok, nt, iz, P = chunks["64-block"]
    T = -(-int(nt.max()) // 256) * 256        # the device plane's narrow rows
    cases = [("64-block chunk (63 BAM blocks + 1 run-length block)", tok, nt,
              iz, P, b"".join(data) + b"A" * 65536),
             (f"the same chunk as [64, {T}] token rows",
              np.ascontiguousarray(tok[:, :T]), nt, iz, P,
              b"".join(data) + b"A" * 65536)]
    for name in ("17-block", "17-block stored"):
        tok, nt, iz, P = chunks[name]
        cases.append((f"{name} chunk in 32 rows of {tok.shape[1]} tokens "
                      f"(the main path's shape)", tok, nt, iz, P,
                      b"".join(data[:17])))
    flat = b"".join(data)
    for P, sizes, B in ((1 << 13, [8192, 5000, 1025, 8000, 7777] * 2 + [0],
                         16), (1 << 10, [1024, 1, 700, 1000, 0], 8)):
        pieces, p = [], 0
        for n in sizes:
            pieces.append(flat[p:p + n])
            p += n
        cases.append((f"B = {B}, P = {P} ({len(pieces)} blocks, an empty "
                      f"one included)", *tokenize(pieces, P, B), P,
                      b"".join(pieces)))
    for name, tok, nt, iz, P, want in cases:
        _k7_check(torch, dev, tok, nt, iz, want, P)
        lr = tid.resolve_launch(*tok.shape, P)
        log(f"{name}: {int(iz.sum())} bytes, {int(nt.sum())} tokens; "
            f"clusters of {lr.C} CTAs x {lr.threads} threads, segments of "
            f"{lr.S}, {lr.smem} B shared memory; bit-equal to plain and to "
            f"zlib, zeros past the total, twice in a row")
    for line in kernels_report("lz77_resolve"):
        log(f"  ptxas: {line}")
    times = k7_times(torch, path, dev)
    for shape, x in times.items():
        x["bound_ms"] = x["nbytes"] / H100_BYTES_PER_S * 1e3
        log(f"K7+K8 at the {shape} chunk ([{x['B']}, {x['T']}] tokens, P = "
            f"{x['P']}, {x['blocks']} blocks, {x['tokens']} tokens, "
            f"{x['passes']} doubling passes in the plain version; launch "
            f"{x.get('launch')}): device {x['ms']:.4f} ms (plain "
            f"{x['plain_ms']:.4f} ms), bound {x['bound_ms']:.6f} ms = "
            f"{x['nbytes']} B / 3.35 TB/s (tokens read once, counts and "
            f"sizes, the [{x['B']} x {x['P']}] buffer written once, the "
            f"total), {100 * x['bound_ms'] / x['ms']:.2f}% of it")
        for name, v in x.get("cluster_ms", {}).items():
            log(f"  launched as {name}: {v['ms']:.4f} ms; phases (mean, "
                f"largest cycles over the CTAs with data): {v['phases']}")
    log("no single PyTorch call computes this function (library_ms null)")
    big, main = times["64-block"], times["17-block"]
    return {"name": "resolve_pack", "route": "cuda",
            "source": "hadoop_bam_torch/csrc/lz77_resolve.cu",
            "replaces": "hadoop_bam_tpu/ops/inflate_device.py:98",
            "max_abs_err": 0, "ms": big["ms"], "loop_ms": big["loop_ms"],
            "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "main_path_shape": _shape_row(
                f"17-block chunk: [{main['B']}, {main['T']}] tokens, P = "
                f"{main['P']}", 0, main["ms"], main["plain_ms"],
                main["nbytes"])}


def kernels_report(name):
    from hadoop_bam_torch.ops import kernels
    return [l.strip() for l in kernels.ptxas_report(name).splitlines()
            if "registers" in l or "spill" in l]


def chunk_tokens(torch, path, dev, n):
    """The BAM's first ``n`` blocks as the device plane stages them:
    ([B, 65,536] int32 token bits with B a power of two >= 8, [B]
    counts, [B] sizes) on ``dev``, and the first record's offset."""
    import numpy as np
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.utils import native
    raw, table = first_blocks(path, n)
    tok, nt, iz = pad_tokens(native.deflate_tokenize_batch(
        np.frombuffer(raw, np.uint8), table["cdata_off"],
        table["cdata_len"], 1 << 16), tid.round_pow2(n, 8))
    _, voff = read_bam_header(path)
    blk = int(np.nonzero(table["coffset"] == voff >> 16)[0][0])
    start = int(iz[:blk].sum()) + (voff & 0xFFFF)
    return [torch.from_numpy(a).to(dev) for a in (tok, nt, iz)], start


def bam_chunk(torch, path, dev, n=64):
    """The BAM's first ``n`` blocks resolved on the card as the device
    plane ships them (rows padded to a power of two >= 8): (buf, total,
    start of the first record, host copy of buf)."""
    from hadoop_bam_torch.ops import inflate_device as tid
    tokens, start = chunk_tokens(torch, path, dev, n)
    buf, total = tid.resolve_pack(*tokens)
    return buf, total, start, buf.cpu().numpy()


def k9_times(torch, path, dev) -> dict:
    """K9's device ms at the 64-block chunk and at the main path's usual
    17-block chunk (32 rows) of the BAM, with the plain version's, the
    bytes of its bound (the chunk's data bytes, min(L, total), read once:
    no output depends on a byte past total; offsets, total and the walk's
    three scalars moved once) and its time by kernel.  Uses only what
    every tree of the port since the device plane has, so that an earlier
    tree (``--tree``) is timed on the same inputs."""
    from hadoop_bam_torch.ops import inflate_device as tid
    out = {}
    for n in (64, 17):
        buf, total, start, _ = bam_chunk(torch, path, dev, n)
        L = buf.shape[0]
        R = tid.records_cap(tid.round_pow2(n, 8), 1 << 16)
        t = int(total)
        copies = [(buf.clone(), total.clone()) for _ in range(4)]
        calls = [lambda c=c: tid.walk_records_device(c[0], c[1], start, t,
                                                     R) for c in copies]
        ms = device_ms(torch, calls, kernel="walk_tiles")
        plain_ms = device_ms(torch, [
            lambda c=c: tid.walk_records_device_plain(c[0], c[1], start, t,
                                                      R) for c in copies])
        got = tid.walk_records_device(buf, total, start, t, R)
        want = tid.walk_records_device_plain(buf, total, start, t, R)
        sync(torch, dev)
        check(torch.equal(got[0], want[0])
              and [int(x) for x in got[1:]] == [int(x) for x in want[1:]],
              f"K9 at the {n}-block chunk equals plain")
        split = kernel_split(torch, calls, kernel="walk_tiles")
        out[f"{n}-block"] = {
            "L": L, "R": R, "total": t, "records": int(got[1]), "ms": ms,
            "loop_ms": loop_ms(torch, calls),
            "plain_ms": plain_ms,
            "nbytes": min(L, t) + 4 * R + 16, "kernels_ms": split}
    return out


def doubling_passes(tok, nt, P) -> int:
    """Passes of the plain resolve's pointer doubling over a [B, T] token
    chunk (numpy, on the host), the final pass that changes nothing
    included: the plain version doubles every row together, so this is
    the most any row needs."""
    import numpy as np
    w = tok.view(np.uint32).astype(np.int64)
    B, T = w.shape
    copy = (w >> 31) == 1
    ln = np.where(copy, (w >> 16) & 0x1FF, 1)
    ln = np.where(np.arange(T)[None, :] < nt[:, None], ln, 0)
    starts = np.cumsum(ln, 1) - ln
    src = np.tile(np.arange(P, dtype=np.int64), (B, 1))
    for b in range(B):
        keep = (ln[b] > 0) & (starts[b] < P)
        idx = np.repeat(np.nonzero(keep)[0],
                        np.minimum(ln[b][keep], P - starts[b][keep]))
        p = np.arange(idx.size)
        src[b, :idx.size] = np.where(
            copy[b, idx], np.maximum(p - (w[b, idx] & 0xFFFF) - 1, 0), p)
    passes = 0
    while True:
        passes += 1
        s2 = np.take_along_axis(src, src, 1)
        if np.array_equal(s2, src):
            return passes
        src = s2


def k7_chunks(path):
    """K7+K8's timing chunks as numpy (tokens as int32 bits, n_tokens,
    isize, P): phase 6's 64-block chunk (63 BAM blocks and a run-length
    block, rows 65,536 tokens wide); the main path's chunk (the BAM's
    first 17 blocks in 32 rows, the tokens only as wide as the longest
    row rounded up to 256, as ``_TokenRing.stage`` ships them); and the
    same 17 blocks stored (all literals), where doubling ends after one
    pass, so the difference to the main path's chunk is the doubling."""
    import zlib
    import numpy as np
    from hadoop_bam_torch.utils import native
    P = 1 << 16

    def narrow(tok, nt, iz):
        T = min(P, -(-max(int(nt.max()), 1) // 256) * 256)
        return np.ascontiguousarray(tok[:, :T]), nt, iz

    raw, table = first_blocks(path, 63)
    src = np.frombuffer(raw, np.uint8)
    rle = zlib.compressobj(6, zlib.DEFLATED, -15)
    rle_c = rle.compress(b"A" * P) + rle.flush()
    both = np.concatenate([src, np.frombuffer(rle_c, np.uint8)])
    off = np.append(table["cdata_off"], src.size).astype(np.int64)
    ln = np.append(table["cdata_len"], len(rle_c)).astype(np.int32)
    big = pad_tokens(native.deflate_tokenize_batch(both, off, ln, P), 64)
    main = narrow(*pad_tokens(native.deflate_tokenize_batch(
        src, table["cdata_off"][:17], table["cdata_len"][:17], P), 32))
    data = [zlib.decompress(raw[o:o + n], wbits=-15) for o, n in
            zip(table["cdata_off"][:17], table["cdata_len"][:17])]
    stored = []
    for d in data:
        co = zlib.compressobj(0, zlib.DEFLATED, -15)
        stored.append(co.compress(d) + co.flush())
    s_src = np.frombuffer(b"".join(stored), np.uint8)
    s_off = np.cumsum([0] + [len(c) for c in stored[:-1]]).astype(np.int64)
    s_ln = np.array([len(c) for c in stored], np.int32)
    st = narrow(*pad_tokens(native.deflate_tokenize_batch(
        s_src, s_off, s_ln, P), 32))
    return {"64-block": (*big, P), "17-block": (*main, P),
            "17-block stored": (*st, P)}


def k7_times(torch, path, dev) -> dict:
    """K7+K8's device ms at its three timing chunks (``k7_chunks``), with
    the plain version's, the bytes of its bound (each row's tokens read
    once, counts and sizes, the [B x P] buffer written once, the total)
    and the plain version's doubling passes.  Pad rows (isize 0) hold
    uninitialised tokens, as on the main path.  Uses only
    ``resolve_pack``'s signature, so that an earlier tree (``--tree``) is
    timed on the same inputs."""
    import numpy as np
    from hadoop_bam_torch.ops import inflate_device as tid
    out = {}
    for name, (tok, nt, iz, P) in k7_chunks(path).items():
        B, T = tok.shape
        used = int(np.count_nonzero(iz))
        tokens = torch.empty((B, T), dtype=torch.int32, device=dev)
        tokens[:used] = torch.from_numpy(tok[:used]).to(dev)
        args = (tokens, torch.from_numpy(nt).to(dev),
                torch.from_numpy(iz).to(dev))
        got, total = tid.resolve_pack(*args, P=P)
        want, want_total = tid.pack_contiguous_plain(
            tid.resolve_tokens_plain(args[0], args[1], P), args[2])
        sync(torch, dev)
        check(torch.equal(got, want) and int(total) == int(want_total),
              f"K7+K8 at the {name} chunk equals plain")
        copies = [tuple(a.clone() for a in args) for _ in range(4)]
        calls = [lambda c=c: tid.resolve_pack(*c, P=P) for c in copies]
        ms = device_ms(torch, calls, kernel="lz77_resolve_kernel")
        plain_ms = device_ms(torch, [lambda c=c: tid.pack_contiguous_plain(
            tid.resolve_tokens_plain(c[0], c[1], P), c[2]) for c in copies])
        n_tok = int(np.minimum(nt, T).sum())
        out[name] = {"B": B, "T": T, "P": P, "blocks": used,
                     "tokens": n_tok, "total": int(total), "ms": ms,
                     "loop_ms": loop_ms(torch, calls),
                     "plain_ms": plain_ms,
                     "nbytes": 4 * n_tok + 8 * B + B * P + 4,
                     "passes": doubling_passes(tok[:used], nt[:used], P)}
        if hasattr(tid, "resolve_launch"):   # the clustered kernel
            out[name]["launch"] = tid.resolve_launch(B, T, P)._asdict()
        if hasattr(tid, "resolve_launch") and dev.type == "cuda":
            out[name]["cluster_ms"] = k7_cluster_variants(
                torch, tid, copies, want, P)
    return out


def k7_cluster_variants(torch, tid, copies, want, P) -> dict:
    """The clustered K7+K8's device ms at each cluster width (CTAs x
    threads) on one chunk (``copies`` of its inputs), each checked
    against the plain version's buffer ``want`` first, each with its
    phase split; the variants are timed twice, in order and in reverse
    order."""
    out = {}
    B, T = copies[0][0].shape
    variants = []
    for c, n in ((2, 0), (4, 0), (4, 512), (8, 0), (8, 256), (16, 0)):
        lr = tid.resolve_launch(B, T, P, cluster=c)
        if n and lr.S % n == 0 and lr.S // n <= 64:
            lr = lr._replace(threads=n)
        variants.append((f"{lr.C}x{lr.threads}", lr))
    # then again in reverse, to see the spread between runs
    variants += [(f"{name} again", lr) for name, lr in variants[::-1]]
    for name, lr in variants:
        got, _ = tid.launch_resolve(*copies[0], lr)
        sync(torch, got.device)
        check(torch.equal(got, want), f"K7+K8 launched as {name} equals "
              f"plain")
        out[name] = {"ms": device_ms(torch, [
            lambda x=x, lr=lr: tid.launch_resolve(*x, lr) for x in copies]),
            "phases": k7_phases(torch, tid, copies[0], lr)}
    return out


K7_PHASES = ("sizes+zeros", "tokens+exchange", "writes", "local doubling",
             "window wait", "resolve+push", "pack", "final barrier")


def k7_phases(torch, tid, args, lr) -> dict:
    """K7+K8's phase split from one launch with clock64() stamps: the
    mean and the largest cycles of each phase over the CTAs of rows with
    data (the pad rows' CTAs stop after the zeros), and the whole."""
    import numpy as np
    clocks = torch.full((lr.B * lr.C, 9), -1, dtype=torch.int64,
                        device=args[0].device)
    tid.launch_resolve(*args, lr, clocks)
    c = clocks.cpu().numpy()
    c = c[c[:, 8] >= 0]
    d = np.diff(c, axis=1)
    out = {k: [float(d[:, i].mean()), int(d[:, i].max())]
           for i, k in enumerate(K7_PHASES)}
    out["whole"] = [float((c[:, 8] - c[:, 0]).mean()),
                    int((c[:, 8] - c[:, 0]).max())]
    out["ctas"] = int(c.shape[0])
    return out


def k10p_bytes(R, S, Q, use) -> int:
    """Bytes of K10p's bound: the [R, S] and [R, Q] tiles written once,
    n_all and the valid records' four int32 columns read once (rows past
    n_valid are zero whatever their columns hold), and their payload
    bytes (``use`` their clipped lengths) read once."""
    return int(R * (S + Q) + 16 * use.size + 4 + ((use + 1) // 2).sum()
               + use.sum())


def k10p_step_chunk(torch, path, dev, n):
    """The BAM's first ``n`` blocks as the device plane's step takes them:
    (tokens, n_tokens, isize) on ``dev``, rows padded to a power of two
    >= 8 and the tokens only as wide as the longest row rounded up to 256
    (as ``_TokenRing.stage`` ships them)."""
    import numpy as np
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.utils import native
    raw, table = first_blocks(path, n)
    tok, nt, iz = pad_tokens(native.deflate_tokenize_batch(
        np.frombuffer(raw, np.uint8), table["cdata_off"],
        table["cdata_len"], 1 << 16), tid.round_pow2(n, 8))
    T = min(1 << 16, -(-max(int(nt.max()), 1) // 256) * 256)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (tok[:, :T], nt, iz))


def k10p_kernel_ms(split) -> float:
    """K10p's ms per call in a ``kernel_split`` reading (nan where there
    is no card)."""
    if not split:
        return float("nan")
    return sum(v for k, v in split.items()
               if any(p in k for p in KERNEL_NAMES["K10p"]))


def k10p_times(torch, path, dev) -> dict:
    """K10p at the 64-block chunk and at the main path's usual 17-block
    chunk (32 token rows) of the BAM, its inputs the walk's offsets and
    K1's columns there: its device ms beside the plain version's; with
    n_all = 0 (every row zero); on the live rows alone (the first n_all
    rows, every one valid); the store floor (``torch.zeros`` of the
    same two tiles: a yardstick the port never calls); and the K10p -> K2
    pair of ``device_seq_stats_step`` (the tiles into K2 with the step's
    lengths), by kernel, so that a K10p gain that K2 gives back shows.
    Also K10p's own kernel time with L2 flushed before each launch, by a
    128 MiB read (``l2_clean_ms``) or write (``l2_dirty_ms``) of another
    buffer, and, at the 17-block chunk, inside ``device_seq_stats_step`` as the device plane
    runs it on that chunk's tokens (resolve, walk and K1 before it, K2
    after: ``step_ms``).  Each with the bytes of its bound.  Checks K10p bit-equal to plain at
    both n_all first.  Uses only what every tree of the port since the
    device plane has, so that an earlier tree (``--tree``) is timed on
    the same inputs."""
    import numpy as np
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.ops.seq_stats import seq_qual_stats
    from hadoop_bam_torch.ops.unpack_bam import unpack_fixed_fields
    from hadoop_bam_torch.parallel.pipeline import (
        PayloadGeometry, device_seq_stats_step,
    )
    g = PayloadGeometry()
    S, Q = g.seq_stride, g.qual_stride
    geo = (g.max_len, S, Q)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for n in (64, 17):
        buf, total, start, _ = bam_chunk(torch, path, dev, n)
        R = tid.records_cap(tid.round_pow2(n, 8), 1 << 16)
        offs, n_all, _, _ = tid.walk_records_device(buf, total, start,
                                                    int(total), R)
        cols = unpack_fixed_fields(buf, offs)
        args = (buf, offs, cols["l_seq"], cols["l_read_name"],
                cols["n_cigar"])
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        for nv_t, what in ((n_all.reshape(1), "the walk's count"),
                           (zero, "n_all 0")):
            got = tid.payload_gather(*args, nv_t, *geo)
            want = tid.payload_gather_plain(*args, nv_t, *geo)
            sync(torch, dev)
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"K10p at the {n}-block chunk, {what}, equals plain")
        nv = min(int(n_all), R)
        valid = torch.arange(R, device=dev) < nv
        lengths = torch.where(valid, torch.clamp(cols["l_seq"], 0,
                                                 g.max_len),
                              0).to(torch.int32)
        copies = [tuple(t.clone() for t in args) + (n_all.reshape(1).clone(),
                                                    lengths.clone())
                  for _ in range(4)]
        gather = [lambda c=c: tid.payload_gather(*c[:6], *geo)
                  for c in copies]
        ms = device_ms(torch, gather, kernel="payload_gather_kernel")
        plain_ms = device_ms(torch, [lambda c=c: tid.payload_gather_plain(
            *c[:6], *geo) for c in copies])
        zero_ms = device_ms(torch, [lambda c=c: tid.payload_gather(
            *c[:5], zero, *geo) for c in copies])
        # the live rows alone: the first nv rows, every one valid
        live_ms = device_ms(torch, [lambda c=c: tid.payload_gather(
            c[0], *(t[:nv] for t in c[1:5]), c[5], *geo) for c in copies])
        floor_ms = device_ms(torch, [lambda: (
            torch.zeros((R, S), dtype=torch.uint8, device=dev),
            torch.zeros((R, Q), dtype=torch.uint8, device=dev))])

        def pair(c):
            seq, qual = tid.payload_gather(*c[:6], *geo)
            return seq_qual_stats(seq, qual, c[6])

        pair_ms = device_ms(torch, [lambda c=c: pair(c) for c in copies])
        split = kernel_split(torch, [lambda c=c: pair(c) for c in copies])
        # L2 flushed before each launch: by a read (clean lines, which
        # K10p's stores replace for free) and by a write (dirty lines of
        # another buffer, which K10p's stores must first write back)
        clean_ms = k10p_kernel_ms(kernel_split(torch, [
            lambda c=c: (flush.max(), tid.payload_gather(*c[:6], *geo))
            for c in copies]))
        dirty_ms = k10p_kernel_ms(kernel_split(torch, [
            lambda c=c: (flush.fill_(1), tid.payload_gather(*c[:6], *geo))
            for c in copies]))
        use = np.clip(cols["l_seq"][:nv].cpu().numpy().astype(np.int64), 0,
                      g.max_len)
        out[f"{n}-block"] = {
            "L": buf.shape[0], "R": R, "records": nv, "ms": ms,
            "loop_ms": loop_ms(torch, gather),
            "plain_ms": plain_ms, "nbytes": k10p_bytes(R, S, Q, use),
            "zero_ms": zero_ms, "zero_nbytes": R * (S + Q) + 4,
            "live_ms": live_ms, "live_nbytes": k10p_bytes(nv, S, Q, use),
            "store_floor_ms": floor_ms, "store_floor_nbytes": R * (S + Q),
            "pair_ms": pair_ms, "pair_kernels_ms": split,
            "l2_clean_ms": clean_ms, "l2_dirty_ms": dirty_ms}
        if n == 17:
            steps = [k10p_step_chunk(torch, path, dev, n) for _ in range(4)]
            walk = device_seq_stats_step(*steps[0], start, int(total), g,
                                         P=1 << 16)[2]
            check(int(walk[0]) == int(n_all),
                  "the device plane's step walked the walk's count")
            out[f"{n}-block"]["step_ms"] = k10p_kernel_ms(kernel_split(
                torch, [lambda c=c: device_seq_stats_step(
                    *c, start, int(total), g, P=1 << 16) for c in steps]))
    return out


def device_plane_times(torch, path, dev) -> dict:
    """The device plane's ``seq_stats()`` over the BAM, once to warm up
    and checked against the generator's counts, then once profiled: wall,
    device-busy s and each hand kernel's total ms (``kernel_totals``) with
    its launches.  Uses only what every tree of the port since the device
    plane has, so that an earlier tree (``--tree``) is profiled on the
    same file."""
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    ds = open_bam(path, config=HBamConfig(inflate_backend="device"))
    n_reads = ds.seq_stats()["n_reads"]
    check(n_reads > 0, "device-plane seq_stats counted reads")
    reset_launches()
    cold()
    wall, busy, by_name = device_busy(torch, ds.seq_stats)
    return {"reads": n_reads, "wall_s": wall, "busy_s": busy,
            "kernels_ms": kernel_totals(by_name),
            "launches": read_launches()}


def native_plane_times(torch, path, dev, reps: int = 5) -> dict:
    """The native plane's three drivers of phase 5 over the BAM, once
    each to warm up, then ``reps`` rounds of the three in turn, the plan
    memo cleared before each call: every wall and their medians.  Uses
    only what every tree of the port has, so that an earlier tree
    (``--tree``) is timed on the same file."""
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    ds = open_bam(path, config=HBamConfig(inflate_backend="native"))
    runs = {"flagstat": ds.flagstat, "seq_stats": ds.seq_stats,
            "flagstat_span": lambda: ds.flagstat(mode="span")}
    for fn in runs.values():
        fn()
    walls = {k: [] for k in runs}
    for _ in range(reps):
        for k, fn in runs.items():
            cold()
            t0 = time.perf_counter()
            fn()
            walls[k].append(time.perf_counter() - t0)
    return {"walls_s": walls,
            "median_s": {k: statistics.median(v) for k, v in walls.items()}}


def native_turns(args) -> dict:
    """``--turns``: ``--times native_plane`` processes in turns for this
    checkout and each ``--tree`` (ABC, CBA, ...); every process's medians
    and, for each tree, its per-round median ratios to this checkout's
    with their median and how many rounds exceed 1."""
    trees = ["."] + [os.path.abspath(t) for t in args.tree]
    runs = {t: [] for t in trees}
    for r in range(args.turns):
        for t in (trees if r % 2 == 0 else trees[::-1]):
            cmd = [sys.executable, os.path.abspath(__file__), "--times",
                   "native_plane", "--reads", str(args.reads),
                   "--seed", str(args.seed)]
            if t != ".":
                cmd += ["--tree", t]
            out = subprocess.run(cmd, check=True, capture_output=True,
                                 text=True, timeout=900).stdout
            med = json.loads(out.strip().splitlines()[-1])["times"][
                "median_s"]
            runs[t].append(med)
            log(f"round {r} {t}: {med}")
    ratios = {}
    for t in trees[1:]:
        per = {k: [b[k] / a[k] for a, b in zip(runs["."], runs[t])]
               for k in runs["."][0]}
        ratios[t] = {k: {"per_round": v, "median": statistics.median(v),
                         "rounds_above_1": sum(x > 1 for x in v)}
                     for k, v in per.items()}
    return {"medians_s": runs, "ratio_to_this_checkout": ratios}


def _le32(a, p):
    return int(a[p:p + 4].view("<i4")[0])


def phase_k9(torch, path, dev) -> dict:
    log("== phase 7: K9 walk_records_device vs plain")
    import numpy as np
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.synth import record_flags, walk_cases
    buf, total, start, host = bam_chunk(torch, path, dev)
    L = buf.shape[0]
    R = tid.records_cap(64, 1 << 16)
    t = int(total)
    second = start + 4 + _le32(host, start)
    third = second + 4 + _le32(host, second)

    def with_bs(p, value):
        b = buf.clone()
        b[p:p + 4] = torch.from_numpy(
            np.frombuffer(np.int32(value).tobytes(), np.uint8).copy())
        return b

    cases = [("chunk", buf, total, start, t, R),
             ("cut final record", buf, third + 20, start, t, R),
             ("start past L", buf, total, L + 3, t, R),
             ("stop mid-chunk", buf, total, start, t // 2, R),
             ("block_size 5", with_bs(third, 5), total, start, t, R),
             ("block_size past L", with_bs(second, L + 1), total, start, t,
              R),
             ("n_all past R", buf, total, start, t, 16)]
    # the tiled walk's edge cases at its tile width (8 tiles each)
    cases += [(name, torch.from_numpy(b).to(dev), tot, st, sp, r)
              for name, b, tot, st, sp, r in walk_cases(tid.WALK_W)]
    for name, b, tot, st, sp, r in cases:
        want = tid.walk_records_device_plain(b, tot, st, sp, r)
        w = [int(x) for x in want[1:]]
        for _ in range(2):   # twice in a row: the scratch is reused
            got = tid.walk_records_device(b, tot, st, sp, r)
            sync(torch, dev)
            check(torch.equal(got[0], want[0]), f"K9 offsets, {name}")
            g = [int(x) for x in got[1:]]
            check(g == w, f"K9 (n_all, tail, bad) {g} != {w}, {name}")
        log(f"{name}: offsets and (n_all, tail, bad) = {tuple(g)} equal, "
            f"twice")
    times = k9_times(torch, path, dev)
    for shape, x in times.items():
        lw = tid.walk_launch(x["L"])
        chunk = bam_chunk(torch, path, dev, int(shape.split("-")[0]))[3]
        n_c = int(record_flags(chunk, x["total"])[1].sum())
        x["bound_ms"] = x["nbytes"] / H100_BYTES_PER_S * 1e3
        log(f"K9 at the {shape} chunk (L = {x['L']}, total {x['total']}, "
            f"R = {x['R']}, {x['records']} records, |C| = {n_c} "
            f"candidates): {lw.tiles} tiles of {lw.W}, {lw.rounds} phase-B "
            f"rounds, {lw.rounds + 3} launches; device {x['ms']:.4f} ms "
            f"(plain {x['plain_ms']:.4f} ms), bound {x['bound_ms']:.6f} ms = "
            f"{x['nbytes']} B / 3.35 TB/s (min(L, total) data bytes read "
            f"once, offsets written once), {100 * x['bound_ms'] / x['ms']:.2f}"
            f"% of it; by kernel (ms per call): {x['kernels_ms']}")
    for line in kernels_report("record_walk"):
        log(f"  ptxas: {line}")
    log("no single PyTorch call computes this function (library_ms null)")
    big, main = times["64-block"], times["17-block"]
    return {"name": "walk_records_device", "route": "cuda",
            "source": "hadoop_bam_torch/csrc/record_walk.cu",
            "replaces": "hadoop_bam_tpu/ops/inflate_device.py:176",
            "max_abs_err": 0, "ms": big["ms"], "loop_ms": big["loop_ms"],
            "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "main_path_shape": _shape_row(
                f"17-block chunk: [{main['L']}] u8, {main['R']} offsets", 0,
                main["ms"], main["plain_ms"], main["nbytes"])}


def phase_k10p(torch, path, dev) -> dict:
    log("== phase 8: K10p payload_gather vs plain")
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.ops.unpack_bam import unpack_fixed_fields
    from hadoop_bam_torch.parallel.pipeline import PayloadGeometry
    from hadoop_bam_torch.synth import (
        PAYLOAD_CASES, payload_rows, poison_allocator,
    )
    g = PayloadGeometry()
    buf, total, start, _ = bam_chunk(torch, path, dev)
    R = tid.records_cap(64, 1 << 16)
    offs, n_all, _, _ = tid.walk_records_device(buf, total, start,
                                                int(total), R)
    cols = unpack_fixed_fields(buf, offs)
    chunk = (buf, offs, cols["l_seq"], cols["l_read_name"], cols["n_cigar"])
    cases = [("64-block chunk", chunk, n_all.reshape(1))]
    L, n = 1 << 16, 8192
    for name in PAYLOAD_CASES:
        rows = [torch.from_numpy(a).to(dev)
                for a in payload_rows(name, L, n, 5)]
        cases.append((name, rows, n - 5))
        # the same rows in a view of buf 3 bytes off 16
        view = torch.empty(L + 3, dtype=torch.uint8, device=dev)[3:]
        view.copy_(rows[0])
        cases.append((f"{name}, buf[3:]", [view] + rows[1:], n - 5))
    rows = [torch.from_numpy(a).to(dev)
            for a in payload_rows("random", L, n, 3)]
    cases += [(f"random, n_all {v}", rows, v)
              for v in (-1, 0, 1, n, n + 7)]
    for name, a, nv in cases:
        nv_t = torch.tensor([int(nv)], dtype=torch.int32, device=dev)
        for strides in ((g.seq_stride, g.qual_stride), (17, 33)):
            geo = (g.max_len, *strides)
            poison_allocator(dev)
            got = tid.payload_gather(*a, nv_t, *geo)
            want = tid.payload_gather_plain(*a, nv_t, *geo)
            sync(torch, dev)
            for x, y, what in zip(got, want, ("seq", "qual")):
                check(torch.equal(x, y), f"K10p {what}, {name}, strides "
                      f"{strides}")
        log(f"{name}: seq and qual tiles bit-equal at strides (96, 160) "
            f"and (17, 33), allocator poisoned ({a[1].shape[0]} rows, "
            f"n_all {int(nv)})")
    if dev.type == "cuda":
        lp = tid.payload_launch(R, g.seq_stride, g.qual_stride,
                                torch.cuda.get_device_properties(dev)
                                .multi_processor_count)
        log(f"K10p launch: one wave of {lp.grid} CTAs x {lp.threads} "
            f"threads")
    for line in kernels_report("payload_gather"):
        log(f"  ptxas: {line}")
    times = k10p_times(torch, path, dev)
    for shape, x in times.items():
        for k in ("", "zero_", "live_", "store_floor_"):
            x[f"{k}bound_ms"] = x[f"{k}nbytes"] / H100_BYTES_PER_S * 1e3
        log(f"K10p at the {shape} chunk (R = {x['R']}, {x['records']} "
            f"records): device {x['ms']:.4f} ms (plain {x['plain_ms']:.4f} "
            f"ms), bound {x['bound_ms']:.4f} ms = {x['nbytes']} B / 3.35 "
            f"TB/s (the [{x['R']}, 96 + 160] tiles written once, columns "
            f"and the records' payload bytes read once), "
            f"{100 * x['bound_ms'] / x['ms']:.1f}% of it; n_all 0 "
            f"{x['zero_ms']:.4f} ms (bound {x['zero_bound_ms']:.4f}); the "
            f"live rows alone {x['live_ms']:.4f} ms (bound "
            f"{x['live_bound_ms']:.4f}); store "
            f"floor (torch.zeros of the two tiles) {x['store_floor_ms']:.4f} "
            f"ms; K10p -> K2 pair {x['pair_ms']:.4f} ms, by kernel "
            f"{x['pair_kernels_ms']}; K10p with L2 flushed before each "
            f"launch by a read {x['l2_clean_ms']:.4f} ms, by a write "
            f"{x['l2_dirty_ms']:.4f} ms; inside the device plane's step "
            f"{x.get('step_ms', float('nan')):.4f} ms")
    log("no single PyTorch call computes this function (library_ms null)")
    big, main = times["64-block"], times["17-block"]
    return {"name": "payload_gather", "route": "cuda",
            "source": "hadoop_bam_torch/csrc/payload_gather.cu",
            "replaces": "hadoop_bam_tpu/ops/inflate_device.py:320",
            "max_abs_err": 0, "ms": big["ms"], "loop_ms": big["loop_ms"],
            "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "zero_ms": big["zero_ms"],
            "l2_clean_ms": big["l2_clean_ms"],
            "l2_dirty_ms": big["l2_dirty_ms"],
            "store_floor_ms": big["store_floor_ms"],
            "main_path_shape": dict(_shape_row(
                f"17-block chunk: {main['R']} rows", 0, main["ms"],
                main["plain_ms"], main["nbytes"]),
                zero_ms=main["zero_ms"], l2_clean_ms=main["l2_clean_ms"],
                l2_dirty_ms=main["l2_dirty_ms"],
                step_ms=main["step_ms"],
                store_floor_ms=main["store_floor_ms"])}


def phase_plane_shapes(torch, path, dev, rows) -> None:
    """K1 and K2 at the shapes the device plane gives them: the 64-block
    chunk's walk offsets at ``records_cap`` rows, and the payload tiles
    K10p cuts from it (lengths 0 past the walk's count, as
    ``device_seq_stats_step`` passes them).  Each must equal its plain
    version; its times and bound there go into its row of the kernels
    line as ``device_plane_shape``."""
    log("== phase 8b: K1 and K2 at the device plane's chunk shape vs plain")
    import numpy as np
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.ops.seq_stats import (
        seq_qual_stats, seq_qual_stats_plain,
    )
    from hadoop_bam_torch.ops.unpack_bam import (
        FIXED_FIELDS, unpack_fixed_fields, unpack_fixed_fields_plain,
    )
    from hadoop_bam_torch.parallel.pipeline import PayloadGeometry
    g = PayloadGeometry()
    buf, total, start, _ = bam_chunk(torch, path, dev)
    L = buf.shape[0]
    R = tid.records_cap(64, 1 << 16)
    offs, n_all, _, _ = tid.walk_records_device(buf, total, start,
                                                int(total), R)
    cols = unpack_fixed_fields(buf, offs)
    want = unpack_fixed_fields_plain(buf, offs)
    sync(torch, dev)
    err = 0
    for name in FIXED_FIELDS:
        diff = cols[name].to(torch.int64) - want[name].to(torch.int64)
        err = max(err, int(diff.abs().max()))
        check(torch.equal(cols[name], want[name]),
              f"K1 column {name} at the device plane's shape")
    nv = min(int(n_all), R)
    log(f"K1 on the chunk's walk offsets ({nv} records, {R} rows, "
        f"L = {L}): every column equal (max_abs_err {err})")
    copies = [(buf.clone(), offs.clone()) for _ in range(4)]
    ms = device_ms(torch, [lambda c=c: unpack_fixed_fields(*c)
                           for c in copies],
                   kernel="unpack_fixed_fields_kernel")
    plain_ms = device_ms(torch, [lambda c=c: unpack_fixed_fields_plain(*c)
                                 for c in copies])
    distinct = int(torch.unique(offs).numel())
    nbytes = 4 * R + 36 * distinct + 48 * R
    rows["unpack_fixed_fields"]["device_plane_shape"] = _shape_row(
        f"[{L}] u8, {R} offsets", err, ms, plain_ms, nbytes)
    rows["unpack_fixed_fields"]["max_abs_err"] = max(
        rows["unpack_fixed_fields"]["max_abs_err"], err)
    log(f"K1 at the device plane's shape: device {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms), bound {nbytes / H100_BYTES_PER_S * 1e3:.4f} ms "
        f"= {nbytes} B / 3.35 TB/s; at the span shape (phase 3) "
        f"{rows['unpack_fixed_fields']['ms']:.4f} ms, bound "
        f"{rows['unpack_fixed_fields']['bound_ms']:.4f} ms")
    seq, qual = tid.payload_gather(buf, offs, cols["l_seq"],
                                   cols["l_read_name"], cols["n_cigar"],
                                   n_all.reshape(1), g.max_len,
                                   g.seq_stride, g.qual_stride)
    valid = torch.arange(R, device=dev) < nv
    lengths = torch.where(valid, torch.clamp(cols["l_seq"], 0, g.max_len),
                          0).to(torch.int32)
    err = _k2_compare(torch, seq, qual, lengths)
    log(f"K2 on the chunk's payload tiles ({R} x ({g.seq_stride}, "
        f"{g.qual_stride}), {nv} with a length): gc, mean_qual bit-equal, "
        f"base_hist equal")
    copies = [(seq.clone(), qual.clone(), lengths.clone()) for _ in range(4)]
    ms = device_ms(torch, [lambda c=c: seq_qual_stats(*c) for c in copies],
                   kernel="seq_stats_kernel")
    plain_ms = device_ms(torch, [lambda c=c: seq_qual_stats_plain(*c)
                                 for c in copies])
    ln = lengths.cpu().numpy().astype(np.int64)
    nbytes = int(4 * R + np.minimum((ln + 1) // 2, g.seq_stride).sum()
                 + np.minimum(ln, g.qual_stride).sum() + 8 * R + 64)
    rows["seq_qual_stats"]["device_plane_shape"] = _shape_row(
        f"{R} x ({g.seq_stride}, {g.qual_stride}), {nv} reads", err, ms,
        plain_ms, nbytes)
    log(f"K2 at the device plane's shape: device {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms), bound {nbytes / H100_BYTES_PER_S * 1e3:.4f} ms "
        f"= {nbytes} B / 3.35 TB/s; at the tile shape (phase 4) "
        f"{rows['seq_qual_stats']['ms']:.4f} ms, bound "
        f"{rows['seq_qual_stats']['bound_ms']:.4f} ms")


def _shape_row(shape, err, ms, plain_ms, nbytes) -> dict:
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    return {"shape": shape, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "share_of_bound": bound_ms / ms}


def phase_device_main(torch, path, truth, card, dev, native_walls):
    log("== phase 9: the device decode plane's main path on cuda:0")
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig, resolve_inflate_backend
    from hadoop_bam_torch.ops.inflate_device import probe_device_plane
    plane = resolve_inflate_backend(HBamConfig())
    check(plane == "native", '"auto" resolves to the native plane')
    log(f'"auto" resolves to {plane!r} without a probe; '
        f"probe_device_plane() reads {probe_device_plane(dev)} (not acted "
        f"on); each driver below names its plane")
    size = os.path.getsize(path)
    ds = open_bam(path, config=HBamConfig(inflate_backend="device"))
    reset_launches()
    walls = {}
    cold()
    t0 = time.perf_counter()
    flag = ds.flagstat()
    walls["flagstat"] = time.perf_counter() - t0
    cold()
    t0 = time.perf_counter()
    stats = ds.seq_stats()
    walls["seq_stats"] = time.perf_counter() - t0
    launches = read_launches()
    log(f"launches in the device plane's main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched on the device plane's main path")
    check_truth(flag, stats, truth)
    log("device plane: flagstat / seq_stats equal the generator's counts "
        f"(mean_gc {stats['mean_gc']:.9f}, mean_qual "
        f"{stats['mean_qual']:.9f})")
    for name, wall in walls.items():
        log(f"{name} on the device plane: {wall:.3f} s wall, "
            f"{truth.n_reads / wall:,.0f} reads/s, {size / wall / 1e6:.1f} "
            f"compressed MB/s; native plane {native_walls[name]:.3f} s, "
            f"{truth.n_reads / native_walls[name]:,.0f} reads/s [{card}]")
    for name, fn in (("flagstat", ds.flagstat), ("seq_stats", ds.seq_stats)):
        cold()
        log_busy(torch, f"{name} (device plane)", fn, card)
    plan_s = device_plane_stages(torch, path, dev, card)
    return launches, walls, plan_s


def device_plane_stages(torch, path, dev, card) -> float:
    """The device plane's host stages, each alone over the whole file:
    the span plan (at the plane's grain and at the native flagstat's,
    memo cleared), the native tokenize of every span on the decode pool,
    and the plane with a step that does nothing on the device (tokenize,
    pinned staging and token copies).  Returns the plan's wall."""
    import concurrent.futures as cf
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.device import data_axis
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.utils.seekable import as_byte_source
    cfg = HBamConfig(inflate_backend="device")
    cold()
    t0 = time.perf_counter()
    spans = list(tp._plan(path, None, 1, tp.DEVICE_PLANE_SPAN_BYTES))
    plan_s = time.perf_counter() - t0
    cold()
    t0 = time.perf_counter()
    coarse = list(tp._plan(path, None, 1, 4 << 20))
    coarse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks = tokens = 0
    with as_byte_source(path) as src, cf.ThreadPoolExecutor(
            cfg.pool_size()) as pool:
        for c in tp.iter_windowed(
                pool, spans, lambda s: tp._tokenize_span_tokens(src, s),
                2 * cfg.pool_size()):
            blocks += c.used
            tokens += int(c.n_tokens.sum())
    tok_s = time.perf_counter() - t0

    def null_step(tok, nt, iz, start, stop, P):
        return torch.zeros(3, dtype=torch.int32, device=tok.device)

    sync(torch, dev)
    t0 = time.perf_counter()
    tp._device_plane(path, data_axis(dev), cfg, None, spans, 2, null_step)
    sync(torch, dev)
    null_s = time.perf_counter() - t0
    log(f"device plane host stages, each alone: plan of {len(spans)} spans "
        f"{plan_s:.3f} s (at 4 MiB, {len(coarse)} spans, {coarse_s:.3f} s); "
        f"tokenize of {blocks} blocks ({tokens} tokens) on "
        f"{cfg.pool_size()} threads {tok_s:.3f} s; tokenize + staging + "
        f"token copies with no device step {null_s:.3f} s "
        f"({os.cpu_count()} CPUs) [{card}]")
    return plan_s


# phase 10's interval filters: about 10% and about 50% of the reads
# (chr20 is 64.4 Mb of the generator's two contigs, chr21 the other half)
REGIONS = ("chr20:1-13000000", "chr21")


class FakeClock:
    """The breakers' clock in phase 10: advanced by hand past a cooldown,
    so the heal run needs no wait."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _jobs_reaped(native, t0: float, delay: float) -> int:
    """The fused native jobs left once every copy wedged at ``t0`` for
    ``delay`` s has woken, started its span's job and handed it to the
    window's cleanup: polled for up to 15 s from half a second past the
    wake, so a job still running when the call returned is waited for,
    not counted."""
    time.sleep(max(0.0, t0 + delay + 0.5 - time.perf_counter()))
    t1 = time.perf_counter()
    while native.live_jobs() and time.perf_counter() - t1 < 15:
        time.sleep(0.05)
    return native.live_jobs()


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _timed_rss(fn):
    """``fn()``, its wall, and this process's resident set size before
    the call and at its peak during it (sampled every 2 ms from
    /proc/self/statm on a thread)."""
    import threading
    base = _rss()
    peak = [base]
    stop = threading.Event()

    def sample():
        while not stop.wait(0.002):
            peak[0] = max(peak[0], _rss())
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        out, wall = _timed(fn)
    finally:
        stop.set()
        t.join()
    return out, wall, base, max(peak[0], _rss())


def _mb(n: int) -> str:
    return f"{n / 1e6:,.1f} MB"


def _piece_bound(grain: int) -> int:
    """The drivers' cut (``pipeline._grain_cut``): a planned span of at
    most two grains is kept, a longer one cut into pieces of at most a
    grain plus one block."""
    from hadoop_bam_torch.formats.bgzf import MAX_BLOCK_SIZE
    return max(2 * grain, grain + MAX_BLOCK_SIZE)


def bai_region_runs(torch, path, card, *, truths=None) -> dict:
    """The native flagstat and seq_stats over each of REGIONS on a
    coordinate-sorted BAM with its ``.bai``, the plan memo cleared before
    each call: walls, the resident set size before and at the peak of
    each call, the reference's trimmed plan (spans, the longest) and the
    spans each driver decoded (``pipeline.spans``).  With ``truths``
    each result is checked against its region's truth.  Uses only what
    every tree of the port since the ``.bai`` has, so that an earlier
    tree (``--tree``) is measured on the same file."""
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.split import planners
    from hadoop_bam_torch.utils.metrics import METRICS
    out = {}
    for region in REGIONS:
        cfg = HBamConfig(inflate_backend="native", bam_intervals=region)
        plan = list(planners.plan_spans_maybe_intervals(path, None, cfg))
        row = {"trimmed_spans": len(plan),
               "trimmed_bytes": sum(s.compressed_size for s in plan),
               "longest_trimmed": max(s.compressed_size for s in plan)}
        ds = open_bam(path, config=cfg)
        got = {}
        for name in ("flagstat", "seq_stats"):
            cold()
            METRICS.reset()
            got[name], wall, base, peak = _timed_rss(getattr(ds, name))
            row[name] = {"wall_s": wall, "rss_before": base,
                         "rss_peak": peak,
                         "spans": METRICS.get("pipeline.spans"),
                         "inflated_bytes":
                             METRICS.get("pipeline.inflated_bytes")}
        if truths is not None:
            check_truth(got["flagstat"], got["seq_stats"], truths[region])
        out[region] = row
    return out


def bai_regions_times(torch, path, dev) -> dict:
    """``--times bai_regions``: ``bai_region_runs`` on a coordinate-sorted
    copy of the BAM's reads (written once beside it, with its ``.bai``,
    and reused)."""
    from hadoop_bam_torch.split.bai import write_bai
    from hadoop_bam_torch.synth import write_synthetic_bam
    srt = path[:-len(".bam")] + "_sorted.bam"
    if not os.path.exists(srt + ".bai"):
        base = os.path.basename(path)[:-len(".bam")].split("_")
        write_synthetic_bam(srt, int(base[2]), int(base[1]),
                            coordinate_sorted=True)
        write_bai(srt)
    return bai_region_runs(torch, srt, None)


def _log_wall(what, wall, n, card, extra="") -> None:
    log(f"{what}: {wall:.3f} s wall, {n / wall:,.0f} reads/s{extra} "
        f"[{card}]")


def _entries(q):
    """A manifest's entries without the message text, in span order."""
    return sorted(({k: e[k] for k in ("path", "span_start", "span_end",
                                      "error_class", "attempts")}
                   for e in q), key=lambda e: e["span_start"])


def phase_resilience(torch, path, truth, card, dev, native_walls, seed,
                     interval_walls):
    """Phase 10: intervals, seeded faults, demotion and quarantine on
    the card, through the entry points; returns the launches of its
    runs and fills ``interval_walls`` with (a)'s native walls by
    (region, driver)."""
    log("== phase 10: resilience and intervals on cuda:0")
    import dataclasses

    import numpy as np
    from hadoop_bam_torch import resilience
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.plan.executor import select_plane
    from hadoop_bam_torch.resilience import chaos
    from hadoop_bam_torch.split.intervals import parse_intervals
    from hadoop_bam_torch.synth import flip_block
    from hadoop_bam_torch.utils.errors import CORRUPT, classify_error
    from hadoop_bam_torch.utils.metrics import METRICS
    from hadoop_bam_torch.utils.resilient import QuarantineManifest
    reset_launches()
    # (a) intervals: native plane, then the device plane named (the gate
    # sends it to a host plane)
    for region in REGIONS:
        want = truth.regions[region]
        for backend in ("native", "device"):
            cfg = HBamConfig(inflate_backend=backend, bam_intervals=region)
            d = select_plane(cfg, intervals=parse_intervals(region))
            check(d.plane == "native", f"{region} on {backend} runs native")
            ds = open_bam(path, config=cfg)
            flag, wf = _timed(ds.flagstat)
            stats, ws = _timed(ds.seq_stats)
            check_truth(flag, stats, want)
            note = "" if backend == "native" else \
                f" (device plane named: {dict(d.rejected)['device']})"
            log(f"(a) {region} on {backend}: {want.n_reads} of "
                f"{truth.n_reads} reads ({100 * want.n_reads / truth.n_reads:.1f}%) "
                f"equal the interval truth{note}")
            for name, wall in (("flagstat", wf), ("seq_stats", ws)):
                _log_wall(f"(a) {name} {region} {backend}", wall,
                          truth.n_reads, card,
                          f"; no intervals {native_walls[name]:.3f} s")
                if backend == "native":
                    interval_walls[(region, name)] = wall
    # (b) seeded device.step faults: demotion, then a heal after the
    # cooldown on an injected clock
    clk = FakeClock()
    resilience.reset(clock=clk)
    METRICS.reset()
    cfg = HBamConfig(inflate_backend="device", breaker_failure_threshold=1.0)
    faults = chaos.seeded_point_faults(seed, "device.step",
                                       ["transient", "corrupt"], 2,
                                       max_call=64)
    log(f"(b) device.step schedule (seed {seed}): "
        f"{[(f.kind, f.at_call) for f in faults]}")
    ds = open_bam(path, config=cfg)
    with chaos.fault_points_on("device.step", faults):
        flag, wf = _timed(ds.flagstat)
        stats, ws = _timed(ds.seq_stats)
    check_truth(flag, stats, truth)
    check(METRICS.get("resilience.demotions") >= 1, "a demotion ticked")
    check(METRICS.get("chaos.point_faults") >= 1, "a device.step fault fired")
    key = f"decode/device/{os.path.abspath(path)}"
    check(resilience.registry().states()[key]["state"] == resilience.OPEN,
          "the device domain's breaker is open")
    log(f"(b) demoted runs equal the truth; counters "
        f"{METRICS.snapshot()['counters']}")
    _log_wall("(b) flagstat demoted mid-run (device -> native)", wf,
              truth.n_reads, card,
              f"; native plane {native_walls['flagstat']:.3f} s")
    _log_wall("(b) seq_stats on the host planes (breaker open)", ws,
              truth.n_reads, card,
              f"; native plane {native_walls['seq_stats']:.3f} s")
    clk.t += cfg.breaker_cooldown_s + 0.1
    before = read_launches()
    flag, wf = _timed(ds.flagstat)
    stats, ws = _timed(ds.seq_stats)
    check_truth(flag, stats, truth)
    healed = {k: v - before[k] for k, v in read_launches().items()}
    for name, n in healed.items():
        check(n > 0, f"{name} launched on the healed device plane")
    state = resilience.registry().states()[key]
    check(state["state"] == resilience.CLOSED and state["healed_total"] == 1,
          f"the device domain healed: {state}")
    check(METRICS.get("resilience.heals") == 1, "resilience.heals ticked")
    _log_wall("(b) flagstat after the cooldown (device plane, heals)", wf,
              truth.n_reads, card)
    _log_wall("(b) seq_stats after the heal (device plane)", ws,
              truth.n_reads, card)
    resilience.reset()
    # (c) seeded transient decode.native faults under the default policy
    METRICS.reset()
    faults = chaos.seeded_point_faults(seed, "decode.native", ["transient"],
                                       3, max_call=40)
    ds = open_bam(path, config=HBamConfig(inflate_backend="native"))
    with chaos.fault_points_on("decode.native", faults):
        flag, wf = _timed(ds.flagstat)
    with chaos.fault_points_on("decode.native", [
            dataclasses.replace(f, count=1) for f in faults]):
        stats, ws = _timed(ds.seq_stats)
    check_truth(flag, stats, truth)
    retries = METRICS.get("pipeline.transient_retries")
    check(retries > 0, "pipeline.transient_retries > 0")
    log(f"(c) decode.native schedule {[f.at_call for f in faults]}: "
        f"{retries} transient retries, results equal the truth")
    _log_wall("(c) flagstat with transient faults", wf, truth.n_reads, card)
    _log_wall("(c) seq_stats with transient faults", ws, truth.n_reads, card)
    # (d) one flipped block: quarantine on the card and on the CPU
    bad = path + ".flipped.bam"
    victim = flip_block(path, bad, os.path.getsize(path) // 2)
    skip = HBamConfig(skip_bad_spans=True)
    got = {}
    for where in (None, "cpu"):
        ds = open_bam(bad, device=where, config=skip)
        qf, qs = QuarantineManifest(), QuarantineManifest()
        (flag, wf) = _timed(lambda: ds.flagstat(quarantine=qf))
        (stats, ws) = _timed(lambda: ds.seq_stats(quarantine=qs))
        got[where] = (flag, stats, _entries(qf.to_dicts()),
                      _entries(qs.to_dicts()))
        label = "cuda:0" if where is None else "cpu"
        _log_wall(f"(d) flagstat skip_bad_spans on {label}", wf,
                  flag["total"], card)
        _log_wall(f"(d) seq_stats skip_bad_spans on {label}", ws,
                  stats["n_reads"], card)
    (fc, sc, qfc, qsc), (fh, sh, qfh, qsh) = got[None], got["cpu"]
    check(fc == fh, "flagstat on the card equals the CPU's")
    check(sc["n_reads"] == sh["n_reads"] and np.array_equal(
        sc["base_hist"], sh["base_hist"]), "seq_stats card == CPU")
    for k in ("mean_gc", "mean_qual"):
        check(abs(sc[k] - sh[k]) <= 1e-6 * abs(sh[k]), f"{k} card == CPU")
    check(qfc == qfh and qsc == qsh, "manifests equal on card and CPU")
    check(len(qfc) == 1 and len(qsc) == 1, "the manifest names one span")
    e = qfc[0]
    check(e["error_class"] == CORRUPT and
          e["span_start"] >> 16 <= victim <= e["span_end"] >> 16,
          f"the entry covers the flipped block at {victim}: {e}")
    check(0 < fc["total"] < truth.n_reads, "the other spans still count")
    log(f"(d) block at {victim} flipped: manifest {qfc} (flagstat) and "
        f"{qsc} (seq_stats) on both devices; {fc['total']} and "
        f"{sc['n_reads']} reads counted")
    for name in ("flagstat", "seq_stats"):
        try:
            getattr(open_bam(bad), name)()
        except ValueError as exc:
            check(classify_error(exc) == CORRUPT,
                  f"{name} raised {type(exc).__name__}")
            log(f"(d) {name} without skip_bad_spans raises "
                f"{type(exc).__name__} (class {classify_error(exc)})")
        else:
            check(False, f"{name} without skip_bad_spans raised")
    os.remove(bad)
    return read_launches()


def _block_starts(path):
    import numpy as np
    from hadoop_bam_torch.formats import bgzf
    with open(path, "rb") as f:
        raw = f.read()
    return np.array([b.coffset for b in bgzf.scan_blocks(raw)], np.int64)


def _span_blocks(starts, spans):
    """Each span's BGZF blocks (the block at a mid-block end counted)."""
    import numpy as np
    return [int(np.searchsorted(starts, s.end[0])
                - np.searchsorted(starts, s.start[0]) + (s.end[1] > 0))
            for s in spans]


def _sidecars(path):
    return [path + suf for suf in (".splitting-bai", ".sbi", ".bai",
                                   ".csi")]


def phase_planning(torch, path, truth, card, dev, args, native_walls,
                   device_walls, guessed_plan_s, interval_walls,
                   sorted_oracle=None):
    """Phase 11: the splitting index, the plan memo, .bai trimming and
    the fused decode through the entry points; returns the launches of
    its runs, and the coordinate-sorted copy (the host ``sort_bam`` of
    the BAM) with its ``.bai`` and its truth (the generator's refid and
    pos columns in the sort's order), which phase 13 queries and then
    removes.  ``sorted_oracle``
    (a dict) receives the copy's wall, record count and SHA-256 digests
    with its co-written ``.bai`` and ``.sbi``: phase 16's oracle."""
    log("== phase 11: span planning and fused decode on cuda:0")
    import numpy as np
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.split import planners
    from hadoop_bam_torch.split.bai import write_bai
    from hadoop_bam_torch.split.splitting_index import (
        SplittingIndex, write_splitting_index,
    )
    from hadoop_bam_torch.utils.metrics import METRICS
    from hadoop_bam_torch.utils.sort import sort_bam
    reset_launches()
    size = os.path.getsize(path)
    work = os.path.join(os.path.dirname(path), "phase11")
    os.makedirs(work, exist_ok=True)
    link = os.path.join(work, "linked.bam")
    srt = os.path.join(work, "sorted.bam")
    for p in [link, srt] + _sidecars(link) + _sidecars(srt):
        if os.path.exists(p):
            os.remove(p)
    try:
        os.link(path, link)
    except OSError:
        import shutil
        shutil.copyfile(path, link)
    native = HBamConfig(inflate_backend="native")
    device = HBamConfig(inflate_backend="device")
    kept = False
    try:
        # (a) the writers
        _, w_sbai = _timed(lambda: write_splitting_index(link, 4096))
        idx = SplittingIndex.load_for(link)
        check(len(idx.voffsets) == -(-truth.n_reads // 4096) + 1,
              "the splitting index samples every 4096th read")
        # the sorted copy is the port's host sort of the same reads (the
        # generator's sorted rewrite took 59.5 s of the 1200), and phase
        # 16 holds its mesh sorts to these bytes
        n_sorted, w_sort = _timed(lambda: sort_bam(path, srt,
                                                   run_records=1 << 40))
        check(n_sorted == truth.n_reads, "the sorted copy holds every read")
        if sorted_oracle is not None:
            sorted_oracle.update(wall=w_sort, n=n_sorted, digests={
                suffix: _digest(srt + suffix)
                for suffix in ("", ".bai", ".sbi")})
        # the query oracle's columns: the generator's, in the order a
        # coordinate sort gives (unplaced reads last, ties by input index)
        order = np.lexsort((np.arange(truth.n_reads), truth.pos,
                            np.where(truth.refid < 0, 2**32,
                                     truth.refid.astype(np.int64))))
        srt_truth = dataclasses.replace(truth, refid=truth.refid[order],
                                        pos=truth.pos[order])
        _, w_bai = _timed(lambda: write_bai(srt))
        log(f"(a) .splitting-bai of {size} bytes: {len(idx.voffsets)} "
            f"offsets, {os.path.getsize(link + '.splitting-bai')} bytes in "
            f"{w_sbai:.3f} s; the reads coordinate-sorted by the host "
            f"sort_bam ({os.path.getsize(srt)} bytes, {w_sort:.1f} s), its "
            f".bai {os.path.getsize(srt + '.bai')} bytes in {w_bai:.3f} s "
            f"[{card}]")

        # (b) plans snapped to the splitting index
        grains = {"device plane": tp.DEVICE_PLANE_SPAN_BYTES,
                  "flagstat": 4 << 20, "seq_stats": 8 << 20,
                  "span mode": (1 << 24) // 8}
        plans = {}
        starts = _block_starts(link)
        for what, grain in grains.items():
            cold()
            plan, wall = _timed(lambda: list(tp._plan(link, None, 1, grain,
                                                      native)))
            plans[what] = plan
            blocks = _span_blocks(starts, plan)
            over = sum(b > tp.DEVICE_PLANE_MAX_BLOCKS for b in blocks)
            log(f"(b) {what} plan at {grain} bytes from the index: "
                f"{len(plan)} spans in {wall:.4f} s; largest "
                f"{max(blocks)} blocks, {over} spans past "
                f"{tp.DEVICE_PLANE_MAX_BLOCKS}"
                + (f"; guessed (phase 9) {guessed_plan_s:.3f} s"
                   if what == "device plane" else "") + f" [{card}]")
        sampled = set(idx.voffsets)
        check(all(s.start_voffset in sampled
                  for s in plans["device plane"][1:]),
              "the device plane's spans start at sampled records")
        cold_walls = {}
        for plane, cfg in (("native", native), ("device", device)):
            ds = open_bam(link, config=cfg)
            cold()
            flag, wf = _timed(ds.flagstat)
            cold()
            stats, ws = _timed(ds.seq_stats)
            check_truth(flag, stats, truth)
            earlier = native_walls if plane == "native" else device_walls
            for name, wall in (("flagstat", wf), ("seq_stats", ws)):
                cold_walls[(plane, name)] = wall
                _log_wall(f"(b) {name} on the {plane} plane, "
                          f".splitting-bai plan", wall, truth.n_reads, card,
                          f"; guessed plan {earlier[name]:.3f} s")
        ds = open_bam(link, config=native)
        cold()
        check(ds.flagstat(mode="span") == truth.flagstat,
              "span-mode flagstat from the index equals the truth")

        # (c) the memo: a second call plans nothing
        for plane, cfg in (("native", native), ("device", device)):
            ds = open_bam(link, config=cfg)
            flag, wf = _timed(ds.flagstat)
            stats, ws = _timed(ds.seq_stats)
            check_truth(flag, stats, truth)
            for name, wall in (("flagstat", wf), ("seq_stats", ws)):
                _log_wall(f"(c) {name} on the {plane} plane, memo hit",
                          wall, truth.n_reads, card,
                          f"; cold {cold_walls[(plane, name)]:.3f} s")
        hit, hit_s = _timed(lambda: tp._plan(
            link, None, 1, tp.DEVICE_PLANE_SPAN_BYTES, device))
        check(isinstance(hit, list), "a repeated plan is a memo hit")
        log(f"(c) device plane plan from the memo: {hit_s * 1e3:.3f} ms, "
            f"{len(planners._PLAN_CACHE)} plans held [{card}]")
        write_splitting_index(link, 4096)
        again = tp._plan(link, None, 1, tp.DEVICE_PLANE_SPAN_BYTES, device)
        check(not isinstance(again, list),
              "a rewritten sidecar makes the next call plan again")
        check([s.to_dict() for s in again] == [s.to_dict() for s in hit],
              "the replanned spans equal the memo's")
        flag, wf = _timed(open_bam(link, config=device).flagstat)
        check(flag == truth.flagstat, "flagstat after the rewrite")
        _log_wall("(c) device plane flagstat after the sidecar rewrite", wf,
                  truth.n_reads, card)

        # (b2) a splitting index sampled more coarsely than the grains
        # (every 65,536th read): the drivers cut the snapped spans back
        write_splitting_index(link, 1 << 16)
        for what, grain in (("device plane", tp.DEVICE_PLANE_SPAN_BYTES),
                            ("span mode", (1 << 24) // 8)):
            cold()
            snapped = list(planners.plan_spans_cached(
                link, None, native, num_spans=-(-size // grain)))
            cold()
            plan, wall = _timed(lambda: list(tp._plan(link, None, 1, grain,
                                                      native)))
            blocks = _span_blocks(starts, plan)
            check(max(s.compressed_size for s in plan)
                  <= _piece_bound(grain),
                  f"{what}: spans from a coarse index stay within the "
                  f"grain's bound")
            if what == "device plane":
                check(max(blocks) <= tp.DEVICE_PLANE_MAX_BLOCKS,
                      "no device-plane span from a coarse index passes "
                      "the chunk's blocks")
            log(f"(b2) {what} plan at {grain} bytes from a coarse index: "
                f"{len(snapped)} snapped spans (longest "
                f"{max(s.compressed_size for s in snapped)} bytes) cut to "
                f"{len(plan)} in {wall:.3f} s; largest {max(blocks)} "
                f"blocks [{card}]")
        cold()
        flag, wf = _timed(open_bam(link, config=device).flagstat)
        check(flag == truth.flagstat, "device plane over a coarse index")
        _log_wall("(b2) device plane flagstat over the coarse index", wf,
                  truth.n_reads, card)
        cold()
        flag, wf = _timed(lambda: open_bam(link, config=native).flagstat(
            mode="span"))
        check(flag == truth.flagstat, "span mode over a coarse index")
        _log_wall("(b2) flagstat(mode=\"span\") over the coarse index", wf,
                  truth.n_reads, card)

        # (d) .bai trimming on the coordinate-sorted copy: full scans
        # (the .bai moved away), then the trimmed runs; the resident set
        # size at each call's peak
        bai = srt + ".bai"
        full = {}
        os.rename(bai, bai + ".off")
        for region in REGIONS:
            ds = open_bam(srt, config=HBamConfig(inflate_backend="native",
                                                 bam_intervals=region))
            got = {}
            for name in ("flagstat", "seq_stats"):
                cold()
                METRICS.reset()
                got[name], wall, base, peak = _timed_rss(getattr(ds, name))
                full[(region, name)] = (wall, base, peak, METRICS.get(
                    "pipeline.inflated_bytes"))
            check_truth(got["flagstat"], got["seq_stats"],
                        truth.regions[region])
        os.rename(bai + ".off", bai)
        trimmed = bai_region_runs(torch, srt, card, truths=truth.regions)
        srt_size = os.path.getsize(srt)
        for region, row in trimmed.items():
            want = truth.regions[region]
            cfg = HBamConfig(inflate_backend="native", bam_intervals=region)
            cuts = {}
            for name, grain in (("flagstat", tp.FLAGSTAT_SPAN_BYTES),
                                ("seq_stats", tp.SEQ_STATS_SPAN_BYTES)):
                cold()
                pieces = list(tp._plan(srt, None, 1, grain, cfg))
                check(max(s.compressed_size for s in pieces)
                      <= _piece_bound(grain),
                      f"{region}: the {name} driver's spans stay within "
                      f"its grain's bound")
                check(row[name]["spans"] == len(pieces),
                      f"{region}: {name} decoded the cut plan")
                cuts[name] = (len(pieces),
                              max(s.compressed_size for s in pieces))
                check(row[name]["inflated_bytes"] < full[(region, name)][3],
                      f"the .bai run inflates less ({region}, {name})")
            log(f"(d) {region}: {want.n_reads} reads equal the interval "
                f"truth with and without the .bai; the trimmed plan is "
                f"{row['trimmed_spans']} span(s) over "
                f"{row['trimmed_bytes']} of {srt_size} compressed bytes "
                f"({100 * row['trimmed_bytes'] / srt_size:.1f}%), the "
                f"longest {row['longest_trimmed']} bytes; decoded as "
                f"{cuts['flagstat'][0]} spans (longest {cuts['flagstat'][1]}"
                f" bytes) by flagstat, {cuts['seq_stats'][0]} (longest "
                f"{cuts['seq_stats'][1]}) by seq_stats")
            for name in ("flagstat", "seq_stats"):
                r = row[name]
                fw, fbase, fpeak, finfl = full[(region, name)]
                _log_wall(f"(d) {name} {region} with the .bai",
                          r["wall_s"], want.n_reads, card,
                          f"; full scan of the sorted copy {fw:.3f} s; "
                          f"phase 10 (a) "
                          f"{interval_walls[(region, name)]:.3f} s")
                log(f"(d) {name} {region}: resident set peak "
                    f"{_mb(r['rss_peak'])} (+{_mb(r['rss_peak'] - r['rss_before'])}"
                    f" over the call's start), inflated {r['inflated_bytes']}"
                    f" bytes; full scan peak {_mb(fpeak)} "
                    f"(+{_mb(fpeak - fbase)}), inflated {finfl} bytes "
                    f"[{card}]")

        # (e) fused against two-pass, in turns, memo cleared each call
        ds_on = open_bam(path, config=native)
        ds_off = open_bam(path, config=HBamConfig(inflate_backend="native",
                                                  use_fused_decode=False))
        runs = {"flagstat": lambda d: d.flagstat(),
                "seq_stats": lambda d: d.seq_stats(),
                "flagstat_span": lambda d: d.flagstat(mode="span")}
        walls = {(k, f): [] for k in runs for f in ("fused", "two-pass")}
        tails = spans = 0
        for r in range(3):
            order = (("fused", ds_on), ("two-pass", ds_off))
            for name, fn in runs.items():
                for label, d in (order if r % 2 == 0 else order[::-1]):
                    cold()
                    METRICS.reset()
                    out, wall = _timed(lambda: fn(d))
                    if name == "seq_stats":
                        check(out["n_reads"] == truth.n_reads and
                              np.array_equal(out["base_hist"],
                                             truth.base_hist),
                              f"seq_stats {label}")
                    else:
                        check(out == truth.flagstat, f"{name} {label}")
                    walls[(name, label)].append(wall)
                    if label == "fused":
                        tails += METRICS.get("pipeline.fused_tail_fallbacks")
                        spans += METRICS.get("pipeline.spans")
        for name in runs:
            on, off = walls[(name, "fused")], walls[(name, "two-pass")]
            log(f"(e) {name}: fused {', '.join(f'{w:.3f}' for w in on)} s, "
                f"two-pass {', '.join(f'{w:.3f}' for w in off)} s; medians "
                f"{statistics.median(on):.3f} / {statistics.median(off):.3f}"
                f" s, {truth.n_reads / statistics.median(on):,.0f} / "
                f"{truth.n_reads / statistics.median(off):,.0f} reads/s "
                f"[{card}]")
        log(f"(e) fused spans finished by the two-pass tail: {tails} of "
            f"{spans} ({100 * tails / max(spans, 1):.2f}%)")
        kept = True
    finally:
        # the sorted copy and its .bai stay for phase 13 when all passed
        for p in [link] + _sidecars(link) + ([] if kept else [srt] + _sidecars(
                srt)) + [srt + ".bai.off"]:
            if os.path.exists(p):
                os.remove(p)
        cold()
    launches = read_launches()
    log(f"launches in phase 11: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched in phase 11")
    return launches, srt, srt_truth


# phase 12's gzipped QSEQ: the first reads of the BAM's
QSEQ_READS = 200_000


def _bytes_of(batch) -> int:
    return sum(t.numel() * t.element_size() for t in batch.values())


def _same_stats(got, want, what) -> None:
    import numpy as np
    check(got["n_reads"] == want["n_reads"], f"{what}: n_reads "
          f"{got['n_reads']} != {want['n_reads']}")
    check(np.array_equal(got["base_hist"], want["base_hist"]),
          f"{what}: base_hist")
    for k in ("mean_gc", "mean_qual"):
        rel = abs(got[k] - want[k]) / abs(want[k])
        check(rel <= 1e-6, f"{what}: {k} rel err {rel} <= 1e-6")


def k2_window_check(torch, batches, dev, card="") -> dict:
    """K2 against its plain version on every FASTA window batch (rows
    past the count at length 0), and its times on the first batch's
    tiles (65,536 x (512, 1024) at window 1024), launched as the main
    path launches it: ``ms`` by the profiler over whole sessions
    (``device_ms``), by kernel, the plain version's, one call and 48
    calls in a row by events, one launch over the rows eight times over
    by events (per 65,536 rows), and the bound."""
    import numpy as np
    from hadoop_bam_torch.ops.seq_stats import (
        k2_launch, seq_qual_stats, seq_qual_stats_plain,
    )
    err = 0
    for b in batches:
        c = int(b["n_records"][0])
        lengths = torch.where(torch.arange(b["lengths"].shape[1],
                                           device=dev) < c,
                              b["lengths"][0], 0).to(torch.int32)
        args_ = (b["seq_packed"][0], b["qual"][0], lengths)
        got = seq_qual_stats(*args_)
        want = seq_qual_stats_plain(*args_)
        sync(torch, dev)
        for k in ("gc", "mean_qual", "base_hist"):
            check(torch.equal(got[k], want[k]),
                  f"K2 {k} at the window shape bit-equal to plain")
        err = max(err, int((got["base_hist"].to(torch.int64)
                            - want["base_hist"].to(torch.int64))
                           .abs().max()))
    b = batches[0]
    s_t, q_t, l_t = b["seq_packed"][0], b["qual"][0], b["lengths"][0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    go = k2_launch(s_t.shape[0], s_t.shape[1], q_t.shape[1],
                   (s_t.data_ptr(), q_t.data_ptr(), l_t.data_ptr()), sms)
    copies = [(s_t.clone(), q_t.clone(), l_t.clone()) for _ in range(2)]
    calls = [lambda c=c: seq_qual_stats(*c) for c in copies]
    ms = device_ms(torch, calls, kernel="seq_stats_kernel")
    # the plain version launches ~1,750 kernels a call: 4 calls a
    # profiler session, not 32, keep the sessions short
    plain_ms = device_ms(torch, [lambda c=c: seq_qual_stats_plain(*c)
                                 for c in copies], reps=4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ev_ms = time_ms(torch, lambda: seq_qual_stats(*copies[0]), flush)
    split = kernel_split(torch, calls, kernel="seq_stats_kernel")
    looped = loop_ms(torch, calls)
    # the same rows eight times over in one launch: the launch overhead
    # amortized, a device time per 65,536 rows that needs no profiler
    # (a check on ``ms``; the main path never launches this shape)
    big = tuple(torch.cat([t] * 8) for t in (s_t, q_t, l_t))
    big_ms = time_ms(torch, lambda: seq_qual_stats(*big), flush) / 8
    for c in copies + [big]:   # the timed inputs give the checked results
        got, want = seq_qual_stats(*c), seq_qual_stats_plain(*c)
        sync(torch, dev)
        check(all(torch.equal(got[k], want[k]) for k in want),
              "K2 on the timed inputs equals plain")
    del big
    ln = l_t.to(torch.int64).clamp(min=0).cpu().numpy()
    nbytes = int(4 * ln.size + np.minimum((ln + 1) // 2, s_t.shape[1]).sum()
                 + np.minimum(ln, q_t.shape[1]).sum() + 8 * ln.size + 64)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    log(f"K2 at the window shape {s_t.shape[0]} x ({s_t.shape[1]}, "
        f"{q_t.shape[1]}) bit-equal to plain on all {len(batches)} "
        f"batches ({'TMA rings' if go.aligned else 'direct loads'}, "
        f"{go.tiles} tiles of {go.rows} rows on {go.grid} blocks of "
        f"{go.warps} warps, {go.smem} B shared memory per block); "
        f"device {ms:.4f} ms a 65,536-row launch (profiler, whole "
        f"sessions), by kernel {split}; {big_ms:.4f} ms per 65,536 rows "
        f"in one launch over 524,288 (events, L2 flushed); one call by "
        f"events incl. launch overhead {ev_ms:.4f} ms; 48 calls in a row "
        f"{looped:.4f} ms a call; plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms = {nbytes} B / 3.35 TB/s [{card}]")
    return {"shape": f"{s_t.shape[0]} x ({s_t.shape[1]}, {q_t.shape[1]})",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "by_kernel": split, "event_ms": ev_ms, "loop_ms": looped,
            "amortized_ms": big_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "share_of_bound": bound_ms / ms}


def k2_window_times(torch, path, dev) -> dict:
    """``--times k2_window``: phase 12 (c)'s FASTA (chr21 + chr22
    lengths) cut into windows of 1024, K2 checked and timed there."""
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.api import open_fasta
    from hadoop_bam_torch.utils.native import BUILD_DIR
    fa = os.path.join(BUILD_DIR, "smoke", "k2_window.fa")
    synth.write_synthetic_fasta(fa, 0)
    try:
        batches = list(open_fasta(fa, device=dev)
                       .window_tensor_batches(window=1024))
    finally:
        os.remove(fa)
    return k2_window_check(torch, batches, dev, card_line())


def phase_reads(torch, path, truth, card, dev, args, native_walls):
    """Phase 12: the read formats and the tensor feeds through the entry
    points on cuda:0; returns the launches of their main paths."""
    log("== phase 12: read formats and tensor feeds on cuda:0")
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.api import open_bam, open_fasta
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.ops.unpack_bam import (
        FIXED_FIELDS, unpack_fixed_fields_plain, unpack_fixed_fields_tile,
    )
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.split.planners import plan_bam_spans
    from hadoop_bam_torch.utils.native import BUILD_DIR
    work = os.path.join(BUILD_DIR, "smoke")
    fq = fastq_path(path)     # written with the BAM (make_bam)
    qs = os.path.join(work, f"synth_{args.seed}_{QSEQ_READS}.qseq.gz")
    fa = os.path.join(work, f"synth_{args.seed}.fa")
    log(f"FASTQ of the BAM's {truth.n_reads} reads: {os.path.getsize(fq)} "
        f"bytes")
    t0 = time.perf_counter()
    qs_truth = synth.write_synthetic_reads(qs, args.reads, args.seed,
                                           fmt="qseq", limit=QSEQ_READS,
                                           compress=True)
    log(f"gzipped QSEQ of the first {qs_truth.n_reads} reads -> "
        f"{os.path.getsize(qs)} bytes in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    contigs = synth.write_synthetic_fasta(fa, args.seed)
    log(f"FASTA of {contigs} -> {os.path.getsize(fa)} bytes in "
        f"{time.perf_counter() - t0:.1f} s")
    ds = open_bam(path, config=HBamConfig(inflate_backend="native"))
    bam_stats = ds.seq_stats()
    walls, kept = {}, {}
    try:
        reset_launches()
        # (a) FASTQ stats against phase 5's BAM seq_stats
        t0 = time.perf_counter()
        got = tp.fastq_seq_stats_file(fq)
        walls["fastq"] = time.perf_counter() - t0
        _same_stats(got, bam_stats, "FASTQ stats against the BAM's")
        _same_stats(got, dataclasses.asdict(truth),
                    "FASTQ stats against the generator's")
        # (b) the gzipped QSEQ against the generator's counts
        t0 = time.perf_counter()
        got = tp.fastq_seq_stats_file(qs)
        walls["qseq_gz"] = time.perf_counter() - t0
        _same_stats(got, dataclasses.asdict(qs_truth), "gzipped QSEQ")
        # (c) FASTA windows, through K2 as each batch arrives
        windows, nbytes, fasta_totals = 0, 0, tp._StatTotals()
        kept["fasta"] = []
        t0 = time.perf_counter()
        for b in open_fasta(fa).window_tensor_batches(window=1024):
            windows += int(b["n_records"][0])
            nbytes += _bytes_of(b)
            fasta_totals.add(*tp.read_stats_step(
                b["seq_packed"][0], b["qual"][0], b["lengths"][0],
                b["n_records"][0]))
            kept["fasta"].append(b)
        fasta_stats = tp._payload_stats_result(fasta_totals)
        walls["fasta_windows"] = time.perf_counter() - t0
        want_windows = sum(synth.window_count(n, 1024)
                           for n in contigs.values())
        check(windows == want_windows == fasta_stats["n_reads"],
              f"FASTA windows {windows} == {want_windows}")
        log(f"(c) {windows} windows of 1024 in {len(kept['fasta'])} "
            f"batches, {nbytes} B delivered in {walls['fasta_windows']:.3f}"
            f" s ({nbytes / walls['fasta_windows'] / 1e9:.3f} GB/s), "
            f"mean_gc {fasta_stats['mean_gc']:.6f} [{card}]")
        # (d) BAM tensor batches through K2 against seq_stats()
        rows, batches, nbytes, totals = 0, 0, 0, tp._StatTotals()
        cold()
        t0 = time.perf_counter()
        for b in ds.tensor_batches():
            n = b["n_records"][0]
            cols = unpack_fixed_fields_tile(b["prefix"][0])
            lengths = torch.clamp(cols["l_seq"], max=tp.PayloadGeometry()
                                  .max_len).to(torch.int32)
            totals.add(*tp.read_stats_step(b["seq_packed"][0], b["qual"][0],
                                           lengths, n))
            rows += int(n)
            batches += 1
            nbytes += _bytes_of(b)
        feed = tp._payload_stats_result(totals)
        walls["bam_tensor_batches"] = time.perf_counter() - t0
        check(rows == truth.n_reads, f"BAM batches hold {rows} rows")
        _same_stats(feed, bam_stats, "BAM tensor_batches through K2")
        log(f"(d) BAM tensor_batches: {batches} batches, {rows} rows, "
            f"{nbytes} B delivered to the card in "
            f"{walls['bam_tensor_batches']:.3f} s: "
            f"{batches / walls['bam_tensor_batches']:.2f} batches/s, "
            f"{nbytes / walls['bam_tensor_batches'] / 1e9:.3f} GB/s, "
            f"{rows / walls['bam_tensor_batches']:,.0f} reads/s [{card}]")
        # (e) unpack_step over one stacked span group
        span = plan_bam_spans(path, num_spans=max(
            1, os.path.getsize(path) // (2 << 20)))[0]
        g = tp.DecodeGeometry()
        group = tp.stack_span_group(path, [span], 1, g)
        dt, ot, ct = (torch.from_numpy(a).to(dev) for a in
                      (group.data, group.offsets, group.n_records))
        cols = tp.unpack_step(dt, ot, ct)
        launches = read_launches()

        def bam_feed():
            for b in ds.tensor_batches():
                c = unpack_fixed_fields_tile(b["prefix"][0])
                tp.read_stats_step(b["seq_packed"][0], b["qual"][0],
                                   torch.clamp(c["l_seq"], max=160)
                                   .to(torch.int32), b["n_records"][0])

        # profiled re-runs (after the counts were read): the busy shares
        for name, fn in (("fastq", lambda: tp.fastq_seq_stats_file(fq)),
                         ("bam_tensor_batches", bam_feed)):
            log_busy(torch, name, fn, card)
    finally:
        for p in (fq, qs, fa):
            if os.path.exists(p):
                os.remove(p)
    log(f"launches in phase 12: {launches}")
    for name in ("unpack_fixed_fields", "seq_qual_stats"):
        check(launches[name] > 0, f"{name} launched in phase 12")
    # the checks against the plain versions (their launches not counted)
    want = unpack_fixed_fields_plain(dt[0], ot[0])
    n = int(group.n_records[0])
    for name in FIXED_FIELDS:
        check(torch.equal(cols[name][0], want[name]), f"unpack_step {name}")
        check(cols[name].shape == (1, g.records_cap), f"{name} shape")
    check(bool(cols["valid"][0, :n].all())
          and not bool(cols["valid"][0, n:].any()), "unpack_step valid")
    log(f"(e) unpack_step over a stacked group of one span ({n} records, "
        f"D = {g.bytes_cap}, N = {g.records_cap}): the 12 columns equal "
        f"K1's plain version, valid = the first {n} rows")
    window = k2_window_check(torch, kept.pop("fasta"), dev, card)
    for name, wall in walls.items():
        n = {"fastq": truth.n_reads, "qseq_gz": QSEQ_READS,
             "fasta_windows": windows,
             "bam_tensor_batches": truth.n_reads}[name]
        log(f"{name}: {wall:.3f} s wall, {n / wall:,.0f} "
            f"{'windows' if name == 'fasta_windows' else 'reads'}/s "
            f"[{card}]")
    log(f"FASTQ stats {walls['fastq']:.3f} s beside phase 5's BAM "
        f"seq_stats {native_walls['seq_stats']:.3f} s "
        f"({walls['fastq'] / native_walls['seq_stats']:.2f}x) [{card}]")
    return launches, {"window_shape": window}


# ``--times KERNEL``: the timing function of each kernel (or path) that
# has one, called as fn(torch, path, dev) -> a JSON-able dict
# phase 13: the coverage BAM piles half of --reads (1,000,000 at the
# default) over chr20:1-10,000,000, about 15x, and the batch holds the
# first 250 of QUERY_DRAWN regions (phase 14 serves the first 200 of
# them, as before the cuts): depth cut from 2,000,000 reads and 1,000
# regions (500 until phase 17 came) to keep the smoke in its 1200 s
COV_SPAN = 10_000_000
CHR20_LEN = 64_444_167
QUERY_DRAWN = 1000
QUERY_REGIONS = 250


def _k12_tiles(torch, cov, dev, rows, mc, copies):
    """``copies`` tiles of ``rows`` cigar rows of the coverage BAM at op
    width ``mc`` (the records of at most ``mc`` ops, packed as the driver
    packs them) on ``dev``, and the aligned ops one tile holds (op
    length > 0, M/=/X, mapped, on chr20)."""
    import numpy as np
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.split.planners import plan_bam_spans
    got, n = [], 0
    for span in plan_bam_spans(cov, num_spans=max(
            1, os.path.getsize(cov) // (4 << 20))):
        r = tp.decode_span_cigar_rows(cov, span, 64)
        nc = r[:, 8].astype(np.int64) | (r[:, 9].astype(np.int64) << 8)
        r = r[nc <= mc, :tp._cigar_row_bytes(mc)]
        got.append(r)
        n += len(r)
        if n >= rows:
            break
    tile = np.ascontiguousarray(np.concatenate(got)[:rows])
    check(tile.shape[0] == rows, f"{rows} rows of at most {mc} ops")
    words = tile[:, 12:].copy().view("<u4").astype(np.int64)
    refid = tile[:, 0:4].copy().view("<i4")[:, 0]
    flag = tile[:, 10].astype(np.int64) | (tile[:, 11].astype(np.int64)
                                           << 8)
    aligned = np.isin(words & 0xF, (0, 7, 8)) & ((words >> 4) > 0) & \
        ((flag & 4) == 0)[:, None] & (refid == 0)[:, None]
    host = torch.from_numpy(tile)
    return [host.to(dev) for _ in range(copies)], host, int(aligned.sum())


def k12_times(torch, cov, dev, card) -> dict:
    """K12 at one dispatch of the driver (``coverage_step``, 32,768 rows)
    at op widths 8 and 64 on the card against the CPU's result on the
    same tile, timed by ``device_ms`` (each call over its own copy of
    the tile, together past the 50 MB L2), with its bound: the tile read
    once and two 4-byte diff entries read and written per aligned op;
    and the final cumsum at the 10 Mb and chr20 windows (a window read
    and written once)."""
    from hadoop_bam_torch.ops.cigar import SPREAD
    from hadoop_bam_torch.parallel import pipeline as tp
    rows, out = 1 << 15, {}
    for mc in (8, 64):
        row_w = tp._cigar_row_bytes(mc)
        copies = max(2, -(-(100 << 20) // (rows * row_w)))
        tiles, host, aligned = _k12_tiles(torch, cov, dev, rows, mc, copies)
        diff = torch.zeros(COV_SPAN + 1 + SPREAD, dtype=torch.int32,
                           device=dev)
        got = tp.coverage_step(tiles[0], rows, 0, 0, COV_SPAN, mc)
        want = tp.coverage_step(host, rows, 0, 0, COV_SPAN, mc)
        check(torch.equal(got.cpu(), want), f"K12 at width {mc}: card "
              f"equals CPU")
        calls = [lambda t=t: tp.coverage_step(t, rows, 0, 0, COV_SPAN, mc,
                                              out=diff) for t in tiles]
        ms = device_ms(torch, calls)
        how = device_ms.how
        nbytes = rows * row_w + 16 * aligned
        bound = 1e3 * nbytes / H100_BYTES_PER_S
        out[f"width_{mc}"] = {"rows": rows, "tile_bytes": rows * row_w,
                              "aligned_ops": aligned, "ms": ms,
                              "bound_ms": bound, "bytes": nbytes}
        log(f"K12 coverage_step at {rows} rows, op width {mc} "
            f"({rows * row_w} B tile, {aligned} aligned ops): {ms:.4f} ms "
            f"by {how}, bound {bound:.4f} ms ({nbytes} B / "
            f"3.35 TB/s, {100 * bound / ms:.1f}%); card equals CPU "
            f"[{card}]")
    for window in (COV_SPAN, CHR20_LEN):
        d = torch.ones(window + 1, dtype=torch.int32, device=dev)
        ms = device_ms(torch, [lambda: torch.cumsum(d[:window], 0,
                                                    dtype=torch.int32)],
                       reps=8)
        bound = 1e3 * 8 * window / H100_BYTES_PER_S
        out[f"cumsum_{window}"] = {"ms": ms, "bound_ms": bound}
        log(f"K12 final cumsum over {window} bases: {ms:.4f} ms, bound "
            f"{bound:.4f} ms ({100 * bound / ms:.1f}%) [{card}]")
    return out


def _query_batch(rng, names, lengths, n):
    """``n`` regions of 1-10 kb over ``names`` weighted by length, a
    tenth of them placed to overlap another region of the batch; as
    (rid, beg, end) 1-based inclusive, in a shuffled order."""
    import numpy as np
    lengths = np.asarray(lengths, np.int64)
    n_free = n - n // 10
    rid = rng.choice(len(names), n_free, p=lengths / lengths.sum())
    ln = rng.integers(1000, 10_001, n)
    beg = 1 + (rng.random(n_free) * (lengths[rid] - ln[:n_free])).astype(
        np.int64)
    other = rng.integers(0, n_free, n - n_free)
    o_beg, o_end = beg[other], beg[other] + ln[other] - 1
    t_len = ln[n_free:]
    t_beg = np.maximum(1, o_beg - t_len + 1 + (rng.random(n - n_free) * (
        o_end - o_beg + t_len)).astype(np.int64))
    rid = np.concatenate([rid, rid[other]])
    beg = np.concatenate([beg, t_beg])
    end = beg + ln - 1
    order = rng.permutation(n)
    return rid[order], beg[order], end[order]


def _query_oracle(srt_truth, rid, beg, end):
    """Reads overlapping each region from the generator's columns: every
    read is 151M, so read i covers [pos + 1, pos + 151]; the sorted
    copy keeps pos sorted within a contig."""
    import numpy as np
    out = np.zeros(rid.size, np.int64)
    for c in np.unique(rid):
        pos1 = srt_truth.pos[srt_truth.refid == c] + 1
        m = rid == c
        out[m] = np.searchsorted(pos1, end[m], "right") - \
            np.searchsorted(pos1, beg[m] - 150, "left")
    return out


def _host_lines(srt, header, regions):
    """The SAM lines of each region's reads in file order, by a full
    native decode of the file (``map_file_spans``) and a host overlap
    test: no index and no query engine."""
    import numpy as np
    from hadoop_bam_torch.formats.bam import BamBatch
    from hadoop_bam_torch.parallel import pipeline as tp

    def lines(data, offs, voffs):
        b = BamBatch(data, offs, header=header)
        pos1 = b.pos + 1
        end1 = pos1 + np.maximum(b.reference_span(), 1) - 1
        return [[b.to_sam_line(int(i)) for i in np.flatnonzero(
            (b.refid == r) & (pos1 <= e) & (end1 >= s))]
            for r, s, e in regions]
    parts = tp.map_file_spans(srt, lines)
    return [sum((p[k] for p in parts), []) for k in range(len(regions))]


def phase_coverage_query(torch, path, truth, card, dev, args, srt,
                         srt_truth, native_walls):
    """Phase 13: coverage (K12) at 15x over mixed CIGARs, batched BAM
    region queries (K13) on phase 11's sorted copy, and the span window's
    hang defence, through the entry points on cuda:0."""
    log("== phase 13: coverage, batched region queries and the hang "
        "defence on cuda:0")
    import numpy as np
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.api import open_bam, query_regions
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.query import engine as qe
    from hadoop_bam_torch.resilience import chaos
    from hadoop_bam_torch.split.bai import write_bai
    from hadoop_bam_torch.utils import native
    from hadoop_bam_torch.utils.errors import PlanError, TransientIOError
    from hadoop_bam_torch.utils.metrics import METRICS
    work = os.path.join(os.path.dirname(path), "phase13")
    os.makedirs(work, exist_ok=True)
    cov = os.path.join(work, "coverage.bam")
    bai = cov + ".bai"
    try:
        # (a) coverage over a 15x pile of mixed CIGARs
        ctruth, w_synth = _timed(lambda: synth.write_coverage_bam(
            cov, args.reads // 2, args.seed, span=COV_SPAN))
        _, w_bai = _timed(lambda: write_bai(cov))
        log(f"(a) coverage BAM: {ctruth.n_reads} reads over "
            f"chr20:1-{COV_SPAN:,} ({ctruth.n_reads * 151 / COV_SPAN:.1f}x), "
            f"{os.path.getsize(cov)} bytes in {w_synth:.1f} s, its .bai in "
            f"{w_bai:.2f} s; ops {ctruth.op_kinds()}, {ctruth.star_cigars} "
            f"'*' CIGARs, {ctruth.unmapped} unmapped, "
            f"{ctruth.reads_over(8)} reads past 8 ops, "
            f"{ctruth.reads_over(32)} past 32 (at most {ctruth.max_ops}), "
            f"{ctruth.on_ref(1)} on chr21")
        check(set("MIDNSH=X") <= set(ctruth.op_kinds())
              and ctruth.reads_over(32) > 0 and ctruth.star_cigars > 0,
              "the CIGAR mix holds every op kind, '*' and > 32 ops")
        tp.coverage_step.launches = 0
        runs = (("chr20:1-10,000,000 through the .bai", "chr20:1-10000000",
                 COV_SPAN),
                ("all of chr20 through the .bai", "chr20", CHR20_LEN),
                ("chr20:1-10,000,000 with the .bai moved aside (whole-file "
                 "plan)", "chr20:1-10000000", COV_SPAN))
        walls = {}
        for k, (label, region, window) in enumerate(runs):
            if k == 2:
                os.rename(bai, bai + ".off")
            try:
                cold()
                METRICS.reset()
                depth, wall = _timed(lambda: tp.coverage_file(cov, region))
            finally:
                if k == 2:
                    os.rename(bai + ".off", bai)
            want = synth.coverage_oracle(ctruth, 0, 0, window)
            check(depth.dtype == np.int32 and depth.shape == (window,)
                  and np.array_equal(depth, want),
                  f"coverage {label} equals the generator's pileup")
            reads = METRICS.get("pipeline.records")
            walls[k] = wall
            log(f"(a) {label}: equals the oracle; {wall:.3f} s wall, "
                f"{reads:,} reads decoded ({reads / wall:,.0f} reads/s), "
                f"{int(depth.sum()):,} aligned bases ({depth.sum() / wall:,.0f}"
                f" bases/s; {window / wall:,.0f} window bases/s), "
                f"{METRICS.get('pipeline.spans')} spans, dispatch "
                f"{METRICS.get('pipeline.dispatch_bytes'):,} B, mean depth "
                f"{depth[:COV_SPAN].mean():.2f}, max {int(depth.max())} "
                f"[{card}]")
            del depth, want
        k12_launches = tp.coverage_step.launches
        log(f"K12 (coverage_step) calls on the main path: {k12_launches}")
        check(k12_launches > 0, "K12 ran on the main path")
        try:
            tp.coverage_file(cov, "chr20:1-10000000", max_cigar=16)
            check(False, "max_cigar=16 raises PlanError")
        except PlanError as e:
            log(f"(a) max_cigar=16 raises PlanError: {e}")
        log_busy(torch, "coverage chr20:1-10,000,000",
                 lambda: tp.coverage_file(cov, "chr20:1-10000000"), card)
        k12 = k12_times(torch, cov, dev, card)
        os.remove(cov)
        os.remove(bai)

        # (b) batched region queries on phase 11's sorted copy
        header, _ = read_bam_header(srt)
        rng = np.random.default_rng(args.seed + 13)
        rid, beg, end = (a[:QUERY_REGIONS] for a in _query_batch(
            rng, header.ref_names, header.ref_lengths, QUERY_DRAWN))
        regions = [f"{header.ref_names[r]}:{s}-{e}"
                   for r, s, e in zip(rid, beg, end)]
        want = _query_oracle(srt_truth, rid, beg, end)
        reqs = [qe.QueryRequest(srt, r) for r in regions]
        eng = qe.QueryEngine()
        qe.overlap_step.launches = 0
        METRICS.reset()

        def kept_counts():
            acc = torch.zeros(len(reqs), dtype=torch.int64, device=dev)
            for out in query_regions(reqs, engine=eng):
                acc += torch.bincount(out["req"][out["keep"]],
                                      minlength=len(reqs))
            return acc.cpu().numpy()
        got, cold_wall = _timed(kept_counts)
        decoded_cold = METRICS.get("query.chunks_decoded")
        check(np.array_equal(got, want), "query_regions' kept counts equal "
              "the generator's")
        engine_counts = got
        got, warm_wall = _timed(kept_counts)
        check(np.array_equal(got, want), "warm kept counts")
        stats = eng.stats()
        k13_launches = qe.overlap_step.launches
        check(k13_launches > 0, "K13 ran on the main path")
        lat = []
        for r in reqs[:200]:
            t0 = time.perf_counter()
            for out in query_regions([r], engine=eng):
                out["keep"].sum().item()
            lat.append(time.perf_counter() - t0)
        overlapping = int(sum(
            np.any((rid == rid[i]) & (beg <= end[i]) & (end >= beg[i])
                   & (np.arange(rid.size) != i)) for i in range(rid.size)))
        log(f"(b) {len(reqs)} regions of 1-10 kb ({overlapping} overlap "
            f"another of the batch), {int(want.sum()):,} reads kept, equal "
            f"to the generator's per request; cold {cold_wall:.3f} s "
            f"({len(reqs) / cold_wall:,.0f} regions/s), warm "
            f"{warm_wall:.3f} s ({len(reqs) / warm_wall:,.0f} regions/s); "
            f"chunks decoded {decoded_cold} cold, "
            f"{METRICS.get('query.chunks_decoded') - decoded_cold} warm; "
            f"cache hits {stats['hits']}, misses {stats['misses']}; one "
            f"request a batch, warm: p50 {1e3 * np.percentile(lat, 50):.2f}"
            f" ms, p99 {1e3 * np.percentile(lat, 99):.2f} ms; K13 calls "
            f"{k13_launches} [{card}]")
        sub = list(range(50))
        res, rec_wall = _timed(lambda: eng.query_records(
            [reqs[i] for i in sub]))
        host = _host_lines(srt, header, [(rid[i], beg[i], end[i])
                                         for i in sub])
        for i, r, h in zip(sub, res, host):
            check([x.to_line() for x in r.records] == h,
                  f"query_records {regions[i]} equals the host oracle")
            check(len(h) == want[i], f"{regions[i]}: {len(h)} lines")
        log(f"(b) query_records on 50 requests: {sum(map(len, host)):,} "
            f"records equal the host oracle line for line, "
            f"{rec_wall:.3f} s [{card}]")
        # K13 at the dispatch shape, on the batch's own candidate rows
        from hadoop_bam_torch.query.scheduler import Deadline
        tuples, _, _, _ = eng._prepare(reqs, Deadline(None))
        cap = eng.config.query_tile_records
        cols = [np.concatenate([t[j] for t in tuples])[:cap]
                for j in range(len(qe.TILE_COLUMNS))]
        host_cols = [torch.from_numpy(c) for c in cols]
        copies = [[c.to(dev) for c in host_cols] for _ in range(64)]
        n = torch.tensor([cap], dtype=torch.int32)
        nd = n.to(dev)
        check(torch.equal(qe.overlap_step(*copies[0], nd).cpu(),
                          qe.overlap_step(*host_cols, n)),
              "K13 on the card equals the CPU")
        ms = device_ms(torch, [lambda c=c: qe.overlap_step(*c, nd)
                               for c in copies])
        nbytes = cap * (4 * len(qe.TILE_COLUMNS) + 1) + 4
        k13 = {"rows": cap, "ms": ms, "bytes": nbytes,
               "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S}
        log(f"K13 overlap_step at {cap} rows: {ms:.4f} ms by {device_ms.how}, "
            f"bound {k13['bound_ms']:.5f} ms ({nbytes} B / 3.35 TB/s, "
            f"{100 * k13['bound_ms'] / ms:.1f}%); card equals CPU [{card}]")
        del copies, eng

        # (c) the span window's hang defence: every pool task wedged past
        # pool_task_timeout_s, then one
        timeout, delay = 0.25, 2.0
        for skip in (False, True):
            cfg = HBamConfig(inflate_backend="native", span_retries=1,
                             pool_task_timeout_s=timeout,
                             speculative_decode=False, skip_bad_spans=skip)
            METRICS.reset()
            cold()
            t0 = time.perf_counter()
            with chaos.fault_points_on("pool.task", [chaos.PointFault(
                    kind="delay", count=10 ** 9, delay_s=delay)]):
                try:
                    open_bam(path, config=cfg).flagstat()
                    check(False, "a wedged pool raises TransientIOError")
                except TransientIOError as e:
                    wall = time.perf_counter() - t0
                    msg = str(e)
            check(wall < delay + 4 * timeout + 1.0,
                  f"raised within {wall:.2f} s")
            check(METRICS.get("pipeline.bad_spans") == 0,
                  "nothing quarantined: the window raises outside the "
                  "span policy, as in the reference")
            check(_jobs_reaped(native, t0, delay) == 0,
                  "no native job left running")
            log(f"(c) every pool task wedged {delay} s, timeout {timeout} s"
                f"{', skip_bad_spans' if skip else ''}: TransientIOError in "
                f"{wall:.3f} s ({msg}); timeouts "
                f"{METRICS.get('pool.task_timeouts')}, resubmits "
                f"{METRICS.get('jobs.timeout_resubmits')}, quarantined 0; "
                f"native jobs 0 {time.perf_counter() - t0:.2f} s after the "
                f"call began [{card}]")
        cfg = HBamConfig(inflate_backend="native", span_retries=1,
                         pool_task_timeout_s=timeout,
                         speculative_decode=False)
        want_flag = truth.flagstat if truth is not None else \
            open_bam(path, config=HBamConfig(inflate_backend="native")
                     ).flagstat()
        with chaos.fault_points_on("pool.task", [chaos.PointFault(
                kind="delay", count=10 ** 9, delay_s=delay)]):
            try:
                tp.coverage_file(srt, "chr20:1-1000000", config=cfg)
                check(False, "coverage on a wedged pool raises")
            except TransientIOError:
                pass
        METRICS.reset()
        cold()
        t0 = time.perf_counter()
        with chaos.fault_points_on("pool.task", [chaos.PointFault(
                kind="delay", at_call=1, delay_s=delay)]):
            flag, wall = _timed(open_bam(path, config=cfg).flagstat)
        check(flag == want_flag, "one wedged task: the truth")
        check(METRICS.get("pool.task_timeouts") == 1 ==
              METRICS.get("jobs.timeout_resubmits"), "one resubmit")
        # the call may return before or after the wedged copy wakes
        check(_jobs_reaped(native, t0, delay) == 0,
              "no native job left running")
        log(f"(c) coverage_file on a wedged pool raises TransientIOError; "
            f"one wedged task: resubmitted once, flagstat equals the "
            f"truth in {wall:.3f} s (phase 5 "
            f"{native_walls.get('flagstat', float('nan')):.3f} s) [{card}]")
    finally:
        for p in [cov, bai, bai + ".off"]:
            if os.path.exists(p):
                os.remove(p)
        if os.path.isdir(work) and not os.listdir(work):
            os.rmdir(work)
        cold()
    # phase 14 serves the first SERVE_REQUESTS of the same regions from
    # the same sorted copy, and removes it
    return ({"K12": dict(k12, launches=k12_launches),
             "K13": dict(k13, launches=k13_launches)},
            (regions, rid, beg, end, engine_counts))


def coverage_query_times(torch, path, dev) -> dict:
    """``--times coverage_query``: phase 13 alone, on a sorted copy of
    the BAM's reads written beside it (its truth columns kept); the
    one-wedged-task check compares with a clean flagstat of the BAM."""
    import types
    from hadoop_bam_torch.split.bai import write_bai
    from hadoop_bam_torch.synth import write_synthetic_bam
    base = os.path.basename(path)[:-len(".bam")].split("_")
    args = types.SimpleNamespace(seed=int(base[1]), reads=int(base[2]))
    srt = path[:-len(".bam")] + "_sorted13.bam"
    srt_truth = write_synthetic_bam(srt, args.reads, args.seed,
                                    coordinate_sorted=True,
                                    keep_columns=True)
    write_bai(srt)
    try:
        return phase_coverage_query(torch, path, None, card_line(), dev,
                                    args, srt, srt_truth, {})[0]
    finally:
        _remove_sorted(srt)


SERVE_REQUESTS = 200


def _remove_sorted(srt) -> None:
    """Remove phase 11's sorted copy, its sidecars and its directory."""
    for p in [srt] + _sidecars(srt):
        if os.path.exists(p):
            os.remove(p)
    work = os.path.dirname(srt)
    if os.path.basename(work) == "phase11" and os.path.isdir(work) \
            and not os.listdir(work):
        os.rmdir(work)


def _k10i_inputs(torch, tokens, start):
    """K10i's inputs on one chunk as the serve step makes them: the
    resolved buffer, the walk's offsets and n_all."""
    from hadoop_bam_torch.ops import inflate_device as tid
    buf, offs, n_all, _, _ = tid._resolve_offsets(*tokens, start, 1 << 30,
                                                  None)
    return [buf, offs, n_all]


def _k10i_bytes(torch, args) -> int:
    """The bytes K10i must move: three int32 [R] outputs written once;
    for each of the min(n_all, R) valid rows its 4-byte offset, its 20
    prefix bytes (4-23) and its 4 * min(n_cigar, cap) CIGAR bytes read
    once; n_all and over, 4 bytes each."""
    from hadoop_bam_torch.ops.inflate_device import DEVICE_TILE_CIGAR_CAP
    from hadoop_bam_torch.ops.unpack_bam import unpack_fixed_fields_plain
    buf, offs, n_all = args
    R = offs.shape[0]
    nv = max(0, min(int(n_all), R))
    # K1's plain gather, which every tree has (``--times interval_chain
    # --tree``): a walked record lies in buf, where its rule is the clip
    nc = unpack_fixed_fields_plain(buf, offs[:nv])["n_cigar"]
    nc = torch.clamp(nc.to(torch.int64), 0, DEVICE_TILE_CIGAR_CAP)
    return 12 * R + (4 + 20) * nv + 4 * int(nc.sum()) + 8


def _k10i_hold(torch, args, label, seed) -> None:
    """K10i against its plain version, bit for bit, each case twice in a
    row, on one chunk's inputs ``args`` (``_k10i_inputs``): the chunk as
    it is and in a view of buf 3 bytes off 16; random l_read_name and
    n_cigar written into the records' prefixes (the buffer's bytes read
    as CIGAR words, op lengths that wrap int32) with offsets cut by the
    buffer's start and end, past both and wrapping int32; a 65-op row
    (over = 1); pos at the int32 edges; and n_all -1, 0 and past R."""
    import numpy as np
    from hadoop_bam_torch.ops import inflate_device as tid
    buf, offs, n_all = args
    dev = offs.device
    R, L = offs.shape[0], buf.shape[0]
    nv = int(n_all)
    rng = np.random.default_rng(seed)

    def col(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    def put(b, rows, at, values):
        """``values`` (bytes, one row of them a record) at prefix byte
        ``at`` of the records ``rows``."""
        b = b.clone()
        vals = col(values, np.uint8).reshape(len(rows), -1)
        idx = offs[torch.as_tensor(rows, device=dev)].to(
            torch.int64)[:, None] + at + torch.arange(
            vals.shape[1], device=dev)
        b[idx] = vals
        return b
    shifted = torch.zeros(L + 3, dtype=torch.uint8, device=dev)
    shifted[3:] = buf
    rows = np.arange(nv)
    rand_buf = put(buf, rows, 12, rng.integers(0, 256, (nv, 1)))
    nc = rng.integers(0, tid.DEVICE_TILE_CIGAR_CAP + 1, nv)
    rand_buf = put(rand_buf, rows, 16, np.stack([nc & 255, nc >> 8], 1))
    offs_edge = offs.clone()
    offs_edge[:12] = col([L - 40, L - 37, L - 23, L - 1, L + 40, 0, L - 300,
                          -1, -13, -40, 2 ** 31 - 20, 2 ** 31 - 40])
    pos = np.array([2 ** 31 - 2, 2 ** 31 - 1, -1, -2 ** 31], "<i4")
    cases = [("chunk", args),
             ("buf 3 bytes off 16", [shifted[3:], offs, n_all]),
             ("random l_read_name and n_cigar, offsets cut by both ends",
              [rand_buf, offs_edge, n_all]),
             ("a 65-op row", [put(buf, [nv // 2], 16, [[65, 0]]), offs,
                              n_all]),
             ("pos at the int32 edges",
              [put(buf, np.arange(4), 8, pos.view(np.uint8).reshape(4, 4)),
               offs, n_all])]
    for v in (-1, 0, R + 7):
        cases.append((f"n_all {v}", [buf, offs, torch.tensor(
            [v], dtype=torch.int32, device=dev)]))
    for name, a in cases:
        want = tid.interval_cols_plain(*a)
        for _ in range(2):
            got = tid.interval_cols(*a)
            sync(torch, dev)
            for g, w, what in zip(got, want,
                                  ("rid", "pos1", "end1", "over")):
                check(torch.equal(g.reshape(-1), w.reshape(-1)),
                      f"K10i {what}, {label}, {name}")
        if name == "a 65-op row":
            check(int(got[3]) == 1, f"a 65-op row raises over ({label})")
        elif name == "chunk":
            check(int(got[3]) == 0 and nv > 0,
                  f"the chunk's CIGARs fit ({label})")
    log(f"K10i at the {label} (R = {R}, {L} buffer bytes, {nv} records): "
        f"rid, pos1, end1 and over bit-equal to plain in {len(cases)} "
        f"cases, twice each")


def _k10i_times(torch, args) -> dict:
    """K10i's device ms (profiler and events) and its plain version's
    over 8 copies of one chunk's inputs, with the bound."""
    from hadoop_bam_torch.ops import inflate_device as tid
    copies = [[t.clone() if torch.is_tensor(t) else t for t in args]
              for _ in range(8)]
    calls = [lambda c=c: tid.interval_cols(*c) for c in copies]
    nbytes = _k10i_bytes(torch, args)
    return {"R": args[1].shape[0], "records": int(args[2]),
            "nbytes": nbytes,
            "ms": device_ms(torch, calls, kernel="interval_cols"),
            "loop_ms": loop_ms(torch, calls),
            "plain_ms": device_ms(torch, [
                lambda c=c: tid.interval_cols_plain(*c) for c in copies],
                reps=4),
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}


def k10i_check(torch, path, dev) -> dict:
    """K10i against its plain version (``_k10i_hold``) on the 64- and
    17-block chunks of ``path`` (mixed CIGARs), then the whole serve step
    (``resolve_walk_intervals``) against ``resolve_walk_intervals_plain``.
    Returns per chunk shape the device ms, plain ms, loop ms and bound."""
    from hadoop_bam_torch.ops import inflate_device as tid
    out = {}
    for n in (64, 17):
        tokens, start = chunk_tokens(torch, path, dev, n)
        args = _k10i_inputs(torch, tokens, start)
        _k10i_hold(torch, args, f"{n}-block chunk", n)
        step = tid.resolve_walk_intervals(*tokens, start, 1 << 30)
        plain = tid.resolve_walk_intervals_plain(*tokens, start, 1 << 30)
        sync(torch, dev)
        for g, w, what in zip(step, plain, ("rid", "pos1", "end1", "n_all",
                                            "tail", "bad", "over")):
            check(torch.equal(g.reshape(-1), w.reshape(-1)),
                  f"resolve_walk_intervals {what} at {n} blocks")
        out[f"{n}-block"] = _k10i_times(torch, args)
    return out


class _CheckedK10i:
    """Stands in for ``interval_cols`` during a checked serve pass: each
    call launches the kernel, holds its outputs bit for bit against
    ``interval_cols_plain`` on the same inputs, and tallies the launch's
    records by its row count R (``seen``), keeping per R the inputs of
    the launch with the most records (``most``)."""

    def __init__(self, torch, tid):
        self.torch, self.tid = torch, tid
        self.kernel = tid.interval_cols
        self.seen, self.most = {}, {}

    def __enter__(self):
        self.tid.interval_cols = self
        return self

    def __exit__(self, *exc):
        self.tid.interval_cols = self.kernel

    # the kernel's wrapper counts its launch on the module's name, which
    # is this stand-in while it is in place: keep the count on the kernel
    @property
    def launches(self):
        return self.kernel.launches

    @launches.setter
    def launches(self, n):
        self.kernel.launches = n

    def __call__(self, *a):
        torch = self.torch
        out = self.kernel(*a)
        want = self.tid.interval_cols_plain(*a)
        R = int(a[1].shape[0])
        for g, w, what in zip(out, want, ("rid", "pos1", "end1", "over")):
            check(torch.equal(g.reshape(-1), w.reshape(-1)),
                  f"K10i {what} in the checked serve pass (R = {R})")
        n = int(a[2])
        self.seen.setdefault(R, []).append(n)
        if n > int(self.most.get(R, [0] * 3)[2]):
            # (buf, offs, n_all): the serve passes the default cap
            self.most[R] = [t.clone() for t in a[:3]]
        return out


def _tile_filter_times(torch, srt_truth, dev) -> dict:
    """``tile_filter_step`` alone on one [1, 4,096] tile group of the
    sorted copy (its first 4,096 reads, every one 151M) against one
    5 kb interval over them, over 8 copies: device ms by the profiler,
    calls in a row by events, one CUDA graph of 32 calls replayed (the
    six kernels without the host's launches), and the bound."""
    import numpy as np
    from hadoop_bam_torch.serve import tiles as st
    cap = 4096
    rid = np.asarray(srt_truth.refid[:cap], np.int32)
    pos1 = np.asarray(srt_truth.pos[:cap], np.int32) + 1
    cols = [torch.from_numpy(np.ascontiguousarray(c)).reshape(1, cap).to(dev)
            for c in (rid, pos1, pos1 + 150)]
    count = torch.tensor([cap], dtype=torch.int32, device=dev)
    iv = torch.tensor([int(rid[cap // 2]), int(pos1[cap // 2]),
                       int(pos1[cap // 2]) + 5000], dtype=torch.int32,
                      device=dev)
    copies = [[c.clone() for c in cols] + [count.clone(), iv.clone()]
              for _ in range(8)]
    calls = [lambda c=c: st.tile_filter_step(*c) for c in copies]
    keep, hits = st.tile_filter_step(*copies[0])
    check(int(hits.sum()) == int(keep.sum()) > 0,
          "the tile filter keeps reads of the interval")
    # three int32 columns, the count and the interval read once; the
    # bool mask and the int32 hit count written once
    nbytes = 3 * 4 * cap + 4 + 12 + cap + 4
    return {"shape": f"[1, {cap}] int32", "nbytes": nbytes,
            "ms": device_ms(torch, calls), "loop_ms": loop_ms(torch, calls),
            "graph_ms": graph_ms(torch, calls),
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}


def _serve_pass(loop, srt, regions):
    """One request a region, in turn, each inside the pass's own
    MetricsContext: (counts, n_candidates, tile hits, tile misses, wall,
    per-request latencies, the context's metrics)."""
    import numpy as np
    from hadoop_bam_torch.utils.metrics import MetricsContext
    counts, cands, hits, misses, lat = [], [], 0, 0, []
    with MetricsContext() as m:
        t0 = time.perf_counter()
        for r in regions:
            t1 = time.perf_counter()
            res = loop.query(srt, [r])[0]
            lat.append(time.perf_counter() - t1)
            counts.append(res.count)
            cands.append(res.n_candidates)
            hits += res.tile_hits
            misses += res.tile_misses
        wall = time.perf_counter() - t0
    return (np.asarray(counts), cands, hits, misses, wall,
            np.asarray(lat), m)


def _log_pass(what, p, card) -> None:
    import numpy as np
    counts, cands, hits, misses, wall, lat, m = p
    s = m.hist_summary("serve.latency_s")
    log(f"(b) {what}: {len(counts)} requests in {wall:.3f} s "
        f"({len(counts) / wall:,.1f} requests/s), {int(counts.sum()):,} "
        f"reads kept of {sum(cands):,} candidates; tile hits {hits}, "
        f"misses {misses}; latency by the client p50 "
        f"{1e3 * np.percentile(lat, 50):.3f} ms, p99 "
        f"{1e3 * np.percentile(lat, 99):.3f} ms; serve.latency_s p50 "
        f"{1e3 * s['p50']:.3f} ms, p99 {1e3 * s['p99']:.3f} ms; chunks "
        f"decoded {m.counters.get('query.chunks_decoded', 0)}, host decode "
        f"{m.timers.get('pipeline.host_decode', 0.0):.3f} s, inflate "
        f"{m.timers.get('pipeline.inflate', 0.0):.3f} s, device tile "
        f"builds {m.counters.get('serve.device_tile_builds', 0)} [{card}]")


def _tcp_lines(host, port, docs, out, key):
    """Send ``docs`` as JSONL on one connection, then read every answer;
    appends (arrival perf_counter, doc) to ``out[key]``."""
    import socket
    with socket.create_connection((host, port), timeout=120) as s:
        s.sendall("".join(json.dumps(d) + "\n" for d in docs).encode())
        s.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                out[key].append((time.perf_counter(), json.loads(line)))


def phase_serve(torch, path, card, dev, seed, srt, srt_truth, served):
    """Phase 14: the resident region server on cuda:0 (K10i, the serve
    tiles, tenancy and the TCP transport) on phase 11's sorted copy,
    for the first SERVE_REQUESTS regions of phase 13 (b).  Returns the
    K10i row, every wrapper's launches in the serve runs, and the tile
    filter's time alone."""
    log("== phase 14: the resident region server on cuda:0")
    import threading
    import numpy as np
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.serve import ServeLoop, make_tcp_server
    from hadoop_bam_torch.serve import tiles as st
    regions, rid, beg, end, engine_counts = served
    regions = list(regions[:SERVE_REQUESTS])
    engine_counts = np.asarray(engine_counts[:SERVE_REQUESTS])
    want = _query_oracle(srt_truth, rid[:SERVE_REQUESTS],
                         beg[:SERVE_REQUESTS], end[:SERVE_REQUESTS])
    check(np.array_equal(engine_counts, want),
          "phase 13's engine counts equal the generator's")
    work = os.path.join(os.path.dirname(path), "phase14")
    os.makedirs(work, exist_ok=True)
    cov = os.path.join(work, "cigars.bam")
    try:
        # (a) K10i against its plain version at both chunk shapes, on a
        # BAM of mixed CIGARs
        ctruth, w = _timed(lambda: synth.write_coverage_bam(
            cov, 200_000, seed, span=COV_SPAN))
        log(f"(a) {ctruth.n_reads} reads of mixed CIGARs ({w:.1f} s): ops "
            f"{ctruth.op_kinds()}, {ctruth.star_cigars} '*', at most "
            f"{ctruth.max_ops} ops")
        times = k10i_check(torch, cov, dev)
        for line in kernels_report("interval_cols"):
            log(f"  ptxas: {line}")
        for shape, x in times.items():
            log(f"K10i at the {shape} chunk (R = {x['R']}, {x['records']} "
                f"records): device {x['ms']:.4f} ms (plain "
                f"{x['plain_ms']:.4f} ms, {x['loop_ms']:.4f} ms a call in a "
                f"row by events), bound {x['bound_ms']:.6f} ms = "
                f"{x['nbytes']} B / 3.35 TB/s, "
                f"{100 * x['bound_ms'] / x['ms']:.1f}% of it [{card}]")
        log("no single PyTorch call computes this function (library_ms "
            "null)")
        os.remove(cov)

        # (b) the server at the default width on the native plane, cold
        # then warm, then cold on the device plane on a fresh loop
        reset_launches()
        tid.interval_cols.launches = 0
        st.tile_filter_step.launches = 0
        native_cfg = HBamConfig(inflate_backend="native",
                                serve_prefetch=False)
        loop = ServeLoop(config=native_cfg).start()
        try:
            cold_p = _serve_pass(loop, srt, regions)
            warm_p = _serve_pass(loop, srt, regions)
            for what, p in (("native plane, cold", cold_p),
                            ("native plane, warm", warm_p)):
                check(np.array_equal(p[0], engine_counts),
                      f"{what}: counts equal the engine's and the "
                      f"generator's")
                _log_pass(what, p, card)
            cm, wm = cold_p[6], warm_p[6]
            check(cm.counters.get("query.chunks_decoded", 0) > 0
                  and cm.timers.get("pipeline.host_decode", 0) > 0
                  and cm.timers.get("pipeline.inflate", 0) > 0,
                  "the cold pass decodes on the host")
            check(wm.counters.get("query.chunks_decoded", 0) == 0
                  and wm.timers.get("pipeline.host_decode", 0.0) == 0.0
                  and wm.timers.get("pipeline.inflate", 0.0) == 0.0
                  and warm_p[3] == 0,
                  "the warm pass decodes nothing on the host")
            log(f"(b) tiles resident: {loop.tiles.stats()}")
            wall, busy, by_name = device_busy(
                torch, lambda: _serve_pass(loop, srt, regions))
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            log(f"(b) warm pass profiled: {wall:.3f} s wall, device busy "
                f"{busy:.4f} s ({100 * busy / wall:.2f}%); top: "
                + "; ".join(f"{k[:60]} {v * 1e3:.2f} ms" for k, v in top)
                + f" [{card}]")

            # (c) two tenants over TCP on the warm loop: a batch flood,
            # then one interactive request that overtakes it
            server = make_tcp_server(loop, port=0)
            host, port = server.server_address[:2]
            t = threading.Thread(target=server.serve_forever, daemon=True)
            t.start()
            try:
                got = {"bulk": [], "web": []}
                bulk = [{"id": i, "path": srt, "region": r,
                         "tenant": "bulk", "priority": "batch"}
                        for i, r in enumerate(regions)]
                tb = threading.Thread(target=_tcp_lines, args=(
                    host, port, bulk, got, "bulk"))
                t0 = time.perf_counter()
                tb.start()
                while not got["bulk"] and tb.is_alive():
                    time.sleep(0.001)
                t_web = time.perf_counter()
                _tcp_lines(host, port, [{
                    "id": "web", "path": srt, "region": regions[0],
                    "tenant": "web", "priority": "interactive"}], got,
                    "web")
                tb.join(120)
                wall = time.perf_counter() - t0
            finally:
                server.shutdown()
                server.server_close()
                t.join(10)
            docs = {d["id"]: d for _, d in got["bulk"]}
            check(len(docs) == len(regions) and all(
                "results" in d for d in docs.values()),
                "every batch request answered over TCP")
            tcp_counts = np.asarray([docs[i]["results"][0]["count"]
                                     for i in range(len(regions))])
            check(np.array_equal(tcp_counts, engine_counts),
                  "TCP counts equal (b)'s")
            (t_ans, web), = got["web"]
            check(web["results"][0]["count"] == engine_counts[0],
                  "the interactive count")
            after = sum(1 for ta, _ in got["bulk"] if ta > t_ans)
            check(after > 0, "the interactive request overtook queued "
                  "batch requests")
            log(f"(c) TCP, two tenants: {len(regions)} batch requests and "
                f"one interactive request sent after the first batch answer"
                f" ({1e3 * (t_web - t0):.1f} ms in), answered in "
                f"{1e3 * (t_ans - t_web):.2f} ms with {after} batch answers "
                f"still to come; all counts equal (b)'s; {wall:.3f} s in "
                f"all [{card}]")
        finally:
            loop.stop()
        # the device plane, cold, on a fresh loop
        dev_cfg = HBamConfig(inflate_backend="device", serve_prefetch=False)
        before = dict(read_launches(),
                      interval_cols=tid.interval_cols.launches)
        loop = ServeLoop(config=dev_cfg).start()
        try:
            dev_p = _serve_pass(loop, srt, regions)
            check(np.array_equal(dev_p[0], engine_counts),
                  "device plane: counts equal the engine's")
            builds = dev_p[6].counters.get("serve.device_tile_builds", 0)
            check(builds > 0, "serve.device_tile_builds > 0")
            _log_pass("device plane, cold", dev_p, card)
        finally:
            loop.stop()
        # K10i reads each record's prefix itself: the chain is K7+K8, K9,
        # K10i, and no K1
        chain = {k: v - before[k] for k, v in dict(
            read_launches(), interval_cols=tid.interval_cols.launches).items()}
        log(f"(b) the device-plane pass's launches: {chain} for {builds} "
            f"device tile builds")
        check(chain["unpack_fixed_fields"] == 0,
              "the device-plane serve launched no K1")
        check(chain["interval_cols"] == chain["resolve_pack"]
              == chain["walk_records_device"] >= builds,
              "each device tile build ran K7+K8, K9 and K10i once")
        launches = dict(read_launches(),
                        interval_cols=tid.interval_cols.launches,
                        tile_filter_step=st.tile_filter_step.launches)
        log(f"launches in the serve runs: {launches}")
        check(launches["interval_cols"] > 0, "K10i ran on the main path")
        check(launches["tile_filter_step"] > 0,
              "the tile filter ran on the main path")

        # the device plane again on a fresh loop, every K10i launch held
        # against its plain version; then K10i checked and timed at the
        # serve's own chunk shape (the R it launched most often), and
        # the tile filter timed alone on one tile group
        loop = ServeLoop(config=dev_cfg).start()
        try:
            with _CheckedK10i(torch, tid) as k10i:
                chk_p = _serve_pass(loop, srt, regions)
        finally:
            loop.stop()
        check(np.array_equal(chk_p[0], engine_counts),
              "checked device plane: counts equal the engine's")
        by_R = {R: len(n) for R, n in sorted(k10i.seen.items())}
        R_serve = max(by_R, key=by_R.get)
        log(f"(b) checked device-plane pass: all {sum(by_R.values())} K10i "
            f"launches bit-equal to plain (the timed pass launched "
            f"{launches['interval_cols']}); launches by R {by_R}; records "
            f"a launch at R = {R_serve}: median "
            f"{statistics.median(k10i.seen[R_serve])}, most "
            f"{max(k10i.seen[R_serve])} (the chunk checked and timed)")
        serve_args = k10i.most[R_serve]
        _k10i_hold(torch, serve_args, "serve chunk", 14)
        times["serve"] = _k10i_times(torch, serve_args)
        del k10i
        x = times["serve"]
        log(f"K10i at the serve chunk (R = {x['R']}, {x['records']} "
            f"records): device {x['ms']:.4f} ms (plain {x['plain_ms']:.4f} "
            f"ms, {x['loop_ms']:.4f} ms a call in a row by events), bound "
            f"{x['bound_ms']:.6f} ms = {x['nbytes']} B / 3.35 TB/s, "
            f"{100 * x['bound_ms'] / x['ms']:.1f}% of it [{card}]")
        tf = _tile_filter_times(torch, srt_truth, dev)
        log(f"K13 rest (tile_filter_step) alone at {tf['shape']}: "
            f"{tf['graph_ms']:.5f} ms a call in one CUDA graph replayed, "
            f"{tf['ms']:.5f} ms by device_ms, {tf['loop_ms']:.5f} ms a call "
            f"in a row by events (the host's launches); bound "
            f"{tf['bound_ms']:.7f} ms = {tf['nbytes']} B / 3.35 TB/s, "
            f"{100 * tf['bound_ms'] / tf['graph_ms']:.2f}% of the graph's "
            f"time [{card}]")
    finally:
        if os.path.exists(cov):
            os.remove(cov)
        if os.path.isdir(work) and not os.listdir(work):
            os.rmdir(work)
        _remove_sorted(srt)
    big, main = times["64-block"], times["serve"]
    row = {"name": "interval_cols", "route": "cuda",
           "source": "hadoop_bam_torch/csrc/interval_cols.cu",
           "replaces": "hadoop_bam_tpu/ops/inflate_device.py:335",
           "max_abs_err": 0, "ms": big["ms"], "loop_ms": big["loop_ms"],
           "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
           "bound_by": "bytes", "library_ms": None,
           "main_path_shape": _shape_row(
               f"serve chunk: {main['R']} rows, {main['records']} records",
               0, main["ms"], main["plain_ms"], main["nbytes"])}
    return row, launches, tf


def serve_tiles_times(torch, path, dev) -> dict:
    """``--times serve_tiles``: phase 14 alone, on a sorted copy of the
    BAM's reads written beside it, with the engine's counts of its
    regions computed here."""
    import numpy as np
    from hadoop_bam_torch.api import query_regions
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.query import engine as qe
    from hadoop_bam_torch.split.bai import write_bai
    from hadoop_bam_torch.synth import write_synthetic_bam
    base = os.path.basename(path)[:-len(".bam")].split("_")
    srt = path[:-len(".bam")] + "_sorted14.bam"
    srt_truth = write_synthetic_bam(srt, int(base[2]), int(base[1]),
                                    coordinate_sorted=True,
                                    keep_columns=True)
    write_bai(srt)
    seed = int(base[1])
    header, _ = read_bam_header(srt)
    rid, beg, end = _query_batch(np.random.default_rng(seed + 13),
                                 header.ref_names, header.ref_lengths,
                                 QUERY_DRAWN)
    regions = [f"{header.ref_names[r]}:{s}-{e}"
               for r, s, e in zip(rid, beg, end)][:SERVE_REQUESTS]
    reqs = [qe.QueryRequest(srt, r) for r in regions]
    acc = torch.zeros(len(reqs), dtype=torch.int64, device=dev)
    for out in query_regions(reqs, engine=qe.QueryEngine()):
        acc += torch.bincount(out["req"][out["keep"]], minlength=len(reqs))
    row, launches, tf = phase_serve(torch, path, card_line(), dev, seed,
                                    srt, srt_truth, (regions, rid, beg, end,
                                                     acc.cpu().numpy()))
    return {"K10i": row, "launches": launches, "tile_filter_step": tf}


# (label, BGZF blocks) of the serve's interval chain: a serve chunk (a
# few blocks in B = 8 rows, R = 16,384, the R of every serve launch) and
# the device plane's 17- and 64-block chunks
CHAIN_SHAPES = (("serve chunk", 4), ("17-block", 17), ("64-block", 64))


def interval_chain_times(torch, path, dev) -> dict:
    """``--times interval_chain``: ``resolve_walk_intervals`` (the serve's
    device tile build) split by kernel at ``CHAIN_SHAPES`` on a BAM of
    mixed CIGARs written beside the BAM (or found there), each shape held
    bit for bit against ``resolve_walk_intervals_plain`` first.  Both
    have the same signature in every tree since K10i was written, so with
    ``--tree`` it times an earlier tree's chain (there K7+K8, K9, K1 and
    K10i with its memset) on the same card and inputs.  Per shape: every
    kernel's ms, K10i's, K1's and the memsets', and the bound of K10i's
    work as this tree's K10i does it (``_k10i_bytes``)."""
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.ops import inflate_device as tid
    seed = int(os.path.basename(path).split("_")[1])
    cov = path[:-len(".bam")] + "_cigars.bam"
    if not os.path.exists(cov):
        _, w = _timed(lambda: synth.write_coverage_bam(
            cov, 200_000, seed, span=COV_SPAN))
        log(f"wrote {cov} (200,000 reads of mixed CIGARs) in {w:.1f} s")
    out = {}
    for label, n in CHAIN_SHAPES:
        tokens, start = chunk_tokens(torch, cov, dev, n)
        got = tid.resolve_walk_intervals(*tokens, start, 1 << 30)
        want = tid.resolve_walk_intervals_plain(*tokens, start, 1 << 30)
        sync(torch, dev)
        for g, w, what in zip(got, want, ("rid", "pos1", "end1", "n_all",
                                          "tail", "bad", "over")):
            check(torch.equal(g.reshape(-1), w.reshape(-1)),
                  f"resolve_walk_intervals {what} at the {label}")
        B, P = tokens[0].shape
        buf, total = tid.resolve_pack(*tokens)
        offs, n_all, _, _ = tid.walk_records_device(
            buf, total, start, 1 << 30, tid.records_cap(B, P))
        nbytes = _k10i_bytes(torch, [buf, offs, n_all])
        copies = [[t.clone() for t in tokens] for _ in range(8)]
        split = kernel_split(torch, [
            lambda c=c: tid.resolve_walk_intervals(*c, start, 1 << 30)
            for c in copies], kernel="interval_cols")

        def part(key):
            return sum(ms for k, ms in split.items() if key in k)
        k10i, k1, memset = (part("interval_cols"),
                            part("unpack_fixed_fields"), part("emset"))
        out[label] = {"blocks": n, "R": int(offs.shape[0]),
                      "records": int(n_all), "by_kernel": split,
                      "k10i_ms": k10i, "k1_ms": k1, "memset_ms": memset,
                      "k1_k10i_ms": k1 + k10i + memset,
                      "chain_ms": sum(split.values()), "nbytes": nbytes,
                      "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}
        x = out[label]
        log(f"interval chain at the {label} (R = {x['R']}, {x['records']} "
            f"records): K10i {k10i:.4f} ms, K1 {k1:.4f} ms, memsets "
            f"{memset:.4f} ms, chain {x['chain_ms']:.4f} ms; K10i's bound "
            f"{x['bound_ms']:.6f} ms = {nbytes} B / 3.35 TB/s")
    return out


def _nvcc_lib(stem, src):
    """CUDA source ``src`` (a probe or a patched kernel of a ``--times``
    reading, no part of the port) built by nvcc into the build dir as
    ``<stem>.so`` with the port's flags, and loaded by ctypes."""
    import ctypes
    from hadoop_bam_torch.ops import kernels
    base = os.path.join(kernels.BUILD_DIR, stem)
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with open(base + ".cu", "w") as f:
        f.write(src)
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
                    base + ".so", base + ".cu"], check=True,
                   capture_output=True)
    return ctypes.CDLL(base + ".so")


def _k10i_memset_scheme(torch):
    """K10i as PR 12 set ``over`` (a memset before the launch, one
    atomicOr a CTA that saw an over-cap row), for ``--times
    interval_floor``: ``csrc/interval_cols.cu`` with its counter-word
    tail and launch patched, built by nvcc into the build dir, wrapped
    like ``interval_cols`` (no launch count)."""
    import ctypes
    from hadoop_bam_torch.ops import kernels
    with open(os.path.join(kernels.CSRC, "interval_cols.cu")) as f:
        src = f.read()
    tail = src[src.index("  // over: the last CTA to count itself in"):
               src.index("}  // namespace")]
    launch = "  interval_cols_kernel<<<"
    check(tail.count("atomicAdd(done") == 1 and src.count(launch) == 1,
          "K10i's source has the counter-word tail to patch")
    src = src.replace(tail, "  if (__syncthreads_or(my_over) && "
                      "threadIdx.x == 0) atomicOr(over, 1);\n}\n\n")
    src = src.replace(launch, "  {\n    const cudaError_t e = "
                      "cudaMemsetAsync(over, 0, 4, static_cast<cudaStream_t>"
                      "(stream));\n    if (e != cudaSuccess) return "
                      "static_cast<int>(e);\n  }\n" + launch)
    fn = _nvcc_lib("interval_cols_memset", src).hbam_interval_cols
    fn.argtypes = kernels.KERNELS["interval_cols"][1]
    fn.restype = ctypes.c_int

    def call(buf, offs, n_all, cap=64):
        dev, R = buf.device, offs.shape[0]
        rid, pos1, end1 = (torch.empty(R, dtype=torch.int32, device=dev)
                           for _ in range(3))
        over = torch.empty(1, dtype=torch.int32, device=dev)
        rc = fn(buf.data_ptr(), buf.shape[0], offs.data_ptr(),
                n_all.data_ptr(), R, cap, rid.data_ptr(), pos1.data_ptr(),
                end1.data_ptr(), over.data_ptr(), None,
                torch.cuda.current_stream(dev).cuda_stream)
        kernels.check_launch("interval_cols (memset scheme)", rc)
        return rid, pos1, end1, over[0]
    return call


def interval_floor_times(torch, path, dev) -> dict:
    """``--times interval_floor``: K10i alone at ``CHAIN_SHAPES`` on the
    mixed-CIGAR BAM of ``interval_chain`` (written beside the BAM if
    missing): walked and with n_all = 0 (the pads and the counter word,
    no walk), and in turns (counter, memset, memset, counter) against
    the memset scheme it replaced (``_k10i_memset_scheme``), each by the
    profiler (kernel and memset activity) and by one CUDA graph
    (``graph_ms``, ``device_ms``'s fallback), after both schemes are held
    bit for bit against plain; and ``graph_ms`` on the chain's K9 and
    K7+K8 calls at each shape."""
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.ops import inflate_device as tid
    seed = int(os.path.basename(path).split("_")[1])
    cov = path[:-len(".bam")] + "_cigars.bam"
    if not os.path.exists(cov):
        synth.write_coverage_bam(cov, 200_000, seed, span=COV_SPAN)
    memset = _k10i_memset_scheme(torch)
    out = {}
    for label, n in CHAIN_SHAPES:
        tokens, start = chunk_tokens(torch, cov, dev, n)
        args = _k10i_inputs(torch, tokens, start)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        want = tid.interval_cols_plain(*args)
        for name, f in (("counter", tid.interval_cols), ("memset", memset)):
            got = f(*args)
            sync(torch, dev)
            check(all(torch.equal(g.reshape(-1), w.reshape(-1))
                      for g, w in zip(got, want)),
                  f"K10i ({name}) equals plain at the {label}")
        row = {"R": int(args[1].shape[0]), "records": int(args[2])}
        for key, a, f in (("walked", args, tid.interval_cols),
                          ("n_all 0", args[:2] + [zero], tid.interval_cols),
                          ("memset", args, memset),
                          ("memset again", args, memset),
                          ("walked again", args, tid.interval_cols)):
            copies = [[t.clone() for t in a] for _ in range(8)]
            calls = [lambda c=c, f=f: f(*c) for c in copies]
            row[key] = {"ms": device_ms(torch, calls, kernel="interval_cols"),
                        "graph_ms": graph_ms(torch, calls)}
        buf, total = tid.resolve_pack(*tokens)
        R = row["R"]
        row["K9 graph_ms"] = graph_ms(torch, [
            lambda: tid.walk_records_device(buf, total, start, 1 << 30, R)])
        row["K7+K8 graph_ms"] = graph_ms(torch, [
            lambda: tid.resolve_pack(*tokens)])
        out[label] = row
        log(f"K10i at the {label}: {json.dumps(row)}")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the variant plane
# ---------------------------------------------------------------------------

# the 1000 Genomes phase 3 layout (synth.write_synthetic_vcf): full width,
# cut in depth to 50,000 records (100,000 until phase 17 came), the last
# 5,000 on X; the BGZF VCF holds the first 10,000
VARIANT_SAMPLES = 2504
VARIANT_RECORDS = 50_000
VARIANT_X = 5_000
VARIANT_VCF = 10_000


def _variant_wrappers():
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.parallel import variant_pipeline as tv
    return {"resolve_pack": tid.resolve_pack,
            "variant_unpack": tid.variant_unpack,
            "variant_prefix": tid.variant_prefix,
            "gt_dosage": tid.gt_dosage,
            "variant_tile_stats": tv.variant_tile_stats}


def _variant_launches() -> dict:
    return {k: w.launches for k, w in _variant_wrappers().items()}


def _unpack_bytes(chunk, samples_pad) -> int:
    """variant_unpack's bytes at a chunk: the packed array read once, each
    group row's GT bytes, the 8 prefix bytes of each record (the pad rows
    all read the same 8 at start 0), and the outputs written once: CHROM
    and POS 8 bytes a row, the flags, the [R, s_pad] tile."""
    R, n = chunk["R"], chunk["n"]
    gt = sum(len(rows) * w * c * ns
             for rows, _, w, c, ns in chunk["meta"]["gt_groups"])
    prefix = 8 * (n + (R > n))
    return (4 * chunk["packed"].size + gt + prefix
            + R * (8 + 1 + samples_pad))


def _k11_cases(torch, dev) -> int:
    """K11 bit-equal to its plain versions, twice in a row, buf at an
    aligned and at an odd address: ``variant_unpack`` in every case of
    ``synth.UNPACK_CASES`` (multi-group spans, widths 1, 2 and 4,
    saturation, rows of no group, pad rows and columns, the clip and wrap
    edges), over a poisoned allocator; ``gt_dosage`` (its one-group mode)
    in every case of ``synth.GT_CASES``; ``variant_prefix`` (its prefix
    mode) in ``synth.prefix_rows``.  Returns the number of cases."""
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.ops import inflate_device as tid
    n = 0

    def at(buf, shift):
        big = torch.zeros(buf.size + shift, dtype=torch.uint8, device=dev)
        big[shift:] = torch.from_numpy(buf).to(dev)
        return big[shift:]
    for i, (label, groups, m, s_pad) in enumerate(synth.UNPACK_CASES):
        buf, meta, R, s_pad = synth.unpack_span(groups, m, s_pad, seed=i)
        packed = tid.pack_variant_meta(meta, R)
        for shift in (0, 3):
            b = at(buf, shift)
            want = tid.variant_unpack_plain(b, packed, R, s_pad)
            for _ in range(2):
                synth.poison_allocator(dev)
                got = tid.variant_unpack(b, packed, R, s_pad)
                sync(torch, dev)
                for g, w, what in zip(got, want, ("chrom", "pos", "flags",
                                                  "dosage")):
                    check(torch.equal(g, w), f"variant_unpack {what}, "
                          f"{label}, shift {shift}")
        n += 1
    for i, (w, c, ns, G) in enumerate(synth.GT_CASES):
        buf, offs, rows, R = synth.gt_rows(w, c, ns, G, seed=i)
        for shift in (0, 3):
            b = at(buf, shift)
            o, r = (torch.from_numpy(a).to(dev) for a in (offs, rows))
            want = tid.gt_dosage_plain(b, o, r, w, c, ns, torch.full(
                (R, ns + 5), -1, dtype=torch.int8, device=dev))
            for _ in range(2):
                got = torch.full((R, ns + 5), -1, dtype=torch.int8,
                                 device=dev)
                tid.gt_dosage(b, o, r, w, c, ns, got)
                sync(torch, dev)
                check(torch.equal(got, want),
                      f"gt_dosage width {w} ploidy {c} n_sample {ns} "
                      f"shift {shift}")
            if c >= 128:
                check(bool((want == 127).any()), "a saturated call")
        n += 1
    for m in (1, 12, 1000, 70_000):
        buf, starts = synth.prefix_rows(m, seed=m)
        b, s = (torch.from_numpy(a).to(dev) for a in (buf, starts))
        want = tid.variant_prefix_plain(b, s)
        for _ in range(2):
            got = tid.variant_prefix(b, s)
            sync(torch, dev)
            for g, w, what in zip(got, want, ("chrom", "pos")):
                check(torch.equal(g, w), f"variant_prefix {what}, R = {m}")
        n += 1
    return n


def _variant_chunk(torch, bcf, dev, samples_pad) -> dict:
    """The main path's own K11 inputs: the first span of the device
    plane's 512 KiB plan over the BGZF BCF, tokenized, staged and
    resolved by K7+K8 as ``_variant_stats_device_plane`` does it, its
    records framed and walked on the host.  Returns buf, the cursor
    metadata (meta), n, R, the chunk's blocks (used, n_blocks) and the
    packed array on the host (packed)."""
    import numpy as np
    from hadoop_bam_torch.api.vcf_dataset import open_vcf
    from hadoop_bam_torch.formats.bcf_columns import decode_bcf_cursor_meta
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.parallel import variant_pipeline as tv
    ds = open_vcf(bcf, device=dev)
    size = os.path.getsize(bcf)
    spans = ds.spans(int(np.ceil(size / tp.DEVICE_PLANE_SPAN_BYTES)))
    span = spans[min(1, len(spans) - 1)]
    chunk = tp._tokenize_span_tokens(bcf, span, True)
    tokens, nt, iz = tp._TokenRing(pin_memory=dev.type == "cuda").stage(
        chunk, dev)
    buf, _ = tid.resolve_pack(tokens, nt, iz, chunk.P)
    hbuf = tv._HostBytes().fetch(buf, int(chunk.ubase[chunk.used])).copy()
    starts, _ = tv._frame_span_records(hbuf, chunk.start, chunk.stop)
    meta = decode_bcf_cursor_meta(hbuf, ds.header, samples_pad,
                                  starts=starts)
    n = int(meta["n"])
    R = tid.round_pow2(n, 8)
    return {"buf": buf, "meta": meta, "n": n, "R": R,
            "packed": tid.pack_variant_meta(meta, R), "used": chunk.used,
            "n_blocks": chunk.n_blocks}


def _k11_alone(torch, chunk, samples_pad, bufs) -> dict:
    """K11 alone at the chunk: ``variant_unpack`` bit-equal to its plain
    version, then the kernel's device ms and its calls in a row by
    events (the packed array copied to the card beforehand, as the
    wrapper copies it, and fresh outputs a call), its plain ms and its
    bound."""
    from hadoop_bam_torch.ops import inflate_device as tid
    buf, R, n, packed = chunk["buf"], chunk["R"], chunk["n"], chunk["packed"]
    dev = buf.device
    got = tid.variant_unpack(buf, packed, R, samples_pad)
    want = tid.variant_unpack_plain(buf, packed, R, samples_pad)
    for g, x, what in zip(got, want, ("chrom", "pos", "flags", "dosage")):
        check(torch.equal(g, x),
              f"variant_unpack {what} at the main path's chunk")
    meta = torch.from_numpy(packed).to(dev)

    def launch(b):
        tid.launch_unpack(
            b, meta, R, samples_pad,
            torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty(R, dtype=torch.uint8, device=dev),
            torch.empty((R, samples_pad), dtype=torch.int8, device=dev))
    calls = [lambda b=b: launch(b) for b in bufs]
    nbytes = _unpack_bytes(chunk, samples_pad)
    return {"variant_unpack": {
        "R": R, "records": n, "groups": len(chunk["meta"]["gt_groups"]),
        "nbytes": nbytes,
        "ms": device_ms(torch, calls, kernel="variant_unpack"),
        "loop_ms": loop_ms(torch, calls),
        "plain_ms": device_ms(torch, [
            lambda b=b: tid.variant_unpack_plain(b, packed, R, samples_pad)
            for b in bufs[:2]], reps=4),
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}}


def _k11_chunk_times(torch, chunk, samples_pad) -> dict:
    """K11 at the main path's chunk (``_k11_alone``); the whole
    ``device_variant_unpack`` of the chunk split by kernel (kernels,
    fills and copies, each call's device time) and its calls in a row by
    events (the host's packing and launches included); and K14 at the
    device plane's tile of that chunk."""
    from hadoop_bam_torch.parallel import variant_pipeline as tv
    buf, R, n = chunk["buf"], chunk["R"], chunk["n"]
    bufs = [buf.clone() for _ in range(8)]
    out = _k11_alone(torch, chunk, samples_pad, bufs)
    meta = chunk["meta"]
    ucalls = [lambda b=b: tv.device_variant_unpack(b, meta, samples_pad)
              for b in bufs]
    split = kernel_split(torch, ucalls)
    out["device_variant_unpack"] = {
        "by_kernel": split, "device_ms": sum(split.values()),
        "loop_ms": loop_ms(torch, ucalls)}
    chrom, pos, flags, tile, _ = tv.device_variant_unpack(buf, meta,
                                                          samples_pad)
    tiles = [tile.clone() for _ in range(8)]
    scalls = [lambda t=t: tv.variant_tile_stats(chrom, pos, flags, t, n)
              for t in tiles]
    nbytes = R * samples_pad + R + 4 * (4 + samples_pad) + 4
    out["variant_tile_stats"] = {
        "shape": f"[{R}, {samples_pad}] int8, {n} records",
        "nbytes": nbytes, "ms": device_ms(torch, scalls),
        "graph_ms": graph_ms(torch, scalls), "loop_ms": loop_ms(torch,
                                                                scalls),
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}
    return out


class _CheckedK11:
    """Stands in for ``variant_unpack`` in parallel/variant_pipeline.py
    during a checked device-plane pass: each call launches the kernel and
    holds its four outputs bit for bit against the plain version on the
    same inputs, tallying the shapes seen."""

    def __init__(self, torch, tid, tv):
        self.torch, self.tid, self.tv = torch, tid, tv
        self.seen = {}

    def __enter__(self):
        self.tv.variant_unpack = self.unpack
        return self

    def __exit__(self, *exc):
        self.tv.variant_unpack = self.tid.variant_unpack

    def unpack(self, buf, meta, R, s_pad):
        got = self.tid.variant_unpack(buf, meta, R, s_pad)
        want = self.tid.variant_unpack_plain(buf, meta, R, s_pad)
        for g, w, what in zip(got, want, ("chrom", "pos", "flags",
                                          "dosage")):
            check(self.torch.equal(g, w),
                  f"variant_unpack {what} in the checked pass")
        key = f"R={R} s_pad={s_pad}"
        self.seen[key] = self.seen.get(key, 0) + 1
        return got


def _same_variant_stats(got, want, what) -> float:
    """Counts and call rates exact, mean_af within rtol 1e-6; returns the
    relative difference of mean_af."""
    import numpy as np
    for k in ("n_variants", "n_snp", "n_pass", "n_af"):
        check(int(got[k]) == int(getattr(want, k)),
              f"{what}: {k} {got[k]} != {getattr(want, k)}")
    check(np.array_equal(got["sample_callrate"], want.sample_callrate),
          f"{what}: sample_callrate")
    rel = abs(got["mean_af"] - want.mean_af) / abs(want.mean_af)
    check(rel <= 1e-6, f"{what}: mean_af rel err {rel} <= 1e-6")
    return rel


def _log_k11_times(times, card) -> None:
    x = times["variant_unpack"]
    log(f"variant_unpack at the main path's chunk: device {x['ms']:.4f} ms "
        f"(plain {x['plain_ms']:.4f} ms, {x['loop_ms']:.4f} ms a call in a "
        f"row by events), bound {x['bound_ms']:.6f} ms = {x['nbytes']} B / "
        f"3.35 TB/s, {100 * x['bound_ms'] / x['ms']:.1f}% of it [{card}]")
    x = times["device_variant_unpack"]
    log(f"device_variant_unpack at that chunk: {x['device_ms']:.4f} ms of "
        f"device work a span ({x['by_kernel']}), {x['loop_ms']:.4f} ms a "
        f"call in a row by events [{card}]")


def phase_variant(torch, path, card, dev, seed, keep=None):
    """Phase 15: the variant plane on cuda:0 over the 1000 Genomes
    layout (``VARIANT_*``), written beside the BAM and removed after
    (with a ``keep`` dict, the BGZF BCF and VCF stay for phase 16 and
    their paths and truth go into it).  Returns the K11 rows of the
    kernels line, the launches of phase 15's device-plane pass (b), and
    K14's times."""
    log("== phase 15: the variant plane on cuda:0")
    import numpy as np
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.api.vcf_dataset import open_vcf
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.parallel import variant_pipeline as tv
    from hadoop_bam_torch.parallel.pipeline import pipeline_span_count
    from hadoop_bam_torch.utils.metrics import MetricsContext
    work = os.path.join(os.path.dirname(os.path.abspath(path)), "phase15")
    os.makedirs(work, exist_ok=True)
    bcf, raw, vz = (os.path.join(work, n) for n in (
        "kg.bcf", "kg.raw.bcf", "kg.vcf.gz"))
    try:
        truth, w = _timed(lambda: synth.write_synthetic_vcf(
            bcf, VARIANT_RECORDS, seed, n_samples=VARIANT_SAMPLES,
            x_records=VARIANT_X, raw_path=raw, vcf_path=vz,
            vcf_records=VARIANT_VCF, keep_rows=True))
        S_pad = tv.VariantGeometry(n_samples=VARIANT_SAMPLES).samples_pad
        log(f"the 1000 Genomes phase 3 layout ({VARIANT_SAMPLES} samples, "
            f"diploid phased GT, FORMAT GT, INFO AC AF AN NS DP VT; the "
            f"last {VARIANT_X} records on X, about half the samples "
            f"haploid there) cut in depth to {truth.n_variants} records "
            f"in {w:.1f} s: BGZF BCF {_mb(os.path.getsize(bcf))}, raw BCF "
            f"{_mb(os.path.getsize(raw))}, BGZF VCF of the first "
            f"{VARIANT_VCF} {_mb(os.path.getsize(vz))}; {truth.n_snp} "
            f"SNPs, {truth.n_pass} PASS, mean AF {truth.mean_af:.6f}; "
            f"additions: {100 * truth.filtered_share:.2f}% of sites not "
            f"PASS, {100 * truth.missing_share:.3f}% of calls './.'")

        # (a) K11 against its plain versions, then at the main path's
        # own chunk with its times and bounds
        cases = _k11_cases(torch, dev)
        for line in kernels_report("variant_unpack"):
            log(f"  ptxas: {line}")
        chunk = _variant_chunk(torch, bcf, dev, S_pad)
        times = _k11_chunk_times(torch, chunk, S_pad)
        log(f"(a) K11 bit-equal to its plain versions in {cases} cases, "
            f"twice each, and at the main path's chunk ({chunk['used']} of "
            f"its span's {chunk['n_blocks']} blocks, {chunk['n']} records, "
            f"R = {chunk['R']})")
        _log_k11_times(times, card)
        x = times["variant_tile_stats"]
        log(f"K14 (variant_tile_stats, torch ops) at {x['shape']}: "
            f"{x['ms']:.4f} ms by device_ms, {x['graph_ms']:.4f} ms a call "
            f"in one CUDA graph, {x['loop_ms']:.4f} ms in a row by events; "
            f"bound {x['bound_ms']:.6f} ms = {x['nbytes']} B / 3.35 TB/s "
            f"[{card}]")
        log("no single PyTorch call computes K11 or K14 (library_ms null)")
        del chunk

        # (b) variant_stats_file on three planes, each equal to the truth
        launches = {}
        rels = {}
        device_cfg = HBamConfig(inflate_backend="device")
        runs = (("host plane, BGZF BCF", bcf, None, truth),
                ("host plane, BGZF VCF", vz, None, truth.vcf),
                ("device plane, BGZF BCF", bcf, device_cfg, truth))
        for what, p, cfg, want in runs:
            kw = {"config": cfg} if cfg is not None else {}
            cold()
            before = _variant_launches()
            with MetricsContext() as m:
                got, wall = _timed(lambda: tv.variant_stats_file(
                    p, device=dev, **kw))
            ran = {k: v - before[k] for k, v in _variant_launches().items()}
            rels[what] = _same_variant_stats(got, want, what)
            c = m.counters
            extra = ""
            if cfg is not None:
                launches = ran
                db, fb = c.get("vcf.device_blocks", 0), \
                    c.get("vcf.fixup_blocks", 0)
                dr, fr = c.get("vcf.device_records", 0), \
                    c.get("vcf.fixup_records", 0)
                check(dr + fr == want.n_variants,
                      "device plane: each record counted once")
                spans = c.get("vcf.device_spans", 0)
                check(ran["resolve_pack"] > 0 and spans > 0
                      and ran["variant_unpack"] == spans,
                      f"the device plane launched K7+K8, and K11 once a "
                      f"span unpacked on the card ({ran['variant_unpack']} "
                      f"launches, {spans} spans)")
                check(ran["variant_prefix"] == ran["gt_dosage"] == 0,
                      "the device plane launched K11 as variant_unpack "
                      "only")
                extra = (f"; spans unpacked on the card {spans}, "
                         f"variant_unpack launches {ran['variant_unpack']}"
                         f"; blocks through the card {db}, through the host "
                         f"fixup {fb} ({100 * fb / max(db + fb, 1):.1f}%); "
                         f"records {dr} / {fr} "
                         f"({100 * fr / max(dr + fr, 1):.1f}% on the host); "
                         f"host decode "
                         f"{m.wall_timers.get('pipeline.host_decode_wall', 0):.3f}"
                         f" s, resolve "
                         f"{m.wall_timers.get('vcf.device_resolve_wall', 0):.3f}"
                         f" s, unpack "
                         f"{m.wall_timers.get('vcf.device_unpack_wall', 0):.3f}"
                         f" s")
            else:
                check(ran["variant_unpack"] == ran["variant_prefix"]
                      == ran["gt_dosage"] == 0, f"{what} launched no K11")
            log(f"(b) {what}: {wall:.3f} s wall, {want.n_variants / wall:,.0f}"
                f" variants/s; mean_af rel err {rels[what]:.2e}; launches "
                f"{ran}{extra} [{card}]")
            pw, busy, by_name = device_busy(torch, lambda: tv.
                                            variant_stats_file(
                                                p, device=dev, **kw))
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
            log(f"(b) {what} profiled: {pw:.3f} s wall, device busy "
                f"{busy:.4f} s ({100 * busy / pw:.2f}%); top: "
                + "; ".join(f"{k[:50]} {v * 1e3:.2f} ms"
                            for k, v in top) + f" [{card}]")

        # (c) the device plane again, every K11 launch held against its
        # plain version
        with _CheckedK11(torch, tid, tv) as chk:
            got = tv.variant_stats_file(bcf, device=dev, config=device_cfg)
        _same_variant_stats(got, truth, "checked device plane")
        n_chk = sum(chk.seen.values())
        check(n_chk == launches["variant_unpack"],
              f"the checked pass launched K11 once a span ({n_chk})")
        log(f"(c) checked device-plane pass: all {n_chk} variant_unpack "
            f"launches bit-equal to plain; shapes seen {chk.seen}")

        # (d) the tensor feed: every batch kept on the card while timed,
        # then its rows held against the generator's
        # the host plane's span count (the dataset's default plan is one
        # span a split_size, which decodes this file on one thread)
        ds = open_vcf(bcf, device=dev)
        tile = tv.VariantGeometry(n_samples=VARIANT_SAMPLES).tile_records
        n_spans = pipeline_span_count(bcf, 1)
        sync(torch, dev)
        t0 = time.perf_counter()
        batches = list(ds.tensor_batches(num_spans=n_spans))
        sync(torch, dev)
        wall = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for b in batches
                     for t in b.values())
        rows = {k: [] for k in ("chrom", "pos", "flags", "dosage")}
        for b in batches:
            n = int(b["n_records"][0])
            check(tuple(b["dosage"].shape) == (1, tile, S_pad),
                  "every batch has tile_records rows")
            for k in rows:
                rows[k].append(b[k][0, :n].cpu().numpy())
            check(bool((b["dosage"][0, n:] == -1).all()),
                  "tensor_batches dosage pads are -1")
        for k in ("chrom", "pos", "flags"):
            check(np.array_equal(np.concatenate(rows[k]), getattr(truth, k)),
                  f"tensor_batches {k} rows equal the generator's")
        check(np.array_equal(np.concatenate(rows["dosage"])[
            :, :VARIANT_SAMPLES], truth.dosage),
            "tensor_batches dosage rows equal the generator's")
        log(f"(d) open_vcf(bcf).tensor_batches(num_spans={n_spans}): "
            f"{len(batches)} batches of "
            f"{tuple(batches[0]['dosage'].shape)} in {wall:.3f} s, "
            f"{len(batches) / wall:,.1f} batches/s, "
            f"{nbytes / wall / 1e9:.3f} GB/s delivered, "
            f"{truth.n_variants / wall:,.0f} variants/s; rows equal the "
            f"generator's [{card}]")
        del batches
    finally:
        left = (raw,) if keep is not None else (bcf, raw, vz)
        for p in left:
            if os.path.exists(p):
                os.remove(p)
        if os.path.isdir(work) and not os.listdir(work):
            os.rmdir(work)
    if keep is not None:
        keep.update(bcf=bcf, vcf=vz, truth=truth, work=work)
    x = times["variant_unpack"]
    rows_out = {"variant_unpack": {
        "name": "variant_unpack", "route": "cuda",
        "source": "hadoop_bam_torch/csrc/variant_gt.cu",
        "replaces": "hadoop_bam_tpu/ops/inflate_device.py:413",
        "also_replaces": "hadoop_bam_tpu/ops/inflate_device.py:391",
        "max_abs_err": 0, "ms": x["ms"], "loop_ms": x["loop_ms"],
        "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "main_path_shape": f"R = {x['R']}, {x['records']} records of "
                           f"{VARIANT_SAMPLES} samples"}}
    return rows_out, launches, dict(times["variant_tile_stats"],
                                    launches=launches["variant_tile_stats"])


def variant_gt_times(torch, path, dev) -> dict:
    """``--times variant_gt``: K11 at phase 15's shapes: the cases
    checked, then the main path's chunk of a BCF of the phase's layout
    written beside the BAM (or found there): K11 alone,
    ``device_variant_unpack`` split by kernel, and two device-plane
    ``variant_stats_file`` passes of that BCF with their
    ``vcf.device_unpack_wall``."""
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.parallel import variant_pipeline as tv
    from hadoop_bam_torch.utils.metrics import MetricsContext
    card = card_line()
    cases = _k11_cases(torch, dev)
    bcf = path[:-len(".bam")] + "_kg.bcf"
    if not os.path.exists(bcf):
        _, w = _timed(lambda: synth.write_synthetic_vcf(
            bcf, VARIANT_RECORDS, 0, n_samples=VARIANT_SAMPLES,
            x_records=VARIANT_X))
        log(f"wrote {bcf} ({VARIANT_RECORDS} records) in {w:.1f} s")
    S_pad = tv.VariantGeometry(n_samples=VARIANT_SAMPLES).samples_pad
    chunk = _variant_chunk(torch, bcf, dev, S_pad)
    out = _k11_chunk_times(torch, chunk, S_pad)
    out.pop("variant_tile_stats")
    _log_k11_times(out, card)
    del chunk
    cfg = HBamConfig(inflate_backend="device")
    planes = []
    for _ in range(2):
        cold()
        with MetricsContext() as m:
            got, wall = _timed(lambda: tv.variant_stats_file(
                bcf, device=dev, config=cfg))
        check(got["n_variants"] == VARIANT_RECORDS,
              "the device plane counted every record")
        c, wt = m.counters, m.wall_timers
        planes.append({
            "wall_s": wall,
            "unpack_wall_s": wt.get("vcf.device_unpack_wall", 0.0),
            "resolve_wall_s": wt.get("vcf.device_resolve_wall", 0.0),
            "host_decode_s": wt.get("pipeline.host_decode_wall", 0.0),
            "device_records": c.get("vcf.device_records", 0),
            "device_spans": c.get("vcf.device_spans")})
        log(f"device plane over {VARIANT_RECORDS} records: {planes[-1]} "
            f"[{card}]")
    out["device_plane"] = planes
    out["cases"] = cases
    return out


def variant_floor_times(torch, path, dev) -> dict:
    """``--times variant_floor``: K11's one launch at the main path's chunk
    of the ``variant_gt`` BCF split by part, the header's mode set to
    each part alone (no part: the launch and the header; CHROM / POS and
    the flags; the tile; all), each read by the profiler over launches
    into one set of outputs."""
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.parallel import variant_pipeline as tv
    bcf = path[:-len(".bam")] + "_kg.bcf"
    if not os.path.exists(bcf):
        from hadoop_bam_torch import synth
        synth.write_synthetic_vcf(bcf, VARIANT_RECORDS, 0,
                                  n_samples=VARIANT_SAMPLES,
                                  x_records=VARIANT_X)
    S_pad = tv.VariantGeometry(n_samples=VARIANT_SAMPLES).samples_pad
    chunk = _variant_chunk(torch, bcf, dev, S_pad)
    buf, packed, R = chunk["buf"], chunk["packed"], chunk["R"]
    bufs = [buf.clone() for _ in range(8)]
    outs = [torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty(R, dtype=torch.uint8, device=dev),
            torch.empty((R, S_pad), dtype=torch.int8, device=dev)]
    out = {"R": R, "records": chunk["n"]}
    for part, mode in (("no part", 0),
                       ("CHROM, POS, flags", tid.MODE_PREFIX | tid.MODE_FLAGS),
                       ("tile", tid.MODE_DOSAGE | tid.MODE_FILL),
                       ("all", tid.MODE_ALL)):
        meta = packed.copy()
        meta[2] = mode
        meta = torch.from_numpy(meta).to(dev)
        out[part] = device_ms(torch, [
            lambda b=b, m=meta: tid.launch_unpack(b, m, R, S_pad, *outs)
            for b in bufs], kernel="variant_unpack")
    log(f"variant_unpack by part at R = {R}: {out} [{card_line()}]")
    return out


def variant_plane_times(torch, path, dev) -> dict:
    """``--times variant_plane``: phase 15 alone."""
    rows, launches, k14 = phase_variant(torch, path, card_line(), dev, 0)
    return {"kernels": rows, "launches": launches, "K14": k14}


QUERY_VARIANT_REGIONS = 200  # phase 16 (a): regions a file
SORT_ROUNDS = 4              # phase 16 (b): the spill exchange's rounds


def _variant_regions(rng, truth, n, limit=None):
    """``n`` regions of 1-5 kb around records drawn from the generator's
    rows (the first ``limit`` only, when given): (contig, start, end)
    1-based inclusive."""
    from hadoop_bam_torch.synth import KG_CONTIGS
    m = truth.pos.size if limit is None else limit
    out = []
    for i in rng.integers(0, m, n):
        width = int(rng.integers(1_000, 5_000))
        start = max(1, int(truth.pos[i]) - int(rng.integers(0, width)))
        out.append((KG_CONTIGS[int(truth.chrom[i])][0], start,
                    start + width - 1))
    return out


def _variant_oracle(truth, region):
    """The (contig, pos) of every generated record overlapping a region,
    in file order: a full scan of the generator's rows."""
    import numpy as np
    from hadoop_bam_torch.synth import KG_CONTIGS
    name, beg, end = region
    cid = [c for c, _ in KG_CONTIGS].index(name)
    pos = truth.pos.astype(np.int64)
    hit = (truth.chrom == cid) & (pos <= end) \
        & (pos + np.maximum(truth.rlen, 1) - 1 >= beg)
    return [(name, int(p)) for p in pos[hit]]


def _digest(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _k15_inputs(torch, path, dev):
    """The index exchange's step inputs at the main path's shape: the
    whole BAM as one decoded span (``plan_bam_spans_balanced(path, 1)``,
    as ``sort_bam_mesh`` plans it on one device), padded as the sort pads
    it."""
    import numpy as np
    from hadoop_bam_torch.config import DEFAULT_CONFIG
    from hadoop_bam_torch.parallel import mesh_sort as ms
    from hadoop_bam_torch.split.planners import plan_bam_spans_balanced
    (span,) = plan_bam_spans_balanced(path, 1)
    data, offs = ms._decode(path, span, DEFAULT_CONFIG)
    n = int(offs.size)
    R = ms._round_up(n, 8)
    D = ms._round_up(data.size, 256)
    host = np.zeros(D, np.uint8)
    host[:data.size] = data
    o = np.zeros(R, np.int32)
    o[:n] = offs
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    return (torch.from_numpy(host).to(dev), torch.from_numpy(o).to(dev), n,
            0, none, none), data, offs


def _k15_check_and_time(torch, path, dev, card) -> dict:
    """K15's index step on the card against its CPU run on the same
    inputs at the main path's shape, and its bytes step at the spill
    round's shape; then the index step's device time, its calls in a
    row, its version with K1's plain PyTorch gather, the one stable
    ``torch.sort`` its (hi, lo) sort reduces to, and its bound."""
    import numpy as np
    from hadoop_bam_torch.ops import unpack_bam
    from hadoop_bam_torch.parallel import mesh_sort as ms
    args, data, offs = _k15_inputs(torch, path, dev)
    n, R = args[2], args[1].shape[0]
    got = ms.sort_step(*args)
    cpu_args = tuple(a.cpu() if hasattr(a, "cpu") else a for a in args)
    want = ms.sort_step(*cpu_args)
    check(torch.equal(got.cpu(), want), "K15 index step equals its CPU run")
    # the bytes step at one spill round's rows
    m = -(-n // SORT_ROUNDS)
    lens = ms._record_lens(data, offs[:m])
    stride = 1 << max(6, int(max(int(lens.max()), 36) - 1).bit_length())
    Rb = ms._round_up(m, 1024)
    none = args[4]
    rows, ln = ms.pack_rows(args[0], offs[:m], lens, Rb, stride)
    g = ms.bytes_sort_step(rows, ln, m, 0, none, none)
    w = ms.bytes_sort_step(rows.cpu(), ln.cpu(), m, 0, none.cpu(),
                           none.cpu())
    for a, b, what in zip(g, w, ("rows", "lengths", "indices")):
        check(torch.equal(a.cpu(), b), f"K15 bytes step {what} equal its "
                                       f"CPU run")
    log(f"(b) K15 on the card equals its CPU run: the index step at the "
        f"main path's shape (R = {R}, {n} records, D = {args[0].numel()}) "
        f"and the bytes step at a spill round's ([{Rb}, {stride}], {m} "
        f"records)")
    del rows, ln, g, w, cpu_args, want
    calls = [lambda: ms.sort_step(*args)]
    # each call launches K1 once: sessions that lost no launch are kept,
    # and without one the calls' CUDA graph gives the device time
    ms_ = device_ms(torch, calls, reps=16,
                    kernel="unpack_fixed_fields_kernel")
    ms_by = device_ms.how
    looped = loop_ms(torch, calls, reps=16)

    def plain_step():
        real = unpack_bam.unpack_fixed_fields
        unpack_bam.unpack_fixed_fields = unpack_bam.unpack_fixed_fields_plain
        try:
            return ms.sort_step(*args)
        finally:
            unpack_bam.unpack_fixed_fields = real
    plain_ms = device_ms(torch, [plain_step], reps=8)
    key = torch.randint(-(1 << 62), 1 << 32, (R,), device=dev)
    lib_ms = device_ms(torch, [lambda: torch.sort(key, stable=True)],
                       reps=16)
    bytes_ms = device_ms(torch, [lambda: ms.bytes_sort_step(
        *ms.pack_rows(args[0], offs[:m], lens, Rb, stride), m, 0, none,
        none)], reps=8)
    # each record's 8 key bytes and 4-byte offset read once, each row's
    # int32 global index written once
    nbytes = 12 * n + 4 * R
    bound = nbytes / H100_BYTES_PER_S * 1e3
    log(f"K15 index step at R = {R}: {ms_:.4f} ms by {ms_by}, "
        f"{looped:.4f} ms a call in a row by events, {plain_ms:.4f} ms with "
        f"K1's plain gather, one stable torch.sort of its {R} int64 keys "
        f"{lib_ms:.4f} ms (the step's one sort), bound {bound:.6f} ms = "
        f"{nbytes} B / 3.35 TB/s; the bytes step with its row packing at "
        f"[{Rb}, {stride}] {bytes_ms:.4f} ms [{card}]")
    return {"name": "mesh_sort_step", "route": "cuda",
            "form": "torch ops (no hand kernel; K1 inside)",
            "source": "hadoop_bam_torch/parallel/mesh_sort.py",
            "replaces": "hadoop_bam_tpu/parallel/mesh_sort.py:179",
            "also_replaces": "hadoop_bam_tpu/parallel/mesh_sort.py:251",
            "max_abs_err": 0, "ms": ms_, "ms_by": ms_by, "loop_ms": looped,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib_ms, "bytes_step_ms": bytes_ms,
            "main_path_shape": f"R = {R}, {n} records"}


def phase_sort_query(torch, path, card, dev, seed, variant, oracle=None):
    """Phase 16: (a) region queries through ``.tbi`` sidecars on phase
    15's BGZF BCF and VCF (``variant`` from ``phase_variant(keep=...)``;
    or written here when None), each equal to the generator's full scan;
    (b) the mesh sort of the main path's BAM through each exchange on
    cuda:0, byte-identical to the port's host ``sort_bam`` (phase 11's
    run of it when ``oracle`` holds its digests, else run here), then
    K15 against its CPU run and timed.  Returns the K15 row and the
    launches of (b)'s sorts."""
    log("== phase 16: variant region queries and the mesh sort on cuda:0")
    import numpy as np
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.api.vcf_dataset import open_vcf
    from hadoop_bam_torch.ops.unpack_bam import unpack_fixed_fields
    from hadoop_bam_torch.parallel import mesh_sort as ms
    from hadoop_bam_torch.query import QueryEngine, QueryRequest
    from hadoop_bam_torch.query.engine import overlap_step
    from hadoop_bam_torch.split.tabix import write_tabix
    from hadoop_bam_torch.utils.sort import sort_bam
    rng = np.random.default_rng(seed)
    made = variant is None
    if made:
        variant = {"work": os.path.join(os.path.dirname(
            os.path.abspath(path)), "phase15")}
        os.makedirs(variant["work"], exist_ok=True)
        variant["bcf"] = os.path.join(variant["work"], "kg.bcf")
        variant["vcf"] = os.path.join(variant["work"], "kg.vcf.gz")
        variant["truth"] = synth.write_synthetic_vcf(
            variant["bcf"], VARIANT_RECORDS, seed,
            n_samples=VARIANT_SAMPLES, x_records=VARIANT_X,
            vcf_path=variant["vcf"], vcf_records=VARIANT_VCF,
            keep_rows=True)
    truth = variant["truth"]
    outs = []
    try:
        # (a) the .tbi sidecars, then batched queries through them
        for what, p, limit in (("BGZF BCF", variant["bcf"], None),
                               ("BGZF VCF", variant["vcf"], VARIANT_VCF)):
            out, wall = _timed(lambda: write_tabix(p))
            outs.append(out)
            regions = _variant_regions(rng, truth, QUERY_VARIANT_REGIONS,
                                       limit)
            eng = QueryEngine(device=dev)
            before = overlap_step.launches
            res, qwall = _timed(lambda: eng.query_records(
                [QueryRequest(p, f"{c}:{b}-{e}") for c, b, e in regions]))
            k13 = overlap_step.launches - before
            n_rec = 0
            for region, r in zip(regions, res):
                got = [(x.chrom, x.pos) for x in r.records]
                check(got == _variant_oracle(truth, region),
                      f"{what} region {region}: the full scan's records")
                n_rec += len(got)
            check(n_rec > 0 and k13 > 0, f"{what}: records found on the "
                                         f"card's overlap step")
            log(f"(a) {what}: .tbi built in {wall:.3f} s "
                f"({os.path.getsize(out)} B); {len(regions)} regions of "
                f"1-5 kb in one batch: {qwall:.3f} s, {n_rec} records, each "
                f"region equal to the generator's full scan; "
                f"{sum(r.n_candidates for r in res)} candidate rows, K13 "
                f"steps {k13} [{card}]")
        regions = _variant_regions(rng, truth, 20, VARIANT_VCF)
        ds = open_vcf(variant["vcf"], device=dev)
        qs, qwall = _timed(lambda: [
            [(x.chrom, x.pos) for x in ds.query(f"{c}:{b}-{e}")]
            for c, b, e in regions])
        for region, got in zip(regions, qs):
            check(got == _variant_oracle(truth, region),
                  f"VcfDataset.query {region}")
        log(f"(a) VcfDataset.query over 20 regions of the BGZF VCF: "
            f"{qwall:.3f} s, {sum(map(len, qs))} records, each equal to "
            f"the full scan [{card}]")
    finally:
        for p in outs + [variant["bcf"], variant["vcf"]]:
            if os.path.exists(p):
                os.remove(p)
        if os.path.isdir(variant["work"]) and \
                not os.listdir(variant["work"]):
            os.rmdir(variant["work"])

    # (b) the mesh sort of the main path's reads
    work = os.path.splitext(path)[0] + "_sort"
    os.makedirs(work, exist_ok=True)
    try:
        if oracle:
            n, wall, want = oracle["n"], oracle["wall"], oracle["digests"]
            log(f"(b) host sort_bam (one run, the oracle): phase 11's, {n} "
                f"records in {wall:.3f} s, {n / wall:,.0f} records/s")
        else:
            host = os.path.join(work, "host.bam")
            n, wall = _timed(lambda: sort_bam(path, host,
                                              run_records=1 << 40))
            log(f"(b) host sort_bam (one run, the oracle): {n} records in "
                f"{wall:.3f} s, {n / wall:,.0f} records/s [{card}]")
            want = {suffix: _digest(host + suffix)
                    for suffix in ("", ".bai", ".sbi")}
        rr = -(-n // SORT_ROUNDS)
        runs = (("index", {}), ("bytes", {"exchange": "bytes"}),
                ("spill", {"round_records": rr}))
        k1_before = unpack_fixed_fields.launches
        ms.sort_step.launches = ms.bytes_sort_step.launches = 0
        steps = {}
        for what, kw in runs:
            out = os.path.join(work, f"{what}.bam")
            before = ms.sort_step.launches + ms.bytes_sort_step.launches
            got, wall = _timed(lambda: ms.sort_bam_mesh(path, out,
                                                        device=dev, **kw))
            steps[what] = ms.sort_step.launches \
                + ms.bytes_sort_step.launches - before
            check(got == n, f"{what} exchange sorted every record")
            for suffix, digest in want.items():
                check(_digest(out + suffix) == digest,
                      f"{what} exchange{suffix}: byte-identical to sort_bam")
            log(f"(b) sort_bam_mesh exchange={what}"
                f"{f', round_records={rr}' if kw.get('round_records') else ''}"
                f": {wall:.3f} s, {n / wall:,.0f} records/s, K15 steps "
                f"{steps[what]}; output, .bai and .sbi byte-identical to "
                f"sort_bam [{card}]")
            os.remove(out)
            for suffix in (".bai", ".sbi"):
                os.remove(out + suffix)
        k1 = unpack_fixed_fields.launches - k1_before
        check(steps["spill"] >= 3, f"the spill exchange took "
                                   f"{steps['spill']} rounds (>= 3)")
        check(k1 >= steps["index"] >= 1, "the index exchange launched K1 "
                                         "inside its step")
        launches = {"mesh_sort_step": sum(steps.values()),
                    "unpack_fixed_fields": k1}
        row = _k15_check_and_time(torch, path, dev, card)
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 16 launches: {launches} (K15 steps by exchange {steps})")
    return row, launches


def sort_query_times(torch, path, dev) -> dict:
    """``--times sort_query``: phase 16 alone (its variant files written
    here)."""
    row, launches = phase_sort_query(torch, path, card_line(), dev, 0, None)
    return {"K15": row, "launches": launches}


MKDUP_READS = 2_000_000      # phase 17 (b): reads of the duplicate-bearing BAM
MKDUP_ROUND = 1_000_000      # the reference's default round: two rounds
MKDUP_ORACLE_READS = 100_000  # phase 17 (b2): the depth held to the oracle


def _flags_of(path):
    """Every record's FLAG in file order (the host span decode)."""
    import numpy as np
    from hadoop_bam_torch.parallel.pipeline import map_file_spans
    return np.concatenate([
        d[o.astype(np.int64)[:, None] + np.arange(18, 20)].copy()
        .view("<u2").ravel()
        for d, o in map_file_spans(path, lambda d, o, v: (d, o))]
    ).astype(np.int64)


def _k16a_tile_check(torch, dev, rows, lib, count, kmax, what,
                     shifts=(0, 16), plain_dev=None, hints=(None,)) -> None:
    """K16a on one tile (at each offset from its allocation, at each
    ``row_bytes`` of ``hints``, twice) against its plain version, on the
    CPU or on ``plain_dev``."""
    from hadoop_bam_torch.prep import markdup as md
    on = torch.device("cpu") if plain_dev is None else plain_dev
    want = md.markdup_columns_plain(
        torch.from_numpy(rows).to(on),
        torch.arange(rows.shape[0], device=on) < count,
        torch.from_numpy(lib).to(on), kmax)
    for shift in shifts:
        base = torch.zeros(rows.size + shift, dtype=torch.uint8, device=dev)
        rt = base[shift:].view(rows.shape)
        rt.copy_(torch.from_numpy(rows))
        for hint in hints:
            kw = {} if hint is None else {"row_bytes": hint}
            for _ in range(2):
                got = md.markdup_columns(rt, count,
                                         torch.from_numpy(lib).to(dev), kmax,
                                         **kw)
                sync(torch, dev)
                check(torch.equal(got[0].to(on), want[0])
                      and torch.equal(got[1].to(on), want[1]),
                      f"K16a equals its plain version ({what}, kmax {kmax}, "
                      f"offset {shift}, row_bytes {hint})")


def _tile_row_bytes(rows, count) -> int:
    """``host_row_bytes`` of a tile's records (rows 0 .. count)."""
    import numpy as np
    from hadoop_bam_torch.prep import markdup as md
    return md.host_row_bytes(rows.reshape(-1),
                             np.arange(count, dtype=np.int64) * rows.shape[1])


def _k16a_cases(torch, dev, this_tree=True) -> int:
    """K16a against its plain version on ``synth.MARKDUP_CASES`` (and
    ``markdup_rows``' pads and tile-end row), at the rows' CIGAR width and
    below it, the tile 16 bytes off its allocation too, twice each; then
    on ``synth.MARKDUP_TILES`` (runs of 400-600 bases at stride 1024,
    30-40-byte names, R = 1, R = 7, R = 1,031) and on a tile past the
    persistent grid's first sweep (more rows than the card has threads
    at once, 2,048 an SM, plus 777: R % 64 != 0), its plain version on
    the card.  Each tile is
    checked with the kernel staging whole rows (no ``row_bytes``), the
    tile's ``host_row_bytes`` and 48 bytes (every op and quality word
    past the fixed fields read from the tile).  ``this_tree`` False (an
    earlier tree, ``--times --tree``): the edge rows alone, staging
    whole rows.  Returns the tiles checked."""
    from hadoop_bam_torch import synth

    def hints(rows, count):
        return ((None, 48, _tile_row_bytes(rows, count)) if this_tree
                else (None,))
    n = 0
    for seed in (0, 1):
        rows, lib, count, _ = synth.markdup_rows(seed=seed)
        for kmax in (synth.rows_kmax(rows), 2, 0):
            _k16a_tile_check(torch, dev, rows, lib, count, kmax,
                             f"seed {seed}", hints=hints(rows, count))
            n += 2
    if not this_tree:
        return n
    for name, kw in synth.MARKDUP_TILES:
        rows, lib, count = synth.markdup_tile(seed=3, **kw)
        for kmax in (synth.rows_kmax(rows), 2, 0):
            _k16a_tile_check(torch, dev, rows, lib, count, kmax, name,
                             hints=hints(rows, count))
            n += 2
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 1)
    R = sms * 2048 + 777
    rows, lib, count = synth.markdup_tile(R, seed=4, stride=128,
                                          l_seq=(10, 40))
    _k16a_tile_check(torch, dev, rows, lib, count, synth.rows_kmax(rows),
                     f"R = {R}, past the first sweep", shifts=(16,),
                     plain_dev=dev, hints=hints(rows, count))
    return n + 1


def _k16_round(torch, path, dev, hint=True):
    """Round 0 of (b)'s run as the pipeline packs it: its rows, lengths,
    library column (``library_from="rg"``), CIGAR width and (``hint``)
    ``row_bytes``, as the pipeline passes them."""
    import numpy as np
    from hadoop_bam_torch.config import DEFAULT_CONFIG
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.parallel import mesh_sort as ms
    from hadoop_bam_torch.prep import markdup as md
    from hadoop_bam_torch.prep.oracle import library_column, library_map
    header, _ = read_bam_header(path)
    span = ms._spill_plan(path, header, MKDUP_ROUND, 1)[0]
    data, offs = ms._decode(path, span, DEFAULT_CONFIG)
    lens = ms._record_lens(data, offs)
    count = int(offs.size)
    R = ms._round_up(count, 1024)
    stride = 1 << max(6, int(max(int(lens.max()), 36) - 1).bit_length())
    kmax = md.host_kmax(data, offs)
    lib = np.zeros(R, np.uint32)
    lib[:count] = library_column(data, offs, lens, library_map(header, "rg"))
    rows, ln = ms.pack_rows(torch.from_numpy(data).to(dev), offs, lens, R,
                            stride)
    b = offs.astype(np.int64)
    n_cigar = data[b[:, None] + np.arange(16, 18)].view("<u2").ravel()
    l_seq = data[b[:, None] + np.arange(20, 24)].view("<i4").ravel()
    # each row's 28 bytes of fixed fields (refid through next_pos) and
    # library number read, its 25 output bytes written; each record's
    # CIGAR words and quality run read
    nbytes = R * (28 + 4 + 25) + int(4 * n_cigar.astype(np.int64).sum()
                                     + l_seq.astype(np.int64).sum())
    return {"rows": rows, "lens": ln, "count": count, "R": R,
            "stride": stride, "kmax": 1 << (kmax - 1).bit_length(),
            "lib": torch.from_numpy(lib).to(dev), "nbytes": nbytes,
            "sector_bytes": _k16a_sector_bytes(data, offs, R),
            "kw": {"row_bytes": md.host_row_bytes(data, offs)} if hint
            else {}, "what": "the round's tile"}


def _k16_names_tile(torch, dev, hint=True):
    """A tile of a round's size, [1,000,448, 512], of ``synth.markdup_tile``
    records with read names of 30-40 bytes (NUL included, as Illumina's
    run and tile coordinate names) and 151-base reads, their quality runs
    ending at bytes 297-331: written by this tree's synth into this
    tree's build dir (``--tree`` runs read it there, so trees in turns
    time the same rows).  The same keys as ``_k16_round``."""
    import numpy as np
    src = os.path.join(os.path.dirname(os.path.realpath(__file__)),
                       "hadoop_bam_torch", "_build", "smoke",
                       "markdup_names.npz")
    R = -(-MKDUP_ROUND // 1024) * 1024
    if not os.path.exists(src):
        os.makedirs(os.path.dirname(src), exist_ok=True)
        from hadoop_bam_torch import synth
        rows, lib, count = synth.markdup_tile(R, seed=7, pads=R - MKDUP_ROUND,
                                              name_len=(30, 40))
        tmp = f"{src}.{os.getpid()}.npz"
        np.savez(tmp, rows=rows, lib=lib, count=count)
        os.replace(tmp, src)
    with np.load(src) as z:
        rows, lib, count = z["rows"], z["lib"], int(z["count"])
    stride = rows.shape[1]
    flat = rows.reshape(-1)
    offs = np.arange(count, dtype=np.int64) * stride
    nc = rows[:count, 16:18].copy().view("<u2").ravel().astype(np.int64)
    ls = rows[:count, 20:24].copy().view("<i4").ravel().astype(np.int64)
    kmax = int(nc.max())
    return {"rows": torch.from_numpy(rows).to(dev), "count": count, "R": R,
            "stride": stride, "kmax": 1 << (kmax - 1).bit_length(),
            "lib": torch.from_numpy(lib).to(dev),
            "nbytes": R * (28 + 4 + 25) + int(4 * nc.sum() + ls.sum()),
            "sector_bytes": _k16a_sector_bytes(flat, offs, R),
            "kw": {"row_bytes": _tile_row_bytes(rows, count)} if hint else {},
            "what": "a round-sized tile of 30-40-byte names"}


def _k16a_sector_bytes(data, offs, R) -> int:
    """A note beside K16a's bound, not the bound: the bytes a kernel
    moves that reads whole 32-byte sectors of each record's row (its
    fixed fields' sector, its CIGAR's, its quality run's; rows start on
    a sector) and writes its 25 output bytes, with each row's 4-byte
    library number."""
    import numpy as np
    b = offs.astype(np.int64)
    lrn = data[b + 12].astype(np.int64)
    nc = data[b[:, None] + np.arange(16, 18)].view("<u2").ravel()
    ls = data[b[:, None] + np.arange(20, 24)].view("<i4").ravel()
    nc, ls = nc.astype(np.int64), ls.astype(np.int64)
    c0 = 36 + lrn
    q0 = c0 + 4 * nc + (ls + 1) // 2

    def span(lo, hi):            # sectors of [lo, hi), 0 when empty
        return np.where(hi > lo, (hi - 1) // 32 - lo // 32 + 1, 0)
    first = np.ones_like(lrn)    # bytes 4-31
    cig = span(c0, c0 + 4 * nc) - (c0 // 32 == 0) * (nc > 0)
    qual = span(q0, q0 + ls)
    shared = (q0 // 32 == (c0 + 4 * nc - 1) // 32) & (nc > 0) & (ls > 0)
    sectors = first + cig + qual - shared
    return int(32 * sectors.sum()) + R * (4 + 25)


def _k16a_check_and_time(torch, rnd, card) -> dict:
    """K16a at a round's tile: bit for bit against its plain version on
    the same card inputs, then its device time, its calls in a row, the
    plain version's time and its bound."""
    from hadoop_bam_torch.prep import markdup as md
    rows, lib, count, kmax = rnd["rows"], rnd["lib"], rnd["count"], rnd["kmax"]
    kw, what = rnd["kw"], rnd["what"]
    valid = torch.arange(rnd["R"], device=rows.device) < count
    got = md.markdup_columns(rows, count, lib, kmax, **kw)
    want = md.markdup_columns_plain(rows, valid, lib, kmax)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"K16a equals its plain version at {what}")
    del want
    calls = [lambda: md.markdup_columns(rows, count, lib, kmax, **kw)]
    ms_ = device_ms(torch, calls, reps=16, kernel="markdup_cols_kernel")
    ms_by = device_ms.how
    looped = loop_ms(torch, calls, reps=16)
    plain_ms = device_ms(torch, [lambda: md.markdup_columns_plain(
        rows, valid, lib, kmax)], reps=4)
    bound = rnd["nbytes"] / H100_BYTES_PER_S * 1e3
    sector_ms = rnd["sector_bytes"] / H100_BYTES_PER_S * 1e3
    log(f"(a) K16a at {what} [{rnd['R']}, {rnd['stride']}] "
        f"({count} records, CIGAR width {kmax}, {kw or 'whole rows'}): "
        f"bit-equal to plain; "
        f"{ms_:.4f} ms by {ms_by}, {looped:.4f} ms a call in a row by "
        f"events, plain {plain_ms:.4f} ms, bound {bound:.6f} ms = "
        f"{rnd['nbytes']} B / 3.35 TB/s, {100 * bound / ms_:.1f}% of it; "
        f"a note, not the bound: whole 32-byte sectors move "
        f"{rnd['sector_bytes']} B = {sector_ms:.6f} ms, a ceiling of "
        f"{100 * bound / sector_ms:.1f}% of the bound [{card}]")
    return {"name": "markdup_columns", "route": "cuda",
            "source": "hadoop_bam_torch/csrc/markdup_cols.cu",
            "replaces": "hadoop_bam_tpu/prep/markdup.py:69",
            "status": "redesigned: each CTA stages its next batch of "
                      "rows' first row_bytes (host_row_bytes) by "
                      "cp.async whole lines while a thread a record "
                      "computes the last",
            "max_abs_err": 0, "ms": ms_, "ms_by": ms_by, "loop_ms": looped,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None,
            "main_path_shape": f"[{rnd['R']}, {rnd['stride']}], {count} "
                               f"records"}


def _k16b_check_and_time(torch, cols_files, dev, card) -> dict:
    """K16b at (b)'s shape (every eligible record's columns, as stage 2
    loads them from the round sidecars): equal to its CPU run, then its
    device time, its calls in a row, one stable ``torch.sort`` of as many
    int64 keys and its bound."""
    import numpy as np
    from hadoop_bam_torch.parallel.mesh_sort import _round_up
    from hadoop_bam_torch.prep import markdup as md
    from hadoop_bam_torch.prep.pipeline import _SIG
    sig = {n: [] for n in _SIG}
    for p in cols_files:
        with np.load(p) as z:
            for n in _SIG:
                sig[n].append(z[n])
    m = int(sum(a.size for a in sig["gidx"]))
    cap = _round_up(m, 1024)

    def padded(name, dtype):
        out = torch.zeros(cap, dtype=dtype)
        out[:m] = torch.from_numpy(np.concatenate(sig[name]))
        return out

    host = [padded(n, torch.uint32) for n in _SIG[:6]] + \
        [padded("gidx", torch.int32)]
    args = [a.to(dev) for a in host]
    got = md.markdup_exchange_step(*args, m)
    want = md.markdup_exchange_step(*host, m)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "K16b on the card equals its CPU run")
    calls = [lambda: md.markdup_exchange_step(*args, m)]
    ms_ = device_ms(torch, calls, reps=8)
    ms_by = device_ms.how
    if ms_by == "events in a row":
        # no profiler session was whole: the step's kernels in one CUDA
        # graph give its device time without the host's launches
        graphed = graph_ms(torch, calls, reps=8)
        if graphed == graphed:
            ms_, ms_by = graphed, "one CUDA graph"
    looped = loop_ms(torch, calls, reps=8)
    key = torch.randint(-(1 << 62), 1 << 32, (m,), device=dev)
    lib_ms = device_ms(torch, [lambda: torch.sort(key, stable=True)],
                       reps=16)
    # the 7 columns of each eligible record read once, each row's int32
    # index and duplicate bit written once
    nbytes = 28 * m + 5 * cap
    bound = nbytes / H100_BYTES_PER_S * 1e3
    log(f"(c) K16b at (b)'s shape ({m} eligible records, {cap} rows): "
        f"equal to its CPU run; {ms_:.4f} ms by {ms_by}, {looped:.4f} ms a "
        f"call in a row by events, one stable torch.sort of {m} int64 "
        f"keys {lib_ms:.4f} ms, bound {bound:.6f} ms = {nbytes} B / "
        f"3.35 TB/s [{card}]")
    return {"name": "markdup_exchange_step", "route": "cuda",
            "form": "torch ops (no hand kernel)",
            "source": "hadoop_bam_torch/prep/markdup.py",
            "replaces": "hadoop_bam_tpu/prep/markdup.py:214",
            "max_abs_err": 0, "ms": ms_, "ms_by": ms_by, "loop_ms": looped,
            "plain_ms": ms_, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib_ms,
            "main_path_shape": f"{m} eligible records, {cap} rows"}


def _scan_overlaps(path, rid, beg, end) -> int:
    """Records of a BAM overlapping a 1-based inclusive region, by a full
    decode (the query engine's overlap rule)."""
    import numpy as np
    from hadoop_bam_torch.formats.bam import BamBatch
    from hadoop_bam_torch.parallel.pipeline import map_file_spans
    n = 0
    for data, offs in map_file_spans(path, lambda d, o, v: (d, o)):
        b = BamBatch(data, offs)
        pos1 = b.pos.astype(np.int64) + 1
        end1 = pos1 + np.maximum(b.reference_span(), 1) - 1
        n += int(((b.refid == rid) & (pos1 <= end) & (end1 >= beg)).sum())
    return n


def phase_mkdup(torch, path, card, dev, seed):
    """Phase 17: duplicate marking on cuda:0.  (a) K16a against its plain
    version in every ``synth.MARKDUP_CASES`` case; (b) ``markdup_bam_mesh``
    over ``MKDUP_READS`` reads of ``synth.write_markdup_bam`` in rounds of
    ``MKDUP_ROUND`` with ``library_from="rg"``: every record's flag equal
    to the generator's truth, the co-written ``.bai`` serving a region
    with no rescan, a profiled re-run's busy share; (b2) at
    ``MKDUP_ORACLE_READS`` reads, byte-identical
    to the port's ``markdup_bam_oracle`` with both library modes (one
    removing duplicates); K16a checked and timed at (b)'s round tile and
    (c) K16b at (b)'s shape.  Returns the K16a and K16b rows and the
    launches of (b)'s run."""
    log("== phase 17: duplicate marking (mkdup) on cuda:0")
    import dataclasses
    import shutil
    import numpy as np
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.config import DEFAULT_CONFIG
    from hadoop_bam_torch.parallel import mesh_sort as ms
    from hadoop_bam_torch.prep import markdup as md
    from hadoop_bam_torch.prep import markdup_bam_mesh, markdup_bam_oracle
    from hadoop_bam_torch.query import QueryEngine, QueryRequest
    from hadoop_bam_torch.split import bai as bai_mod
    from hadoop_bam_torch.utils.metrics import MetricsContext
    n_cases = _k16a_cases(torch, dev)
    log(f"(a) K16a bit-equal to its plain version in {n_cases} tiles (the "
        f"{len(synth.MARKDUP_CASES)} MARKDUP_CASES rows, MARKDUP_TILES, a "
        f"tile past the first sweep), twice each")
    work = os.path.join(os.path.dirname(os.path.abspath(path)), "phase17")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        src = os.path.join(work, "md.bam")
        truth, wall = _timed(lambda: synth.write_markdup_bam(
            src, MKDUP_READS, seed))
        log(f"(b) {MKDUP_READS} paired 151-bp reads, {truth.copy_pairs} "
            f"pairs copying another (5' clips, other qualities, three read "
            f"groups over two libraries) in {wall:.1f} s: "
            f"{os.path.getsize(src)} bytes; the truth marks "
            f"{int(truth.dup['rg'].sum())} ('rg') / "
            f"{int(truth.dup['none'].sum())} ('none') duplicates")
        out = os.path.join(work, "out.bam")
        keep = dataclasses.replace(DEFAULT_CONFIG, debug_keep_spill=True)
        wrappers = (md.markdup_columns, md.markdup_exchange_step,
                    ms.bytes_sort_step, md.fused_sort_markdup_step)
        for w in wrappers:
            w.launches = 0
        with MetricsContext() as mc:
            n, wall = _timed(lambda: markdup_bam_mesh(
                src, out, device=dev, library_from="rg",
                round_records=MKDUP_ROUND, config=keep))
        launches = {"markdup_columns": md.markdup_columns.launches,
                    "markdup_exchange_step":
                        md.markdup_exchange_step.launches,
                    "mesh_sort_step": ms.bytes_sort_step.launches}
        snap = mc.snapshot()
        check(n == MKDUP_READS, f"mkdup wrote {n} records")
        check(np.array_equal(_flags_of(out), truth.output_flags("rg")),
              "every output flag equals the generator's truth")
        n_dup = int(snap["counters"].get("prep.duplicates_marked", -1))
        check(n_dup == int(truth.dup["rg"].sum()),
              "the duplicates marked equal the truth's")
        check(launches["markdup_columns"] == 2
              and launches["markdup_exchange_step"] == 1
              and launches["mesh_sort_step"] == 2,
              f"the run launched K16a a round, K16b once: {launches}")
        walls = snap["wall_timers"]
        log(f"(b) markdup_bam_mesh(library_from='rg', round_records="
            f"{MKDUP_ROUND}): {wall:.3f} s, {n / wall:,.0f} records/s, "
            f"{n_dup} duplicates marked ({100 * n_dup / n:.2f}%), every "
            f"flag equal to the truth; stages: sort "
            f"{walls.get('prep.sort_wall', 0):.3f} s, markdup "
            f"{walls.get('prep.markdup_wall', 0):.3f} s, write "
            f"{walls.get('prep.write_wall', 0):.3f} s; launches {launches} "
            f"[{card}]")
        cols_files = sorted(
            os.path.join(out + ".mkdup-spill", f)
            for f in os.listdir(out + ".mkdup-spill") if f.startswith("cols"))
        busy_out = os.path.join(work, "busy.bam")
        pwall, busy, by_name = device_busy(torch, lambda: markdup_bam_mesh(
            src, busy_out, device=dev, library_from="rg",
            round_records=MKDUP_ROUND))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"(b) the same run profiled: {pwall:.3f} s wall, device busy "
            f"{busy:.4f} s ({100 * busy / pwall:.2f}%); top: "
            + "; ".join(f"{k[:60]} {v * 1e3:.2f} ms" for k, v in top)
            + f" [{card}]")
        for suffix in ("", ".bai", ".sbi"):
            os.remove(busy_out + suffix)
        real = bai_mod.build_bai

        def no_rescan(*a, **kw):
            raise RuntimeError("build_bai called: the co-written .bai "
                               "should serve the query")
        bai_mod.build_bai = no_rescan
        try:
            (res,), qwall = _timed(lambda: QueryEngine(device=dev)
                                   .query_records([QueryRequest(
                                       out, "chr20:20000000-20500000")]))
        finally:
            bai_mod.build_bai = real
        want = _scan_overlaps(out, 0, 20_000_000, 20_500_000)
        check(len(res.records) == want > 0,
              f"the .bai query found {len(res.records)} of {want} records")
        log(f"(b) chr20:20000000-20500000 through the co-written .bai, "
            f"build_bai refused: {len(res.records)} records in {qwall:.3f} "
            f"s, equal to a full scan")

        # (b2) byte identity with the oracle, at a cut depth
        small = os.path.join(work, "small.bam")
        st = synth.write_markdup_bam(small, MKDUP_ORACLE_READS, seed + 1)
        for lf, rm in (("rg", False), ("none", True)):
            a, b = os.path.join(work, "m.bam"), os.path.join(work, "o.bam")
            na, wa = _timed(lambda: markdup_bam_mesh(
                small, a, device=dev, library_from=lf, remove_duplicates=rm,
                round_records=MKDUP_ORACLE_READS // 2))
            nb, wb = _timed(lambda: markdup_bam_oracle(
                small, b, library_from=lf, remove_duplicates=rm))
            check(na == nb == MKDUP_ORACLE_READS - (
                int(st.dup[lf].sum()) if rm else 0), f"(b2) {lf} counts")
            for suffix in ("", ".bai", ".sbi"):
                check(_digest(a + suffix) == _digest(b + suffix),
                      f"(b2) {lf}{suffix} byte-identical to the oracle")
            if not rm:
                check(np.array_equal(_flags_of(a), st.output_flags(lf)),
                      f"(b2) {lf}: every flag equals the truth")
            log(f"(b2) {MKDUP_ORACLE_READS} reads, library_from={lf!r}, "
                f"remove_duplicates={rm}: the pipeline {wa:.3f} s, the "
                f"oracle {wb:.3f} s, {na} records; output, .bai and .sbi "
                f"byte-identical [{card}]")

        rnd = _k16_round(torch, src, dev)
        row_a = _k16a_check_and_time(torch, rnd, card)
        del rnd
        row_b = _k16b_check_and_time(torch, cols_files, dev, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 17 launches: {launches}")
    return {"markdup_columns": row_a, "markdup_exchange_step": row_b}, \
        launches


def mkdup_times(torch, path, dev) -> dict:
    """``--times mkdup``: phase 17 alone."""
    rows, launches = phase_mkdup(torch, path, card_line(), dev, 0)
    return {"K16": rows, "launches": launches}


def _markdup_round_file(path) -> str:
    """A ``MKDUP_ROUND``-read ``write_markdup_bam`` file beside the BAM,
    written by the first timing process and reused by later ones (so
    trees in turns time the same tile)."""
    from hadoop_bam_torch import synth
    src = path[:-len(".bam")] + "_markdup.bam"
    if not os.path.exists(src):
        tmp = f"{src}.{os.getpid()}.tmp"
        synth.write_markdup_bam(tmp, MKDUP_ROUND,
                                int(os.path.basename(path).split("_")[1]))
        os.replace(tmp, src)
    return src


def _this_tree() -> bool:
    """Whether the imported port is the one beside this script (not an
    earlier tree's, ``--tree``)."""
    import hadoop_bam_torch
    here = os.path.dirname(os.path.realpath(__file__))
    return os.path.realpath(os.path.dirname(hadoop_bam_torch.__file__)) \
        == os.path.join(here, "hadoop_bam_torch")


def markdup_cols_times(torch, path, dev) -> dict:
    """``--times markdup_cols``: K16a alone, no pipeline: checked in
    phase 17 (a)'s cases (an earlier tree: the edge rows alone), then
    checked and timed at round 0's tile of ``_markdup_round_file`` and at
    ``_k16_names_tile``, with ``row_bytes`` as the pipeline passes it
    (an earlier tree: as its wrapper launches)."""
    this = _this_tree()
    n = _k16a_cases(torch, dev, this)
    card = card_line()
    out = {"tiles_checked": n}
    for key, rnd in (
            ("K16a", lambda: _k16_round(torch, _markdup_round_file(path),
                                        dev, hint=this)),
            ("K16a, 30-40-byte names",
             lambda: _k16_names_tile(torch, dev, hint=this))):
        out[key] = _k16a_check_and_time(torch, rnd(), card)
    return out


# a read probe, no part of the port: the 16-byte words sel[0 .. n_sel) of
# each of R rows (at most 32), a warp a row
_ROW_PROBE_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
// warp w reads rows w, w + warps, ...: lane k < n_sel the 16-byte word
// sel[k] of the row, four rows in flight a warp
__global__ void __launch_bounds__(256)
row_probe(const uint4* __restrict__ rows, int64_t R, int64_t wpr,
          const int* __restrict__ sel, int n_sel, unsigned* sink) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const bool on = lane < n_sel;
  const int w = on ? __ldg(sel + lane) : 0;
  uint32_t x = 0;
  int64_t r = warp;
  for (; r + 3 * warps < R; r += 4 * warps) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = on ? __ldg(rows + (r + u * warps) * wpr + w)
                : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < 4; ++u) x ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  for (; r < R; r += warps) {
    const uint4 v = on ? __ldg(rows + r * wpr + w) : make_uint4(0u, 0u, 0u, 0u);
    x ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (x == 0x9E3779B9u) sink[0] = x;   // keeps the loads
}
extern "C" int hbam_row_probe(const void* rows, int64_t R, int64_t wpr,
                              const void* sel, int n_sel, void* sink,
                              int blocks, void* stream) {
  row_probe<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), R, wpr, static_cast<const int*>(sel),
      n_sel, static_cast<unsigned*>(sink));
  return static_cast<int>(cudaGetLastError());
}
"""


def _row_probe(torch):
    """``_ROW_PROBE_SRC`` built by ``_nvcc_lib``: a call (rows, words)
    reading those 16-byte words of every row."""
    import ctypes
    from hadoop_bam_torch.ops import kernels
    fn = _nvcc_lib("row_probe", _ROW_PROBE_SRC).hbam_row_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def reader(rows, words):
        check(len(words) <= 32, "the probe reads at most 32 words a row")
        sel = torch.tensor(sorted(words), dtype=torch.int32, device="cuda")
        R, stride = rows.shape

        def call():
            rc = fn(rows.data_ptr(), R, stride // 16, sel.data_ptr(),
                    sel.numel(), sink.data_ptr(), sms * 8,
                    torch.cuda.current_stream().cuda_stream)
            kernels.check_launch("row_probe", rc)
        return call
    return reader


def markdup_floor_times(torch, path, dev) -> dict:
    """``--times markdup_floor``: the memory system under K16a at round
    0's tile of ``_markdup_round_file``: the time to read chosen 16-byte words of every row
    with coalesced loads (``_ROW_PROBE_SRC``, no part of the port), for
    the words of the 32-byte sectors K16a reads from a typical row (its
    fixed fields', its CIGAR's, its quality run's), for the 128-byte
    lines those lie in, for every word of the row, and for the fixed
    fields' sector alone; K16a itself before and after.  Each by events
    over calls in a row, with its bytes and rate."""
    import numpy as np
    from hadoop_bam_torch.prep import markdup as md
    rnd = _k16_round(torch, _markdup_round_file(path), dev)
    rows, count, R, stride = rnd["rows"], rnd["count"], rnd["R"], rnd["stride"]
    # a typical row: the median record's CIGAR and quality run
    head = rows[:count].cpu().numpy()
    lrn = head[:, 12].astype(np.int64)
    nc = head[:, 16:18].copy().view("<u2").ravel().astype(np.int64)
    ls = head[:, 20:24].copy().view("<i4").ravel().astype(np.int64)
    q0 = 36 + lrn + 4 * nc + (ls + 1) // 2
    m = int(np.argsort(q0)[count // 2])
    spans = [(4, 32), (36 + lrn[m], 36 + lrn[m] + 4 * nc[m]),
             (q0[m], q0[m] + ls[m])]

    def words(grain):
        out = set()
        for a, b in spans:
            for g in range(int(a) // grain, (int(b) - 1) // grain + 1):
                out.update(range(g * grain // 16, (g + 1) * grain // 16))
        return sorted(out)
    reader = _row_probe(torch)
    sets = {"K16a's sectors": words(32), "their 128-byte lines": words(128),
            "every word": list(range(stride // 16)),
            "the fixed fields' sector": [0, 1]}
    lib, kmax = rnd["lib"], rnd["kmax"]
    out = {"card": card_line(), "R": R, "stride": stride,
           "typical_row": {"spans": [[int(a), int(b)] for a, b in spans]}}
    k16a = [lambda: md.markdup_columns(rows, count, lib, kmax, **rnd["kw"])]
    out["K16a ms"] = [loop_ms(torch, k16a, reps=32)]
    for name, w in sets.items():
        call = reader(rows, w)
        ms_ = statistics.median(loop_ms(torch, [call], reps=32)
                                for _ in range(3))
        nbytes = 16 * len(w) * R
        out[name] = {"words": w, "bytes": nbytes, "ms": ms_,
                     "TB/s": nbytes / ms_ / 1e9}
        log(f"row probe, {name} ({len(w)} words a row): {nbytes} B in "
            f"{ms_:.4f} ms, {nbytes / ms_ / 1e9:.3f} TB/s [{card_line()}]")
    out["K16a ms"].append(loop_ms(torch, k16a, reps=32))
    log(f"K16a at the same tile: {out['K16a ms']} ms by events in a row")
    return out


COHORT_SAMPLES = 2504        # phase 18: 1000 Genomes phase 3's sample count
COHORT_SITES = 200           # the joined grid's sites (the depth, cut)
COHORT_SLICES = 200          # phase 18 (c): warm gene-sized slices


def _k17a_cases(torch, dev) -> float:
    """K17a against its plain version on the card in every
    ``synth.GWAS_CASES`` case, twice each: AF and call rate bit for bit,
    HWE and score within rtol 1e-5, atol 1e-6.  Returns the largest
    absolute difference over the cases' defined values."""
    import numpy as np
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.cohort.gwas import (
        cohort_gwas_plain, cohort_gwas_step,
    )
    worst = 0.0
    for name in synth.GWAS_CASES:
        d, count, pheno, S = synth.gwas_case(name)
        dt = torch.from_numpy(d).to(dev)
        pt = None if pheno is None else torch.from_numpy(pheno).to(dev)
        ct = torch.tensor([count], dtype=torch.int32, device=dev)
        for _ in range(2):
            got = cohort_gwas_step(dt, ct, pt, S).cpu().numpy()
            want = cohort_gwas_plain(dt, ct, pt, S).cpu().numpy()
            check(np.array_equal(got[..., :2], want[..., :2],
                                 equal_nan=True),
                  f"K17a AF and call rate bit-equal to plain ({name})")
            check(np.array_equal(np.isnan(got), np.isnan(want)),
                  f"K17a NaNs where plain's are ({name})")
            check(np.allclose(got[..., 2:], want[..., 2:], rtol=1e-5,
                              atol=1e-6, equal_nan=True),
                  f"K17a HWE and score within rtol 1e-5, atol 1e-6 of "
                  f"plain ({name})")
            ok = ~np.isnan(want)
            if ok.any():
                worst = max(worst, float(np.abs(got - want)[ok].max()))
    return worst


def _k17_kernel() -> str:
    """The profiler's name of the imported tree's cohort kernel: the row
    kernel K17a and K17b both launch, or an earlier tree's
    ``cohort_stats_kernel`` (whose K17b was that kernel and torch ops)."""
    from hadoop_bam_torch.ops import kernels
    return ("cohort_rows_kernel" if "cohort_slice" in kernels.KERNELS
            else "cohort_stats_kernel")


def _k17b_hold(torch, got, want, what) -> float:
    """K17b against its plain version: keep, hits and af_n exactly, af
    bit for bit, af_sum within rtol 1e-6.  Returns af_sum's absolute
    difference."""
    import numpy as np
    names = ("keep", "hits", "af", "af_sum", "af_n")
    g = dict(zip(names, (x.cpu() for x in got)))
    w = dict(zip(names, (x.cpu() for x in want)))
    for k in names:
        check(g[k].dtype == w[k].dtype and g[k].shape == w[k].shape,
              f"K17b {k} of plain's dtype and shape ({what})")
    for k in ("keep", "hits", "af_n"):
        check(torch.equal(g[k], w[k]), f"K17b {k} equals plain's ({what})")
    check(torch.equal(g["af"].view(torch.int32), w["af"].view(torch.int32)),
          f"K17b af bit-equal to plain's ({what})")
    check(np.allclose(g["af_sum"].numpy(), w["af_sum"].numpy(), rtol=1e-6,
                      atol=0.0),
          f"K17b af_sum within rtol 1e-6 of plain's ({what})")
    return float((g["af_sum"] - w["af_sum"]).abs().max())


def _k17b_cases(torch, dev) -> float:
    """K17b against ``cohort_slice_plain`` on the card in every
    ``synth.SLICE_CASES`` case, twice each (the ticket is back at zero
    between launches).  Returns the largest af_sum difference."""
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.cohort.serving import (
        cohort_slice_plain, cohort_slice_step,
    )
    worst = 0.0
    for name in synth.SLICE_CASES:
        tile = [torch.from_numpy(a).to(dev) for a in synth.slice_case(name)]
        for _ in range(2):
            worst = max(worst, _k17b_hold(torch, cohort_slice_step(*tile),
                                          cohort_slice_plain(*tile), name))
    return worst


def _serve_tile(torch, dev, count=200, cap=4096, spad=2504, seed=0):
    """The serve's tile [1, 4,096, 2,504] with ``count`` live rows, built
    here so that every tree times the same inputs: sorted positions on
    two contigs, diploid dosages with ~10% of calls missing and ~5% of
    rows uncalled, rows past the count -1; and an interval on contig 0
    keeping a quarter of the live rows."""
    import numpy as np
    rng = np.random.default_rng(seed)
    chrom = np.full((1, cap), -1, np.int32)
    pos = np.zeros((1, cap), np.int32)
    chrom[0, :count] = np.sort(rng.integers(0, 2, count))
    pos[0, :count] = rng.integers(1, 60_000_000, count)
    pos[0, :count] = pos[0, np.lexsort((pos[0, :count], chrom[0, :count]))]
    p = rng.uniform(0.0, 0.6, cap)[:, None]
    d = ((rng.random((cap, spad)) < p).astype(np.int8)
         + (rng.random((cap, spad)) < p).astype(np.int8))
    d[rng.random((cap, spad)) < 0.1] = -1
    d[rng.random(cap) < 0.05] = -1
    d[count:] = -1
    on0 = np.sort(pos[0, :count][chrom[0, :count] == 0])
    iv = [0, int(on0[len(on0) // 4]), int(on0[len(on0) // 2])]
    tile = tuple(torch.from_numpy(a).to(dev) for a in (
        chrom, pos, d[None], np.asarray([count], np.int32)))
    return tile, torch.tensor(iv, dtype=torch.int32, device=dev)


def _k17a_bytes(count: int, spad: int, cap: int, pheno: bool) -> int:
    """K17a's bytes: the dosage of the rows under the count read once
    (the kernel reads no row past it), the phenotype and the count, 16
    bytes a row written."""
    return count * spad + (4 * spad if pheno else 0) + 4 + 16 * cap


def _k17b_bytes(count: int, spad: int, cap: int) -> int:
    """K17b's bytes: the dosage and the chrom / pos of the rows under the
    count read once (the kernel reads no row past it), the count and
    interval; keep and af of every row and the three sums written once."""
    return count * spad + 8 * count + 4 + 12 + cap + 4 * cap + 12


def _flushed_ms(torch, call, flush) -> float:
    """Device ms of a call with L2 flushed before each launch by a 64 MB
    write, by the profiler: every kernel of the call but the flush's fill
    (NaN without a session that recorded every launch)."""
    split = kernel_split(torch, [lambda: (flush.zero_(), call())], reps=16,
                         kernel=_k17_kernel())
    return (sum(v for k, v in split.items() if "FillFunctor" not in k)
            if split else float("nan"))


def _flush_buffer(torch, dev):
    """64 MB rewritten before each launch of a flushed timing: more than
    the 50 MB L2, which the 8.4 MB tiles otherwise stay in."""
    return torch.empty(16 << 20, dtype=torch.float32, device=dev)


def _k17a_times(torch, dosage, count, pheno, S, what, card,
                flush=None) -> dict:
    """K17a timed at one tile: device time, calls in a row, with L2
    flushed before each launch (``flush`` given), the plain version's
    time and the bound."""
    from hadoop_bam_torch.cohort.gwas import (
        cohort_gwas_plain, cohort_gwas_step,
    )
    _, cap, spad = dosage.shape
    ct = torch.tensor([count], dtype=torch.int32, device=dosage.device)
    calls = [lambda: cohort_gwas_step(dosage, ct, pheno, S)]
    ms_ = device_ms(torch, calls, kernel=_k17_kernel())
    ms_by = device_ms.how
    looped = loop_ms(torch, calls)
    flushed = (_flushed_ms(torch, calls[0], flush) if flush is not None
               else None)
    plain_ms = device_ms(torch, [lambda: cohort_gwas_plain(
        dosage, ct, pheno, S)], reps=8)
    nbytes = _k17a_bytes(count, spad, cap, pheno is not None)
    bound = nbytes / H100_BYTES_PER_S * 1e3
    log(f"K17a at {what} [1, {cap}, {spad}], {count} rows, "
        f"{'a' if pheno is not None else 'no'} phenotype: {ms_:.4f} ms by "
        f"{ms_by}, {looped:.4f} ms a call in a row by events"
        + (f", {flushed:.4f} ms a call with L2 flushed" if flushed else "")
        + f", plain {plain_ms:.4f} ms, bound {bound:.6f} ms = {nbytes} B / "
        f"3.35 TB/s, {100 * bound / ms_:.1f}% of it [{card}]")
    return {"ms": ms_, "ms_by": ms_by, "loop_ms": looped,
            "flushed_ms": flushed, "plain_ms": plain_ms, "bound_ms": bound,
            "nbytes": nbytes, "shape": f"[1, {cap}, {spad}], {count} rows"}


def _k17b_times(torch, tile, iv, card, flush=None) -> dict:
    """K17b timed at the serve's tile: device time, in one CUDA graph, in
    a row, with L2 flushed before each launch (``flush`` given), its
    plain version's time and the bound."""
    from hadoop_bam_torch.cohort.gwas import cohort_gwas_plain
    from hadoop_bam_torch.cohort.serving import (
        cohort_slice_step, slice_of_af,
    )
    chrom, pos, dosage, count = tile
    _, cap, spad = dosage.shape
    n = int(count[0])
    calls = [lambda: cohort_slice_step(chrom, pos, dosage, count, iv)]
    # a tree whose K17b was K17a and torch ops: with no whole profiler
    # session, one CUDA graph
    ms_ = device_ms(torch, calls, reps=16, kernel=_k17_kernel())
    ms_by = device_ms.how
    graphed = graph_ms(torch, calls, reps=16)
    looped = loop_ms(torch, calls)
    flushed = (_flushed_ms(torch, calls[0], flush) if flush is not None
               else None)
    # the plain version (``cohort_slice_plain``, spelled out for trees
    # before it)
    plain_ms = device_ms(torch, [lambda: slice_of_af(
        chrom, pos, count, iv,
        cohort_gwas_plain(dosage, count, None, spad)[..., 0])], reps=8)
    nbytes = _k17b_bytes(n, spad, cap)
    bound = nbytes / H100_BYTES_PER_S * 1e3
    log(f"K17b (cohort_slice_step) at the serve's tile [1, {cap}, {spad}], "
        f"{n} rows: {ms_:.4f} ms by {ms_by}, {graphed:.4f} ms a call in one "
        f"CUDA graph, {looped:.4f} ms a call in a row by events"
        + (f", {flushed:.4f} ms a call with L2 flushed" if flushed else "")
        + f", plain {plain_ms:.4f} ms, bound {bound:.6f} ms = {nbytes} B / "
        f"3.35 TB/s [{card}]")
    return {"ms": ms_, "ms_by": ms_by, "loop_ms": looped, "graph_ms": graphed,
            "flushed_ms": flushed, "plain_ms": plain_ms, "bound_ms": bound,
            "nbytes": nbytes, "shape": f"[1, {cap}, {spad}], {n} rows"}


def _gwas_reference(dosage, pheno):
    """The GWAS columns of the truth tensor ([sites, samples] int8) in
    float64 NumPy (tests/test_cohort.py's formulas, by rows)."""
    import numpy as np
    d = dosage.astype(np.int64)
    called = d >= 0
    nc = called.sum(1)
    alt = np.where(called, d, 0).sum(1)
    with np.errstate(invalid="ignore", divide="ignore"):
        n = [((d == k) & called).sum(1).astype(float) for k in range(3)]
        m = n[0] + n[1] + n[2]
        p = np.where(m > 0, (2 * n[2] + n[1]) / (2 * np.maximum(m, 1)), 0.0)
        exp = ((1 - p) ** 2 * m, 2 * p * (1 - p) * m, p ** 2 * m)
        hwe = sum(np.where(e > 0, (o - e) ** 2 / np.where(e > 0, e, 1), 0.0)
                  for o, e in zip(n, exp))
        hwe = np.where(m > 0, hwe, np.nan)
        use = called & np.isfinite(pheno)[None, :]
        k = use.sum(1).astype(float)
        y = np.where(use, pheno[None, :].astype(float), 0.0)
        g = np.where(use, d, 0).astype(float)
        ybar = y.sum(1) / np.maximum(k, 1)
        gbar = g.sum(1) / np.maximum(k, 1)
        dy = np.where(use, y - ybar[:, None], 0.0)
        dg = np.where(use, g - gbar[:, None], 0.0)
        u = (dy * dg).sum(1)
        vg = (dg * dg).sum(1)
        vy = (dy * dy).sum(1) / np.maximum(k, 1)
        score = np.where((k > 1) & (vy * vg > 1e-12),
                         u * u / np.where(vy * vg > 0, vy * vg, 1), np.nan)
    return nc, alt, hwe, score


def _raise_nofile(need: int) -> None:
    """A k-way merge of ``need`` inputs may hold them open at once: raise
    this process's soft RLIMIT_NOFILE toward its hard limit where it is
    below, and print both."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != resource.RLIM_INFINITY and soft < need:
        new = need if hard == resource.RLIM_INFINITY else min(need, hard)
        resource.setrlimit(resource.RLIMIT_NOFILE, (new, hard))
        log(f"RLIMIT_NOFILE soft {soft} raised to {new} (hard {hard})")
    else:
        log(f"RLIMIT_NOFILE soft {soft}, hard {hard}: enough for {need}")


def phase_cohort(torch, path, card, dev, seed):
    """Phase 18: the cohort plane on cuda:0.  (a) K17a against its plain
    version in every ``synth.GWAS_CASES`` case; (b) ``COHORT_SAMPLES``
    single-sample call sets of ``synth.write_cohort`` (text VCF, BGZF
    VCF, BGZF BCF in turn) over ``COHORT_SITES`` sites, written beside
    the BAM and removed after, through ``open_cohort(manifest).gwas(y)``
    (journaled) equal to the truth and to a NumPy reference, and one pass
    of ``tensor_batches`` (the journal's replay); (c) a ``ServeLoop``
    over the same manifest: one cold slice, ``COHORT_SLICES`` warm
    gene-sized slices and one request over TCP, counts equal to the
    truth's.  K17a timed at the main path's tile and at the full tile,
    K17b at the serve's.  Returns the K17a and K17b rows and their
    launches: K17a's in (b), K17b's in (c)."""
    log("== phase 18: the cohort plane on cuda:0")
    import shutil
    import threading
    import numpy as np
    from hadoop_bam_torch import synth
    from hadoop_bam_torch.cohort import open_cohort
    from hadoop_bam_torch.cohort import gwas as tg
    from hadoop_bam_torch.serve import ServeLoop, make_tcp_server
    from hadoop_bam_torch.utils.metrics import MetricsContext
    from hadoop_bam_torch.cohort import serving as tsv
    _raise_nofile(COHORT_SAMPLES + 256)
    worst = _k17a_cases(torch, dev)
    log(f"(a) K17a bit-equal to its plain version in AF and call rate, HWE "
        f"and score within rtol 1e-5, atol 1e-6 (largest difference "
        f"{worst:.3g}), in the {len(synth.GWAS_CASES)} GWAS_CASES "
        f"({', '.join(synth.GWAS_CASES)}), twice each")
    worst_b = _k17b_cases(torch, dev)
    log(f"(a) K17b equal to cohort_slice_plain (keep, hits, af_n; af bit "
        f"for bit; af_sum within rtol 1e-6, largest difference "
        f"{worst_b:.3g}) in the {len(synth.SLICE_CASES)} SLICE_CASES "
        f"({', '.join(synth.SLICE_CASES)}), twice each")
    for line in kernels_report("cohort_stats"):
        log(f"  ptxas: {line}")
    work = os.path.join(os.path.dirname(os.path.abspath(path)), "phase18")
    shutil.rmtree(work, ignore_errors=True)
    try:
        truth, wall = _timed(lambda: synth.write_cohort(
            work, COHORT_SAMPLES, COHORT_SITES, seed))
        size = sum(os.path.getsize(p) for p in truth.paths)
        n_sites = int(truth.pos.shape[0])
        log(f"(b) {COHORT_SAMPLES} single-sample call sets (text VCF, BGZF "
            f"VCF, BGZF BCF in turn) over {COHORT_SITES} sites in "
            f"{wall:.1f} s, {_mb(size)}: {truth.n_records} records, "
            f"{n_sites} joined sites ({truth.n_multi_sites} multi-allelic), "
            f"{truth.n_swapped} REF/ALT swapped, {truth.n_split} split and "
            f"{truth.n_reversed} reordered multi-allelic records, "
            f"{truth.n_badref} with an indel REF, {truth.n_duplicates} "
            f"duplicate positions, {truth.n_missing_calls} './.' calls")
        rng = np.random.default_rng(seed + 18)
        y = rng.standard_normal(COHORT_SAMPLES).astype(np.float32)
        y[rng.random(COHORT_SAMPLES) < 0.05] = np.nan
        journal = os.path.join(work, "join.hbam-journal")
        # K17a's launches on the GWAS path: set to 0 just before, read
        # just after (the profiled re-run and the timings come later)
        tg.cohort_gwas_step.launches = 0
        with MetricsContext() as mc:
            t0 = time.perf_counter()
            ds = open_cohort(truth.manifest, device=dev,
                             journal_path=journal)
            owall = time.perf_counter() - t0
            res = ds.gwas(y)
            wall = time.perf_counter() - t0
        snap = mc.snapshot()
        launches = {"cohort_gwas_step": tg.cohort_gwas_step.launches}
        check(res["n_variants"] == n_sites, "gwas found every joined site")
        for k in ("chrom", "pos", "n_allele"):
            check(np.array_equal(res[k], getattr(truth, k)),
                  f"gwas {k} equals the generator's")
        nc, alt, hwe, score = _gwas_reference(truth.dosage, y)
        f32 = np.float32
        af = np.where(nc > 0, f32(alt) / (f32(2) * np.maximum(f32(nc), 1)),
                      np.nan).astype(np.float32)
        cr = f32(nc) * (f32(1) / f32(COHORT_SAMPLES))
        check(np.array_equal(res["af"], af, equal_nan=True),
              "gwas AF equals the truth's, bit for bit")
        check(np.array_equal(res["call_rate"], cr),
              "gwas call rate equals the truth's, bit for bit")
        for k, want in (("hwe_chi2", hwe), ("score_chi2", score)):
            check(np.allclose(res[k], want, rtol=2e-4, atol=2e-4,
                              equal_nan=True),
                  f"gwas {k} within rtol 2e-4, atol 2e-4 of the float64 "
                  f"reference")
        walls = snap["wall_timers"]
        log(f"(b) open_cohort(manifest, journal).gwas(y): {wall:.3f} s, "
            f"{n_sites / wall:,.1f} sites/s, {truth.n_records / wall:,.0f} "
            f"sample-records/s; open (headers) {owall:.3f} s, join "
            f"{walls.get('cohort.join_wall', 0):.3f} "
            f"s, K17a spans {walls.get('cohort.kernel_wall', 0):.4f} s, "
            f"copies {walls.get('cohort.dispatch_wall', 0):.4f} s; AF and "
            f"call rate equal to the truth's bit for bit, HWE and score "
            f"within rtol 2e-4 of float64 NumPy on the truth; "
            f"{int(np.isfinite(res['score_chi2']).sum())} score tests "
            f"[{card}]")
        # one dataset over the finished journal for the profiled re-run and
        # the feed: each pass replays the chunks, neither joins again
        ds, owall = _timed(lambda: open_cohort(
            truth.manifest, device=dev, journal_path=journal))
        for _ in range(3):
            # late in a smoke a profiler session now and then records no
            # device event at all: such a reading is not kept
            pwall, busy, by_name = device_busy(torch, lambda: ds.gwas(y))
            if by_name:
                break
            log("(b) the profiler recorded no device event; again")
        if by_name:
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            log(f"(b) gwas again from the journal (no join; opened in "
                f"{owall:.3f} s) profiled: "
                f"{pwall:.3f} s wall, device busy {busy:.4f} s "
                f"({100 * busy / pwall:.2f}% of it, "
                f"{100 * busy / wall:.3f}% of the joined run's wall); top: "
                + "; ".join(f"{k[:60]} {v * 1e3:.3f} ms" for k, v in top)
                + f" [{card}]")
        else:
            log(f"(b) gwas again from the journal (no join; opened in "
                f"{owall:.3f} s): {pwall:.3f} s wall; device busy not "
                f"measured: three profiler sessions recorded no device "
                f"event [{card}]")
        sync(torch, dev)
        t0 = time.perf_counter()
        batches = list(ds.tensor_batches())
        sync(torch, dev)
        bwall = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for b in batches
                     for t in b.values())
        cols = {k: np.concatenate([b[k][0, :int(b["n_records"][0])]
                                   .cpu().numpy() for b in batches])
                for k in ("chrom", "pos", "n_allele", "dosage")}
        for k in ("chrom", "pos", "n_allele"):
            check(np.array_equal(cols[k], getattr(truth, k)),
                  f"tensor_batches {k} equals the generator's")
        check(np.array_equal(cols["dosage"][:, :COHORT_SAMPLES],
                             truth.dosage),
              "tensor_batches dosage equals the generator's")
        log(f"(b) open_cohort(manifest, journal).tensor_batches() (the "
            f"journal's replay): {len(batches)} batches of "
            f"{tuple(batches[0]['dosage'].shape)} in {bwall:.3f} s, "
            f"{len(batches) / bwall:,.1f} batches/s, "
            f"{nbytes / bwall / 1e9:.3f} GB/s delivered; rows equal the "
            f"generator's [{card}]")
        main_tile = batches[0]
        del batches, cols

        # (c) cohort slices served from resident tiles
        names = list(truth.contigs)
        regions = []
        for _ in range(COHORT_SLICES + 1):
            c = int(rng.integers(len(names)))
            span = int(10 ** rng.uniform(4, np.log10(2e6)))
            beg = int(rng.integers(1, synth.COHORT_CONTIGS[c][1] - span))
            regions.append((c, beg, beg + span - 1))
        text = [f"{names[c]}:{b}-{e}" for c, b, e in regions]
        want = [truth.slice_count(c, b, e) for c, b, e in regions]
        # K17b's launches on the serve path: set to 0 just before, read
        # just after the TCP request; the slices launch no K17a
        tg.cohort_gwas_step.launches = 0
        tsv.cohort_slice_step.launches = 0
        with ServeLoop(device=dev) as loop:
            with MetricsContext() as m:
                cold, cwall = _timed(lambda: loop.query(
                    truth.manifest, [text[0]], cohort=True)[0])
            cw = m.snapshot()["wall_timers"]
            check(cold.count == want[0] and cold.tile_misses >= 1,
                  "the cold slice's count equals the truth's")
            check(cold.extra["n_samples"] == COHORT_SAMPLES,
                  "the slice reports the cohort's samples")
            lat, got = [], []
            with MetricsContext() as m:
                t0 = time.perf_counter()
                for r in text[1:]:
                    t1 = time.perf_counter()
                    x = loop.query(truth.manifest, [r], cohort=True)[0]
                    lat.append(time.perf_counter() - t1)
                    got.append((x.count, x.tile_hits, x.tile_misses))
                wwall = time.perf_counter() - t0
            ww = m.snapshot()["wall_timers"]
            check([g[0] for g in got] == want[1:],
                  "every warm slice's count equals the truth's")
            check(all(h >= 1 and ms_ == 0 for _, h, ms_ in got),
                  "every warm slice hit the resident tiles")
            check(ww.get("cohort.join_wall", 0.0) == 0.0
                  and ww.get("pipeline.host_decode_wall", 0.0) == 0.0,
                  "warm slices do no join and no host decode")
            lat = np.asarray(lat)
            from hadoop_bam_torch.cohort import manifest as tman
            man = tman.load_manifest(truth.manifest)
            _, by_path = _timed(lambda: [os.stat(p) for p in truth.paths])
            _, ident = _timed(man.identity)
            log(f"(c) the manifest's identity: {len(truth.paths)} stats "
                f"by path {1e3 * by_path:.3f} ms; the identity (a stat "
                f"relative to each directory opened once) "
                f"{1e3 * ident:.3f} ms")
            log(f"(c) ServeLoop cohort slices: cold {cwall:.3f} s (join "
                f"{cw.get('cohort.join_wall', 0):.3f} s, tile build "
                f"{cw.get('cohort.tile_build_wall', 0):.3f} s); "
                f"{COHORT_SLICES} warm gene-sized slices (10 kb-2 Mb) in "
                f"{wwall:.3f} s, p50 {1e3 * np.percentile(lat, 50):.3f} "
                f"ms, p99 {1e3 * np.percentile(lat, 99):.3f} ms, "
                f"{sum(want[1:])} sites kept; join and host decode 0 s "
                f"on the warm pass, the manifest's identity checks "
                f"{ww.get('cohort.resolve_wall', 0):.3f} s, the slice "
                f"steps {ww.get('cohort.slice_wall', 0):.3f} s [{card}]")
            server = make_tcp_server(loop, port=0)
            host, port = server.server_address[:2]
            th = threading.Thread(target=server.serve_forever, daemon=True)
            th.start()
            try:
                out = {"tcp": []}
                _tcp_lines(host, port, [{
                    "id": 1, "cohort": True, "path": truth.manifest,
                    "regions": text[1:4], "records": True}], out, "tcp")
            finally:
                server.shutdown()
                server.server_close()
                th.join(10)
            doc = out["tcp"][0][1]
            check([r["count"] for r in doc["results"]] == want[1:4]
                  and [len(r["records"]) for r in doc["results"]]
                  == want[1:4],
                  "the TCP request's counts and records equal the truth's")
            log(f"(c) one request of three slices over TCP: counts "
                f"{[r['count'] for r in doc['results']]}, mean AF "
                f"{[r['mean_af'] for r in doc['results']]}, "
                f"{doc['latency_ms']} ms")
            launches["cohort_slice_step"] = tsv.cohort_slice_step.launches
            check(tg.cohort_gwas_step.launches == 0,
                  f"the slices launched K17b alone, no K17a "
                  f"({tg.cohort_gwas_step.launches})")
            tile = None
            for v in loop.tiles._entries.values():
                g = v.groups[0]
                tile = (g.cols[0], g.cols[1], g.cols[3], g.counts)
        check(launches["cohort_gwas_step"] > 0
              and launches["cohort_slice_step"] > 0,
              f"the main path launched K17a and K17b: {launches}")
        log(f"phase 18 launches: K17a {launches['cohort_gwas_step']} in "
            f"(b)'s gwas, K17b {launches['cohort_slice_step']} in (c)'s "
            f"{COHORT_SLICES + 1} slices and TCP request")

        # K17a timed at the main path's tile as the run gave it, and at
        # the full tile of the GWAS_CASES with and without a phenotype
        # (the phenotype's re-reads against the dosage's counting);
        # K17b at the serve's tile
        ypad = torch.from_numpy(y).to(dev)
        flush = _flush_buffer(torch, dev)
        ka = _k17a_times(torch, main_tile["dosage"], int(
            main_tile["n_records"][0]), ypad, COHORT_SAMPLES,
            "the main path's tile", card, flush)
        d, count, pheno, S = synth.gwas_case("main path tile")
        dfull = torch.from_numpy(d).to(dev)
        kf = _k17a_times(torch, dfull, count,
                         torch.from_numpy(pheno).to(dev), S,
                         "the full tile (GWAS_CASES)", card)
        kn = _k17a_times(torch, dfull, count, None, S,
                         "the full tile (GWAS_CASES)", card)
        iv = torch.tensor(regions[1], dtype=torch.int32, device=dev)
        kb = _k17b_times(torch, tile, iv, card, flush)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("no single PyTorch call computes K17a or K17b (library_ms null)")
    row_a = {"name": "cohort_gwas_step", "route": "cuda",
             "source": "hadoop_bam_torch/csrc/cohort_stats.cu",
             "replaces": "hadoop_bam_tpu/cohort/gwas.py:40",
             "max_abs_err": worst, "ms": ka["ms"], "ms_by": ka["ms_by"],
             "loop_ms": ka["loop_ms"], "plain_ms": ka["plain_ms"],
             "bound_ms": ka["bound_ms"], "bound_by": "bytes",
             "library_ms": None, "main_path_shape": ka["shape"],
             "full_tile_shape": kf["shape"], "full_tile_ms": kf["ms"],
             "full_tile_plain_ms": kf["plain_ms"],
             "full_tile_bound_ms": kf["bound_ms"],
             "full_tile_no_pheno_ms": kn["ms"],
             "full_tile_no_pheno_bound_ms": kn["bound_ms"],
             "flushed_ms": ka["flushed_ms"],
             "launches_of": "cohort_gwas_step in (b)'s gwas"}
    row_b = {"name": "cohort_slice_step", "route": "cuda",
             "form": "CUDA C++",
             "source": "hadoop_bam_torch/csrc/cohort_stats.cu",
             "replaces": "hadoop_bam_tpu/cohort/serving.py:79",
             "max_abs_err": worst_b, "ms": kb["ms"], "ms_by": kb["ms_by"],
             "loop_ms": kb["loop_ms"], "plain_ms": kb["plain_ms"],
             "bound_ms": kb["bound_ms"], "bound_by": "bytes",
             "library_ms": None, "main_path_shape": kb["shape"],
             "flushed_ms": kb["flushed_ms"],
             "launches_of": "cohort_slice_step in (c)'s slice steps"}
    return {"cohort_gwas_step": row_a, "cohort_slice_step": row_b}, launches


def cohort_times(torch, path, dev) -> dict:
    """``--times cohort``: phase 18 alone."""
    rows, launches = phase_cohort(torch, path, card_line(), dev, 0)
    return {"K17": rows, "launches": launches}


# variants of csrc/cohort_stats.cu timed by ``--times cohort_stats`` (no
# part of the port): name -> [(text of the source, its replacement)];
# a name starting "probe:" takes a part out to time the rest (its outputs
# are not checked)
_K17_VARIANTS = {
    "8 warps a CTA (4 CTAs an SM)": [
        ("constexpr int kWarps = 16;", "constexpr int kWarps = 8;"),
        ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 4)")],
    "32 warps a CTA (1 CTA an SM)": [
        ("constexpr int kWarps = 16;", "constexpr int kWarps = 32;"),
        ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
    "the phenotype read from its vector (not staged)": [
        ("constexpr int kStageMax = 9000;", "constexpr int kStageMax = 8;")],
    "no fast 0 / 1 / 2 sums (the general sums every word)": [
        ("      if (!__any_sync(kAll, big != 0u)) {", "      if (false) {")],
    "SWAR by __vcmpges4 / __vcmpeq4 / __popc (the first design's counts)": [
        ("      if (!__any_sync(kAll, big != 0u)) {", "      if (false) {"),
        ('  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(0u), '
         '"r"(0xBA98u));',
         "  r = ~__vcmpges4(x, 0u);"),
        ("  const uint32_t s80 =\n"
         "      ~(((x & 0x7C7C7C7Cu) + 0x7C7C7C7Cu) | x) & 0x80808080u;\n"
         "  const uint32_t s1 = s80 >> 7;\n"
         "  const uint32_t lo = x & (s1 * 3u);\n"
         "  a.ns = __dp4a(static_cast<int>(s1), 0x01010101, a.ns);\n"
         "  a.s1 = __dp4a(static_cast<int>(lo), 0x01010101, a.s1);\n"
         "  a.s2 = __dp4a(static_cast<int>(lo), static_cast<int>(lo), a.s2);\n"
         "  a.n3 = __dp4a(static_cast<int>(lo & (lo >> 1) & 0x01010101u), "
         "0x01010101,\n                a.n3);",
         "  const int e0 = __popc(__vcmpeq4(x, 0u)) >> 3;\n"
         "  const int e1 = __popc(__vcmpeq4(x, 0x01010101u)) >> 3;\n"
         "  const int e2 = __popc(__vcmpeq4(x, 0x02020202u)) >> 3;\n"
         "  a.ns += e0 + e1 + e2;\n  a.s1 += e1 + 2 * e2;\n"
         "  a.s2 += e1 + 4 * e2;")],
    "2^23 + byte floats and a saturated 'called'": [
        ("    const float t = (neg >> (8 * k)) & 1u ? 0.0f : y[k];",
         "    const float b = __int_as_float(static_cast<int>(\n"
         "        __byte_perm(xc | neg, 0x4B00u, 0x5440u | k)));\n"
         "    const float t = __fmul_rn(\n"
         "        __saturatef(__fsub_rn(8388736.0f, b)), y[k]);"),
        ("    a.sgy = __fmaf_rn(static_cast<float>((xc >> (8 * k)) & 0xFFu), "
         "y[k],\n                      a.sgy);",
         "    a.sgy = __fmaf_rn(__fsub_rn(b, 8388608.0f), t, a.sgy);")],
    "probe: return after reading the count": [
        ("  const int32_t c_raw = __ldg(a.count);\n",
         "  const int32_t c_raw = __ldg(a.count);\n"
         "  if (c_raw != -7) return;\n")],
    "probe: no dosage loads (made-up words)": [
        ("__ldg(words + wi)", "make_uint2(0x00010200u ^ wi, 0x02000100u)")],
    "probe: no phenotype loads (made-up values)": [
        ("    p0 = pheno4(a.pheno, 2 * threadIdx.x);\n"
         "    q0 = pheno4(a.pheno, 2 * threadIdx.x + 1);",
         "    p0 = make_float4(0.5f, -1.0f, 2.0f, 0.25f);\n"
         "    q0 = make_float4(1.5f, -0.5f, 0.75f, 3.0f);")],
    "probe: no formulas or row writes": [
        ("    if (!on || lane != 0) continue;",
         "    if (!on || lane != 0 || acc.unc != -2147483647) continue;")]}


@contextlib.contextmanager
def _k17_variant(name, edits):
    """One ``_K17_VARIANTS`` entry built by ``_nvcc_lib``, its entry
    points put in place of the port's while the block runs, so that
    ``cohort_gwas_step`` and ``cohort_slice_step`` launch it (with
    per-stream scratches of its own; the launch counts restored after)."""
    import ctypes

    import torch

    from hadoop_bam_torch.cohort import gwas as tg
    from hadoop_bam_torch.cohort import serving as tsv
    from hadoop_bam_torch.ops import kernels
    with open(os.path.join(kernels.CSRC, "cohort_stats.cu")) as f:
        src = f.read()
    for old, new in edits:
        check(src.count(old) >= 1, f"variant {name!r}: {old!r} in the source")
        src = src.replace(old, new)
    stem = "cohort_variant_" + "".join(ch if ch.isalnum() else "_"
                                       for ch in name)[:40]
    lib = _nvcc_lib(stem, src)
    swap = {}
    for k in ("cohort_stats", "cohort_slice", "cohort_slice_slots"):
        symbol, argtypes = kernels.KERNELS[k][:2]
        fn = getattr(lib, symbol)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        swap[k] = fn
    kept = ({k: kernels.kernel(k) for k in swap}, dict(tsv._SLICE_SCRATCH),
            tg.cohort_gwas_step.launches, tsv.cohort_slice_step.launches)
    kernels._fns.update(swap)
    tsv._SLICE_SCRATCH.clear()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        kernels._fns.update(kept[0])
        tsv._SLICE_SCRATCH.clear()
        tsv._SLICE_SCRATCH.update(kept[1])
        tg.cohort_gwas_step.launches, tsv.cohort_slice_step.launches = kept[2:]


def _k17_host_us(torch, dev, dosage, pheno, S, tile, iv) -> dict:
    """Host microseconds a call (400 calls, no synchronisation between
    them, so the launches queue and the card never holds the host back)
    of K17a's and K17b's wrappers."""
    from hadoop_bam_torch.cohort.gwas import cohort_gwas_step
    from hadoop_bam_torch.cohort.serving import cohort_slice_step
    ct = torch.tensor([200], dtype=torch.int32, device=dev)

    def host_us(fn, n=400):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        return us
    out = {"cohort_gwas_step": host_us(
               lambda: cohort_gwas_step(dosage, ct, pheno, S)),
           "cohort_slice_step": host_us(
               lambda: cohort_slice_step(*tile, iv))}
    log("host us a call: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in out.items()))
    return out


def _k17_timing_inputs(torch, dev):
    """The inputs every ``--times cohort_*`` reading times: the serve's
    tile and interval (``_serve_tile``), the full GWAS tile
    (``synth.gwas_case("main path tile")``, in every tree) with its
    phenotype and sample count, the L2 flush, and K17a's three shapes
    (name, live rows, phenotype)."""
    from hadoop_bam_torch import synth
    tile, iv = _serve_tile(torch, dev)
    d, _, pheno, S = synth.gwas_case("main path tile")
    dfull = torch.from_numpy(d).to(dev)
    ypad = torch.from_numpy(pheno).to(dev)
    shapes = (("K17a, full tile, phenotype", 3352, ypad),
              ("K17a, full tile, no phenotype", 3352, None),
              ("K17a, main path's 200 rows, phenotype", 200, ypad))
    return tile, iv, dfull, ypad, S, _flush_buffer(torch, dev), shapes


def cohort_stats_times(torch, path, dev) -> dict:
    """``--times cohort_stats``: K17a and K17b alone.  Checked in phase 18
    (a)'s cases (an earlier tree: K17a's cases, K17b at its timing tile),
    then timed at the full GWAS tile (``synth.gwas_case("main path
    tile")``) with and without its phenotype, at that tile with the main
    path's 200 live rows, and K17b at the serve's tile with 200 live rows
    (``_serve_tile``): by the profiler, in a row by events and with L2
    flushed before each launch; and each wrapper's host time."""
    from hadoop_bam_torch.cohort.gwas import cohort_gwas_plain
    from hadoop_bam_torch.cohort.serving import cohort_slice_step, slice_of_af
    this = _this_tree()
    card = card_line()
    out = {"card": card, "K17a cases max abs err": _k17a_cases(torch, dev)}
    if this:
        out["K17b cases max af_sum err"] = _k17b_cases(torch, dev)
    tile, iv, dfull, ypad, S, flush, shapes = _k17_timing_inputs(torch, dev)
    chrom, pos, d, n = tile
    # the plain version (``cohort_slice_plain``, spelled out for trees
    # before it)
    _k17b_hold(torch, cohort_slice_step(*tile, iv), slice_of_af(
        chrom, pos, n, iv, cohort_gwas_plain(d, n, None, d.shape[-1])[..., 0]),
        "the serve's timing tile")
    for what, n, y in shapes:
        out[what] = _k17a_times(torch, dfull, n, y, S, "the full GWAS tile",
                                card, flush)
    out["K17b, serve's tile, 200 rows"] = _k17b_times(torch, tile, iv, card,
                                                      flush)
    out["host us a call"] = _k17_host_us(torch, dev, dfull, ypad, S, tile,
                                         iv)
    return out


def cohort_variants_times(torch, path, dev) -> dict:
    """``--times cohort_variants``: the ``_K17_VARIANTS`` of this tree's
    source, launched through the port's wrappers, each checked against
    the plain versions (probes not) and timed at ``--times
    cohort_stats``' four tiles, by the profiler, in a row and with L2
    flushed."""
    import numpy as np
    from hadoop_bam_torch.cohort.gwas import (
        cohort_gwas_plain, cohort_gwas_step,
    )
    from hadoop_bam_torch.cohort.serving import (
        cohort_slice_plain, cohort_slice_step,
    )
    card = card_line()
    tile, iv, dfull, ypad, S, flush, shapes = _k17_timing_inputs(torch, dev)
    out = {"card": card}
    for name, edits in _K17_VARIANTS.items():
        probe = name.startswith("probe:")
        row = {}
        with _k17_variant(name, edits):
            for what, n, y in shapes:
                ct = torch.tensor([n], dtype=torch.int32, device=dev)
                got = cohort_gwas_step(dfull, ct, y, S).cpu().numpy()
                want = cohort_gwas_plain(dfull, ct, y, S).cpu().numpy()
                check(probe or (np.array_equal(got[..., :2], want[..., :2],
                                               equal_nan=True)
                                and np.allclose(got[..., 2:], want[..., 2:],
                                                rtol=1e-5, atol=1e-6,
                                                equal_nan=True)),
                      f"variant {name!r} equals plain at {what}")
                calls = [lambda: cohort_gwas_step(dfull, ct, y, S)]
                row[what] = {
                    "ms": device_ms(torch, calls, kernel=_k17_kernel()),
                    "ms_by": device_ms.how, "loop_ms": loop_ms(torch, calls),
                    "flushed_ms": _flushed_ms(torch, calls[0], flush)}
            if not probe:
                _k17b_hold(torch, cohort_slice_step(*tile, iv),
                           cohort_slice_plain(*tile, iv),
                           f"variant {name!r}")
            calls = [lambda: cohort_slice_step(*tile, iv)]
            row["K17b, serve's tile, 200 rows"] = {
                "ms": device_ms(torch, calls, reps=16, kernel=_k17_kernel()),
                "ms_by": device_ms.how, "loop_ms": loop_ms(torch, calls),
                "flushed_ms": _flushed_ms(torch, calls[0], flush)}
        log(f"variant {name}: " + "; ".join(
            f"{k} {v['ms']:.4f} ms ({v['flushed_ms']:.4f} flushed)"
            for k, v in row.items()) + f" [{card}]")
        out[name] = row
    return out


TIMES = {"walk_records_device": k9_times, "resolve_pack": k7_times,
         "payload_gather": k10p_times, "device_plane": device_plane_times,
         "native_plane": native_plane_times, "k2_window": k2_window_times,
         "bai_regions": bai_regions_times,
         "coverage_query": coverage_query_times,
         "serve_tiles": serve_tiles_times,
         "interval_chain": interval_chain_times,
         "interval_floor": interval_floor_times,
         "variant_gt": variant_gt_times, "variant_floor": variant_floor_times,
         "variant_plane": variant_plane_times,
         "sort_query": sort_query_times, "mkdup": mkdup_times,
         "markdup_cols": markdup_cols_times,
         "markdup_floor": markdup_floor_times, "cohort": cohort_times,
         "cohort_stats": cohort_stats_times,
         "cohort_variants": cohort_variants_times}


def check_truth(flag, stats, truth) -> None:
    import numpy as np
    check(flag == truth.flagstat, f"flagstat {flag} != {truth.flagstat}")
    check(stats["n_reads"] == truth.n_reads, "seq_stats n_reads")
    check(np.array_equal(stats["base_hist"], truth.base_hist),
          "seq_stats base_hist")
    for k in ("mean_gc", "mean_qual"):
        rel = abs(stats[k] - getattr(truth, k)) / abs(getattr(truth, k))
        check(rel <= 1e-6, f"seq_stats {k} rel err {rel} <= 1e-6")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--times", choices=sorted(TIMES), default=None,
                    help="only build, then check and time this kernel at "
                    "its shapes; print them as one JSON line")
    ap.add_argument("--tree", action="append", default=[],
                    help="with --times: import hadoop_bam_torch from this "
                    "checkout (an earlier tree, timed on the same inputs); "
                    "with --turns: one of the trees timed in turns")
    ap.add_argument("--turns", type=int, default=0,
                    help="rounds of the native plane's times in turns "
                    "with each --tree")
    args = ap.parse_args(argv)
    if args.tree and not (args.times or args.turns):
        ap.error("--tree needs --times or --turns")
    if args.times and len(args.tree) > 1:
        ap.error("--times takes one --tree")
    if args.turns and (args.times or not args.tree):
        ap.error("--turns needs --tree and no --times")
    if args.times and args.tree:
        sys.path.insert(0, os.path.abspath(args.tree[0]))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import hadoop_bam_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_env(torch)
    if args.turns:
        print(json.dumps({"card": card, "turns": native_turns(args)}))
        return 0
    phase_build(force=not args.times)
    path, truth = make_bam(args)
    dev = torch.device("cuda", 0)
    if args.times:
        import hadoop_bam_torch
        print(json.dumps({"tree": os.path.dirname(hadoop_bam_torch.__file__),
                          "card": card, "kernel": args.times,
                          "times": TIMES[args.times](torch, path, dev)}))
        return 0
    k1 = phase_k1(torch, path, dev)
    k2 = phase_k2(torch, path, dev)
    native_launches, native_walls = phase_main(torch, path, truth, card, dev)
    k7 = phase_k7(torch, path, dev)
    k9 = phase_k9(torch, path, dev)
    k10 = phase_k10p(torch, path, dev)
    rows = {"unpack_fixed_fields": k1, "seq_qual_stats": k2,
            "resolve_pack": k7, "walk_records_device": k9,
            "payload_gather": k10}
    phase_plane_shapes(torch, path, dev, rows)
    device_launches, device_walls, plan_s = phase_device_main(
        torch, path, truth, card, dev, native_walls)
    interval_walls = {}
    resilience_launches = phase_resilience(torch, path, truth, card, dev,
                                           native_walls, args.seed,
                                           interval_walls)
    sorted_oracle = {}
    planning_launches, srt, srt_truth = phase_planning(
        torch, path, truth, card, dev, args, native_walls, device_walls,
        plan_s, interval_walls, sorted_oracle)
    reads_launches, k2_window = phase_reads(torch, path, truth, card, dev,
                                            args, native_walls)
    steps, served = phase_coverage_query(torch, path, truth, card, dev, args,
                                         srt, srt_truth, native_walls)
    k10i, serve_launches, tile_filter = phase_serve(
        torch, path, card, dev, args.seed, srt, srt_truth, served)
    rows["interval_cols"] = k10i
    variant_files = {}
    k11, variant_launches, k14 = phase_variant(torch, path, card, dev,
                                               args.seed, keep=variant_files)
    rows.update(k11)
    k15, sort_launches = phase_sort_query(torch, path, card, dev, args.seed,
                                          variant_files, sorted_oracle)
    rows["mesh_sort_step"] = k15
    k16, mkdup_launches = phase_mkdup(torch, path, card, dev, args.seed)
    rows.update(k16)
    k17, cohort_launches = phase_cohort(torch, path, card, dev, args.seed)
    rows.update(k17)
    rows["seq_qual_stats"].update(k2_window)
    for name, x in list(rows.items()) + [
            ("seq_qual_stats at the window shape",
             k2_window["window_shape"])]:
        # the profiler's reading against this process's event timing of
        # the same calls back to back (an upper bound) and the bound
        log(f"{name}: {x['ms']:.4f} ms by {x.get('ms_by', 'device_ms')}, "
            f"{x['loop_ms']:.4f} ms a call in a row by events, bound "
            f"{x['bound_ms']:.4f} ms")
        check(x["bound_ms"] <= x["ms"] <= 1.2 * x["loop_ms"],
              f"{name}: device_ms's {x['ms']:.4f} ms lies between the "
              f"bound and the back-to-back event time")
    counted = set(_wrappers())   # the kernels every earlier path counts
    for name, row in rows.items():
        def on(launches):
            # K10i runs on the serve path alone: the earlier paths' counts
            # do not hold it
            return launches[name] if name in counted else 0
        by_path = {"native": native_launches.get(name, 0),
                   "device": on(device_launches),
                   "resilience": on(resilience_launches),
                   "planning": on(planning_launches),
                   "reads": on(reads_launches),
                   "serve": serve_launches.get(name, 0),
                   "variant": variant_launches.get(name, 0),
                   "sort": sort_launches.get(name, 0),
                   "mkdup": mkdup_launches.get(name, 0),
                   "cohort": cohort_launches.get(name, 0)}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    steps["K13 rest (tile_filter_step)"] = dict(
        tile_filter, launches=serve_launches["tile_filter_step"])
    steps["K14 (variant_tile_stats)"] = k14
    log(f"torch-op steps of phases 13-15 (no hand kernel): "
        f"{json.dumps(steps)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
