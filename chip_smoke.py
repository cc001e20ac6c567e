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
5. the main path: a synthetic paired-end BAM (``--reads`` 151-bp reads,
   made from ``--seed``) through ``open_bam(path).flagstat()``,
   ``.seq_stats()`` and the span-mode ``.flagstat(mode="span")`` on
   cuda:0, checked against the generator's own counts, with each
   kernel's launch count from that run.

The last lines are the kernels' JSON summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


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


def device_ms(torch, calls, reps: int = 32) -> float:
    """Mean device time per call: the CUDA activity (kernels, memsets,
    copies) torch.profiler records over ``reps`` calls, cycling through
    ``calls`` (each over its own copy of the inputs, together larger than
    the 50 MB L2, so every call reads device memory).  Unlike event
    timing around one call, host launch overhead does not count.  Falls
    back to event timing (``time_ms``) when three profiler sessions in a
    row record no device activity, and says so."""
    if not torch.cuda.is_available():
        return float("nan")   # a rehearsal on the CPU measures nothing
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for call in calls:
        call()
    torch.cuda.synchronize()
    for _ in range(3):   # a profiler session now and then records nothing
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                calls[i % len(calls)]()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    log("torch.profiler recorded no device time in 3 sessions: event "
        "timing instead")
    return time_ms(torch, calls[0], torch.empty(
        64 << 20, dtype=torch.uint8, device="cuda"))


def device_busy(torch, fn):
    """(wall s, device-busy s, {kernel name: device s}) of one run of
    ``fn`` under torch.profiler (CUDA activity only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, by_name = 0.0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
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


def phase_build() -> None:
    log("== phase 2: kernel build")
    from hadoop_bam_torch.ops import kernels
    from hadoop_bam_torch.utils import native
    t0 = time.perf_counter()
    kernels.build(force=True)
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
    t0 = time.perf_counter()
    truth = write_synthetic_bam(path, args.reads, args.seed)
    log(f"synthesized {args.reads} reads (seed {args.seed}) -> "
        f"{os.path.getsize(path)} bytes in {time.perf_counter() - t0:.1f} s")
    return path, truth


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
    ms = device_ms(torch, [lambda c=c: unpack_fixed_fields(*c)
                           for c in copies])
    plain_ms = device_ms(torch, [lambda c=c: unpack_fixed_fields_plain(*c)
                                 for c in copies])
    distinct = int(torch.unique(o).numel())
    nbytes = 4 * N + 36 * distinct + 48 * N
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    log(f"K1 device {ms:.4f} ms (plain {plain_ms:.4f} ms; one call timed "
        f"by events incl. launch overhead {ev_ms:.4f} ms), bound "
        f"{bound_ms:.4f} ms = {nbytes} B / 3.35 TB/s; no single PyTorch "
        f"call computes this function (library_ms null)")
    return {"name": "unpack_fixed_fields", "route": "cuda",
            "source": "hadoop_bam_torch/csrc/unpack_bam.cu",
            "replaces": "hadoop_bam_tpu/ops/unpack_bam.py:113",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
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
    ms = device_ms(torch, [lambda c=c: seq_qual_stats(*c) for c in copies])
    plain_ms = device_ms(torch, [lambda c=c: seq_qual_stats_plain(*c)
                                 for c in copies])
    # the same rows through the direct path (rows 1..n of [n + 1, W]
    # copies: base addresses off 16 bytes), and through the TMA rings with
    # every length 0 (the bytes staged, nothing counted)
    off16 = [tuple(t.new_empty((n + 1,) + t.shape[1:])[1:].copy_(t)
                   for t in c) for c in copies]
    direct_ms = device_ms(torch, [lambda c=c: seq_qual_stats(*c)
                                  for c in off16])
    del off16
    staged_ms = device_ms(torch, [lambda c=c: seq_qual_stats(
        c[0], c[1], torch.zeros_like(c[2])) for c in copies])
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
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def phase_main(torch, path, truth, card, dev) -> dict:
    log("== phase 5: main path on cuda:0")
    import numpy as np
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.ops.seq_stats import seq_qual_stats
    from hadoop_bam_torch.ops.unpack_bam import unpack_fixed_fields
    size = os.path.getsize(path)
    ds = open_bam(path) if dev.type == "cuda" else open_bam(path, dev)
    check(ds.device == dev, f"dataset device is {dev}")
    unpack_fixed_fields.launches = 0
    seq_qual_stats.launches = 0
    walls = {}
    t0 = time.perf_counter()
    flag = ds.flagstat()
    walls["flagstat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = ds.seq_stats()
    walls["seq_stats"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flag_span = ds.flagstat(mode="span")
    walls["flagstat_span"] = time.perf_counter() - t0
    launches = {"unpack_fixed_fields": unpack_fixed_fields.launches,
                "seq_qual_stats": seq_qual_stats.launches}
    log(f"launches in the main path: {launches}")
    for name, n in launches.items():
        check(n > 0 or dev.type != "cuda", f"{name} launched on the main path")
    check(flag == truth.flagstat, f"flagstat {flag} != {truth.flagstat}")
    check(flag_span == truth.flagstat, "span-mode flagstat matches")
    check(all(v > 0 for v in flag.values()), "every counter non-zero")
    check(stats["n_reads"] == truth.n_reads, "seq_stats n_reads")
    check(np.array_equal(stats["base_hist"], truth.base_hist),
          "seq_stats base_hist")
    for k in ("mean_gc", "mean_qual"):
        rel = abs(stats[k] - getattr(truth, k)) / abs(getattr(truth, k))
        check(rel <= 1e-6, f"seq_stats {k} rel err {rel} <= 1e-6")
    log(f"flagstat / seq_stats / span flagstat equal the generator's counts "
        f"(mean_gc {stats['mean_gc']:.9f}, mean_qual "
        f"{stats['mean_qual']:.9f})")
    for name, wall in walls.items():
        log(f"{name}: {wall:.3f} s wall, {truth.n_reads / wall:,.0f} reads/s, "
            f"{size / wall / 1e6:.1f} compressed MB/s [{card}]")
    if dev.type == "cuda":
        # a second, profiled run of each driver: the device's busy share
        for name, fn in (("flagstat", ds.flagstat),
                         ("seq_stats", ds.seq_stats),
                         ("flagstat_span",
                          lambda: ds.flagstat(mode="span"))):
            wall, busy, by_name = device_busy(torch, fn)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            k2 = sum(v for k, v in by_name.items() if "seq_stats_kernel" in k)
            log(f"{name} profiled: {wall:.3f} s wall, device busy "
                f"{busy:.4f} s ({100 * busy / wall:.2f}%); K2 {k2 * 1e3:.3f} "
                f"ms; top: "
                + "; ".join(f"{k[:60]} {v * 1e3:.2f} ms" for k, v in top))
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=2_000_000)
    args = ap.parse_args(argv)
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
    phase_build()
    path, truth = make_bam(args)
    dev = torch.device("cuda", 0)
    k1 = phase_k1(torch, path, dev)
    k2 = phase_k2(torch, path, dev)
    launches = phase_main(torch, path, truth, card, dev)
    k1["launches"] = launches["unpack_fixed_fields"]
    k2["launches"] = launches["seq_qual_stats"]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
