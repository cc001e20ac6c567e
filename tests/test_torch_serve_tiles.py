"""The serve tiles' device build against the JAX package's, on the CPU:
K10i's plain version (``interval_cols_plain``, and the whole step
``resolve_walk_intervals`` on CPU tensors) against JAX's
``resolve_walk_intervals`` on natively tokenized chunks of a BAM with
clips, indels, N skips, =/X, '*' CIGARs, unmapped reads, a 65-op read
(``over``) and a read at pos 2^31 - 2, and against the reference's
formula on random inputs; then the device-plane serve (every kernel's
plain version) against JAX's device-plane serve, and a ``device.step``
fault demoting to the host build with the same counts in both packages.

Tolerances: every output is an integer and must match exactly.  Each
test starts from reset metrics, flight recorders, registries, chaos
points and background queues in both packages."""
import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_bam_tpu.config import DEFAULT_CONFIG as JCONFIG
from hadoop_bam_tpu.formats.bam import SAMHeader
from hadoop_bam_tpu.formats.sam import SamRecord
from hadoop_bam_tpu.ops import inflate_device as jid
from hadoop_bam_tpu.ops.unpack_bam import unpack_fixed_fields_tile
from hadoop_bam_tpu.utils import metrics as jmetrics
from hadoop_bam_torch.config import HBamConfig
from hadoop_bam_torch.ops import inflate_device as tid
from hadoop_bam_torch.parallel.pipeline import _tokenize_span_tokens
from hadoop_bam_torch.split.planners import plan_bam_spans, read_bam_span
from hadoop_bam_torch.utils.metrics import MetricsContext, base_metrics

I32_MAX = 2 ** 31 - 1


@pytest.fixture(autouse=True)
def _clean():
    from hadoop_bam_tpu import resilience as jres
    from hadoop_bam_tpu.obs import flight as jflight
    from hadoop_bam_tpu.resilience import chaos as jchaos
    from hadoop_bam_tpu.utils import pools as jpools
    from hadoop_bam_torch import resilience as tres
    from hadoop_bam_torch.obs import flight as tflight
    from hadoop_bam_torch.resilience import chaos as tchaos
    from hadoop_bam_torch.utils import pools as tpools

    def reset():
        for m in (base_metrics(), jmetrics.base_metrics()):
            m.reset()
        for mod in (tflight, jflight, tres, jres):
            mod.reset()
        for mod in (tchaos, jchaos):
            mod.clear_fault_points()
        for mod in (tpools, jpools):
            mod.cancel_background()
    reset()
    yield
    reset()


# ---------------------------------------------------------------------------
# a BAM of every CIGAR shape
# ---------------------------------------------------------------------------

_QUERY_OPS = set("MIS=X")


def _cigar(rng: random.Random):
    """A random CIGAR of 1-12 ops over every kind, and its query length
    (M/I/S/=/X consume bases; H clips only at the ends)."""
    n = rng.randint(1, 12)
    ops = []
    for i in range(n):
        op = rng.choice("MMMMIDNS=X")
        if op == "S" and 0 < i < n - 1:
            op = "M"
        ln = rng.randint(50, 5000) if op == "N" else rng.randint(1, 40)
        ops.append((ln, op))
    if rng.random() < 0.2:
        ops = [(rng.randint(1, 30), "H")] + ops
    if not any(op in "M=X" for _, op in ops):
        ops.append((10, "M"))
    qlen = sum(ln for ln, op in ops if op in _QUERY_OPS)
    return "".join(f"{ln}{op}" for ln, op in ops), qlen


@pytest.fixture(scope="module")
def cigar_bam(tmp_path_factory):
    """A BAM (not sorted; no index needed) of 3,000 reads on chr1 (LN
    2^31 - 1) and chr2: mixed CIGARs, '*' CIGARs on mapped reads,
    unmapped reads, a 65-op read and a read at pos 2^31 - 2 (0-based)."""
    from hadoop_bam_tpu.formats.bamio import BamWriter

    rng = random.Random(12)
    text = ("@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:chr1\tLN:2147483647\n"
            "@SQ\tSN:chr2\tLN:1000000\n")
    header = SAMHeader(text=text, ref_names=["chr1", "chr2"],
                       ref_lengths=[I32_MAX, 1_000_000])
    recs = []
    for i in range(3000):
        kind = rng.random()
        rname = rng.choice(["chr1", "chr2"])
        pos = rng.randint(1, 900_000)
        if kind < 0.03:                     # unmapped, at its mate's place
            cigar, qlen, flag = "*", rng.randint(20, 150), 4
        elif kind < 0.06:                   # mapped with a '*' CIGAR
            cigar, qlen, flag = "*", rng.randint(0, 150), 0
        else:
            (cigar, qlen), flag = _cigar(rng), rng.choice([0, 16, 99, 147])
        if i == 1500:
            cigar, qlen = "1M1I" * 32 + "1M", 65        # 65 ops
            flag = 0
        if i == 2999:
            rname, pos, cigar, qlen, flag = "chr1", I32_MAX, "151M", 151, 0
        seq = "".join(rng.choice("ACGT") for _ in range(qlen)) or "*"
        qual = "".join(chr(33 + rng.randint(0, 40))
                       for _ in range(qlen)) or "*"
        recs.append(SamRecord(qname=f"r{i:05d}", flag=flag, rname=rname,
                              pos=pos, mapq=30, cigar=cigar, seq=seq,
                              qual=qual))
    path = str(tmp_path_factory.mktemp("ttiles") / "cig.bam")
    with BamWriter(path, header) as w:
        for r in recs:
            w.write_sam_record(r)
    return path


def _chunks(path, num_spans):
    """Native token chunks of the BAM's spans as the device plane ships
    them: [B, P] uint32 tokens (B a power of two >= 8), counts, sizes,
    start, stop; and the span."""
    out = []
    for span in plan_bam_spans(path, num_spans=num_spans):
        c = _tokenize_span_tokens(path, span)
        if c is None or c.used < c.n_blocks:
            continue
        B = tid.round_pow2(c.used, 8)
        tok = np.zeros((B, c.P), np.uint32)
        tok[:c.used] = c.tokens
        nt = np.zeros(B, np.int32)
        iz = np.zeros(B, np.int32)
        nt[:c.used], iz[:c.used] = c.n_tokens, c.isize
        out.append((tok, nt, iz, c.start, c.stop, c.P, span))
    return out


def _host_columns(path, span):
    """(rid, pos1, end1) of the span's records by the host decode (the
    query engine's chunk columns)."""
    b = read_bam_span(path, span)
    pos1 = b.pos.astype(np.int64) + 1
    end1 = pos1 + np.maximum(b.reference_span(), 1) - 1
    return (b.refid.astype(np.int32), np.minimum(pos1, I32_MAX),
            np.minimum(end1, I32_MAX))


@pytest.mark.parametrize("num_spans", [1, 4])
def test_k10i_step_matches_jax_on_native_chunks(cigar_bam, num_spans):
    chunks = _chunks(cigar_bam, num_spans)
    assert chunks
    overs, edge = 0, False
    for tok, nt, iz, start, stop, P, span in chunks:
        want = jid.resolve_walk_intervals(
            jnp.asarray(tok), jnp.asarray(nt), jnp.asarray(iz),
            jnp.int32(start), jnp.int32(stop))
        args = [torch.from_numpy(a) for a in (tok.view(np.int32), nt, iz)]
        got = tid.resolve_walk_intervals(*args, start, stop, P)
        plain = tid.resolve_walk_intervals_plain(*args, start, stop, P)
        for g, p, w in zip(got, plain, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(p.numpy(), np.asarray(w))
        n = int(got[3])
        overs += int(got[6])
        if not int(got[6]) and not int(got[5]) and int(got[4]) >= stop:
            # the chunk's columns are the host decode's
            host = _host_columns(cigar_bam, span)
            for g, h in zip(got[:3], host):
                np.testing.assert_array_equal(g.numpy()[:n], h)
        pos1 = got[1].numpy()[:n]
        if (pos1 == I32_MAX).any():
            edge = True
            assert (got[2].numpy()[:n][pos1 == I32_MAX] == I32_MAX).all()
        # rows past the walk hold the tile pads
        assert (got[0].numpy()[n:] == -1).all()
        assert not got[1].numpy()[n:].any() and not got[2].numpy()[n:].any()
    assert overs >= 1 and edge


def _jax_interval_formula(buf, offs, n_all, cap):
    """hadoop_bam_tpu/ops/inflate_device.py:359-386 as written there, on a
    given buffer and walk offsets (the reference computes them inside its
    jitted step): the prefix gathered with the clip, then the interval."""
    L = buf.shape[0]
    R = offs.shape[0]
    buf, offs = jnp.asarray(buf), jnp.asarray(offs)
    idx = jnp.clip(offs[:, None] + jnp.arange(36, dtype=jnp.int32)[None, :],
                   0, L - 1)
    cols = unpack_fixed_fields_tile(buf[idx])
    n_cigar, l_seq = cols["n_cigar"], cols["l_seq"]
    valid = jnp.arange(R, dtype=jnp.int32) < jnp.minimum(n_all, R)
    over = jnp.any(valid & (n_cigar > cap)).astype(jnp.int32)
    cig_off = offs + 36 + cols["l_read_name"]
    k = jnp.arange(cap, dtype=jnp.int32)[None, :]
    widx = cig_off[:, None] + 4 * k
    b = [buf[jnp.clip(widx + j, 0, L - 1)].astype(jnp.uint32)
         for j in range(4)]
    word = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
    op = (word & 0xF).astype(jnp.int32)
    oplen = (word >> 4).astype(jnp.int32)
    consumes = ((op == 0) | (op == 2) | (op == 3) | (op == 7) | (op == 8))
    act = k < jnp.minimum(n_cigar, cap)[:, None]
    cig_span = jnp.sum(jnp.where(act & consumes, oplen, 0), axis=1)
    ref_span = jnp.where(n_cigar > 0, cig_span, jnp.maximum(l_seq, 0))
    imax = jnp.int32(I32_MAX)
    pos1 = jnp.minimum(cols["pos"], imax - 1) + 1
    end1 = pos1 + jnp.minimum(jnp.maximum(ref_span, 1) - 1, imax - pos1)
    return (jnp.where(valid, cols["refid"], -1),
            jnp.where(valid, pos1, 0), jnp.where(valid, end1, 0), over)


@pytest.mark.parametrize("n_all", [-1, 0, 1, 300, 1024, 1500])
def test_interval_cols_plain_matches_reference_formula(n_all):
    """Records' prefixes written into random bytes at every offset residue
    mod 4 (``synth.interval_rows``): CIGAR words of every op with lengths
    whose int32 sum wraps, n_cigar 0, the cap and one past it, pos at the
    int32 edges, prefixes cut by either end, past both ends or wrapping
    int32, CIGARs cut by the end."""
    from hadoop_bam_torch.synth import interval_rows
    R = 1024
    buf, offs, edges = interval_rows(1 << 15, R, seed=n_all + 7, over=True)
    want = _jax_interval_formula(buf, offs, n_all, 64)
    got = tid.interval_cols(torch.from_numpy(buf), torch.from_numpy(offs),
                            torch.tensor([n_all], dtype=torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # row R // 2 has cap + 1 ops (an edge row's clipped bytes may too)
    assert int(got[3]) >= int(n_all > R // 2)
    assert len(edges["prefix"]) == 9 and len(edges["cigar"]) == 4


# offsets whose 36-byte prefix runs off the buffer's start, its end, or
# past int32: the reference clips each index, K1 wraps a negative one by
# L (and sums in int64, so it never wraps past int32)
_CUT = [-40, -24, -13, -1, "L - 23", "L - 12", "L - 1", "L + 40",
        I32_MAX - 19]


@pytest.mark.parametrize("at", _CUT)
def test_interval_cols_prefix_off_either_end_takes_the_clip(at):
    from hadoop_bam_torch.ops.unpack_bam import unpack_fixed_fields_plain
    from hadoop_bam_torch.synth import interval_rows
    L, R = 1 << 13, 256
    buf, offs, _ = interval_rows(L, R, seed=11)
    o = L + int(at[1:].replace(" ", "")) if isinstance(at, str) else at
    offs[:R // 2:7] = o
    for n_all in (R, 7):
        want = _jax_interval_formula(buf, offs, n_all, 64)
        got = tid.interval_cols(torch.from_numpy(buf),
                                torch.from_numpy(offs), n_all)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # where K1's rule reads other bytes 4-23, the columns follow the clip
    clip = tid._prefix_columns(torch.from_numpy(buf), torch.from_numpy(offs))
    wrap = unpack_fixed_fields_plain(torch.from_numpy(buf),
                                     torch.from_numpy(offs))
    differs = any(
        (clip[k][0] != wrap[k][0].to(torch.int64)).item()
        for k in ("refid", "pos", "l_read_name", "n_cigar", "l_seq"))
    assert differs == (o + 4 < 0 or o + 23 > I32_MAX)


def test_interval_cols_refuses_bad_arguments():
    buf = torch.zeros(64, dtype=torch.uint8)
    col = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tid.interval_cols(buf, col.to(torch.int64), 4)
    with pytest.raises(ValueError):
        tid.interval_cols(buf.to(torch.int32), col, 4)
    with pytest.raises(ValueError):
        tid.interval_cols(buf, col, 4, cap=-1)
    with pytest.raises(ValueError):
        tid.interval_cols(buf, col.reshape(2, 2), 4)


# ---------------------------------------------------------------------------
# the device-plane serve, against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sorted_cigars(tmp_path_factory):
    from hadoop_bam_torch.split.bai import write_bai
    from hadoop_bam_torch.synth import write_coverage_bam
    path = str(tmp_path_factory.mktemp("ttiles") / "cov.bam")
    write_coverage_bam(path, 6_000, seed=3, span=200_000)
    write_bai(path)
    return path


_REGIONS = ["chr20:1-40000", "chr20:90000-90500", "chr21"]


def _serve_both(path, regions, **kw):
    from hadoop_bam_tpu.serve import ServeLoop as JServeLoop
    from hadoop_bam_torch.serve import ServeLoop
    jcfg = dataclasses.replace(JCONFIG, serve_prefetch=False, **kw)
    tcfg = HBamConfig(serve_prefetch=False, **kw)
    with MetricsContext() as m, ServeLoop(config=tcfg, device="cpu") as t:
        got = t.query(path, regions)
    with jmetrics.MetricsContext() as jm, JServeLoop(config=jcfg) as j:
        want = j.query(path, regions)
    return got, want, m, jm


def test_device_plane_serve_matches_jax(sorted_cigars):
    got, want, m, jm = _serve_both(sorted_cigars, _REGIONS,
                                   inflate_backend="device")
    assert [r.count for r in got] == [r.count for r in want]
    assert [r.n_candidates for r in got] == [r.n_candidates for r in want]
    assert sum(r.count for r in got) > 0
    assert m.get("serve.device_tile_builds") == \
        jm.get("serve.device_tile_builds") > 0
    # the device build never decoded on the host
    assert m.get("query.chunks_decoded") == 0
    assert m.timers.get("pipeline.inflate", 0.0) == 0.0
    assert m.wall_calls["serve.device_resolve_wall"] > 0
    # and the native plane serves the same counts
    native, _, _, _ = _serve_both(sorted_cigars, _REGIONS,
                                  inflate_backend="native")
    assert [r.count for r in native] == [r.count for r in got]
    assert [r.n_candidates for r in native] == \
        [r.n_candidates for r in got]


def test_device_step_fault_demotes_to_host_build(sorted_cigars):
    from hadoop_bam_tpu.resilience import chaos as jchaos
    from hadoop_bam_torch.resilience import chaos as tchaos
    clean, _, _, _ = _serve_both(sorted_cigars, _REGIONS,
                                 inflate_backend="native")
    with tchaos.fault_points_on("device.step", [tchaos.PointFault(
            "transient", at_call=0)]), \
            jchaos.fault_points_on("device.step", [jchaos.PointFault(
                "transient", at_call=0)]):
        got, want, m, jm = _serve_both(sorted_cigars, _REGIONS,
                                       inflate_backend="device")
    assert [r.count for r in got] == [r.count for r in want] == \
        [r.count for r in clean]
    assert m.get("resilience.demotions") == \
        jm.get("resilience.demotions") == 1
    assert m.get("query.chunks_decoded") == \
        jm.get("query.chunks_decoded") == 1
    assert m.get("serve.device_tile_builds") == \
        jm.get("serve.device_tile_builds")


def test_kernel_failure_in_a_device_build_raises(sorted_cigars,
                                                 monkeypatch):
    """A kernel that fails to build or launch is the port's own fault:
    the serve loop raises it instead of moving the chunk to the host."""
    from hadoop_bam_torch.ops.kernels import KernelLaunchError
    from hadoop_bam_torch.serve import ServeLoop
    from hadoop_bam_torch.serve import loop as serve_loop

    def broken(*a, **k):
        raise KernelLaunchError("interval_cols launch failed: CUDA error 9")

    monkeypatch.setattr(serve_loop, "device_build_chunk", broken)
    cfg = HBamConfig(serve_prefetch=False, inflate_backend="device")
    with MetricsContext() as m, ServeLoop(config=cfg, device="cpu") as t:
        with pytest.raises(KernelLaunchError):
            t.query(sorted_cigars, _REGIONS[:1])
    assert m.get("resilience.demotions") == 0
    assert m.get("query.chunks_decoded") == 0
