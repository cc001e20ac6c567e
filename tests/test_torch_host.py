"""Host-side machinery of the PyTorch port, on the CPU: the staging
ring's in-flight rule, configuration carry-over, device defaults, the
kernel/native build errors, and import isolation from JAX."""
import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.parallel import pipeline as jp
import hadoop_bam_torch
from hadoop_bam_torch import config as tconfig
from hadoop_bam_torch.formats.bam import SAMHeader
from hadoop_bam_torch.formats.bamio import BamWriter
from hadoop_bam_torch.parallel import pipeline as tp
from hadoop_bam_torch.parallel.staging import (
    FeedPipeline, StagingRing, TileSpec, bucket_cap,
)
from hadoop_bam_torch.utils.errors import PlanError

PKG_DIR = os.path.dirname(hadoop_bam_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
BLOCKED = ("jax", "jaxlib", "hadoop_bam_tpu")


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """A header-only BAM written by the port's writer."""
    path = str(tmp_path_factory.mktemp("th") / "h.bam")
    header = SAMHeader.from_sam_text("@HD\tVN:1.6\n@SQ\tSN:c1\tLN:1000\n")
    with BamWriter(path, header):
        pass
    return path


class FakeEvent:
    """Stands in for a CUDA event: the copy counts as complete only once
    someone waits for it."""

    def __init__(self):
        self.synced = False

    def synchronize(self):
        self.synced = True


def test_staging_ring_waits_for_in_flight_copy():
    ring = StagingRing(1, 4, [TileSpec((3,), np.uint8)])
    seen = {}
    for _ in range(6):
        slot = ring.lease()
        prev = seen.get(id(slot))
        assert slot.in_flight is None
        if prev is not None:
            assert prev.synced, "slot re-leased before its copy completed"
        ev = FakeEvent()
        slot.in_flight = ev
        seen[id(slot)] = ev
        ring.release(slot)
    assert len(seen) == 2


def test_feed_pipeline_repacks_and_never_reuses_in_flight_slot():
    """Groups carry the concatenated row stream in order; every dispatch
    finds the previous copy out of its slot completed."""
    rng = np.random.default_rng(1)
    spans = [rng.integers(0, 255, (int(n), 5), dtype=np.uint8)
             for n in rng.integers(0, 40, 30)]
    fp = FeedPipeline(1, 64, [TileSpec((5,), np.uint8)], block_n=8)
    last_event = {}
    got = []
    lock = threading.Lock()

    def dispatch(tensors, counts):
        t = tensors[0]
        key = t.data_ptr()
        with lock:
            prev = last_event.get(key)
            assert prev is None or prev.synced
            got.append(t[0, :int(counts[0])].numpy().copy())
            ev = FakeEvent()
            last_event[key] = ev
        return ev

    groups = fp.feed(((s,) for s in spans), dispatch)
    assert groups == len(got) >= 2
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.concatenate(spans))


def test_bucket_cap_matches_jax():
    from hadoop_bam_tpu.parallel.staging import bucket_cap as jax_bucket
    for count in (0, 1, 255, 256, 4095, 4096, 4097, 16384, 65535, 65536):
        assert bucket_cap(count, 1 << 16) == jax_bucket(count, 1 << 16)


def _named(d):
    """A config dict with each enum value (the quality encodings) as its
    name: the two packages' enums are different classes."""
    import enum
    return {k: v.name if isinstance(v, enum.Enum) else v
            for k, v in d.items()}


def test_config_and_geometry_from_jax_dicts():
    cfg = tconfig.config_from_dict(dataclasses.asdict(JAX_CONFIG))
    assert cfg == tconfig.HBamConfig(inflate_backend="auto")
    assert tconfig.resolve_inflate_backend(cfg) == "native"
    # every field the port carries has the reference's default
    ref = _named(dataclasses.asdict(JAX_CONFIG))
    assert {k: ref[k] for k in tconfig.CARRIED} == \
        _named(dataclasses.asdict(cfg))
    assert (cfg.fastq_base_quality_encoding.name,
            cfg.qseq_base_quality_encoding.name) == ("SANGER", "ILLUMINA")
    assert (cfg.span_retries, cfg.adaptive_planes) == (2, True)
    # the planning and fused-decode settings, at the reference's defaults
    assert (cfg.split_size, cfg.use_splitting_index,
            cfg.keep_paired_reads_together, cfg.use_fused_decode,
            cfg.decode_chunk_blocks) == (128 << 20, True, False, True, 32)
    z = dataclasses.replace(JAX_CONFIG, inflate_backend="zlib",
                            check_crc=True, decode_pool_workers=3,
                            span_retries=5, adaptive_planes=False,
                            max_bad_span_fraction=0.25,
                            breaker_cooldown_s=0.5, chaos_seed=11,
                            split_size=1 << 20, use_splitting_index=False,
                            keep_paired_reads_together=True,
                            use_fused_decode=False, decode_chunk_blocks=7,
                            fastq_base_quality_encoding=type(
                                JAX_CONFIG.fastq_base_quality_encoding)
                            .ILLUMINA, fastq_filter_failed_qc=True,
                            qseq_filter_failed_qc=True)
    cfg = tconfig.config_from_dict(dataclasses.asdict(z))
    assert (cfg.fastq_base_quality_encoding, cfg.fastq_filter_failed_qc,
            cfg.qseq_filter_failed_qc) == (
        tconfig.BaseQualityEncoding.ILLUMINA, True, True)
    assert (cfg.inflate_backend, cfg.check_crc, cfg.pool_size()) == \
        ("zlib", True, 3)
    assert (cfg.split_size, cfg.use_splitting_index,
            cfg.keep_paired_reads_together, cfg.use_fused_decode,
            cfg.decode_chunk_blocks) == (1 << 20, False, True, False, 7)
    ref = _named(dataclasses.asdict(z))
    assert {k: ref[k] for k in tconfig.CARRIED} == \
        _named(dataclasses.asdict(cfg))
    # the chaos seed is an argument of install_chaos_seeded, not a setting
    assert "chaos_seed" not in tconfig.CARRIED
    assert tconfig.config_from_dict(
        {"inflate_backend": "device"}).inflate_backend == "device"
    with pytest.raises(PlanError):
        tconfig.config_from_dict({"inflate_backend": "gpu"})
    for g in (jp.PayloadGeometry(max_len=100, tile_records=512),
              jp.DecodeGeometry(bytes_cap=1 << 20)):
        tg = tconfig.geometry_from_dict(dataclasses.asdict(g))
        ref = dataclasses.asdict(g)
        assert dataclasses.asdict(tg) == {k: ref[k]
                                          for k in dataclasses.asdict(tg)}
    pg = tconfig.geometry_from_dict(dataclasses.asdict(jp.PayloadGeometry()))
    assert (pg.seq_stride, pg.qual_stride, pg.fixed_shape) == \
        (96, 160, False)
    pg = tconfig.geometry_from_dict(dataclasses.asdict(
        jp.PayloadGeometry(fixed_shape=True)))
    assert pg.fixed_shape is True


@pytest.fixture(scope="module")
def synth_bam(tmp_path_factory):
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path_factory.mktemp("th") / "s.bam")
    truth = write_synthetic_bam(path, 4000, 3, regions=("chr20:1-1000",))
    return path, truth


@pytest.mark.parametrize("field,value", [
    ("bam_intervals", "chr20:1-1000"), ("skip_bad_spans", True),
    ("io_read_retries", 2)])
def test_config_refuses_reference_settings_it_cannot_honour(
        synth_bam, field, value):
    """The port refuses (PlanError) only reference settings it cannot
    honour; ``UNSUPPORTED`` is empty since the failure policy and the
    interval filter were ported.  These three fields, which it used to
    refuse, now carry over beside every other setting, and both drivers
    return what the reference returns with them set."""
    path, truth = synth_bam
    assert tconfig.UNSUPPORTED == {}
    ref = dataclasses.replace(JAX_CONFIG, **{field: value},
                              inflate_backend="zlib", check_crc=True)
    cfg = tconfig.config_from_dict(dataclasses.asdict(ref))
    assert getattr(cfg, field) == value
    assert (cfg.inflate_backend, cfg.check_crc) == ("zlib", True)
    geom = jp.PayloadGeometry(tile_records=1 << 10)
    got = tp.flagstat_file(path, device="cpu", config=cfg)
    assert got == jp.flagstat_file(path, config=ref)
    stats = tp.seq_stats_file(path, device="cpu", config=cfg,
                              geometry=tconfig.geometry_from_dict(
                                  dataclasses.asdict(geom)))
    want = jp.seq_stats_file(path, config=ref, geometry=geom)
    assert stats["n_reads"] == want["n_reads"]
    np.testing.assert_array_equal(stats["base_hist"], want["base_hist"])
    whole = truth.regions[value] if field == "bam_intervals" else truth
    assert got == whole.flagstat and stats["n_reads"] == whole.n_reads
    if field == "bam_intervals":   # the reference reads "" as no filter
        assert tconfig.config_from_dict({field: ""}) == \
            tconfig.HBamConfig(bam_intervals="")
        assert tp.flagstat_file(path, device="cpu", config=tconfig.
                                config_from_dict({field: ""})) == \
            truth.flagstat


def test_entry_points_default_to_cuda_and_never_fall_back(bam, monkeypatch):
    """With no card, an entry point that was not given device="cpu"
    raises instead of moving to the CPU."""
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tp.flagstat_file(bam)
    with pytest.raises(RuntimeError):
        tp.seq_stats_file(bam)
    with pytest.raises(RuntimeError):
        open_bam(bam)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 0)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    from hadoop_bam_torch.utils import native
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "libbroken.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError):
        native.load()


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    from hadoop_bam_torch.ops import kernels
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(os.path, "exists",
                        lambda p, _e=os.path.exists: False
                        if p == "/usr/local/cuda/bin/nvcc" else _e(p))
    with pytest.raises(kernels.KernelBuildError):
        kernels.build(force=True)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="hadoop_bam_torch."))


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where jax, jaxlib
    and hadoop_bam_tpu cannot be imported."""
    mods = _port_modules()
    assert len(mods) >= 20, mods
    for m in ("api.read_datasets", "formats.fastq", "formats.qseq",
              "formats.fasta", "split.read_planners", "split.tabix",
              "split.kmerge", "write.api", "write.parallel_bgzf",
              "write.indexing", "jobs.journal", "jobs.runner",
              "parallel.mesh_sort", "parallel.distributed", "utils.sort",
              "cohort.manifest", "cohort.harmonize", "cohort.join",
              "cohort.dataset", "cohort.gwas", "cohort.serving",
              "plan.ir", "plan.builders"):
        assert f"hadoop_bam_torch.{m}" in mods
    code = f"""
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {BLOCKED!r}:
            raise ImportError('blocked: ' + name)
        return None
sys.meta_path.insert(0, Block())
for m in {mods!r}:
    importlib.import_module(m)
bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}]
assert not bad, bad
print('imported', len({mods!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert f"imported {len(mods)}" in out.stdout


def test_port_sources_never_name_jax():
    """AST scan of the port and chip_smoke.py: no import of the blocked
    packages anywhere, not even inside a function."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 20
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BLOCKED, f"{path}: {n}"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where
    CUDA is absent, and in a directory that holds nothing else."""
    import shutil
    env = {**os.environ, "PYTHONPATH": ""}
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
