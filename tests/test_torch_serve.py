"""The port's resident region server against the JAX package's, on the
CPU: every case of tests/test_serve.py but the CLI verb (the port's CLI
waits for ROADMAP Queue 1 item 12), each run through the port's
``ServeLoop(device="cpu")`` and held to the JAX ``ServeLoop`` and the JAX
engine oracle on the same BAM and index: counts, ``n_candidates`` and
records line for line.  The tile cache's, the ring's and the pools'
unit cases run the port's classes (and the reference's where they
compare).  Cases of the port alone: the fleet refusal, the health
document and the transport's out-of-band ops (a cohort-slice request
among them, whose count equals the oracle join's; the cohort plane's
own cases are tests/test_torch_cohort.py's).

Each test starts from reset metrics, flight recorders, resilience
registries, chaos and background queues in both packages.  Tile
geometry differs (the port holds one device, the reference's CPU mesh
eight), so tile bytes are never compared across packages."""
import concurrent.futures as cf
import dataclasses
import io
import json
import os
import threading
import time

import numpy as np
import pytest

from hadoop_bam_tpu.config import DEFAULT_CONFIG as JCONFIG
from hadoop_bam_tpu.query import (
    QueryEngine as JQueryEngine, QueryRequest as JRequest,
)
from hadoop_bam_tpu.serve import ServeLoop as JServeLoop
from hadoop_bam_tpu.utils import metrics as jmetrics
from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.query import (
    ChunkCache, QueryEngine, QueryRequest, QueryScheduler,
)
from hadoop_bam_torch.serve import ServeLoop, handle_stream
from hadoop_bam_torch.utils.errors import PlanError, TransientIOError
from hadoop_bam_torch.utils.metrics import (
    METRICS, MetricsContext, base_metrics,
)

from fixtures import make_header, make_records


@pytest.fixture(autouse=True)
def _clean():
    from hadoop_bam_tpu import resilience as jres
    from hadoop_bam_tpu.obs import flight as jflight
    from hadoop_bam_tpu.utils import pools as jpools
    from hadoop_bam_tpu.utils import resilient as jrs
    from hadoop_bam_torch import resilience as tres
    from hadoop_bam_torch.obs import flight as tflight
    from hadoop_bam_torch.utils import pools as tpools
    from hadoop_bam_torch.utils import resilient as trs

    def reset():
        for m in (base_metrics(), jmetrics.base_metrics()):
            m.reset()
        for mod in (tflight, jflight):
            mod.reset()
        for mod in (tres, jres):
            mod.reset()
        for mod in (trs, jrs):
            mod.clear_chaos()
        for mod in (tpools, jpools):
            mod.cancel_background()
    reset()
    yield
    reset()


def _cfg(**kw) -> HBamConfig:
    return dataclasses.replace(DEFAULT_CONFIG, **kw)


def _loop(**kw) -> ServeLoop:
    return ServeLoop(config=_cfg(**kw), device="cpu")


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _coord_sorted(header, recs):
    def key(r):
        rid = (header.ref_names.index(r.rname) if r.rname != "*"
               else 1 << 30)
        return (rid, r.pos)
    return sorted(recs, key=key)


def _write_bam(path, header, n, seed):
    from hadoop_bam_tpu.formats.bamio import BamWriter
    from hadoop_bam_tpu.split.bai import write_bai

    recs = _coord_sorted(header, make_records(header, n, seed=seed))
    with BamWriter(path, header) as w:
        for r in recs:
            w.write_sam_record(r)
    write_bai(path)


@pytest.fixture(scope="module")
def served_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tserve") / "s.bam")
    header = make_header(2)
    _write_bam(path, header, 2500, seed=77)
    return path, header


_REGIONS = ["chr1:1000-200000", "chr1:500,000-650,000", "chr2:1-5000",
            "chr2:100000-400000"]


def _oracle(path, regions):
    """The JAX engine's (counts, results)."""
    res = JQueryEngine().query_records([JRequest(path, r) for r in regions])
    return [len(r.records) for r in res], res


def _lines(records):
    return [r.to_line() for r in records]


@pytest.fixture(scope="module")
def jax_served(served_bam):
    """The JAX ServeLoop's answers on the module's BAM: counts,
    candidates and the first two regions' record lines."""
    path, _ = served_bam
    with JServeLoop(config=dataclasses.replace(JCONFIG,
                                               serve_prefetch=False)) as l:
        res = l.query(path, _REGIONS)
        recs = l.query(path, _REGIONS[:2], want_records=True)
    return ([r.count for r in res], [r.n_candidates for r in res],
            [_lines(r.records) for r in recs])


# ---------------------------------------------------------------------------
# tile cache: hits bypass the decode path entirely
# ---------------------------------------------------------------------------

def test_serve_counts_match_engine_oracle(served_bam, jax_served):
    path, _header = served_bam
    want, _ = _oracle(path, _REGIONS)
    j_counts, j_cands, _ = jax_served
    with _loop() as loop:
        res = loop.query(path, _REGIONS)
        assert [r.count for r in res] == want == j_counts
        assert [r.n_candidates for r in res] == j_cands
        assert sum(want) > 0
        assert all(r.n_candidates >= r.count for r in res)
    # the port's engine agrees as well
    t = QueryEngine(device="cpu").query_records(
        [QueryRequest(path, r) for r in _REGIONS])
    assert [len(r.records) for r in t] == want


def test_warm_tile_hits_skip_decode_and_host_work(served_bam):
    path, _header = served_bam
    with _loop(serve_prefetch=False) as loop:
        with MetricsContext() as cold_metrics:
            cold = loop.query(path, _REGIONS)
        assert all(r.tile_misses > 0 for r in cold)
        with MetricsContext() as warm_metrics:
            warm = loop.query(path, _REGIONS)
        assert [r.count for r in warm] == [r.count for r in cold]
        assert all(r.tile_misses == 0 and r.tile_hits > 0 for r in warm)
        snap = warm_metrics.snapshot()
        assert snap["counters"].get("query.chunks_decoded", 0) == 0
        assert snap["timers"].get("pipeline.host_decode", 0.0) == 0.0
        assert snap["timers"].get("pipeline.inflate", 0.0) == 0.0
        assert loop.tiles.stats()["hits"] > 0
        # the cold pass did decode on the host: the warm assertion is
        # not vacuous
        snap = cold_metrics.snapshot()
        assert snap["counters"]["query.chunks_decoded"] > 0
        assert snap["timers"]["pipeline.host_decode"] > 0
        assert snap["timers"]["pipeline.inflate"] > 0
        assert cold_metrics.wall_calls["serve.tile_build_wall"] > 0
        assert warm_metrics.wall_calls["serve.filter_wall"] > 0


def test_records_mode_matches_oracle_byte_identical(served_bam, jax_served):
    path, _header = served_bam
    _want_counts, oracle = _oracle(path, _REGIONS[:2])
    with _loop() as loop:
        loop.query(path, _REGIONS[:2])          # warm the tiles
        res = loop.query(path, _REGIONS[:2], want_records=True)
    with _loop() as cold_loop:
        cold_records = cold_loop.query(path, _REGIONS[:2],
                                       want_records=True)
    for out, want, jlines in zip(res, oracle, jax_served[2]):
        assert _lines(out.records) == _lines(want.records) == jlines
    assert [_lines(r.records) for r in cold_records] == jax_served[2]
    assert sum(len(o.records) for o in res) > 0


def test_tile_invalidation_on_file_change(tmp_path):
    path = str(tmp_path / "inval.bam")
    header = make_header(1)
    region = "chr1:1-1000000"
    _write_bam(path, header, 400, seed=1)
    with _loop() as loop:
        first = loop.query(path, [region], want_records=True)[0]
        assert first.records

        _write_bam(path, header, 150, seed=2)   # replace in place
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))

        second = loop.query(path, [region], want_records=True)[0]
        _counts, oracle = _oracle(path, [region])
        assert _lines(second.records) == _lines(oracle[0].records)
        assert _lines(second.records) != _lines(first.records)
        assert loop.tiles.stats()["invalidated"] > 0


def test_tile_cache_evicts_but_stays_correct(served_bam):
    path, _header = served_bam
    want, _ = _oracle(path, _REGIONS)
    # the budget is half of what the four regions' tiles need at cap
    # 512 on one device, forcing LRU churn
    with _loop(serve_tile_records=512, serve_prefetch=False) as loop:
        loop.query(path, _REGIONS)
        need = loop.tiles.stats()["bytes"]
    with _loop(serve_tile_records=512, serve_tile_cache_bytes=need // 2,
               serve_prefetch=False) as loop:
        for _ in range(3):
            res = loop.query(path, _REGIONS)
            assert [r.count for r in res] == want
        stats = loop.tiles.stats()
        assert stats["evictions"] > 0
        assert stats["bytes"] <= stats["byte_budget"]


@pytest.mark.parametrize("pkg", ["torch", "tpu"])
def test_device_tile_cache_unit_semantics(pkg):
    if pkg == "torch":
        from hadoop_bam_torch.serve import DeviceTileCache
        from hadoop_bam_torch.serve.tiles import TileSet
        from hadoop_bam_torch.utils.errors import PlanError as Err
    else:
        from hadoop_bam_tpu.serve import DeviceTileCache
        from hadoop_bam_tpu.serve.tiles import TileSet
        from hadoop_bam_tpu.utils.errors import PlanError as Err

    def ts(ident, nbytes):
        return TileSet(groups=[], n=0, nbytes=nbytes, ident=ident)

    ident_a = ("/f/a.bam", 10, 111)
    cache = DeviceTileCache(byte_budget=100)
    cache.put((ident_a, "bam", 0, 1, "iv", 8, 64), ts(ident_a, 60))
    cache.put((ident_a, "bam", 2, 3, "iv", 8, 64), ts(ident_a, 30))
    assert len(cache) == 2
    ident_a2 = ("/f/a.bam", 11, 222)
    cache.put((ident_a2, "bam", 0, 1, "iv", 8, 64), ts(ident_a2, 10))
    assert cache.get((ident_a, "bam", 0, 1, "iv", 8, 64)) is None
    assert cache.stats()["invalidated"] == 2
    ident_b = ("/f/b.bam", 1, 1)
    cache.put((ident_b, "bam", 0, 1, "iv", 8, 64), ts(ident_b, 95))
    assert cache.bytes_used <= 100
    cache.put((ident_b, "bam", 9, 9, "iv", 8, 64), ts(ident_b, 1000))
    assert cache.get((ident_b, "bam", 9, 9, "iv", 8, 64)) is None
    assert cache.stats() == {
        "entries": 1, "bytes": 95, "byte_budget": 100, "hits": 0,
        "misses": 2, "evictions": 1, "invalidated": 2, "hit_rate": 0.0}
    with pytest.raises(Err):
        DeviceTileCache(byte_budget=0)


def test_tile_filter_step_matches_the_reference_predicate():
    import torch

    from hadoop_bam_torch.serve.tiles import tile_filter_step
    rng = np.random.default_rng(4)
    cap = 512
    rid = rng.integers(-1, 3, (1, cap)).astype(np.int32)
    pos1 = rng.integers(1, 9000, (1, cap)).astype(np.int32)
    end1 = pos1 + rng.integers(0, 300, (1, cap)).astype(np.int32)
    for count in (cap, 300, 0):
        for iv in ((1, 100, 4000), (0, 1, 2 ** 31 - 1), (2, 8000, 8000)):
            keep, hits = tile_filter_step(
                *(torch.from_numpy(a) for a in (rid, pos1, end1)),
                torch.tensor([count], dtype=torch.int32),
                torch.tensor(iv, dtype=torch.int32))
            valid = np.arange(cap) < count
            want = valid & (rid[0] == iv[0]) & (pos1[0] <= iv[2]) & \
                (end1[0] >= iv[1])
            np.testing.assert_array_equal(keep.numpy()[0], want)
            assert hits.dtype == torch.int32
            assert hits.tolist() == [int(want.sum())]


# ---------------------------------------------------------------------------
# slot pinning: cached device tiles are never aliased by ring reuse
# ---------------------------------------------------------------------------

def test_pinned_slot_leaves_ring_and_is_replenished():
    from hadoop_bam_torch.parallel.staging import StagingRing, TileSpec

    ring = StagingRing(2, 4, [TileSpec((), np.int32)], slots=2)
    cancel = threading.Event()
    a = ring.lease(cancel)
    a.arrays[0][:] = 7
    a.pin()
    a.release()
    assert a.parked
    b = ring.lease(cancel)
    c = ring.lease(cancel)
    assert b is not a and c is not a
    for s in (b, c):
        assert s.arrays[0] is not a.arrays[0]
        s.arrays[0][:] = 123
        s.release()
    for _ in range(6):
        s = ring.lease(cancel)
        assert s is not a and s.arrays[0] is not a.arrays[0]
        s.arrays[0][:] = 9
        s.release()
    assert np.all(a.arrays[0] == 7)
    a.unpin()
    s = ring.lease(cancel)
    assert s is not a
    s.pin()
    s.unpin()
    s.release()
    assert ring.lease(cancel) in (s, b, c)


def test_cached_tiles_survive_ring_churn(served_bam):
    """Snapshot a cached tile's values, push many other queries through
    the same builder ring, and require the snapshot to still match: on
    the CPU a tile IS its slot's memory, so a recycled slot would have
    rewritten it."""
    path, _header = served_bam
    with _loop(serve_prefetch=False, serve_tile_records=256) as loop:
        loop.query(path, [_REGIONS[0]])
        key, tiles = next(iter(loop.tiles._entries.items()))
        snap = [tuple(c.numpy().copy() for c in g.cols)
                for g in tiles.groups]
        assert snap
        for _ in range(2):
            loop.query(path, _REGIONS[1:])
        tiles2 = loop.tiles._entries.get(key)
        assert tiles2 is tiles
        for g, cols in zip(tiles.groups, snap):
            for dev_col, saved in zip(g.cols, cols):
                assert np.array_equal(dev_col.numpy(), saved)


def test_quarantined_chunk_not_cached_as_empty_tile(served_bam):
    from hadoop_bam_torch.utils.resilient import FaultSpec, chaos_on

    path, _header = served_bam
    region = "chr2:100000-400000"
    with _loop(skip_bad_spans=True, span_retries=0,
               serve_prefetch=False) as loop:
        loop.query(path, ["chr1:1-2000"])     # warm metadata cleanly
        with chaos_on(path, [FaultSpec("bitflip", at_read=0, count=64,
                                       xor_mask=0xFF)]):
            faulted = loop.query(path, [region])[0]
        assert faulted.count == 0
        assert METRICS.get("serve.tiles_uncached_quarantine") > 0
        healed = loop.query(path, [region])[0]
        _counts, oracle = _oracle(path, [region])
        assert healed.count == len(oracle[0].records) > 0


# ---------------------------------------------------------------------------
# predictive prefetch
# ---------------------------------------------------------------------------

def test_prefetch_decodes_adjacent_windows(served_bam):
    path, _header = served_bam
    with _loop() as loop:
        loop.query(path, ["chr1:1000-60000"])
        loop.prefetcher.drain()
        assert loop.prefetcher.stats()["issued"] > 0
        assert METRICS.get("serve.prefetch_issued") > 0
        adjacent = "chr1:60001-119001"
        with MetricsContext() as m:
            res = loop.query(path, [adjacent])[0]
            loop.prefetcher.drain()
        assert m.counters.get("serve.prefetch_useful", 0) >= 1
        assert m.counters.get("query.cache_hits", 0) >= 1
        assert m.counters.get("query.chunks_decoded", 0) <= \
            m.counters.get("serve.prefetch_issued", 0)
        assert loop.prefetcher.stats()["useful"] > 0
        _counts, oracle = _oracle(path, [adjacent])
        assert res.count == len(oracle[0].records)


def test_prefetch_disabled_issues_nothing(served_bam):
    path, _header = served_bam
    with _loop(serve_prefetch=False) as loop:
        loop.query(path, ["chr1:1000-60000"])
        loop.prefetcher.drain()
        assert loop.prefetcher.stats()["issued"] == 0


# ---------------------------------------------------------------------------
# background pool priority
# ---------------------------------------------------------------------------

def test_background_submit_never_starves_foreground():
    from hadoop_bam_torch.utils import pools

    pool = cf.ThreadPoolExecutor(max_workers=4)
    release = threading.Event()
    peak = [0]
    running = [0]
    lock = threading.Lock()

    def bg_task():
        with lock:
            running[0] += 1
            peak[0] = max(peak[0], running[0])
        release.wait(5.0)
        with lock:
            running[0] -= 1
        return "bg"

    try:
        bg_futs = [pools.submit(pool, bg_task, priority="bg")
                   for _ in range(6)]
        time.sleep(0.05)
        assert pools.background_limit(pool) == 1
        assert peak[0] <= 1
        assert pools.pool_stats()["bg_queued"] == 5
        t0 = time.perf_counter()
        assert pools.submit(pool, lambda: "fg").result(timeout=2.0) == "fg"
        assert time.perf_counter() - t0 < 1.0
        release.set()
        assert [f.result(timeout=10.0) for f in bg_futs] == ["bg"] * 6
        assert peak[0] <= 1
        assert METRICS.get("pool.bg_submitted") == 6
    finally:
        release.set()
        pool.shutdown(wait=True)


def test_cancel_background_drops_queued_tasks():
    from hadoop_bam_torch.utils import pools

    pool = cf.ThreadPoolExecutor(max_workers=4)
    release = threading.Event()
    try:
        first = pools.submit(pool, release.wait, 5.0, priority="bg")
        time.sleep(0.02)
        queued = [pools.submit(pool, lambda: None, priority="bg")
                  for _ in range(3)]
        cancelled = pools.cancel_background()
        assert cancelled == 3
        assert all(f.cancelled() for f in queued)
        release.set()
        first.result(timeout=5.0)
    finally:
        release.set()
        pool.shutdown(wait=True)


def test_bad_priority_is_plan_error():
    from hadoop_bam_torch.utils import pools

    pool = cf.ThreadPoolExecutor(max_workers=1)
    try:
        with pytest.raises(PlanError):
            pools.submit(pool, lambda: None, priority="urgent")
    finally:
        pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# tenancy: quotas + priority classes
# ---------------------------------------------------------------------------

def test_tenant_quota_sheds_only_the_flooder(served_bam):
    path, _header = served_bam
    with _loop(serve_prefetch=False, serve_tenant_max_in_flight=1,
               serve_tenant_queue_depth=0) as loop:
        loop.query(path, _REGIONS[:2], tenant="B")   # warm
        before_rejects = METRICS.get("query.rejected")
        with loop.tenants.scheduler("A").admit():    # occupy A's slot
            with pytest.raises(TransientIOError) as e:
                loop.submit(path, [_REGIONS[0]], tenant="A")
            assert e.value.retry_after_s == pytest.approx(0.1)
            assert METRICS.get("query.rejected") == before_rejects + 1
            res = loop.query(path, [_REGIONS[1]], tenant="B",
                             deadline_s=30.0)
            assert res[0].tile_hits > 0
        assert loop.query(path, [_REGIONS[0]], tenant="A")


def test_priority_classes_let_interactive_jump_batch(served_bam):
    path, _header = served_bam
    done_order = []
    lock = threading.Lock()

    def mark(tag):
        def _cb(_fut):
            with lock:
                done_order.append(tag)
        return _cb

    n_batch = 24
    with _loop(serve_prefetch=False, serve_tenant_max_in_flight=8,
               serve_tenant_queue_depth=32) as loop:
        loop.query(path, _REGIONS)            # warm
        batch_futs = []
        for i in range(n_batch):
            f = loop.submit(path, [_REGIONS[i % len(_REGIONS)]],
                            tenant="bulk", priority="batch")
            f.add_done_callback(mark(("batch", i)))
            batch_futs.append(f)
        inter = loop.submit(path, [_REGIONS[0]], tenant="web",
                            priority="interactive")
        inter.add_done_callback(mark(("inter", 0)))
        inter.result(timeout=30.0)
        cf.wait(batch_futs, timeout=60.0)
    assert ("inter", 0) in done_order
    assert done_order.index(("inter", 0)) < done_order.index(
        ("batch", n_batch - 1))


def test_unknown_priority_and_empty_regions_are_plan_errors(served_bam):
    path, _header = served_bam
    with _loop() as loop:
        with pytest.raises(PlanError):
            loop.submit(path, [_REGIONS[0]], priority="vip")
        with pytest.raises(PlanError):
            loop.submit(path, [])
        with pytest.raises(PlanError):
            loop.submit(path, [_REGIONS[0]], tenant="")


def test_idle_tenant_gates_are_lru_bounded():
    from hadoop_bam_torch.serve import TenantQuotas

    quotas = TenantQuotas(_cfg(serve_max_tenants=4))
    for i in range(16):
        quotas.scheduler(f"tenant-{i}")
    assert len(quotas.stats()) <= 4


def test_tenant_breaker_opens_on_serving_failures(served_bam, tmp_path):
    """A tenant whose requests keep failing (a missing file is PLAN and
    never counts; a corrupt one does) sheds with the breaker's hint while
    another tenant serves."""
    path, _header = served_bam
    bad = str(tmp_path / "bad.bam")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    with open(bad, "wb") as f:
        f.write(bytes(data))
    with open(path + ".bai", "rb") as f, open(bad + ".bai", "wb") as g:
        g.write(f.read())
    with _loop(serve_prefetch=False, breaker_failure_threshold=2.0,
               adaptive_planes=False) as loop:
        with pytest.raises(FileNotFoundError):    # PLAN class
            loop.query(str(tmp_path / "missing.bam"), ["chr1:1-10"],
                       tenant="t")
        assert loop.tenants.breaker("t").state == "closed"
        mid = len(data) // 2
        data[mid:mid + 4000] = bytes(4000)
        with open(bad, "wb") as f:
            f.write(bytes(data))
        for _ in range(2):
            with pytest.raises(Exception):
                loop.query(bad, ["chr1:1-1000000", "chr2"], tenant="t")
        assert loop.tenants.breaker("t").state == "open"
        with pytest.raises(TransientIOError):
            loop.submit(path, [_REGIONS[0]], tenant="t")
        assert METRICS.get("resilience.tenant_shed") == 1
        assert loop.query(path, [_REGIONS[0]], tenant="other")


# ---------------------------------------------------------------------------
# MetricsContext isolation across the shared dispatcher + pool
# ---------------------------------------------------------------------------

def test_metrics_context_isolated_per_client(served_bam):
    path, _header = served_bam
    n_a, n_b = 6, 3
    out = {}

    with _loop(serve_prefetch=False) as loop:
        loop.query(path, _REGIONS)            # warm

        def client(tag, n):
            with MetricsContext() as m:
                for i in range(n):
                    loop.query(path, [_REGIONS[i % len(_REGIONS)]],
                               tenant=tag)
            out[tag] = m

        ta = threading.Thread(target=client, args=("a", n_a))
        tb = threading.Thread(target=client, args=("b", n_b))
        ta.start(); tb.start()
        ta.join(30.0); tb.join(30.0)
        # the process-global series the SLO engine reads got them all
        assert base_metrics().hist_summary("serve.latency_s.a")["count"] \
            == n_a

    assert out["a"].hist_summary("serve.latency_s")["count"] == n_a
    assert out["b"].hist_summary("serve.latency_s")["count"] == n_b
    assert out["a"].counters.get("serve.requests", 0) == n_a
    assert out["b"].counters.get("serve.requests", 0) == n_b


def test_metrics_context_reaches_the_decode_pool(served_bam):
    """A cold request's chunk decodes run on pool threads (the prefetch
    into the host cache): their counters land in the submitter's
    context, not in the process global."""
    path, _header = served_bam
    with _loop() as loop:
        with MetricsContext() as m:
            loop.query(path, ["chr1:1000-60000"])
            loop.prefetcher.drain()
        assert m.counters.get("serve.prefetch_issued", 0) > 0
        assert m.hist_summary("pool.task_run_s")["count"] > 0
        assert m.counters.get("query.chunks_decoded", 0) > \
            base_metrics().get("query.chunks_decoded")


# ---------------------------------------------------------------------------
# ChunkCache: the hammer + single-flight
# ---------------------------------------------------------------------------

def test_chunk_cache_concurrent_hammer():
    cache = ChunkCache(byte_budget=4096)
    n_threads, ops = 8, 400
    errs = []

    def worker(seed):
        rng = np.random.RandomState(seed)
        try:
            for i in range(ops):
                k = ("k", int(rng.randint(0, 64)))
                if rng.rand() < 0.5:
                    cache.get(k)
                else:
                    cache.put(k, bytes(8), nbytes=int(rng.randint(1, 256)))
        except BaseException as e:  # noqa: BLE001 — crosses the thread
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(s,))
               for s in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert errs == []
    stats = cache.stats()
    assert stats["hits"] + stats["misses"] + stats["evictions"] > 0
    assert cache.bytes_used <= 4096
    with cache._lock:
        assert cache._bytes == sum(nb for _v, nb in
                                   cache._entries.values())


def test_chunk_cache_single_flight_coalesces_computes():
    cache = ChunkCache(byte_budget=1 << 20)
    n_threads = 6
    computes = [0]
    barrier = threading.Barrier(n_threads)
    results = []

    def compute():
        computes[0] += 1
        time.sleep(0.05)
        return ({"v": 42}, 64)

    def caller():
        barrier.wait(5.0)
        results.append(cache.get_or_compute(("hot",), compute))

    threads = [threading.Thread(target=caller) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert computes[0] == 1
    assert all(r is results[0] for r in results)
    assert cache.stats()["coalesced"] == n_threads - 1
    out = cache.get_or_compute(("skip",), lambda: ({"empty": True}, None))
    assert out == {"empty": True}
    assert cache.contains(("hot",)) and not cache.contains(("skip",))


def test_single_flight_leader_exception_reaches_waiters():
    cache = ChunkCache(byte_budget=1 << 20)
    gate = threading.Event()
    seen = []

    def compute():
        gate.wait(5.0)
        raise TransientIOError("decode blew up")

    def waiter():
        try:
            cache.get_or_compute(("bad",), compute)
        except TransientIOError as e:
            seen.append(e)

    t1 = threading.Thread(target=waiter)
    t1.start()
    time.sleep(0.05)
    t2 = threading.Thread(target=waiter)
    t2.start()
    time.sleep(0.05)
    gate.set()
    t1.join(5.0); t2.join(5.0)
    assert len(seen) == 2
    assert cache.get_or_compute(("bad",), lambda: ("ok", 8)) == "ok"


# ---------------------------------------------------------------------------
# deadlines: enqueue anchoring + the miss counter
# ---------------------------------------------------------------------------

def test_per_request_deadline_anchored_at_enqueue(served_bam):
    path, _header = served_bam
    sched = QueryScheduler(max_in_flight=1, queue_depth=4)
    engine = QueryEngine(scheduler=sched, device="cpu")
    engine.query_records([QueryRequest(path, _REGIONS[0])])  # warm meta

    release = threading.Event()
    holding = threading.Event()

    def hold_slot():
        with sched.admit():
            holding.set()
            release.wait(5.0)

    t = threading.Thread(target=hold_slot)
    t.start()
    holding.wait(2.0)
    before = METRICS.get("query.deadline_misses")

    def free_later():
        time.sleep(0.3)
        release.set()

    threading.Thread(target=free_later).start()
    with pytest.raises(TransientIOError):
        engine.query_records(
            [QueryRequest(path, _REGIONS[0], deadline_s=0.1)])
    t.join(5.0)
    assert METRICS.get("query.deadline_misses") > before


def test_deadline_rebudget_keeps_anchor():
    from hadoop_bam_torch.query.scheduler import Deadline

    t = [100.0]
    clock = lambda: t[0]
    batch = Deadline(10.0, clock=clock)
    t[0] = 100.4
    req = batch.rebudget(0.5)
    assert req.t_start == batch.t_start
    assert abs(req.remaining() - 0.1) < 1e-9
    t[0] = 100.6
    assert req.expired and not batch.expired
    with pytest.raises(TransientIOError):
        req.check("serve")


def test_serve_job_finishing_late_counts_a_miss(served_bam):
    path, _header = served_bam
    with _loop() as loop:
        loop.query(path, [_REGIONS[0]])
        before = METRICS.get("query.deadline_misses")
        with pytest.raises(TransientIOError):
            loop.query(path, [_REGIONS[0]], deadline_s=0.0)
        assert METRICS.get("query.deadline_misses") > before


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

def _jsonl_lines(path):
    return [
        json.dumps({"id": "q1", "path": path, "regions": _REGIONS[:2]}),
        "this is not json",
        json.dumps({"id": "q2", "path": "/nope.bam",
                    "region": "chr1:1-10"}),
        json.dumps({"id": "q3", "path": path}),       # missing regions
        json.dumps({"id": "q4", "path": path, "region": _REGIONS[2],
                    "tenant": "t", "priority": "batch",
                    "records": True}),
    ]


def test_jsonl_stream_serves_counts_and_errors(served_bam):
    from hadoop_bam_tpu.serve import handle_stream as jhandle_stream

    path, _header = served_bam
    want, _ = _oracle(path, _REGIONS[:2])
    lines = _jsonl_lines(path)
    out, jout = io.StringIO(), io.StringIO()
    with _loop() as loop:
        n = handle_stream(loop, io.StringIO("\n".join(lines) + "\n"), out)
    # the reference without prefetch: no background decode of its own
    # outlives the test in the worker
    with JServeLoop(config=dataclasses.replace(
            JCONFIG, serve_prefetch=False)) as jloop:
        jhandle_stream(jloop, io.StringIO("\n".join(lines) + "\n"), jout)
    assert n == 5
    docs = {d.get("id"): d
            for d in map(json.loads, out.getvalue().splitlines())}
    jdocs = {d.get("id"): d
             for d in map(json.loads, jout.getvalue().splitlines())}
    assert [r["count"] for r in docs["q1"]["results"]] == want
    assert docs["q1"]["latency_ms"] >= 0
    assert docs["q2"]["kind"] == "plan"
    assert docs["q3"]["kind"] == "plan"
    assert docs[2]["kind"] == "plan"
    assert "records" in docs["q4"]["results"][0]
    _w, oracle = _oracle(path, [_REGIONS[2]])
    assert docs["q4"]["results"][0]["records"] == \
        _lines(oracle[0].records)
    # the reference answers every line with the same kinds and results
    assert sorted(docs, key=str) == sorted(jdocs, key=str)
    for k, d in docs.items():
        assert d.get("kind") == jdocs[k].get("kind")
        for r, jr in zip(d.get("results", []), jdocs[k].get("results", [])):
            assert {x: r[x] for x in ("region", "count", "candidates")} == \
                {x: jr[x] for x in ("region", "count", "candidates")}
            assert r.get("records") == jr.get("records")


def test_tcp_transport_round_trip(served_bam):
    import socket

    from hadoop_bam_torch.serve import make_tcp_server

    path, _header = served_bam
    want, _ = _oracle(path, [_REGIONS[0]])
    with _loop() as loop:
        server = make_tcp_server(loop, port=0)
        host, port = server.server_address[:2]
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            with socket.create_connection((host, port), timeout=10) as s:
                req = json.dumps({"id": 1, "path": path,
                                  "region": _REGIONS[0]}) + "\n"
                s.sendall(req.encode())
                s.shutdown(socket.SHUT_WR)
                buf = b""
                s.settimeout(10)
                while b"\n" not in buf:
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
            doc = json.loads(buf.decode().splitlines()[0])
            assert [r["count"] for r in doc["results"]] == want
            assert len(doc["trace"]) == 16
        finally:
            server.shutdown()
            server.server_close()
            t.join(5.0)


def test_out_of_band_ops_health_metrics_and_fleet_answers(served_bam,
                                                          tmp_path):
    from test_cohort import _oracle_join, _serve_fixture
    path, _header = served_bam
    cohort_man, cohort_paths = _serve_fixture(tmp_path)
    _contigs, rows = _oracle_join([str(p) for p in cohort_paths])
    lines = [json.dumps({"id": 1, "path": path, "region": _REGIONS[0],
                         "tenant": "w"}),
             json.dumps({"id": "h", "op": "health"}),
             json.dumps({"id": "m", "op": "metrics"}),
             json.dumps({"id": "p", "op": "metrics",
                         "format": "prometheus"}),
             json.dumps({"id": "hb", "op": "heartbeat", "from": "r2"}),
             json.dumps({"id": "f", "op": "fleet"}),
             json.dumps({"id": "c", "op": "chunk", "path": path, "s": 0,
                         "e": 1}),
             json.dumps({"id": "co", "path": cohort_man,
                         "region": "chr20:1-150", "cohort": True}),
             json.dumps({"id": "dl", "path": path, "region": _REGIONS[0],
                         "deadline_s": 5.0, "enqueue_age_s": 9.0})]
    out = io.StringIO()
    with _loop(serve_prefetch=False) as loop:
        loop.query(path, [_REGIONS[1]])       # metrics to report
        handle_stream(loop, io.StringIO("\n".join(lines) + "\n"), out)
    docs = {d["id"]: d for d in map(json.loads, out.getvalue().splitlines())}
    h = docs["h"]["health"]
    assert h["status"] == "serving" and h["device"] == "cpu"
    assert h["plane"]["plane"] == "native"
    assert h["fleet"] is None and "slo" in h and "pool" in h
    assert docs["m"]["metrics"]["counters"]["serve.requests"] >= 1
    assert "latency/_all" in docs["m"]["slo"]
    assert "hbam_serve_latency_s_count" in docs["p"]["prometheus"]
    assert docs["hb"] == {"id": "hb", "ok": True, "replica": None}
    assert docs["f"] == {"id": "f", "fleet": None}
    assert docs["c"]["kind"] == "plan"
    # a cohort-slice request is served: the oracle join's count
    co = docs["co"]["results"][0]
    assert co["count"] == sum(1 for r in rows
                              if r[0] == 0 and 1 <= r[1] <= 150)
    assert co["n_samples"] == 3 and co["tile_misses"] >= 1
    # an enqueue age past the budget re-anchors to an expired deadline
    assert docs["dl"]["kind"] == "transient"


def test_stopped_loop_sheds_submissions(served_bam):
    path, _header = served_bam
    loop = _loop()
    loop.start()
    loop.query(path, [_REGIONS[0]])
    loop.stop()
    with pytest.raises(TransientIOError):
        loop.submit(path, [_REGIONS[0]])


# ---------------------------------------------------------------------------
# the port's refusals and device rule
# ---------------------------------------------------------------------------

def test_fleet_is_refused_until_ported(served_bam):
    path, _header = served_bam
    with pytest.raises(PlanError, match="item 11a"):
        _loop(serve_replica_id="r1", serve_peers="r2=localhost:1")
    # either one alone is carried and changes nothing
    with _loop(serve_replica_id="r1") as loop:
        assert loop.fleet is None
        assert loop.query(path, [_REGIONS[0]])[0].count == \
            _oracle(path, [_REGIONS[0]])[0][0]


def test_cohort_requests_are_served(served_bam, tmp_path):
    """``cohort=True`` is served (the cohort plane is ported): the count
    equals the oracle join's, beside a region query on the same loop; a
    BAM named as a manifest is a PlanError."""
    from test_cohort import _oracle_join, _serve_fixture
    path, _header = served_bam
    man, paths = _serve_fixture(tmp_path)
    _contigs, rows = _oracle_join([str(p) for p in paths])
    with _loop(serve_replica_id="r1") as loop:
        res = loop.query(man, ["chr20:1-150"], cohort=True)[0]
        assert res.count == sum(1 for r in rows
                                if r[0] == 0 and 1 <= r[1] <= 150)
        assert res.extra["n_samples"] == 3
        assert loop.query(path, [_REGIONS[0]])[0].count == \
            _oracle(path, [_REGIONS[0]])[0][0]
        with pytest.raises(PlanError):
            loop.query(path, [_REGIONS[0]], cohort=True)
        assert loop.stats()["cohort"] == {"manifests": 1}


def test_serve_config_fields_carry_over():
    from hadoop_bam_torch.config import CARRIED, config_from_dict

    names = [n for n in dataclasses.asdict(JCONFIG)
             if n.startswith(("serve_", "slo_", "flight_"))]
    assert len(names) == 21 and set(names) <= set(CARRIED)
    j = dataclasses.replace(
        JCONFIG, serve_tile_records=512, serve_tile_cache_bytes=1 << 20,
        serve_prefetch=False, serve_ring_slots=5, serve_peers="a=h:1",
        slo_latency_s=0.25, flight_dump_dir="/x", flight_dump_cap=3)
    t = config_from_dict(dataclasses.asdict(j))
    for n in names:
        assert getattr(t, n) == getattr(j, n), n


def test_server_wants_a_card_unless_told(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ServeLoop()
