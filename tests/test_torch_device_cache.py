"""The port's device-index cache (``dial_rag_tpu_torch/index/device_cache.py``)
through the cases of tests/test_device_cache.py, each scenario run through
the JAX package's ``DeviceIndexCache`` as well and the two held to the same
hits, misses, entries and bytes: token keying, LRU eviction by bytes,
unpersisted records bypassing the cache, single-flight builds, a racer's
duplicate insert, a failed build retried, the ``warm=`` hook once a miss
and never on hits, a failing warm-up that leaves serving alone, and
``wait_warm``'s timeout. The three index warm-ups read that every wave
bucket ran (PyTorch compiles nothing ahead) and that results after them
are right. (The storage layer's stamping of ``cache_token`` comes with the
port's storage.)
"""

import threading
import time

import numpy as np
import pytest
import torch

from dial_rag_tpu.index.device_cache import DeviceIndexCache as JaxDeviceIndexCache
from dial_rag_tpu_torch.index.bm25 import Bm25Index
from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
from dial_rag_tpu_torch.index.device_cache import DeviceIndexCache
from dial_rag_tpu_torch.index.late_interaction import LateInteractionIndex
from dial_rag_tpu_torch.index.records import RetrievalType
from dial_rag_tpu_torch.runtime import micro_batcher as mb

CACHES = [DeviceIndexCache, JaxDeviceIndexCache]


class FakeIndex:
    def __init__(self, nbytes=100):
        self.nbytes = nbytes


class Rec:
    def __init__(self, token):
        self.cache_token = token


def state(cache) -> tuple:
    return cache.hits, cache.misses, len(cache), cache.size_bytes


@pytest.mark.parametrize("make", CACHES)
def test_hit_on_same_tokens(make):
    cache = make()
    a = cache.get_or_build([Rec(("u1", "sha1")), Rec(("u2", "sha2"))], ("semantic", 7), FakeIndex)
    b = cache.get_or_build([Rec(("u1", "sha1")), Rec(("u2", "sha2"))], ("semantic", 7), FakeIndex)
    assert a is b and state(cache) == (1, 1, 1, 100)


@pytest.mark.parametrize("make", CACHES)
def test_miss_on_different_config_or_content(make):
    cache = make()
    records = [Rec(("u1", "sha1"))]
    a = cache.get_or_build(records, ("semantic", 7), FakeIndex)
    b = cache.get_or_build(records, ("semantic", 3), FakeIndex)
    c = cache.get_or_build([Rec(("u1", "OTHER"))], ("semantic", 7), FakeIndex)
    assert a is not b and a is not c and state(cache) == (0, 3, 3, 300)


@pytest.mark.parametrize("make", CACHES)
def test_unpersisted_records_bypass_cache(make):
    cache = make()
    a = cache.get_or_build([Rec(None)], ("semantic", 7), FakeIndex)
    b = cache.get_or_build([Rec(None)], ("semantic", 7), FakeIndex)
    assert a is not b and len(cache) == 0
    assert cache.get_or_build([], ("semantic", 7), FakeIndex) is not a and len(cache) == 0


def test_lru_eviction_by_bytes():
    states = []
    for make in CACHES:
        cache = make(capacity_bytes=250)
        for i in range(4):
            cache.get_or_build([Rec((f"u{i}", "s"))], ("c",), lambda: FakeIndex(100))
        assert len(cache) <= 3 and cache.size_bytes <= 250 + 100  # at most one entry over
        # the oldest went first; a hit refreshes an entry
        cache.get_or_build([Rec(("u2", "s"))], ("c",), FakeIndex)
        cache.get_or_build([Rec(("u9", "s"))], ("c",), lambda: FakeIndex(100))
        states.append((state(cache), [k[0][0][0] for k in cache._entries]))
    assert states[0] == states[1] == ((1, 5, 2, 200), ["u2", "u9"])


def test_an_entry_over_capacity_stays_alone():
    """The rule ``len(entries) > 1``: an index larger than the capacity is
    kept, alone; the next insert evicts it."""
    states = []
    for make in CACHES:
        cache = make(capacity_bytes=250)
        cache.get_or_build([Rec(("a", "s"))], ("c",), lambda: FakeIndex(100))
        cache.get_or_build([Rec(("big", "s"))], ("c",), lambda: FakeIndex(400))
        after_big = [k[0][0][0] for k in cache._entries]
        cache.get_or_build([Rec(("b", "s"))], ("c",), lambda: FakeIndex(100))
        states.append((after_big, [k[0][0][0] for k in cache._entries], state(cache)))
    assert states[0] == states[1] == (["big"], ["b"], (0, 3, 1, 100))


@pytest.mark.parametrize("make", CACHES)
def test_single_flight_concurrent_builds(make):
    cache = make()
    records = [Rec(("u", "s"))]
    builds = []

    def slow_builder():
        builds.append(1)
        time.sleep(0.05)
        return FakeIndex()

    results = []
    threads = [
        threading.Thread(target=lambda: results.append(cache.get_or_build(records, ("c",), slow_builder)))
        for _ in range(5)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and all(r is results[0] for r in results)
    assert cache.hits == 4 and cache.misses == 1


@pytest.mark.parametrize("make", CACHES)
def test_duplicate_insert_replaces_and_subtracts_bytes(make):
    """A racer's entry that lands between the re-check and this build's
    insert is replaced, and its bytes subtracted."""
    cache = make()
    key = ((("u", "s"),), ("c",))

    def builder():
        with cache._lock:
            cache._entries[key] = FakeIndex(300)
            cache._size += 300
        return FakeIndex(100)

    out = cache.get_or_build([Rec(("u", "s"))], ("c",), builder)
    assert out.nbytes == 100 and cache.size_bytes == 100 and not cache._building


@pytest.mark.parametrize("make", CACHES)
def test_failed_build_can_retry(make):
    cache = make()
    calls = []

    def failing_then_ok():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("boom")
        return FakeIndex()

    with pytest.raises(RuntimeError):
        cache.get_or_build([Rec(("u2", "s"))], ("c",), failing_then_ok)
    out = cache.get_or_build([Rec(("u2", "s"))], ("c",), failing_then_ok)
    assert isinstance(out, FakeIndex) and len(calls) == 2 and not cache._building


@pytest.mark.parametrize("make", CACHES)
def test_warm_runs_once_on_miss_not_on_hits(make):
    cache = make()
    records = [Rec(("u1", "sha1"))]
    warmed = []
    a = cache.get_or_build(records, ("semantic", 7), FakeIndex, warm=warmed.append)
    cache.wait_warm(5)
    assert warmed == [a]
    b = cache.get_or_build(records, ("semantic", 7), FakeIndex, warm=warmed.append)
    cache.wait_warm(5)
    assert b is a and warmed == [a]


@pytest.mark.parametrize("make", CACHES)
def test_warm_failure_does_not_break_serving(make):
    cache = make()
    records = [Rec(("u1", "sha1"))]

    def warm(index):
        raise RuntimeError("warm-up exploded")

    a = cache.get_or_build(records, ("k",), FakeIndex, warm=warm)
    cache.wait_warm(5)
    assert cache.get_or_build(records, ("k",), FakeIndex) is a


def test_wait_warm_returns_at_its_timeout():
    """Every wait has a timeout: ``wait_warm`` gives up after it (False)
    while a warm-up runs, and says True once none runs."""
    cache = DeviceIndexCache()
    release = threading.Event()
    cache.get_or_build([Rec(("u", "s"))], ("k",), FakeIndex, warm=lambda index: release.wait(10))
    t0 = time.monotonic()
    assert cache.wait_warm(0.2) is False
    assert time.monotonic() - t0 < 2.0
    release.set()
    assert cache.wait_warm(10) is True


def test_dense_index_warm_compiles_wave_buckets(monkeypatch):
    """``warm_query_buckets`` runs the lone scan and ``find_batch`` at every
    wave bucket up to the wave size (8 and 16, at a wave size of 16), on
    the index's device; results after it are right."""
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((600, 16)).astype(np.float32)
    idx = DenseIndex(RetrievalType.TEXT, [DocEmbeddings(chunk_ids=np.arange(600), embeddings=emb)], limit=7,
                     device="cpu")
    ran = []
    find, find_batch = idx.find, idx.find_batch
    monkeypatch.setattr(idx, "find", lambda q: ran.append(("find", tuple(q.shape), q.device.type)) or find(q))
    monkeypatch.setattr(idx, "find_batch", lambda q, n_real=None: ran.append(
        ("find_batch", tuple(q.shape), q.device.type)) or find_batch(q, n_real))
    monkeypatch.setattr(mb, "MAX_WAVE", 16)
    idx.warm_query_buckets()
    assert ran == [("find", (16,), "cpu"), ("find_batch", (8, 16), "cpu"), ("find_batch", (16, 16), "cpu")]
    monkeypatch.undo()
    target = 123
    assert idx.find(emb[target])[0].chunk_id == target
    for nq in (2, 8, 16):
        assert all(h[0].chunk_id == target for h in idx.find_batch(np.tile(emb[target], (nq, 1))))


def test_bm25_warm_compiles_wave_buckets(monkeypatch):
    """A lone query and batches of 2, 4 and 8 at the serving k."""
    idx = Bm25Index.build([[f"w{i % 17}", "common"] for i in range(300)], device="cpu")
    ran = []
    single, batch = idx.top_n_with_scores, idx.top_n_batch_with_scores
    monkeypatch.setattr(idx, "top_n_with_scores", lambda q, n: ran.append(("single", n)) or single(q, n))
    monkeypatch.setattr(idx, "top_n_batch_with_scores", lambda qs, n: ran.append((len(qs), n)) or batch(qs, n))
    monkeypatch.setattr(mb, "MAX_WAVE", 8)
    idx.warm_query_buckets(k=5)
    # (the lone query is a batch of one inside)
    assert ran == [("single", 5), (1, 5), (2, 5), (4, 5), (8, 5)]
    monkeypatch.undo()
    assert len(idx.top_n(["w3"], 5)) == 5


def test_late_interaction_warm_compiles_buckets(monkeypatch):
    """The lone query at lane buckets 8, 16, 32 and coalesced waves of 4
    and 8 queries at 16 lanes (one grouped scan each)."""
    rng = np.random.default_rng(1)
    chunks = [rng.standard_normal((3, 16)).astype(np.float32) for _ in range(50)]
    idx = LateInteractionIndex(RetrievalType.TEXT, [chunks], max_chunk_tokens=4, limit=3, device="cpu")
    ran = []
    find, scan = idx._find, idx._scan_wave
    monkeypatch.setattr(idx, "_find", lambda q, c, k: ran.append(tuple(q.shape)) or find(q, c, k))
    monkeypatch.setattr(idx, "_scan_wave", lambda qs: ran.append(("wave", len(qs))) or scan(qs))
    monkeypatch.setattr(mb, "MAX_WAVE", 8)
    idx.warm_query_buckets()
    assert ran == [(1, 8, 16), (1, 16, 16), (1, 32, 16), ("wave", 4), (4, 16, 16), ("wave", 8), (8, 16, 16)]
    monkeypatch.undo()
    hits = idx.find(chunks[7])
    assert hits and hits[0].chunk_id == 7


def test_dense_index_warm_on_the_cache_thread():
    """Through the cache: the warm-up runs on its thread after the miss, and
    ``wait_warm`` returns once it has run."""
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((40, 8)).astype(np.float32)
    cache = DeviceIndexCache()
    warmed = []

    def build():
        return DenseIndex(RetrievalType.TEXT, [DocEmbeddings(np.arange(40), emb)], limit=3, device="cpu")

    def warm(index):
        index.warm_query_buckets()
        warmed.append(threading.current_thread().name)

    idx = cache.get_or_build([Rec(("d", "s"))], ("semantic",), build, warm=warm)
    assert cache.wait_warm(30) and warmed == ["index-warm"]
    assert cache.size_bytes == idx.nbytes == idx._emb.numel() * 4
    assert idx.find(torch.from_numpy(emb[5]))[0].chunk_id == 5


class DeviceStub:
    """An index built on ``device``, in place of a retriever's real one."""

    nbytes = 100

    def __init__(self, *args, device, **kwargs):
        self.device = torch.device(device)

    @classmethod
    def build(cls, *args, device, **kwargs):
        return cls(device=device)

    def warm_query_buckets(self, *args):
        pass


@pytest.mark.parametrize("arm", ["semantic", "bm25", "chargram", "late_interaction"])
def test_retriever_cache_keys_name_the_device(monkeypatch, arm):
    """Builds over the same stamped records on two devices are two misses:
    a request that asks for one device is never handed the other's index.
    The index classes are stubbed, so the second device needs no card."""
    from types import SimpleNamespace

    from dial_rag_tpu_torch.documents.model import Chunk, DocumentRecord, IndexSettings
    from dial_rag_tpu_torch.retrieval import bm25_retriever, chargram_retriever, late_interaction, semantic

    record = DocumentRecord(
        format_version=None, index_settings=IndexSettings(), chunks=[Chunk("alpha beta", {})],
        text_index=[["alpha", "beta"]], embeddings_index=None, multimodal_embeddings_index=None,
        description_embeddings_index=None, mime_type="text/plain", document_bytes=b"",
        chargram_index=[["alpha", "beta"]], cache_token=("doc", "sha"),
    )
    for module, name in ((semantic, "DenseIndex"), (late_interaction, "LateInteractionIndex"),
                         (bm25_retriever, "Bm25Index"), (chargram_retriever, "ChargramIndex")):
        monkeypatch.setattr(module, name, DeviceStub)
    for module in (bm25_retriever, chargram_retriever):
        monkeypatch.setattr(module, "resolve_device", torch.device)

    def build(cache, device):
        if arm == "semantic":
            return semantic.SemanticRetriever.from_doc_records(
                SimpleNamespace(device=torch.device(device)), [record], device_cache=cache).index
        if arm == "late_interaction":
            return late_interaction.LateInteractionRetriever.from_doc_records(
                SimpleNamespace(device=torch.device(device)), [record], device_cache=cache).index
        if arm == "bm25":
            return bm25_retriever.Bm25Retriever.from_doc_records([record], device=device, device_cache=cache)._index
        return chargram_retriever.ChargramRetriever.from_doc_records([record], device=device, device_cache=cache)._index

    cache = DeviceIndexCache()
    on_cpu, on_card, again = build(cache, "cpu"), build(cache, "cuda"), build(cache, "cuda")
    assert (on_cpu.device.type, on_card.device.type) == ("cpu", "cuda") and again is on_card
    assert (cache.misses, cache.hits, len(cache)) == (2, 1, 2)
    assert cache.wait_warm(30)
