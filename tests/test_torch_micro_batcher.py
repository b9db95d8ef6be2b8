"""The port's micro-batcher (``dial_rag_tpu_torch/runtime/micro_batcher.py``)
through every case of tests/test_micro_batcher.py: coalescing, the window,
a full batch flushing at once, the in-flight accumulation rule, errors
reaching every waiter, one batcher a loop; its wave and item counters,
and ``fused_encoder``'s launch counters, exact under many threads; and the
embedder's coalesced query encodes: equal to the port's lone encodes bit
for bit, and to the JAX package's ``aembed_query`` within 2e-5 (f32, the
reference's f32 gate), the same seeded weights in both.
"""

import asyncio
import sys
import threading

import jax
import numpy as np

from dial_rag_tpu.embeddings.embedder import BgeEmbedder as JaxEmbedder
from dial_rag_tpu.models.tokenizer import build_test_vocab
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.models.bert import BertConfig, BertEncoder
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer
from dial_rag_tpu_torch.ops import fused_encoder as fe
from dial_rag_tpu_torch.runtime import micro_batcher as mb
from dial_rag_tpu_torch.runtime.micro_batcher import MicroBatcher, PerLoopBatcher
from dial_rag_tpu_torch.weights import params_from_jax_numpy


async def test_concurrent_submits_coalesce():
    calls = []

    async def batch_fn(items):
        calls.append(list(items))
        return [i * 2 for i in items]

    b = MicroBatcher(batch_fn, max_batch=16, window_s=0.01)
    results = await asyncio.gather(*(b.submit(i) for i in range(5)))
    assert results == [0, 2, 4, 6, 8]
    assert len(calls) == 1 and sorted(calls[0]) == [0, 1, 2, 3, 4]


async def test_full_batch_flushes_immediately():
    calls = []

    async def batch_fn(items):
        calls.append(list(items))
        return items

    b = MicroBatcher(batch_fn, max_batch=3, window_s=10.0)  # a window that never ends in the test
    results = await asyncio.wait_for(asyncio.gather(*(b.submit(i) for i in range(3))), timeout=1.0)
    assert results == [0, 1, 2]
    assert len(calls) == 1


async def test_sequential_submits_get_separate_batches():
    calls = []

    async def batch_fn(items):
        calls.append(list(items))
        return items

    b = MicroBatcher(batch_fn, window_s=0.001)
    assert await asyncio.wait_for(b.submit("a"), timeout=5.0) == "a"
    assert await asyncio.wait_for(b.submit("b"), timeout=5.0) == "b"
    assert len(calls) == 2


async def test_inflight_wave_accumulates_arrivals_into_one_followup():
    """Arrivals during an in-flight wave form one follow-up wave that
    flushes the moment the wave completes, not one wave per arrival."""
    calls = []
    release = asyncio.Event()

    async def batch_fn(items):
        calls.append(list(items))
        if len(calls) == 1:
            await release.wait()
        return items

    b = MicroBatcher(batch_fn, max_batch=16, window_s=0.001)
    first = asyncio.ensure_future(b.submit("w0"))
    await asyncio.sleep(0.01)  # wave 1 in flight, held on release
    late = [asyncio.ensure_future(b.submit(f"l{i}")) for i in range(5)]
    await asyncio.sleep(0.02)  # well past the window: no flush yet
    assert len(calls) == 1
    release.set()
    results = await asyncio.wait_for(asyncio.gather(first, *late), timeout=1.0)
    assert results == ["w0", "l0", "l1", "l2", "l3", "l4"]
    assert len(calls) == 2 and sorted(calls[1]) == ["l0", "l1", "l2", "l3", "l4"]


async def test_errors_propagate_to_all_waiters():
    async def batch_fn(items):
        raise ValueError("boom")

    b = MicroBatcher(batch_fn, window_s=0.001)
    results = await asyncio.wait_for(asyncio.gather(b.submit(1), b.submit(2), return_exceptions=True), timeout=5.0)
    assert all(isinstance(r, ValueError) for r in results)


async def test_wrong_result_count_is_an_error():
    async def batch_fn(items):
        return items[:-1]

    b = MicroBatcher(batch_fn, window_s=0.001)
    results = await asyncio.wait_for(asyncio.gather(b.submit(1), b.submit(2), return_exceptions=True), timeout=5.0)
    assert all(isinstance(r, RuntimeError) for r in results)


async def test_per_loop_batcher_in_one_loop():
    made = []

    def make():
        async def batch_fn(items):
            return items

        b = MicroBatcher(batch_fn, window_s=0.001)
        made.append(b)
        return b

    p = PerLoopBatcher(make)
    await asyncio.wait_for(asyncio.gather(p.submit(1), p.submit(2)), timeout=5.0)
    assert len(made) == 1


def test_per_loop_batcher_one_batcher_a_loop():
    """Each event loop gets its own batcher (futures cannot cross loops)."""
    made = []

    def make():
        async def batch_fn(items):
            return items

        made.append(MicroBatcher(batch_fn, window_s=0.001))
        return made[-1]

    p = PerLoopBatcher(make)
    for _ in range(2):
        assert asyncio.run(asyncio.wait_for(p.submit(7), timeout=5.0)) == 7
    assert len(made) == 2


async def test_wave_and_item_counters():
    async def batch_fn(items):
        return items

    mb.reset_counts()
    b = MicroBatcher(batch_fn, max_batch=4, window_s=0.001, name="probe")
    await asyncio.wait_for(asyncio.gather(*(b.submit(i) for i in range(10))), timeout=5.0)
    assert mb.WAVES["probe"] == 3 and mb.ITEMS["probe"] == 10  # 4 + 4 + 2
    mb.reset_counts()
    assert mb.WAVES == {} and mb.ITEMS == {}


def test_counters_count_exactly_under_threads():
    """Serving threads count waves and kernel launches: with more threads
    than cores and a short switch interval no update is lost."""
    threads, per_thread = 32, 2000
    mb.reset_counts()
    counts = {"probe": 0}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread):
                mb._count("stress", 2)
                fe.count_launch(counts, "probe")

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert mb.WAVES["stress"] == threads * per_thread and mb.ITEMS["stress"] == 2 * threads * per_thread
    assert counts["probe"] == threads * per_thread
    fe.zero_launches(counts)
    assert counts == {"probe": 0}


async def test_embedder_batched_query_encodes_match_single():
    """Coalesced encodes (one wave) = the port's lone encodes (bit for bit:
    the same padded rows) = the JAX package's ``aembed_query`` (2e-5)."""
    vocab = build_test_vocab([chr(c) for c in range(97, 123)])
    ref = JaxEmbedder.from_random(vocab=vocab, batch_size=8)
    port = BgeEmbedder(
        tokenizer=WordPieceTokenizer(vocab=ref.tokenizer.vocab),
        encoder=BertEncoder(BertConfig.tiny()),
        params=params_from_jax_numpy(jax.tree.map(np.asarray, ref.params)),
        device="cpu",
        batch_size=8,
    )
    queries = ["abc", "def ghi", "jkl mno pqr"]
    mb.reset_counts()
    batched = await asyncio.wait_for(asyncio.gather(*(port.aembed_query(q) for q in queries)), timeout=60.0)
    assert mb.WAVES["query_encode"] == 1 and mb.ITEMS["query_encode"] == 3
    want = await asyncio.wait_for(asyncio.gather(*(ref.aembed_query(q) for q in queries)), timeout=60.0)
    for q, emb, ref_emb in zip(queries, batched, want):
        assert emb.shape == (port.dim,) and np.array_equal(emb.numpy(), port.embed_query(q))
        np.testing.assert_allclose(emb.numpy(), np.asarray(ref_emb), rtol=0, atol=2e-5)


async def test_scan_batcher_flushes_after_one_loop_iteration(monkeypatch):
    """An index's scan batcher (``per_loop_batcher``) takes every item
    submitted in one loop iteration into one wave, with no wall-clock
    window, and at most ``MAX_WAVE`` items a wave."""

    class Owner:
        pass

    monkeypatch.setattr(mb, "MAX_WAVE", 8)
    batcher = mb.per_loop_batcher(Owner(), "probe_scan", lambda items: [2 * x for x in items])
    mb.reset_counts()
    got = await asyncio.wait_for(asyncio.gather(*(batcher.submit(i) for i in range(12))), timeout=5.0)
    assert got == [2 * i for i in range(12)]
    assert mb.WAVES["probe_scan"] == 2 and mb.ITEMS["probe_scan"] == 12  # 8, then the 4 that accumulated
    assert mb.SCAN_WINDOW_S == 0.0
