"""The port's mesh and multi-process set-up (``dial_rag_tpu_torch/parallel/``)
and ``ChargramIndex.with_inner``, on the CPU.

- ``create_mesh``: the (dp, tp) grid, its shape, a mesh that names one
  device more than once, the visible cards by default;
- ``initialize_multihost`` in one process is a no-op False, as the JAX
  package's; ``create_global_mesh``'s shapes, device order and an
  indivisible tp, against the JAX package's on its 8 host devices;
- two processes joined by ``gloo``, 4 CPU slots each: every rank holds
  its own 4 shards of a dense (float32 and two_pass) and a CSC BM25
  index, and each rank's top-k, merged across the ranks through one
  all-gather, equals the JAX package's sharded indexes on 8 devices. The
  ranks run in subprocesses under a time limit of 120 s, so a hung
  collective fails this test, not the suite;
- ``with_inner``: the same gram state over another scoring index.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dial_rag_tpu.index.bm25 import Bm25Index as JaxBm25Index
from dial_rag_tpu.index.chargram import ChargramIndex as JaxChargramIndex
from dial_rag_tpu.index.dense_index import DocEmbeddings as JaxDocEmbeddings
from dial_rag_tpu.index.records import RetrievalType as JaxRetrievalType
from dial_rag_tpu.parallel import mesh as jax_mesh_mod
from dial_rag_tpu.parallel import multihost as jmh
from dial_rag_tpu.parallel import sharded_index as jsi
from dial_rag_tpu_torch.index.bm25 import Bm25Index
from dial_rag_tpu_torch.index.chargram import ChargramIndex
from dial_rag_tpu_torch.parallel.mesh import Mesh, create_mesh, dp_slots, visible_devices
from dial_rag_tpu_torch.parallel.multihost import create_global_mesh, gather_ranks, initialize_multihost
from dial_rag_tpu_torch.parallel.sharded_index import ShardedBm25Index
from tests.utils.sharded_corpora import corpora

ROOT = Path(__file__).resolve().parent.parent
RANK_LIMIT_S = 120


def test_create_mesh_shapes_and_axes():
    m = create_mesh(devices=["cpu"] * 8)
    assert isinstance(m, Mesh) and list(m.shape) == ["dp", "tp"]
    assert dict(m.shape) == {"dp": 8, "tp": 1} and m.devices.shape == (8, 1) and m.size == m.devices.size == 8
    m2 = create_mesh(4, tp=2, devices=["cpu"] * 8)
    assert dict(m2.shape) == dict(jax_mesh_mod.create_mesh(4, tp=2).shape) == {"dp": 2, "tp": 2}
    with pytest.raises(ValueError):
        create_mesh(6, tp=4, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        jax_mesh_mod.create_mesh(6, tp=4)
    with pytest.raises(ValueError):
        create_mesh(9, devices=["cpu"] * 8)


def test_mesh_may_repeat_a_device():
    """The tests' and the one-card smoke's mesh: one device named 4 times
    gives 4 dp slots and one replica."""
    m = create_mesh(devices=["cpu"] * 4)
    assert [str(d) for d in m.local_devices] == ["cpu"] * 4 and m.first_device == torch.device("cpu")
    assert dp_slots(m, 8) == [(torch.device("cpu"), slice(2 * i, 2 * i + 2)) for i in range(4)]
    assert list(dict.fromkeys(m.devices[:, 0])) == [torch.device("cpu")]
    with pytest.raises(ValueError):
        dp_slots(m, 6)
    m2 = create_mesh(4, tp=2, devices=["cpu", "meta"] * 2)  # tp copies are not slots
    assert dp_slots(m2, 4) == [(torch.device("cpu"), slice(0, 2)), (torch.device("cpu"), slice(2, 4))]


def test_create_mesh_defaults_to_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert visible_devices("cuda") == [torch.device("cuda", i) for i in range(8)]
    assert visible_devices("cpu") == [torch.device("cpu")]
    m = create_mesh(tp=2)  # torch.device objects only: no card is touched
    assert m.devices[1, 0] == torch.device("cuda", 2) and dict(m.shape) == {"dp": 4, "tp": 2}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_mesh()


def test_initialize_multihost_single_process_is_false(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is False
    assert initialize_multihost("127.0.0.1:1", num_processes=1, process_id=0) is False
    assert jmh.initialize_multihost() is False
    assert not torch.distributed.is_initialized()


def test_create_global_mesh_shapes_order_and_indivisible_tp():
    cards = [f"cuda:{i}" for i in range(8)]
    m = create_global_mesh(tp=2, devices=cards)
    assert dict(m.shape) == dict(jmh.create_global_mesh(tp=2).shape) == {"dp": 4, "tp": 2}
    # row-major: tp inside a grid row, as the JAX package's device order
    assert [str(d) for d in m.devices[:, 0]] == ["cuda:0", "cuda:2", "cuda:4", "cuda:6"]
    jgrid = jmh.create_global_mesh(tp=2).devices
    assert [[d.id for d in row] for row in jgrid] == [[int(str(d)[5:]) for d in row] for row in m.devices]
    assert (m.process_index, m.process_count, m.shard_offset) == (0, 1, 0)
    # across processes the grids stack rank-major along dp
    m2 = Mesh(m.devices, process_index=1, process_count=2)
    assert dict(m2.shape) == {"dp": 8, "tp": 2} and m2.size == 16 and m2.shard_offset == 8
    t = torch.arange(3)
    assert gather_ranks(m, t) is t
    with pytest.raises(ValueError):
        create_global_mesh(tp=3, devices=cards)
    with pytest.raises(ValueError):
        jmh.create_global_mesh(tp=3)


def test_chargram_with_inner_keeps_the_gram_state():
    words = [["alps", "alpine", "glacier"], ["glaciers", "valley"], ["alpine", "pass"], ["river", "valleys"]]
    cg = ChargramIndex.build(words, device="cpu", max_band_bytes=0)
    jcg = JaxChargramIndex.build(words, device=False)
    mesh = create_mesh(devices=["cpu"] * 8)
    sharded = cg.with_inner(ShardedBm25Index(cg.inner, mesh, limit=3))
    jsharded = jcg.with_inner(jsi.ShardedBm25Index(jcg.inner, jax_mesh_mod.create_mesh(8), limit=3))
    assert sharded._vocab is cg._vocab and sharded._idf_arr is cg._idf_arr
    assert (sharded.n_lo, sharded.n_hi, sharded._packed_keys) == (cg.n_lo, cg.n_hi, cg._packed_keys)
    single = ChargramIndex.build(words, device="cpu")
    for q in ("alpin", "glacer valey", "rivers", "zzz"):
        got, scores = sharded.top_n_with_scores(q, 3)
        want, want_scores = single.top_n_with_scores(q, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(scores, want_scores)
        np.testing.assert_array_equal(got, jsharded.top_n(q, 3))


# the two ranks: each builds the same corpora, holds its own 4 shards, and
# writes what its queries return
_RANK = r"""
import json, sys
import numpy as np
import torch
from dial_rag_tpu_torch.index.bm25 import Bm25Index
from dial_rag_tpu_torch.index.dense_index import DocEmbeddings
from dial_rag_tpu_torch.index.records import RetrievalType
from dial_rag_tpu_torch.parallel.multihost import create_global_mesh, initialize_multihost
from dial_rag_tpu_torch.parallel.sharded_index import ShardedBm25SparseIndex, ShardedDenseIndex

address, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, ".")
from tests.utils.sharded_corpora import corpora

emb, queries, items, bm25_queries = corpora()
assert initialize_multihost(address, num_processes=2, process_id=rank, device="cpu", timeout_s=60)
mesh = create_global_mesh(devices=["cpu"] * 4)
result = {"shape": mesh.shape, "offset": mesh.shard_offset}
for storage in ("float32", "two_pass"):
    index = ShardedDenseIndex(RetrievalType.TEXT, [DocEmbeddings(np.arange(len(emb)), emb)], mesh, limit=7,
                              storage_dtype=storage)
    result[storage] = {
        "bases": [base for base, _ in index._shards],
        "hits": [[(h.chunk_id, h.score) for h in hits] for hits in index.find_batch(queries)],
        "one": [(h.chunk_id, h.score) for h in index.find(queries[0])],
    }
sparse = ShardedBm25SparseIndex(Bm25Index.build(items, max_dense_bytes=0, device="cpu", max_band_bytes=0), mesh,
                                limit=7)
result["bm25"] = [[idx.tolist(), s.tolist()] for idx, s in sparse.top_n_batch_with_scores(bm25_queries, 7)]
result["bm25_scores"] = sparse.get_scores(bm25_queries[0]).tolist()
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(result, f)
torch.distributed.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_ranks_gloo_merge_equals_jax_on_8_devices(tmp_path):
    address = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, address, str(rank), str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    deadline = time.monotonic() + RANK_LIMIT_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-4000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]

    emb, queries, items, bm25_queries = corpora()
    assert len(jax.devices()) == 8
    jmesh = jax_mesh_mod.create_mesh(8)
    rows = 1024  # 4396 rows over 8 shards: 550 a shard, padded to the 512-row quantum
    assert [r["offset"] for r in ranks] == [0, 4] and ranks[0]["shape"] == {"dp": 8, "tp": 1}
    for storage in ("float32", "two_pass"):
        ref = jsi.ShardedDenseIndex(JaxRetrievalType.TEXT, [JaxDocEmbeddings(np.arange(len(emb)), emb)], jmesh,
                                    limit=7, storage_dtype=storage)
        want = ref.find_batch(queries)
        assert [r[storage]["bases"] for r in ranks] == [[s * rows for s in range(4)], [s * rows for s in range(4, 8)]]
        for r in ranks:
            assert [[c for c, _ in hits] for hits in r[storage]["hits"]] == [[h.chunk_id for h in w] for w in want]
            for hits, w in zip(r[storage]["hits"], want):
                np.testing.assert_allclose([s for _, s in hits], [h.score for h in w], rtol=1e-6, atol=1e-6)
            # a lone query's [1, D] product rounds apart from the batch's
            assert [c for c, _ in r[storage]["one"]] == [c for c, _ in r[storage]["hits"][0]]
            np.testing.assert_allclose([s for _, s in r[storage]["one"]], [s for _, s in r[storage]["hits"][0]],
                                       rtol=1e-6, atol=1e-6)
        assert [c for c, _ in ranks[0][storage]["one"]][:4] == [5, 2100, 4000, 4300]  # earliest first
    jsparse = jsi.ShardedBm25SparseIndex(JaxBm25Index.build(items, max_dense_bytes=0, device=False), jmesh, limit=7)
    want = jsparse.top_n_batch_with_scores(bm25_queries, 7)
    for r in ranks:
        assert r["bm25"] == ranks[0]["bm25"]
        for (idx, scores), (widx, wscores) in zip(r["bm25"], want):
            assert idx == widx.tolist()
            np.testing.assert_allclose(scores, wscores, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["bm25_scores"], jsparse.get_scores(bm25_queries[0]), rtol=1e-6, atol=1e-6)
    # the three identical items tie, and rank later item first, across ranks
    assert ranks[0]["bm25"][0][0][:3] == [140, 75, 10]
    single = Bm25Index.build(items, max_dense_bytes=0, device="cpu")
    np.testing.assert_array_equal(ranks[0]["bm25_scores"], single.get_scores(bm25_queries[0]))
