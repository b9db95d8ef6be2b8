"""The port's index storage against the JAX package's.

- the msgpack codec (``storage/_msgpack.py``): byte-equal to
  ``msgpack.packb(use_bin_type=True)`` at every size boundary, equal to
  ``msgpack.unpackb(raw=False, strict_map_key=False)`` on what it reads,
  refusing what msgpack refuses (numpy scalars included);
- records cross both ways: what either package's ``serialize_record``
  writes loads in the other, every field, with the same msgpack payload;
- tests/test_storage.py's cases but the Dial client's, each through the
  port: LRU eviction by bytes, the holder's shared cache, path traversal,
  the record memo and the validator, invalidation;
- tests/test_device_cache.py::test_storage_stamps_cache_token, and a
  record loaded through storage building the four arms with no warning,
  a device-cache hit the second time.
"""

import asyncio
import dataclasses
import gzip
import random
import warnings

import msgpack
import numpy as np
import pytest

from dial_rag_tpu.documents import model as jax_model
from dial_rag_tpu.storage import serialization as jax_serialization
from dial_rag_tpu.storage.storage import link_to_index_url as jax_link_to_index_url
from dial_rag_tpu_torch import telemetry
from dial_rag_tpu_torch.documents import model as port_model
from dial_rag_tpu_torch.documents.model import (
    FORMAT_VERSION,
    Chunk,
    DocumentRecord,
    IndexSettings,
    build_chunks_list,
)
from dial_rag_tpu_torch.errors import InvalidAttachmentError
from dial_rag_tpu_torch.storage import (
    IndexStorage,
    IndexStorageHolder,
    LocalFileStorage,
    LRUCacheStorage,
    deserialize_record,
    serialize_record,
)
from dial_rag_tpu_torch.storage import _msgpack
from dial_rag_tpu_torch.storage import storage as storage_mod
from dial_rag_tpu_torch.storage.storage import RecordMemo, _sha256, link_to_index_url

# --- the codec ---------------------------------------------------------------

BOUNDARIES = [
    None, True, False,
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63),
    0.0, -0.0, 1.5, 1e300, float("inf"), float("-inf"), np.float64(2.5),
    "", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 65535, "a" * 65536, "é" * 16, "日本" * 100, "😀",
    b"", b"x", b"x" * 255, b"x" * 256, b"x" * 65535, b"x" * 65536, bytearray(b"ab"),
    [], [1] * 15, [1] * 16, [1] * 65535, [1] * 65536, (1, "two", None),
    {}, {i: i for i in range(15)}, {i: i for i in range(16)}, {f"k{i}": i for i in range(65536)},
    {1: (1, 2), -5: {"a": [None, b"z", 2.0]}, "s": {"nested": [[[]]]}},
]


@pytest.mark.parametrize("value", BOUNDARIES, ids=[f"{type(v).__name__}{i}" for i, v in enumerate(BOUNDARIES)])
def test_codec_packs_like_msgpack(value):
    packed = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value, use_bin_type=True) == packed
    assert _msgpack.unpackb(packed, raw=False, strict_map_key=False) == msgpack.unpackb(
        packed, raw=False, strict_map_key=False)


@pytest.mark.parametrize("seed", range(4))
def test_codec_random_payloads_like_msgpack(seed):
    rng = random.Random(seed)

    def value(depth=0):
        kind = rng.randrange(9 if depth < 3 else 6)
        if kind == 0:
            return rng.choice([None, True, False])
        if kind == 1:
            return rng.randrange(-(2**63), 2**64)
        if kind == 2:
            return rng.random() * 10 ** rng.randrange(-8, 8)
        if kind == 3:
            return "".join(chr(rng.randrange(32, 0x3000)) for _ in range(rng.randrange(300)))
        if kind == 4:
            return bytes(rng.randrange(256) for _ in range(rng.randrange(300)))
        if kind == 5:
            return rng.randrange(-40, 300)
        if kind == 6:
            return [value(depth + 1) for _ in range(rng.randrange(20))]
        if kind == 7:
            return tuple(value(depth + 1) for _ in range(rng.randrange(5)))
        return {rng.choice([rng.randrange(-99, 99), str(rng.random())]): value(depth + 1)
                for _ in range(rng.randrange(20))}

    for _ in range(300):
        v = value()
        packed = msgpack.packb(v, use_bin_type=True)
        assert _msgpack.packb(v) == packed
        assert _msgpack.unpackb(packed) == msgpack.unpackb(packed, raw=False, strict_map_key=False)


@pytest.mark.parametrize(
    "value",
    [np.int64(3), np.int32(-1), np.float32(1.0), np.bool_(True), complex(1, 2), {1, 2}, object(),
     [np.int64(1)], {"m": np.float32(2)}, 2**64, -(2**63) - 1],
    ids=lambda v: type(v).__name__,
)
def test_codec_refuses_what_msgpack_refuses(value):
    with pytest.raises(Exception) as ref:
        msgpack.packb(value, use_bin_type=True)
    with pytest.raises(type(ref.value)) as got:
        _msgpack.packb(value, use_bin_type=True)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize(
    "data",
    [b"\x91\x01\x02", b"\x92\x01", b"\xc1", b"\xa1\xff", b"", b"\xdb\xff\xff\xff\xff", b"\xc6\x00"],
    ids=["trailing", "truncated", "reserved", "bad_utf8", "empty", "long_str", "short_len"],
)
def test_codec_unpack_errors_are_value_errors(data):
    with pytest.raises(ValueError):
        _msgpack.unpackb(data)
    with pytest.raises(Exception):
        msgpack.unpackb(data, raw=False, strict_map_key=False)


def test_codec_refuses_ext_types():
    """msgpack reads an ext type as ``ExtType``; no record holds one, so
    the port's codec refuses it (storage then rebuilds the record)."""
    assert isinstance(msgpack.unpackb(b"\xd4\x01\x02", raw=False, strict_map_key=False), msgpack.ExtType)
    with pytest.raises(ValueError, match="ext type"):
        _msgpack.unpackb(b"\xd4\x01\x02")


def test_codec_unhashable_key_and_depth():
    data = msgpack.packb({(1, 2): 3}, use_bin_type=True)  # an array key
    with pytest.raises(TypeError):
        _msgpack.unpackb(data)
    deep = []
    for _ in range(600):
        deep = [deep]
    with pytest.raises(ValueError, match="recursion limit"):
        _msgpack.packb(deep)


# --- records across the packages ---------------------------------------------


def record_fields(index: int) -> dict:
    rng = np.random.default_rng(index)
    li = [rng.standard_normal((int(n), 8)).astype(np.float32) for n in (3, 0, 5)]
    base = dict(
        format_version=FORMAT_VERSION,
        index_settings={"parser": {"chunk_size": 1000}, "embedder": {"model_id": "m", "dim": 8}},
        chunks=[("alpha", {"chunk_id": 0, "page_number": 1, "source": "u#page=1"}),
                ("béta — ünïcode", {"chunk_id": 1, "source": "u", "extra": [1, 2.5, None, True]}),
                ("", {"chunk_id": 2, "page_number": 3, 7: "int key"})],
        text_index=[["alpha"], ["beta", "unicod"], []],
        embeddings_index=[rng.standard_normal((1, 8)).astype(np.float32) for _ in range(3)],
        multimodal_embeddings_index=[rng.standard_normal((1, 4)).astype(np.float32) for _ in range(3)],
        description_embeddings_index=[np.zeros((0, 8), np.float32), np.full((2, 8), 0.5, np.float32),
                                      rng.standard_normal((1, 8)).astype(np.float32)],
        mime_type="application/pdf",
        document_bytes=b"%PDF-1.5 " + bytes(range(256)),
        late_interaction_index=li,
        chargram_index=[["alpha"], ["béta", "ünïcode"], []],
    )
    if index == 1:  # the optional indexes absent
        base.update(late_interaction_index=None, chargram_index=None, multimodal_embeddings_index=None,
                    description_embeddings_index=None)
    if index == 2:  # no embeddings at all
        base.update(embeddings_index=None, text_index=None)
    return base


def make_record(model, index: int = 0, **overrides) -> object:
    fields = {**record_fields(index), **overrides}
    fields["index_settings"] = model.IndexSettings(indexes=fields["index_settings"])
    fields["chunks"] = [model.Chunk(text=t, metadata=dict(m)) for t, m in fields["chunks"]]
    return model.DocumentRecord(**fields)


def fields_of(record) -> dict:
    """Every serialized field, arrays as (dtype, shape, bytes)."""
    def arrays(multi):
        return None if multi is None else [(a.dtype.str, a.shape, a.tobytes()) for a in multi]

    out = {f.name: getattr(record, f.name) for f in dataclasses.fields(record) if f.name != "cache_token"}
    out["index_settings"] = record.index_settings.indexes
    out["chunks"] = [(c.text, c.metadata) for c in record.chunks]
    for name in ("embeddings_index", "multimodal_embeddings_index", "description_embeddings_index",
                 "late_interaction_index"):
        out[name] = arrays(out[name])
    return out


@pytest.mark.parametrize("index", range(3))
def test_records_cross_between_packages(index):
    port_rec, jax_rec = make_record(port_model, index), make_record(jax_model, index)
    port_bytes, jax_bytes = serialize_record(port_rec), jax_serialization.serialize_record(jax_rec)
    # gzip stamps the time into its header: the msgpack payloads are the bytes to compare
    assert gzip.decompress(port_bytes) == gzip.decompress(jax_bytes)
    from_jax = deserialize_record(jax_bytes)
    from_port = jax_serialization.deserialize_record(port_bytes)
    assert type(from_jax) is DocumentRecord and type(from_port) is jax_model.DocumentRecord
    assert fields_of(from_jax) == fields_of(port_rec) == fields_of(from_port) == fields_of(jax_rec)
    assert from_jax.chunks[2].metadata[7] == "int key"


def test_numpy_scalar_in_metadata_is_refused_like_msgpack():
    chunks = [("x", {"chunk_id": 0, "page_number": np.int64(1)})]
    with pytest.raises(TypeError) as ref:
        jax_serialization.serialize_record(make_record(jax_model, chunks=chunks))
    with pytest.raises(TypeError) as got:
        serialize_record(make_record(port_model, chunks=chunks))
    assert str(got.value) == str(ref.value)


# --- tests/test_storage.py through the port ----------------------------------


def simple_record(**overrides) -> DocumentRecord:
    base = dict(
        format_version=FORMAT_VERSION,
        index_settings=IndexSettings(indexes={"parser": {"chunk_size": 1000}}),
        chunks=[Chunk(text="alpha", metadata={"chunk_id": 0, "page_number": 1}),
                Chunk(text="beta", metadata={"chunk_id": 1, "source": "u"})],
        text_index=[["alpha"], ["beta"]],
        embeddings_index=[np.ones((1, 4), np.float32), np.arange(4, dtype=np.float32).reshape(1, 4)],
        multimodal_embeddings_index=None,
        description_embeddings_index=[np.zeros((0, 4), np.float32), np.full((2, 4), 0.5, np.float32)],
        mime_type="application/pdf",
        document_bytes=b"%PDF-1.4 fake",
    )
    base.update(overrides)
    return DocumentRecord(**base)


def test_roundtrip():
    rec = simple_record()
    out = deserialize_record(serialize_record(rec))
    assert (out.format_version, out.index_settings, out.text_index) == (
        rec.format_version, rec.index_settings, rec.text_index)
    assert [c.text for c in out.chunks] == ["alpha", "beta"]
    assert out.chunks[0].metadata == {"chunk_id": 0, "page_number": 1}
    np.testing.assert_array_equal(out.embeddings_index[1], rec.embeddings_index[1])
    assert out.multimodal_embeddings_index is None
    assert out.description_embeddings_index[0].shape == (0, 4)
    assert (out.document_bytes, out.mime_type) == (rec.document_bytes, "application/pdf")


def test_no_pickle_involved():
    data = serialize_record(simple_record())
    assert b"pickle" not in data and not gzip.decompress(data).startswith(b"\x80")


async def test_index_storage_load_store_and_invalidation(tmp_path):
    storage = IndexStorage(LocalFileStorage(str(tmp_path)))
    settings = IndexSettings(indexes={"parser": {"chunk_size": 1000}})
    url = link_to_index_url("files/bucket/doc.pdf", "rag-bucket")
    assert await storage.load(url, settings) is None
    await storage.store(url, simple_record(index_settings=settings))
    loaded = await storage.load(url, settings)
    assert loaded is not None and [c.text for c in loaded.chunks] == ["alpha", "beta"]
    assert await storage.load(url, IndexSettings(indexes={"parser": {"chunk_size": 500}})) is None
    await storage.store(url, simple_record(format_version=FORMAT_VERSION - 1, index_settings=settings))
    assert await storage.load(url, settings) is None
    (tmp_path / url).write_bytes(b"garbage")
    assert await storage.load(url, settings) is None


def test_link_to_index_url_layout():
    url = link_to_index_url("files/bucket/doc.pdf", "rag-bucket")
    assert url.startswith("files/rag-bucket/dial-rag-index/") and url.endswith("/index.bin")
    parts = url.split("/")[3:-1]
    assert len(parts) == 8 and all(len(p) == 8 for p in parts)
    assert url == jax_link_to_index_url("files/bucket/doc.pdf", "rag-bucket")
    assert url != link_to_index_url("files/bucket/doc2.pdf", "rag-bucket")


async def test_lru_eviction_by_bytes():
    telemetry.metrics().reset()
    cache = LRUCacheStorage(capacity=100)
    await cache.store("a", b"x" * 40)
    await cache.store("b", b"y" * 40)
    assert await cache.load("a") is not None
    await cache.store("c", b"z" * 40)
    assert await cache.load("b") is None
    assert await cache.load("a") is not None and await cache.load("c") is not None
    assert cache.size <= 100
    await cache.store("huge", b"h" * 1000)
    assert await cache.load("huge") is None and await cache.load("a") is not None
    assert (telemetry.metrics().total("dial_rag.index_cache.hits"),
            telemetry.metrics().total("dial_rag.index_cache.misses")) == (4, 2)


async def test_holder_shares_cache_across_storages(tmp_path):
    holder = IndexStorageHolder()
    remote = LocalFileStorage(str(tmp_path))
    settings = IndexSettings()
    await holder.get_storage(remote).store("files/b/x/index.bin", simple_record(index_settings=settings))
    (tmp_path / "files/b/x/index.bin").unlink()
    assert await holder.get_storage(remote).load("files/b/x/index.bin", settings) is not None


@pytest.mark.parametrize("url", ["files/../../../../etc/evil", "../outside", "files/b/../../../x"])
def test_local_storage_rejects_path_traversal(tmp_path, url):
    storage = LocalFileStorage(str(tmp_path / "root"))
    with pytest.raises(InvalidAttachmentError, match="escapes the storage root"):
        asyncio.run(storage.store(url, b"x"))
    with pytest.raises(InvalidAttachmentError):
        asyncio.run(storage.load(url))
    asyncio.run(storage.store("files/b/ok/index.bin", b"data"))
    assert asyncio.run(storage.load("files/b/ok/index.bin")) == b"data"


async def test_record_memo_skips_decode_but_not_invalidation(tmp_path, monkeypatch):
    class NoValidatorStorage(LocalFileStorage):
        async def validator(self, url):
            return None

    holder = IndexStorageHolder()
    remote = NoValidatorStorage(str(tmp_path))
    settings = IndexSettings(indexes={"parser": {"chunk_size": 1000}})
    await IndexStorage(remote).store("files/b/m/index.bin", simple_record(index_settings=settings))
    calls = []
    real = storage_mod.deserialize_record
    monkeypatch.setattr(storage_mod, "deserialize_record", lambda data: calls.append(1) or real(data))
    first = await holder.get_storage(remote).load("files/b/m/index.bin", settings)
    assert first is not None and len(calls) == 1
    second = await holder.get_storage(remote).load("files/b/m/index.bin", settings)
    assert second is first and len(calls) == 1 and second.cache_token == first.cache_token
    other = IndexSettings(indexes={"embedder": {"model_id": "other"}})
    assert await holder.get_storage(remote).load("files/b/m/index.bin", other) is None
    rec2 = simple_record(index_settings=settings,
                         chunks=[Chunk(text="reminted", metadata={"chunk_id": 0, "page_number": 1})])
    await holder.get_storage(remote).store("files/b/m/index.bin", rec2)
    reloaded = await holder.get_storage(remote).load("files/b/m/index.bin", settings)
    assert reloaded.chunks[0].text == "reminted"


def test_record_memo_sha_pins_bounded_bytes():
    memo = RecordMemo(max_sha_entries=64, max_sha_bytes=1000)
    big = b"x" * 2000
    assert memo.sha("u0", big) == _sha256(big)
    assert memo._sha_bytes == 0 and "u0" not in memo._sha_by_url
    blobs = {f"u{i}": bytes([i]) * 300 for i in range(1, 8)}
    for url, data in blobs.items():
        assert memo.sha(url, data) == _sha256(data)
        assert memo._sha_bytes <= 1000
        assert memo._sha_bytes == sum(len(d) for d, _ in memo._sha_by_url.values())
    assert memo.sha("u7", blobs["u7"]) == _sha256(blobs["u7"]) and "u7" in memo._sha_by_url
    replacement = b"y" * 300
    memo.sha("u7", replacement)
    assert memo._sha_bytes <= 1000 and memo._sha_by_url["u7"][0] is replacement


async def test_validated_memo_skips_byte_reads(tmp_path):
    class CountingLocalStorage(LocalFileStorage):
        def __init__(self, root):
            super().__init__(root)
            self.byte_loads = 0

        async def load(self, url):
            self.byte_loads += 1
            return await super().load(url)

    telemetry.metrics().reset()
    holder = IndexStorageHolder()
    remote = CountingLocalStorage(str(tmp_path))
    settings = IndexSettings(indexes={"parser": {"chunk_size": 1000}})
    rec = simple_record(index_settings=settings)
    url = "files/b/v/index.bin"
    await holder.get_storage(remote).store(url, rec)
    for _ in range(2):
        assert await holder.get_storage(remote).load(url, settings) is rec and remote.byte_loads == 0
    assert telemetry.metrics().total("dial_rag.record_memo.validated_hits") == 2
    other = IndexSettings(indexes={"embedder": {"model_id": "other"}})
    assert await holder.get_storage(remote).load(url, other) is None and remote.byte_loads == 0
    rec2 = simple_record(index_settings=settings, chunks=[Chunk(text="gamma", metadata={"chunk_id": 0})])
    await asyncio.sleep(0.01)
    (tmp_path / url).write_bytes(serialize_record(rec2))
    got = await holder.get_storage(remote).load(url, settings)
    assert got is not rec and remote.byte_loads == 1 and [c.text for c in got.chunks] == ["gamma"]
    again = await holder.get_storage(remote).load(url, settings)
    assert again is got and remote.byte_loads == 1


async def test_storage_written_by_one_package_loads_in_the_other(tmp_path):
    from dial_rag_tpu.storage.storage import IndexStorage as JaxIndexStorage
    from dial_rag_tpu.storage.storage import LocalFileStorage as JaxLocalFileStorage

    jax_store = JaxIndexStorage(JaxLocalFileStorage(str(tmp_path)))
    port_store = IndexStorage(LocalFileStorage(str(tmp_path)))
    jax_rec, port_rec = make_record(jax_model), make_record(port_model)
    await jax_store.store("files/b/j/index.bin", jax_rec)
    await port_store.store("files/b/p/index.bin", port_rec)
    from_jax = await port_store.load("files/b/j/index.bin", IndexSettings(record_fields(0)["index_settings"]))
    from_port = await jax_store.load("files/b/p/index.bin",
                                     jax_model.IndexSettings(record_fields(0)["index_settings"]))
    assert fields_of(from_jax) == fields_of(jax_rec) and fields_of(from_port) == fields_of(port_rec)
    assert from_jax.cache_token == jax_rec.cache_token and from_port.cache_token == port_rec.cache_token


# --- cache_token and the device cache ----------------------------------------


def test_storage_stamps_cache_token(tmp_path):
    async def run():
        storage = IndexStorageHolder().get_storage(LocalFileStorage(str(tmp_path)))
        rec = DocumentRecord(
            format_version=FORMAT_VERSION, index_settings=IndexSettings(),
            chunks=build_chunks_list([("text", {"source": "s"})]), text_index=[["text"]], embeddings_index=None,
            multimodal_embeddings_index=None, description_embeddings_index=None, mime_type="text/plain",
            document_bytes=b"",
        )
        assert rec.cache_token is None
        await storage.store("files/b/x/index.bin", rec)
        data = (tmp_path / "files/b/x/index.bin").read_bytes()
        assert rec.cache_token == ("files/b/x/index.bin", _sha256(data))
        loaded = await storage.load("files/b/x/index.bin", IndexSettings())
        assert loaded.cache_token == rec.cache_token
        fresh = await IndexStorage(LocalFileStorage(str(tmp_path))).load("files/b/x/index.bin", IndexSettings())
        assert fresh is not rec and fresh.cache_token == rec.cache_token
        return True

    assert asyncio.run(run())


def test_loaded_record_builds_without_warning_and_hits_the_device_cache(tmp_path):
    """A record read back from storage holds read-only arrays: the four
    arms build from it with no warning (no write into its buffers), and
    a second load of the same bytes is a device-cache hit."""
    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.index.device_cache import DeviceIndexCache
    from dial_rag_tpu_torch.models.tokenizer import build_test_vocab
    from dial_rag_tpu_torch.retrieval import (
        Bm25Retriever,
        ChargramRetriever,
        LateInteractionRetriever,
        SemanticRetriever,
    )

    texts = ["the alps stretch across eight countries", "glaciers shaped the valleys", "mont blanc is high"]
    emb = BgeEmbedder.from_random(vocab=build_test_vocab(sorted({w for t in texts for w in t.split()})),
                                  device="cpu", batch_size=4)
    chunks = build_chunks_list([(t, {"source": "s"}) for t in texts])
    rec = DocumentRecord(
        format_version=FORMAT_VERSION, index_settings=IndexSettings(), chunks=chunks,
        text_index=Bm25Retriever.build_index(chunks), embeddings_index=SemanticRetriever.build_index(emb, chunks),
        multimodal_embeddings_index=None, description_embeddings_index=None, mime_type="text/plain",
        document_bytes=b"", late_interaction_index=LateInteractionRetriever.build_index(emb, chunks, 16),
        chargram_index=ChargramRetriever.build_index(chunks),
    )
    holder = IndexStorageHolder()
    asyncio.run(IndexStorage(LocalFileStorage(str(tmp_path))).store("files/b/r/index.bin", rec))
    cache = DeviceIndexCache()

    def load_and_build():
        loaded = asyncio.run(holder.get_storage(LocalFileStorage(str(tmp_path))).load("files/b/r/index.bin",
                                                                                     IndexSettings()))
        assert not loaded.embeddings_index[0].flags.writeable  # np.frombuffer over the stored bytes
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            arms = [SemanticRetriever.from_doc_records(emb, [loaded], k=2, device_cache=cache),
                    Bm25Retriever.from_doc_records([loaded], k=2, device="cpu", device_cache=cache),
                    ChargramRetriever.from_doc_records([loaded], k=2, device="cpu", device_cache=cache),
                    LateInteractionRetriever.from_doc_records(emb, [loaded], k=2, device_cache=cache)]
            hits = [[h.key for h in arm.retrieve("glaciers valleys")] for arm in arms]
        return loaded, hits

    first, hits = load_and_build()
    assert (cache.misses, cache.hits) == (4, 0)
    second, again = load_and_build()
    assert second.cache_token == first.cache_token == rec.cache_token
    assert (cache.misses, cache.hits) == (4, 4) and again == hits
    assert cache.wait_warm(60)
