"""The description arm (``retrieval/description.py``) and the multimodal
arm's client (``embeddings/multimodal.py``) of the port against the JAX
package's, on the CPU.

Tolerances, stated before any comparison: the vision-LLM JSON parsing,
the page-description chunks and the prompt are equal; description
embeddings within EMBED_ATOL of the JAX package's (the tiny f32 encoder
on the CPU, its weights carried over with ``params_from_jax_numpy``); the
description hits are the JAX retriever's. The scripted vision LLM is
tests/utils/fake_dial.py's, answering each page's request in turn.
"""

import base64
import dataclasses
import inspect
import io
import re

import jax
import numpy as np
import pytest

from dial_rag_tpu.documents.parser import parse_document as jax_parse_document
from dial_rag_tpu.embeddings.embedder import BgeEmbedder as JaxEmbedder
from dial_rag_tpu.models.bert import BertConfig as JaxBertConfig
from dial_rag_tpu.models.tokenizer import build_test_vocab
from dial_rag_tpu.retrieval import description as jax_description
from dial_rag_tpu.runtime.limited import DialLimitedResources as JaxLimited
from dial_rag_tpu.runtime.limited import TokenStats as JaxTokenStats
from dial_rag_tpu.runtime.limited import UserLimitsForModel as JaxLimits
from dial_rag_tpu.service.config import DescriptionIndexConfig as JaxDescriptionConfig
from dial_rag_tpu_torch.documents.parser import parse_document
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.models.bert import BertConfig, BertEncoder
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer
from dial_rag_tpu_torch.retrieval import description
from dial_rag_tpu_torch.runtime.limited import DialLimitedResources, TokenStats, UserLimitsForModel
from dial_rag_tpu_torch.service.config import DescriptionIndexConfig
from dial_rag_tpu_torch.utils.streams import NullStream
from dial_rag_tpu_torch.weights import params_from_jax_numpy
from tests.utils.fake_dial import FakeDialCore
from tests.utils.image_pdf import build_image_pdf
from tests.utils.port_parity import same, twin_module

EMBED_ATOL = 1e-5
IMAGE_LEVELS = 3  # tests/test_torch_render.py's gate on page images

PARSING = twin_module("test_description_parsing")
PARSING_CASES = sorted(n for n in dir(PARSING) if n.startswith("test_"))
REPLIES = [
    '{"page_summary": "The Alps and the Cadibona pass.", "keyfact": "Cadibona is the southern boundary.",'
    ' "image_quality": {"level": "detailed", "explanation": "small map labels"},'
    ' "images": [{"description": "A relief map", "type": "map", "keyfact": "Mont Blanc is highest"}],'
    ' "tables": [{"description": "No tables are present"}]}',
    'Sure! ```json\n{"page_summary": "Alpine climate by elevation.", "keyfact": "Climate varies",}\n```',
    "plain prose about glaciers carving valleys, no JSON at all",
    '{"page_summary": "Rivers: the Rhine and the Rhone.", "tables": [{"description": "River lengths",'
    ' "keyfact": "The Rhine is longer"}]}',
]
QUERIES = ["southern boundary of the alps", "climate and elevation", "glaciers", "river lengths"]


@pytest.mark.parametrize("case", PARSING_CASES)
def test_description_parsing_cases_hold_for_the_port(case):
    """Every case of tests/test_description_parsing.py, on the port."""
    fn = getattr(PARSING, case)
    fn(*[None for _ in inspect.signature(fn).parameters])


@pytest.mark.parametrize("text", REPLIES + ["", "{", '{"images": "not a list"}', "{'keyfact': 'single quotes',}"])
def test_parsing_and_chunks_equal_the_jax_package(text):
    same(lambda P: P.m("retrieval.description").parse_page_description(text))
    same(lambda P: P.m("retrieval.description").parse_page_description(text).to_chunks())
    same(lambda P: P.m("retrieval.description").repair_and_parse_json(text))


def test_prompt_is_the_jax_package_byte_for_byte():
    assert description.PAGE_DESCRIPTION_PROMPT == jax_description.PAGE_DESCRIPTION_PROMPT
    assert description.MAX_RETRIES == jax_description.MAX_RETRIES


def _limits(limited, limits, stats):
    async def get(model_name):
        return limits(minute_token_stats=stats(total=10**9, used=0), day_token_stats=stats(total=10**9, used=0))

    return limited(get)


@pytest.fixture(scope="module")
def embedders():
    words = sorted(set(re.findall(r"[a-z]+", " ".join(REPLIES + QUERIES).lower())))
    config = dataclasses.replace(JaxBertConfig.tiny(), max_position_embeddings=512)
    jax_emb = JaxEmbedder.from_random(config=config, vocab=build_test_vocab(words), batch_size=4)
    port_emb = BgeEmbedder(
        tokenizer=WordPieceTokenizer(vocab=jax_emb.tokenizer.vocab),
        encoder=BertEncoder(dataclasses.replace(BertConfig.tiny(), max_position_embeddings=512)),
        params=params_from_jax_numpy(jax.tree.map(np.asarray, jax_emb.params)),
        device="cpu",
        batch_size=jax_emb.batch_size,
        model_id=jax_emb.model_id,
    )
    return jax_emb, port_emb


async def test_description_index_and_hits_equal_the_jax_package(embedders):
    """build_index through each package against the scripted vision LLM
    (one request a page, each with the prompt and the page's PNG), then
    the description arm's hits for each query."""
    pdf = build_image_pdf([([(72, 700, 14, f"Page {i}: the Alps, part {i}")],
                            [(72, 300, 200, 150, np.full((30, 40, 3), 40 * i, np.uint8))]) for i in range(4)])
    await _description_index_and_hits(embedders, pdf)


async def test_description_index_of_jpx_and_arithmetic_jpeg_pages_equals_the_jax_package(embedders):
    """The same through both packages for a PDF whose pages hold a JPEG 2000
    photograph (9/7), a JPEG 2000 gray scan (5/3), an arithmetic-coded
    JPEG and a lossless JPEG: the page images the vision LLM receives
    within IMAGE_LEVELS of the JAX package's below the text line, the
    index and hits equal."""
    from PIL import Image

    from tests.utils import image_encoders as enc
    from tests.utils.make_jpeg_fixtures import photo

    a = photo(60, 80, 3)

    def jpx(image, **options):
        buf = io.BytesIO()
        image.save(buf, "JPEG2000", **options)
        return buf.getvalue()

    images = [("jpx", jpx(Image.fromarray(a), irreversible=True, quality_layers=[20]), 80, 60, 3),
              ("jpx", jpx(Image.fromarray(a[..., 1]), no_jp2=True), 80, 60, 1),
              ("dct", enc.jpeg_arithmetic(a, progressive=True), 80, 60, 3),
              ("dct", enc.jpeg_lossless(a[..., 2], predictor=4), 80, 60, 1)]
    pdf = build_image_pdf([([(72, 700, 14, f"Page {i}: the Alps, part {i}")], [(72, 300, 200, 150, image)])
                           for i, image in enumerate(images)])
    pages = await _description_index_and_hits(embedders, pdf)
    for got, ref in zip(pages["port"], pages["jax"]):
        below_text = got.shape[0] // 4  # the page's text line is drawn in a font only close to PIL's
        assert got.shape == ref.shape
        assert int(np.abs(got.astype(np.int64) - ref)[below_text:].max()) <= IMAGE_LEVELS
        assert got[below_text:].min() < 200  # the image was drawn


async def _description_index_and_hits(embedders, pdf: bytes) -> dict:
    """Both packages' description index of ``pdf`` and hits, equal; returns
    each package's page images as the vision LLM received them."""
    from dial_rag_tpu_torch.image_processor.png import decode_png

    jax_emb, port_emb = embedders
    out, images = {}, {}
    for pkg, mod, emb, cfg, limited in (
        ("jax", jax_description, jax_emb, JaxDescriptionConfig, _limits(JaxLimited, JaxLimits, JaxTokenStats)),
        ("port", description, port_emb, DescriptionIndexConfig, _limits(DialLimitedResources, UserLimitsForModel,
                                                                          TokenStats)),
    ):
        fake = FakeDialCore()
        fake.script_llm(*REPLIES)
        url = await fake.start()
        try:
            packed = await mod.DescriptionRetriever.build_index(
                url, "key", limited, cfg(), emb, pdf, "application/pdf", NullStream())
        finally:
            await fake.stop()
        prompts = [r["messages"][0]["content"] for r in fake.llm_requests]
        assert len(prompts) == 4 and all(p[0]["text"] == mod.PAGE_DESCRIPTION_PROMPT for p in prompts)
        assert all(p[1]["image_url"]["url"].startswith("data:image/png;base64,") for p in prompts)
        images[pkg] = [decode_png(base64.b64decode(p[1]["image_url"]["url"].split(",", 1)[1])) for p in prompts]
        parse = jax_parse_document if pkg == "jax" else parse_document
        chunks = parse(pdf, "application/pdf", source_link="doc.pdf")
        record = type("Record", (), {"chunks": chunks, "description_embeddings_index": packed})()
        retriever = mod.DescriptionRetriever.from_doc_records(emb, [record], k=3)
        hits = [[(h.doc_id, h.chunk_id) for h in await retriever.aretrieve(q)] for q in QUERIES]
        out[pkg] = (packed, hits, mod.DescriptionRetriever.has_index([record]))
    (ref, ref_hits, ref_has), (got, got_hits, got_has) = out["jax"], out["port"]
    assert [len(p) for p in got] == [len(p) for p in ref] == [4, 2, 1, 3]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=EMBED_ATOL, rtol=0)
    assert got_hits == ref_hits and got_has == ref_has is True
    return images


async def test_multimodal_rate_limit_collapses_to_one_error():
    """embeddings/multimodal.py on the port's HTTP client: a 429 past the
    retries is one RateLimitError naming the model, as in the JAX package;
    an image embeds through custom_input."""
    from dial_rag_tpu.embeddings.multimodal import MultimodalEmbeddingsClient as JaxClient
    from dial_rag_tpu_torch.embeddings.multimodal import MultimodalEmbeddingsClient
    from dial_rag_tpu_torch.errors import RateLimitError

    fake = FakeDialCore()
    url = await fake.start()
    try:
        vectors = [await cls(url, "k", "mm").aembed_image("aGVsbG8=") for cls in (JaxClient, MultimodalEmbeddingsClient)]
        np.testing.assert_array_equal(vectors[1], vectors[0])
        fake.embeddings_status = 429
        with pytest.raises(RateLimitError, match="Rate limit exceeded for mm"):
            await MultimodalEmbeddingsClient(url, "k", "mm").aembed_query("q")
    finally:
        await fake.stop()
