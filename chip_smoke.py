#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dial_rag_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced by a ``[phase]`` line:

1. device: the card's name, CUDA version and ``nvidia-smi`` name/power limit;
2. build: ``nvcc`` builds the kernels in ``dial_rag_tpu_torch/csrc`` and
   prints the registers, spill and shared memory of the newer ones; g++
   builds the C++ host cores in ``dial_rag_tpu_torch/native`` meanwhile
   (a failed build of either stops the run);
3. kernels: each block kernel (attention, FFN, whole layer) in each
   instantiation (bf16 and f32; H=384 with the shipped checkpoint's
   layer-0 weights, H=768 with a seeded bge-base-width encoder's) against
   its plain PyTorch version at B=128, S=256, and timed (CUDA events)
   beside its bound and a PyTorch composition, the whole layer also
   bit-equal to kernels 1 then 2, and kernel 1 in bf16 profiled by stage
   (QKV projection, attention, output projection, LayerNorm); in f32
   (split-TF32 products) each block also read against the block
   evaluated in f64 (at most 1.5 times the plain version's distance) and
   kernels 1 and 2 profiled by stage; kernels 1-3 in bf16 and f32 also at
   bge-large's H=1024 (16 heads of 64) on a seeded layer;
4. main path: ``BgeEmbedder`` (bf16, ``checkpoints/alps-semantic``) embeds
   2048 chunks into a ``SemanticRetriever`` and answers queries; a seeded
   1M x 384 f32 ``DenseIndex`` answers ``find_batch``. The kernels' launch
   counts must equal 12 x the encode batches; top-1 hits must agree with
   the same path through the plain versions; embeddings must agree with
   the f32 path on a few chunks.

   document indexing: the same 2048 texts laid out as 16 PDF manuals of
   128 pages (one text a page, wrapped into lines; plain, Flate and
   xref-stream variants, written by the port's ``documents/pdf/writer.py``)
   and 4 DOCX, 4 PPTX, 2 XLSX, 2 Markdown, 2 plain-text and 2 CSV
   documents of further texts, one indexing request: ``detect_mime`` ->
   ``parse_document`` (in spawned worker processes), the bf16 semantic
   index (kernels 1-2 must launch 12 x the encode batches) and the BM25
   text index, ``serialize_record`` -> ``IndexStorage.store`` over
   ``LocalFileStorage`` in a temporary directory, a fresh
   ``IndexStorage.load`` of every record, then semantic, BM25 and RRF
   retrieval of the 64 queries over the loaded records. Gates: each PDF
   page's chunks hold its text word for word; each loaded record equals
   the stored one (chunks, text index, every array bit for bit) with the
   ``cache_token`` (url, sha256 of the stored bytes); the hits over the
   loaded records equal those over the records before storage in every
   arm; a second request is a storage memo or byte-LRU hit and a
   device-cache hit and launches no encoder kernel; the kernel encode of the parsed chunks has
   the plain version's top-1. Prints documents, pages and chunks by
   format, parse s and pages/s, encode s and device ms, serialize, store
   and load s, record bytes raw and gzipped, and the storage and
   device-cache counters.

   hybrid retrieval: the same 2048 chunks' keyword preprocessing (the C++
   core ``native/keywords.cpp`` for ASCII text, the Python path for the
   rest, which stems with ``porter_lite`` where ``nltk`` is missing), a
   ``Bm25Retriever`` over them (the dense [N, V] layout), its 64 queries
   in a batch and 5 singly, then ``EnsembleRetriever`` (semantic k=7 +
   BM25 k=7, RRF) through ``aretrieve_batch`` and 5 ``aretrieve`` calls:
   kernels 1-2 must launch 12 x the encode batches; BM25 scores within
   rtol 1e-5 / atol 1e-6 of the same port code on the CPU, top-7 equal
   apart from near-ties, and the fused lists equal to the fusion of the
   CPU arms' lists wherever both arms agree;

   BM25 1M: 1M items of 48 unique Zipf(1.1) terms over 262,144 (seed 0)
   through ``Bm25Index.from_term_weight_arrays`` (a 128-column band and a
   CSC tail), 64 queries of 8 terms in a batch and 5 singly; scores and
   top-7 against a host scipy scoring on 4 queries, the same bits when
   scored twice, and a planted group of 16 identical items ranked latest
   first.

   dense layouts: the seeded 1M x 384 matrix again, with 300 identical
   rows and 300 within 1e-7 of them planted, as float32, bfloat16,
   two_pass and int8 ``DenseIndex``es built from the host rows, each
   answering ``find_batch`` of the 64 queries and ``find`` of 5 (timed,
   beside its bound, with the scan's memory beyond the index): the bf16
   scan may hold at most a tenth of the index beyond it; a lone query
   (float32 and bfloat16), whose scores are ranked whole, must give the
   hits of the same query ranked a block at a time, on every query (but
   near-ties), distances within 2e-6, and its device time is printed;
   two_pass must give float32's hits on
   every query, alone and batched, distances within 2e-6, and fall back
   on the planted rows (the fallbacks of the 64 queries printed); int8
   distances within rtol 1e-6 of the same code on the CPU on 4 queries,
   top-7 equal apart from near-ties, and overlapping float32's top-7 by
   at least 0.85.

   late interaction: ``checkpoints/alps-maxsim`` in bf16 token-encodes the
   2048 chunks (256 tokens a chunk; kernels 1-2 must launch 12 x the
   encode batches) into float32, bfloat16 and int8
   ``LateInteractionIndex``es, which answer the 64 queries through
   ``retrieve_batch`` and 5 through ``retrieve`` and ``aretrieve``; each
   MaxSim scan timed beside its bound; scores of 4 queries over the first
   256 chunks within 1e-5 of the same code on the CPU, top-7 equal apart
   from near-ties, a batch scored twice the same bits, batch equal to
   single, each query's scores over every chunk from its lone encode
   within 1e-5 of its batch encode's, ``retrieve_batch``'s hits those of
   ``retrieve`` on all 64 queries (swaps only within twice that drift),
   ``embed_query_tokens_device``'s rows the host rows bit for bit.

   local arms ensemble: the chargram arm (the C++ core
   ``native/chargram.cpp``) and the word vectors of BM25's query
   expansion built over the same chunks and timed, then the RRF ensemble
   of the semantic, late-interaction, expanded BM25 and chargram arms
   (k = 7 each) through ``aretrieve_batch`` and 5 ``aretrieve`` calls:
   kernels 1-2 12 x the encode batches, chargram scores within rtol 1e-5 /
   atol 1e-6 of the CPU's, the fused lists the fusion of the CPU arms'
   lists wherever every arm agrees.

   concurrent serving: the four arms (semantic, late interaction in
   bfloat16, expanded BM25, chargram; k = 7) over the same chunks, their
   record stored through ``IndexStorage`` and loaded back (the load
   stamps its cache token), rebuilt per request through one
   ``DeviceIndexCache`` (1 GiB); 64 requests on one event loop through
   ``asyncio.gather`` (each under ``asyncio.wait_for``) awaiting
   ``EnsembleRetriever.aretrieve``, after a warm-up wave and
   ``wait_warm``, then the same 64 one at a time. Gates: every request's
   fused hits equal to its lone run's but for arm near-ties (the hybrid
   phase's gap rules), the dense query rows of the coalesced and the lone
   encodes within 1e-5; at most 8 query-encode waves and kernels 1-2
   launching 12 x (encode waves + MaxSim token encodes) exactly; one
   cache miss per cached object, hits for the rest, the cache within its
   capacity and no warm-up thread alive after ``wait_warm``; a second
   cache below the late-interaction index's bytes keeping it alone, the
   next request rebuilding every arm (each a counted miss) with the same
   hits. Prints requests/s and p50 / p99 latency, concurrent and serial,
   the items per wave of each batcher and the device time of one
   coalesced wave beside its wall time.

   whole-layer serve: 256 of those chunks and 16 queries through the
   "fused_layer" route (the whole-layer kernel); its launches must equal
   12 x the encode batches, its embeddings agree with the "fused" and
   "fused_layer_plain" routes and its top-1 with the plain route;
5. attention kernels: the single-tile attention forward (packed qkv
   and head-major: in f32 one strided split-TF32 tensor-core kernel, in
   bf16 the tensor-core forward) and its recompute-P backward (one launch
   a (head, batch row) up to S = 128: in f32 of split-TF32 products, in
   bf16 of bf16 tensor-core products) against their plain versions in each
   instantiation (f32 and bf16, 12 heads of 32 and of 64), ragged S and a
   fully masked row, at fixed shapes, at S = 520, at the longest S their
   shared memory takes, past it (S = 1700, and every S past 128 for the
   backward: the query-blocked kernels' code, as the launch counters must
   show) and at every (B, S) the training and f32 serve phases give them;
   the single-tile backward in each dtype also timed against the
   query-blocked backward's code at [32, 12, 128 and 64, Dh]
   (``backward_designs``, both gated and run twice for the same bits);
   the bf16 tensor-core forward at S = 64 to 4096
   and the bf16 KV-blocked tensor-core forward (kernel 7) at S = 4608 and
   8192 (log-sum-exp too), at both head widths. Each timed beside its
   bound, the plain version
   and ``F.scaled_dot_product_attention`` (additive mask);
   auto repair: "auto" on a seeded 1-layer encoder at H=384 and 768
   where the port once raised, (f32, tanh GELU) through kernels 1-2 (and
   "fused_layer", kernel 3), (bf16, exact) through kernels 4 and 8, bf16
   and f32 at S = 520 through kernel 5 and kernel 8's route (past S = 128
   kernel 9's code), and at S = 1700, past the
   single-tile kernels' shared memory, through the query-blocked codes,
   each against the plain route;
   f32 tanh-GELU encode: one encode batch of the main path's chunks
   (B=128, S=256, 12 layers) and its 64 queries in f32 with tanh GELU,
   at bge-small widths (the checkpoint) and bge-base widths (the seeded
   encoder), through "auto" (kernels 1 and 2), "fused_layer" (kernel 3)
   and "fused_plain": 12 launches of each kernel an encode, the hidden
   states within 1e-4 of the plain route's ("fused_layer" equal to "auto"
   bit for bit), the embeddings' cosine above 1 - 1e-6, the same top-1,
   and each route's device time an encode with its kernels' shares;
   bf16 gradient: one bf16 ``contrastive_loss`` backward through "auto"
   (the fused block kernels, recompute backward) against the
   "fused_plain" route: the whole gradient's cosine > 0.9999, and each
   tensor at least as close as the plain "xla" route is;
   bf16 short-context gradient: one bf16 ``contrastive_loss`` backward of
   the training phase's first batch (B = 32, S = 64) at bge-small widths
   (the checkpoint) and at bge-base widths (the seeded encoder) through
   "pallas" (kernel 4 forward, kernel 8 backward, both in bf16), the
   "pallas_plain" route in bf16 and the "pallas" route in f32: the two
   counters layers x 2 encodes and no blocked backward, the kernel route's
   1 - cos to the f32 gradient at most BF16_NOISE_RATIO times the plain
   route's; prints the losses, the kernel route's cosine to the plain one
   and a device profile of one backward with kernel 8's share;
6. training: ``train()`` fine-tunes ``checkpoints/alps-semantic`` in f32
   at full width and depth for 20 steps of 32 (question, fact) pairs from
   ``eval/data/alps_handmade_questions.json``, no batch holding one fact
   twice (``positive_disjoint_stream``). Step 1 must match the
   plain route (loss rel 1e-5, gradient cosine > 0.9999); the losses must
   be finite and fall; the attention counters must read 12 layers x 2
   encodes x 20 steps; a restore from the step-10 checkpoint must be
   bit-exact and steps 11-20 must come out again (losses rel 1e-6).
   Checkpoints go to a temporary directory outside the checkout;
7. f32 serve: the trained params in an f32 ``BgeEmbedder`` embed the 155
   facts into a ``SemanticRetriever`` and answer the 155 questions; the
   forward counter must equal 12 x the encode batches and top-1 must
   agree with the plain route; ``export_hf_state`` and ``save_file``
   write the trained encoder (with the checkpoint's config, vocabulary and
   idf table) into a temporary directory, and ``from_hf_checkpoint`` must
   read back an encoder whose embeddings equal the trained one's bit for
   bit;
8. bge-base serve: a seeded encoder at BAAI/bge-base-en-v1.5's widths
   (12 layers, H=768, 12 heads of 64, FFN 3072, 512 positions, CLS
   pooling, the alps-semantic vocabulary) embeds the main path's 2048
   chunks in bf16 through "auto" (kernels 1-2) and answers its 64
   queries; top-1 must equal the "fused_plain" route's; then the
   "fused_layer" route on 256 of them, bit-equal to "fused" (kernel 3
   runs kernels 1 and 2's launch sequences); bge-base
   training: ``train()`` fine-tunes that encoder in f32 for 10 steps of 32
   Alps (question, fact) pairs at S = 64 (kernels 4 and 8 at head_dim
   64), each batch against the "pallas_plain" route, the loss falling;
9. long-document serve: a bge-small-width, 12-layer encoder with 8192
   positions and seeded weights, the ``alps-semantic`` vocabulary and
   tokenizer buckets up to 8192, indexes long texts made of the Alps
   oracle chunks (encode batches at S = 1024, 2048, 4096 and 8192) in bf16
   and in f32 and answers queries; the query-blocked (in bf16 the
   tensor-core forward) and KV-blocked kernels' launches must equal 12 x
   their encode batches, the embeddings agree with the "pallas_plain"
   route (cosine) and top-1 with it apart from near-ties. Before it, the
   long-sequence forwards (query-blocked and KV-blocked, f32 and bf16)
   against theirs at [4, 12, 1024], [2, 12, 2048], [1, 12, 4096] and
   [1, 12, 8192] (log-sum-exp too) and at that phase's encode batches,
   each timed; the f32 query-blocked and KV-blocked kernels (split-TF32
   products on the tensor cores) and their plain versions are also read
   against the function evaluated in f64 at each gated shape (o, and the
   KV-blocked lse);
10. long-context backward kernels: the query-blocked backward (TPU kernel
   9) and the KV-blocked dQ and dK/dV passes (kernels 10 and 11) against
   their plain versions at [4, 12, S, 32] for S = 1024, 4096, 8192 (the
   training phase's) and 4352 (query-blocked above 4096), in f32 and bf16,
   standard-normal inputs, ragged rows and a fully masked one, the
   KV-blocked passes fed the forward kernel's o and lse, the f32
   query-blocked backward (split-TF32 products) and its plain version also
   read against the plain version evaluated in f64; the f32 KV-blocked
   passes (split-TF32 products too) and their plain version also read
   against the f64 evaluation on every row; each timed at the training
   phase's shape beside its bound (the f32 kernels' at the 3xTF32 rate,
   their CUDA-core f32 bound beside it), the plain version, SDPA forward +
   backward and SDPA's backward alone, and run twice there, which must
   give the same bits (the bf16 backwards on the bf16 tensor cores);
11. bf16 long-context gradient: one bf16 ``contrastive_loss`` backward on
   the long-context training's S = 8192 batch (B = 4) through "auto"
   (kernel 7 forward, kernels 10 and 11 backward, all in bf16), the
   "pallas_plain" route in bf16 and the "pallas" route in f32: the kernel
   route's distance to the f32 gradient (1 - cos) at most 1.1 times the
   plain route's, and the counters of the three kernels 12 layers x 2
   encodes; prints the losses, each tensor's cosine to the plain route
   and a device profile of the "auto" backward;
12. long-context training: ``train()`` trains that seeded encoder in f32 on
   12 Alps (question, passage) pairs, each passage its fact and a long
   text, in three batches of 4 at S = 1024, 4096 and 8192, the stream
   repeating them 4 times. Each batch's loss and gradients through the
   kernels must match the "pallas_plain" route (loss rel 1e-5, cosine >
   0.9999 per tensor); the losses must be finite, each batch's loss lower
   at its last appearance than at its first, and the counters must read
   12 layers x 2 encodes x the steps at each route for kernels 6, 7, 9, 10
   and 11. Prints the median step per S, a profile of one step per S
   (each kernel's device time and share of the step) and the peak memory;
13. phases 9-12 again with a seeded encoder at BAAI/bge-base-en-v1.5's
   widths (12 layers, H=768, 12 heads of 64, FFN 3072) and 8192
   positions: the long-document serve in bf16 and f32, the blocked
   backward kernels at [4, 12, S, 64], the bf16 long-context gradient and
   the long-context training in f32 with each batch seen twice (kernels 6,
   7, 9, 10, 11 at head_dim 64).

Each phase prints its seconds. The second-to-last line is a JSON object with the kernels' numbers, the
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
the result is printed. Writes nothing in the checkout but the kernels'
build directory.
"""

import asyncio
import collections
import concurrent.futures
import copy
import importlib.util
import json
import math
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "checkpoints" / "alps-semantic"
ORACLE_CHUNKS = ROOT / "tests" / "data" / "alps_oracle_chunks.json"
QUESTIONS = ROOT / "eval" / "data" / "alps_handmade_questions.json"
N_DOCS = 2048
N_QUERIES = 64
# the document indexing phase: the main path's texts as PDF_DOCS manuals,
# one text a page, and OFFICE_TEXTS further texts in each other document
PDF_DOCS = 16
OTHER_DOCS = (("docx", 4), ("pptx", 4), ("xlsx", 2), ("md", 2), ("txt", 2), ("csv", 2))
OFFICE_TEXTS = 4
PDF_LINE_CHARS = 95
OFFICE_BUILDER = ROOT / "tests" / "utils" / "office_builder.py"
N_TOP1 = 16
# the service phase: the port's DIAL app booted through the production loader
# on the tuned zero-egress preset, answering over HTTP on 127.0.0.1, against
# a standard-library fake Dial Core; its corpus is the document indexing
# phase's cut to SERVICE_PDF_TEXTS pages in SERVICE_PDF_DOCS PDFs, with the
# same 16 office, text and CSV documents
FAKE_DIAL = ROOT / "tests" / "utils" / "fake_dial_stdlib.py"
SERVICE_PRESET = "config/zero_egress_tuned.yaml"
SERVICE_PDF_DOCS, SERVICE_PDF_TEXTS = 2, 64
SERVICE_RETRIEVALS, SERVICE_GROUPS, SERVICE_GROUP_DOCS = 64, 8, 4
CHAT_PATH = "openai/deployments/dial-rag/chat/completions"
# the error cases of tests/test_app_e2e.py: (what, request body, status, the
# JAX package's error body; a message ending in ": " is a prefix, the one
# intended difference being the invalid configuration's text after it)
SERVICE_ERRORS = (
    ("malformed body", b"{not json", 400, {"error": {"message": "Invalid request body",
                                                    "type": "invalid_request_error", "code": "400"}}),
    ("list content", {"messages": [{"role": "user", "content": [{"type": "text", "text": "hi"}]}]}, 400,
     {"error": {"message": "Message content is not a string", "type": "invalid_request_error", "code": "400"}}),
    ("bad fusion method", {"messages": [{"role": "user", "content": "q"}],
                           "custom_fields": {"configuration": {"retrieval": {"fusion_method": "borda"}}}}, 400,
     {"error": {"message": "Invalid configuration: ", "type": "invalid_request_error", "code": "400"}}),
    ("assistant last message", {"messages": [{"role": "user", "content": "what is this?"},
                                             {"role": "assistant", "content": "an answer"}]}, 400,
     {"error": {"message": "The last message must be a user message", "type": "invalid_request_error",
                "code": "400"}}),
)
TOLERANCE = 3e-2  # bf16 kernel vs plain version: tests/test_fused_encoder.py's bf16 atol
TIE_GAP = 1e-3  # top-1 may differ from the plain path only between rows this close
# BM25 on the card vs the same port code on the CPU: tests/test_bm25.py's tolerance
BM25_RTOL, BM25_ATOL = 1e-5, 1e-6
HYBRID_K = 7  # each ensemble arm's depth, the reference's serving k
REQUEST_TIMEOUT = 120.0  # seconds a served request may take
MAX_QUERY_WAVES = 8  # the 64 concurrent requests' query encodes in at most this many waves
# the BM25 1M phase: items, postings an item, Zipf law of the term ids over
# the vocabulary, query terms, and the planted group of identical items
BM25_1M_ITEMS, BM25_1M_POSTINGS, BM25_1M_VOCAB, BM25_1M_ZIPF = 1_000_000, 48, 262_144, 1.1
BM25_1M_QUERY_TERMS, BM25_1M_GROUP = 8, 16
# the dense layouts phase: the main path's seeded 1M x 384 matrix; a planted
# group of identical rows and as many within 1e-7 of them (the adversarial
# corpus of tests/test_dense_index.py); distances of one query by two
# routes of the f32 scan (two_pass against float32, a lone query's scores
# ranked whole against a block at a time: products of other shapes); int8 top-7 overlap with f32 (tests/test_dense_index.py); the
# share of the index a bf16 scan may hold beyond it
DENSE_ROWS, PLANTED = 1_000_000, 300
DENSE_ATOL = 2e-6
INT8_OVERLAP = 0.85
SCAN_SHARE = 0.1
# late interaction: the MaxSim checkpoint, the index's tokens a chunk, the
# chunks whose scores the card holds to the CPU, the score tolerance (also
# between a query's scores from its lone and its batch encode, bf16 token
# rows at other sequence buckets: 0 read over 64 queries x 2048 chunks in
# every layout on an H100)
LI_CHECKPOINT = ROOT / "checkpoints" / "alps-maxsim"
LI_MAX_TOKENS = 256
LI_GATE_CHUNKS = 256
MAXSIM_ATOL = 1e-5
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_F32_FLOPS = 67e12  # H100 SXM f32, CUDA cores
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8
# f32-grade products as three TF32 tensor-core passes (495 TFLOP/s dense
# TF32 / 3): the rate of the split-TF32 kernels' bound (kernels 4-6 and
# 8-11 in f32), their CUDA-core f32 bound kept beside it
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# f32 attention kernels vs plain versions: forward 2e-5, ten times the
# reference's 2e-6 (tests/test_flash_attention.py) for another summation
# order over S <= 512 keys; gradients the reference's own atol and rtol
F32_FWD_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-4
LSE_TOL = 1e-5  # the reference's long-context lse tolerance (tests/test_flash_attention.py)
GRAD_COS = 0.9999  # bf16 gradients, kernel route vs plain route (the whole gradient)
# the bf16 S = 8192 gradient: its kernel route's distance to the f32
# gradient (1 - cos) over the bf16 plain route's may reach this. At S =
# 8192 bf16 rounding moves the gradient far more than GRAD_COS allows: two
# plain routes that differ only in the f32 order of the forward's sums lay
# 0.986 / 0.995 apart at head_dim 32 / 64 and every bf16 route 0.976 /
# 0.993 from the f32 gradient, their distances to it within 3.0% / 2.6% of
# each other (scripts/bf16_long_gradient_routes.py on an H100 80GB HBM3 at
# 700 W)
BF16_NOISE_RATIO = 1.1
# per tensor, the kernel route's cosine to the "fused_plain" route may fall
# at most this below the "xla" route's: on an H100 80GB HBM3 (700 W) it
# lay 2.3e-5 or more above it for every tensor of the first 6 batches
GRAD_COS_EPS = 0.0
# long-document serve: buckets past 512, rows per encode batch, and the
# token count of each text (four encode batches, at S = 1024, 2048, 4096
# and 8192; the last batch has two pad rows, which are fully masked)
LONG_BUCKETS = (1024, 2048, 4096, 8192)
LONG_MAX_POSITIONS = 8192
LONG_BATCH = 4
LONG_TARGETS = (1000, 700, 850, 1020, 2000, 1500, 1800, 1200, 4000, 3000, 2500, 4090, 8000, 6000)
LONG_QUERIES = 8
# long-context training: 4 (question, passage) pairs a batch, the passages
# (fact + long text) sized so the three batches land at S = 1024, 4096 and
# 8192 (token targets of the long text after the fact); the stream repeats
# the three batches LONG_TRAIN_CYCLES times
LONG_TRAIN_BATCH = 4
LONG_TRAIN_TARGETS = ((600, 950, 800, 700), (2500, 4000, 3000, 3500), (8000, 5000, 6500, 7000))
LONG_TRAIN_SEQS = (1024, 4096, 8192)
LONG_TRAIN_CYCLES = 4
LONG_TRAIN_LR = 1e-4
# the bge-base-width long-context training sees each batch twice, at the
# rate the bge-small fine-tune uses: at LONG_TRAIN_LR its S = 4096 batch's
# loss rose from 1.428 to 3.004 between its two appearances (an H100 80GB
# HBM3 at 700 W), while each batch's loss and gradients through the
# kernels matched the plain route's (loss rel 1.8e-6): too high a rate for
# a seeded 110M-parameter encoder on batches of 4 pairs
BASE_LONG_TRAIN_CYCLES = 2
BASE_LONG_TRAIN_LR = 2e-5
# a single-tile S (not a multiple of 256) past the single-tile kernels'
# shared-memory limits at both head widths, forward and backward
PAST_LIMIT_S = 1700
# sequence lengths of the tensor-core forward's gates: one 64-key chunk, a
# ragged S, a 256 bucket, past one 512 tile (ragged), past the
# single-tile limits (ragged) and a query-blocked S
TC_SEQS = (64, 100, 256, 520, PAST_LIMIT_S, 4096)
# (B, S) of the KV-blocked tensor-core forward's gates (kernel 7 in bf16):
# the shortest S the route takes (S > 4096, S % 512 == 0) with one ragged
# row, and the long-document phase's longest with a full, a ragged and a
# fully masked row
KV_TC_SHAPES = ((1, 4608), (3, 8192))
# dynamic shared memory of csrc/gemm_tc.cuh's products (kSmemBytes): a
# 4-stage ring of [256, 64] and [64, 128] bf16 tiles, + 1024 B to align it
GEMM_TC_SMEM = 4 * (256 * 64 + 64 * 128) * 2 + 1024
# and of csrc/gemm_tf32.cuh's (kSmemBytes): a 4-stage ring of a [128, 40]
# f32 A tile and a 32-deep slice of a 128-column panel's hi and lo planes
GEMM_TF32_SMEM = 4 * (128 * 40 + 32 * 128 * 2) * 4
# the status, in the kernels JSON line, of the f32 rows redesigned on
# split-TF32 products: the query-blocked kernels 6 and 9, the single-tile
# kernels 4 (with 5) and 8, the KV-blocked backward passes 10 and 11, the
# KV-blocked forward 7; and of the bf16 query-blocked backward (kernel 9)
# redesigned on the bf16 tensor cores
REDESIGNED = "redesigned (3xTF32, query-blocked)"
REDESIGNED_SINGLE_TILE = "redesigned (3xTF32, single tile)"
REDESIGNED_KV_BLOCKED = "redesigned (3xTF32, KV-blocked)"
REDESIGNED_KV_FORWARD = "redesigned (3xTF32, KV-blocked forward)"
REDESIGNED_TC_BACKWARD = "redesigned (TC, mma.sync, query-blocked)"
REDESIGNED_TC_KV_BLOCKED = "redesigned (TC, mma.sync, KV-blocked)"
# the status of the f32 rows of kernels 1-3, launch sequences of split-TF32
# products (csrc/gemm_tf32.cuh) and kernel 4's f32 attention
REDESIGNED_BLOCKS = "redesigned (3xTF32 products)"
# kernels 1-3 in f32: each block's largest distance from the block
# evaluated in f64 may reach this many times the plain version's
F64_RATIO = 1.5
# the f32 tanh-GELU encode (12 layers): last hidden states of the kernel
# routes vs the plain route, 12 layers of the blocks' 2e-5; the pooled,
# L2-normalised embeddings' cosine to the plain route's
F32_ENCODE_TOL = 1e-4
F32_ENCODE_COS = 1 - 1e-6


def tf32_smem(dh: int) -> int:
    """Dynamic shared memory of a split-TF32 attention block
    (csrc/tensor_core_tf32.cuh's Layout): two fixed [64, dh + 4] f32
    tiles and two ring stages of two such tiles and 256 floats."""
    tile = 64 * (dh + 4)
    return 4 * (2 * tile + 2 * (2 * tile + 256))


def library_smem(build, stem: str, entry: str, dh: int, s: int) -> int:
    """The dynamic shared memory a block of a single-tile f32 kernel is
    launched with at head_dim dh and S = s, as its library's ``entry``
    query (``*_smem_bytes``) works it out from the kernel's own layout."""
    import ctypes

    out = ctypes.c_int(0)
    err = getattr(build.libs[stem], entry)(dh, s, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"{entry}({dh}, {s}) returned CUDA error {err}")
    return out.value
# bge-large's width (BAAI/bge-large-en-v1.5 config.json: hidden_size 1024,
# num_attention_heads 16, intermediate_size 4096), seeded weights: the
# bf16 H 1024 instantiations of kernels 1-3, gated and timed; no phase
# runs an encoder at that width
LARGE_WIDTHS = {"hidden_size": 1024, "num_layers": 1, "num_heads": 16, "intermediate_size": 4096}
# blocked backward kernels vs plain versions in bf16: of the plain
# gradient's largest magnitude in each (batch row, head) (gradients are not
# O(1))
BF16_GRAD_REL = 3e-2
# kernels 1-3 in bf16 at H 768 vs plain versions: of each row's largest
# plain value, the limit the bf16 gradients use (``block_tolerance``)
BF16_ROW_REL = 3e-2
# bf16 attention outputs vs plain versions, beside TOLERANCE: of each
# (batch row, head)'s largest plain |value| (``head_over``). A typical
# output is about sqrt(e / S) (0.026 at S = 4096), so TOLERANCE alone is
# as large as what it compares at long S
BF16_HEAD_REL = 3e-2
LAYER_SUBSET = 256  # chunks of the main path served through the whole-layer route
# whole-layer route vs its plain composition, bf16 document embeddings
# (unit norm): the measured cosine is 0.999975 on an H100 80GB HBM3 at 700 W
LAYER_PLAIN_COS = 0.9999
# bge-base serve, kernel route vs "fused_plain", bf16 document and query
# embeddings (unit norm): the long-document serve's bf16 limit
BASE_PLAIN_COS = 0.999
# BAAI/bge-base-en-v1.5's published widths (config.json: hidden_size 768,
# num_attention_heads 12, intermediate_size 3072, 12 layers, 512
# positions), seeded weights: no bge-base checkpoint is in the repository
BASE_WIDTHS = {"hidden_size": 768, "num_layers": 12, "num_heads": 12, "intermediate_size": 3072,
               "max_position_embeddings": 512}
BASE_TRAIN_STEPS = 10
BASE_TRAIN_LR = 1e-4


_PHASE = {}


def phase(name: str | None) -> None:
    """Announces phase ``name`` (None: the end of the last one), after the
    seconds the previous phase took."""
    now = time.perf_counter()
    if _PHASE:
        print(f"[phase] {_PHASE['name']}: {now - _PHASE['t0']:.1f} s", flush=True)
    if name is not None:
        print(f"[phase] {name}", flush=True)
        _PHASE.update(name=name, t0=now)


def kernel_resources(build) -> None:
    """Prints the registers, spill and static shared memory a thread block
    of the bf16 KV-blocked forward, the bf16 blocked backwards' passes
    (query-blocked and KV-blocked), the bf16 and the f32 split-TF32
    products of kernels 1-3 (and the split of W), the LayerNorm pass,
    the split-TF32 kernels 4 (with 5), 6, 7, 8, 9, 10 and 11 in f32 and
    the bf16 single-tile backward (kernel 8) takes, from
    ``-Xptxas -v``, and the dynamic shared memory it is launched with (the
    products': gemm_tc.cuh's kSmemBytes, GEMM_TC_SMEM; the blocked
    split-TF32 kernels': ``tf32_smem``; the single-tile ones' at the main
    path's S, as their libraries report it: the forward's at 256, the
    backwards' at 64 and 128)."""

    def width(line: str) -> str:  # the int template argument of a mangled name
        return re.search(r"ILi(\d+)E", line).group(1)

    products = {"0": "FFN up product (GELU epilogue)", "1": "f32 product (FFN down, output projection)",
                "2": "QKV projection (bias epilogue)"}

    def product(line: str) -> str:  # gemm_kernel's Epilogue argument
        epilogue = re.search(r"EpilogueE(\d)E", line).group(1)
        return f"{products[epilogue]}, 512 threads"

    tf32_products = {"0": "FFN up product (GELU epilogue)", "1": "product (FFN down, output projection)",
                     "2": "QKV projection (bias epilogue)"}

    def tf32_product(line: str) -> str:  # gemm_tf32_kernel's Epilogue argument
        epilogue = re.search(r"EpilogueE(\d)E", line).group(1)
        return f"f32 {tf32_products[epilogue]} (3xTF32), 256 threads"

    # (source stem, substrings of the kernel's mangled name, dynamic shared memory, label)
    kernels = (
        ("attention_tc", ("kv_blocked_tc_kernel",), 0,
         lambda line: f"KV-blocked forward, head_dim {width(line)}, 128 threads"),
        ("ffn_tc", ("gemm_kernel",), GEMM_TC_SMEM, product),
        ("ffn_tc", ("layernorm_kernel",), 0, lambda line: f"LayerNorm, H {width(line)}, 256 threads"),
        ("fused_attention", ("gemm_kernel", "EpilogueE2E"), GEMM_TC_SMEM, product),
        ("fused_ffn", ("gemm_tf32_kernel",), GEMM_TF32_SMEM, tf32_product),  # all three epilogues
        ("fused_ffn", ("split_kernel",), 0, lambda line: "split of W into TF32 planes, 256 threads"),
    )
    for dh in (32, 64):
        kernels += (
            ("flash_attention_long", ("q_blocked_tf32_kernelILi" + str(dh),), tf32_smem(dh),
             lambda line: f"query-blocked f32 forward (3xTF32), head_dim {width(line)}, 128 threads"),
            ("flash_attention_long", ("kv_blocked_tf32_kernelILi" + str(dh),), tf32_smem(dh),
             lambda line: f"KV-blocked f32 forward (3xTF32), head_dim {width(line)}, 128 threads"),
            ("flash_attention_long_bwd", (f"dq_tc_kernelILi{dh}ELb0E",), 0,
             lambda line: f"query-blocked bf16 backward dQ pass (TC), head_dim {width(line)}, 128 threads"),
            ("flash_attention_long_bwd", (f"dkv_tc_kernelILi{dh}ELb0E",), 0,
             lambda line: f"query-blocked bf16 backward dK/dV pass (TC), head_dim {width(line)}, 128 threads"),
            ("flash_attention_long_bwd", (f"dq_tc_kernelILi{dh}ELb1E",), 0,
             lambda line: f"KV-blocked bf16 dQ pass (TC), head_dim {width(line)}, 128 threads"),
            ("flash_attention_long_bwd", (f"dkv_tc_kernelILi{dh}ELb1E",), 0,
             lambda line: f"KV-blocked bf16 dK/dV pass (TC), head_dim {width(line)}, 128 threads"),
            ("flash_attention_long_bwd", (f"dq_tf32_kernelILi{dh}ELb0E",), tf32_smem(dh),
             lambda line: f"query-blocked f32 backward dQ pass (3xTF32), head_dim {width(line)}, 128 threads"),
            ("flash_attention_long_bwd", (f"dkv_tf32_kernelILi{dh}ELb0E",), tf32_smem(dh),
             lambda line: f"query-blocked f32 backward dK/dV pass (3xTF32), head_dim {width(line)}, 128 threads"),
            ("flash_attention_long_bwd", (f"dq_tf32_kernelILi{dh}ELb1E",), tf32_smem(dh),
             lambda line: f"KV-blocked f32 dQ pass (3xTF32), head_dim {width(line)}, 128 threads"),
            ("flash_attention_long_bwd", (f"dkv_tf32_kernelILi{dh}ELb1E",), tf32_smem(dh),
             lambda line: f"KV-blocked f32 dK/dV pass (3xTF32), head_dim {width(line)}, 128 threads"),
            ("flash_attention_fwd", ("single_tile_tf32_kernelILi" + str(dh),),
             library_smem(build, "flash_attention_fwd", "dial_attention_fwd_smem_bytes", dh, 256),
             lambda line: f"single-tile f32 forward (3xTF32), head_dim {width(line)}, 128 threads, at S = 256"),
            ("flash_attention_bwd", ("single_tile_bwd_tf32_kernelILi" + str(dh),),
             f"{library_smem(build, 'flash_attention_bwd', 'dial_attention_bwd_smem_bytes_f32', dh, 64)} B at "
             f"S = 64 (128 threads), "
             f"{library_smem(build, 'flash_attention_bwd', 'dial_attention_bwd_smem_bytes_f32', dh, 128)}",
             lambda line: f"single-tile f32 backward (3xTF32), head_dim {width(line)}, 256 threads at S = 128"),
        )
        for keys in (64, 128):  # the bf16 single-tile backward's two instantiations (padded S)
            kernels += (
                ("flash_attention_bwd", (f"single_tile_bwd_tc_kernelILi{dh}ELi{keys // 8}E",),
                 library_smem(build, "flash_attention_bwd", "dial_attention_bwd_smem_bytes_bf16", dh, keys),
                 lambda line, keys=keys: f"single-tile bf16 backward (TC), head_dim {width(line)}, "
                                         f"{2 * keys} threads, S <= {keys}"),
            )
    for stem, names, dynamic, label in kernels:
        lines = build.ptxas[stem]
        for i, line in enumerate(lines):
            if all(n in line for n in names) and i + 2 < len(lines):
                print(f"resources of csrc/{stem}.cu's {label(line)}: {lines[i + 2]}; {lines[i + 1]}; "
                      f"{dynamic} B dynamic shared memory a block")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(torch, fn, cpu: bool = True) -> list:
    """Runs ``fn`` once under ``torch.profiler`` and returns the device
    kernels' averaged events. User-annotation ranges (an optimizer step's)
    span kernels that are already counted, so they are left out. With
    ``cpu`` false only the device is traced (far less overhead on
    host-paced code; the device times are the same)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU] * cpu + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def device_profile(torch, fn, what: str, card: str, top: int = 8, share_of: str | None = None,
                   cpu: bool = True) -> float:
    """Runs ``fn`` once under ``torch.profiler`` and prints its device
    time (with ``share_of``, also that of the kernels named like it and
    their share) and the ``top`` kernels by device time; returns the total
    in ms. ``cpu``: as ``device_events``."""
    events = device_events(torch, fn, cpu)
    total_ms = sum(e.self_device_time_total for e in events) / 1e3
    share = ""
    if share_of is not None:
        ms = sum(e.self_device_time_total for e in events if share_of in e.key) / 1e3
        share = f", {share_of}* kernels {ms:.3f} ms, {100 * ms / total_ms if total_ms > 0 else 0.0:.1f}%"
    print(f"profile of {what}: device time {total_ms:.3f} ms{share} {card}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        # the port's kernels by their own names: gemm_kernel<(Epilogue)2> is
        # the QKV product, 0 the FFN's up product, 1 the products into f32
        name = re.sub(r"\(anonymous namespace\)::|dial::\w+::", "", e.key)
        share = 100 * e.self_device_time_total / 1e3 / total_ms if total_ms > 0 else 0.0
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {share:5.1f}%  {e.count:4d} x  {name[:90]}")
    sys.stdout.flush()
    return total_ms


def kernel_device_ms(torch, fn, match: str, iters: int = 20, attempts: int = 3) -> float:
    """Device time per call of ``fn`` spent in kernels whose name holds
    ``match`` ("" for every kernel), by ``torch.profiler`` after one
    warm-up call: a kernel's own time where the host paces its launches.
    A profile that shows no such kernel is printed with the kernels it
    does show and taken again, up to ``attempts`` profiles in all (one
    call on an H100 once returned a profile without the kernel that the
    same code showed in four calls before)."""
    fn()

    def calls():
        for _ in range(iters):
            fn()

    for _ in range(attempts):
        events = device_events(torch, calls)
        us = sum(e.self_device_time_total for e in events if match in e.key)
        if us > 0:
            return us / 1e3 / iters
        print(f"the profile of {iters} calls shows no kernel named like {match!r}, only "
              f"{sorted(e.key[:80] for e in events)[:8]}; profiling again", flush=True)
    raise RuntimeError(f"{attempts} profiles of {iters} calls show no kernel named like {match!r}")


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def block_tolerance(dtype, hid: int) -> tuple[float, bool]:
    """Kernels 1-3's output gate: (tolerance, whether it is of each row's
    largest plain value). bf16 at H >= 768 is held per row (BF16_ROW_REL):
    its LayerNorm outputs reach |v| >= 4, where one bf16 ulp (2^-5)
    exceeds TOLERANCE, and the kernel and the plain version, summing in
    different orders, can round such a value to neighbouring bf16 values."""
    import torch

    if dtype != torch.bfloat16:
        return F32_FWD_TOL, False
    return (BF16_ROW_REL, True) if hid >= 768 else (TOLERANCE, False)


def over_limit(out, ref, tol: float, per_row: bool = False) -> float:
    """The largest |out - ref| over its limit: ``tol``, or with
    ``per_row`` ``tol`` times the largest |ref| of each row (the last
    dimension). At most 1 passes."""
    out, ref = out.float(), ref.float()
    limit = tol * ref.abs().amax(dim=-1, keepdim=True) if per_row else tol
    return ((out - ref).abs() / limit).max().item()


def head_over(out, ref, heads: int | None = None) -> float:
    """The largest |out - ref| of each (batch row, head) over BF16_HEAD_REL
    times that (batch row, head)'s largest |ref|: at most 1 passes. Takes
    head-major [B, h, S, Dh] outputs, or packed [B, S, H] ones with
    ``heads``."""
    import torch

    if heads is not None:
        out, ref = (t.view(*t.shape[:2], heads, -1).transpose(1, 2) for t in (out, ref))
    out, ref = out.float(), ref.float()
    limit = BF16_HEAD_REL * ref.abs().amax(dim=(2, 3), keepdim=True).clamp_min(torch.finfo(torch.float32).tiny)
    return ((out - ref).abs() / limit).max().item()


def bf16_ulp(x) -> float:
    """The spacing of bf16 values at the largest |x| (2^-5 in [4, 8))."""
    top = x.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def tolerance_text(tol: float, per_row: bool) -> str:
    return f"{tol} of each row's largest plain value" if per_row else f"{tol}"


def synthetic_texts(vocab: dict, n: int, seed: int) -> list[str]:
    """Texts of 200-253 whole vocab words, one WordPiece token each, so a
    batch of them fills the 256-token bucket."""
    import numpy as np

    words = sorted(w for w in vocab if w.isascii() and w.isalpha() and w.islower() and len(w) > 1)
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, size=int(rng.integers(200, 254)))) for _ in range(n)]


def attention_inputs(torch, dev, b, s, heads, dh, seed, dtype=None):
    """Seeded packed qkv [B, S, 3H] (f32 unless ``dtype``), a mask with
    ragged rows and one fully masked row, and a cotangent [B, S, H] f32."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3 * heads * dh, generator=g).to(dev, dtype or torch.float32)
    lengths = torch.randint(1, s + 1, (b,), generator=g)
    lengths[0] = s
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32)
    mask[-1] = 0
    cot = torch.randn(b, s, heads * dh, generator=g).to(dev)
    return qkv, mask.to(dev), cot


def instantiation(name: str, dtype, width: str) -> str:
    """The kernels JSON row name of one instantiation: the bare name for
    the one earlier slices ported first (bf16 at H 384 for kernels 1-3,
    f32 at head_dim 32 for kernels 4-11), else the name with (dtype,
    width)."""
    import torch

    first = (torch.bfloat16, "H 384") if name.startswith("fused_") else (torch.float32, "head_dim 32")
    return name if (dtype, width) == first else f"{name} ({str(dtype)[6:]}, {width})"


def attention_rows(torch, dev, card, heads: int, dh: int, path_shapes, dtype) -> dict:
    """Kernels 4, 5 and 8 in ``dtype`` at head width ``dh`` against their
    plain versions (gated) at fixed shapes and at ``path_shapes``, the
    (use, B, S) the main path's phases give them, at the longest S their
    shared memory takes and past it (S = 1700: the f32 forward and both
    backwards on the query-blocked kernels' code, the launch counters
    say so); timed beside their bound, the plain version and SDPA. In bf16
    kernels 4 and 5 are the tensor-core forward, held also to
    ``head_over``. bf16 gradients are held per batch row to BF16_GRAD_REL
    of the plain gradient's largest value."""
    import torch.nn.functional as F

    from dial_rag_tpu_torch.ops import flash_attention as fa

    bf16 = dtype == torch.bfloat16
    tol = TOLERANCE if bf16 else F32_FWD_TOL
    tol_text = f"{tol}" + (f" and {BF16_HEAD_REL} of each (batch row, head)'s largest plain value" if bf16 else "")
    kind = f"{str(dtype)[6:]}, head_dim {dh}"

    def grads(fn, inputs, cot):
        inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
        (fn(*inputs).float() * cot).sum().backward()
        return [t.grad for t in inputs]

    def check_fwd(name, out, ref, packed=False):
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise RuntimeError(f"{name} ({kind}): kernel output is not finite")
        err = (out.float() - ref.float()).abs().max().item()
        over = head_over(out, ref, heads if packed else None) if bf16 else 0.0
        if not (err <= tol and over <= 1):
            raise RuntimeError(f"{name} ({kind}): kernel disagrees with its plain version by {err} ({over} of "
                               f"{BF16_HEAD_REL} of a (batch row, head)'s largest plain value)")
        return err

    def check_grads(name, got, want):
        torch.cuda.synchronize()
        err = 0.0
        for a, w in zip(got, want):
            a, w = a.float(), w.float()
            if not torch.isfinite(a).all():
                raise RuntimeError(f"{name} ({kind}): gradient is not finite")
            if bf16:
                rel = max(((a[r] - w[r]).abs().max() / w[r].abs().max().clamp_min(1e-30)).item()
                          for r in range(a.shape[0]))
                if not rel <= BF16_GRAD_REL:
                    raise RuntimeError(f"{name} ({kind}): gradient off its plain version by {rel} of a row's largest")
            else:
                excess = ((a - w).abs() - GRAD_RTOL * w.abs()).max().item()
                if not excess <= GRAD_ATOL:
                    raise RuntimeError(f"{name} ({kind}): gradient off its plain version by {excess} past rtol")
            err = max(err, (a - w).abs().max().item())
        return err

    grad_tol = (f"per row {BF16_GRAD_REL} of the largest plain gradient" if bf16
                else f"atol {GRAD_ATOL}, rtol {GRAD_RTOL}")
    # every shape gated: a full serving bucket (B=128, S=256), a full
    # training bucket (B=32, S=128), a ragged S, S = 512, S = 520 (past
    # one 512 tile, not a multiple of 256: still single-tile, as in the
    # reference), the longest S the backward's shared memory takes, S =
    # 1700 past both limits, and each shape the main path's phases give
    # the kernels
    # the f32 forward's limit (the bf16 forward, the tensor-core kernel,
    # has none) and the backward's in this dtype
    fwd_max = fa.single_tile_max_s("fwd", head_dim=dh)
    bwd_max = fa.single_tile_max_s("bwd", head_dim=dh, dtype=dtype)
    print(f"single-tile limits on this card at head_dim {dh}: f32 forward S <= {fwd_max}, {str(dtype)[6:]} "
          f"backward S <= {bwd_max}", flush=True)
    if not PAST_LIMIT_S > max(fwd_max, bwd_max) or fa.attention_route(PAST_LIMIT_S) != "single_tile":
        raise RuntimeError(f"S={PAST_LIMIT_S} is not a single-tile S past both limits at head_dim {dh}")
    fixed = [("bucket", 128, 256), ("bucket", 32, 128), ("ragged", 32, 100), ("one tile", 4, 512),
             ("past one tile", 2, 520), ("backward limit", 2, bwd_max), ("past both limits", 2, PAST_LIMIT_S)]
    # the code each call takes: (forward, backward) launch counter
    fwd_key = "attention_tc" if bf16 else "qkv_native_attention"
    for use, b, s in fixed + [t for t in path_shapes if t[1:] not in {f[1:] for f in fixed}]:
        qkv, mask, cot = attention_inputs(torch, dev, b, s, heads, dh, seed=b + s, dtype=dtype)
        past = s > fwd_max
        want = {fwd_key if not past or bf16 else "attention_q_blocked": 1,
                "attention_bwd_q_blocked" if s > bwd_max else "flash_attention_bwd": 1}
        with torch.no_grad():
            e4 = check_fwd("qkv_native_attention", fa.fused_qkv_attention(qkv, mask, heads),
                           fa.fused_qkv_attention(qkv, mask, heads, plain=True), packed=True)
            q, k, v = (t.contiguous() for t in fa._split_heads(qkv, heads))
            e5 = check_fwd("flash_attention_fwd", fa.flash_attention(q, k, v, mask),
                           fa.flash_attention(q, k, v, mask, plain=True))
        fa.reset_launches()
        got = grads(lambda x: fa.fused_qkv_attention(x, mask, heads), [qkv], cot)
        torch.cuda.synchronize()
        ran = {k: n for k, n in fa.LAUNCHES.items() if n}
        if ran != want:
            raise RuntimeError(f"attention ({kind}) at B={b} S={s}: launches {ran}, expected {want}")
        e8p = check_grads("flash_attention_bwd (packed qkv)", got,
                          grads(lambda x: fa.fused_qkv_attention(x, mask, heads, plain=True), [qkv], cot))
        cot_h = cot.view(b, s, heads, dh).transpose(1, 2).contiguous()
        e8h = check_grads(
            "flash_attention_bwd (head-major)",
            grads(lambda *x: fa.flash_attention(*x, mask), [q, k, v], cot_h),
            grads(lambda *x: fa.flash_attention(*x, mask, plain=True), [q, k, v], cot_h),
        )
        print(f"attention kernels ({kind}) at B={b} S={s} ({use}; ragged rows, one fully masked): launches {ran}; "
              f"max abs err qkv_native {e4:.3g}, head-major {e5:.3g} (tolerance {tol_text}); backward packed "
              f"{e8p:.3g}, head-major {e8h:.3g} ({grad_tol})", flush=True)

    # the forward at its own limit (B=2: a ragged row and a fully masked
    # one). Where the limit is a multiple of 256 past 512 the head-major
    # dispatch takes the query-blocked route there; kernel 5 is then gated
    # 64 rows below it
    qkv, mask, _ = attention_inputs(torch, dev, 2, fwd_max, heads, dh, seed=fwd_max, dtype=dtype)
    q, k, v = fa._split_heads(qkv, heads)
    expected = fa.attention_route(fwd_max)
    s5 = fwd_max if expected == "single_tile" else fwd_max - 64
    if fa.attention_route(s5) != "single_tile":
        raise RuntimeError(f"head-major dispatch at head_dim {dh}: S={s5} takes {fa.attention_route(s5)}")
    with torch.no_grad():
        e4 = check_fwd("qkv_native_attention", fa.fused_qkv_attention(qkv, mask, heads),
                       fa.fused_qkv_attention(qkv, mask, heads, plain=True), packed=True)
        e6 = check_fwd("flash_attention_fwd", fa.flash_attention(q, k, v, mask),
                       fa.flash_attention(q, k, v, mask, plain=True))
        q5, k5, v5, m5 = q[:, :, :s5], k[:, :, :s5], v[:, :, :s5], mask[:, :s5]
        e5 = check_fwd("flash_attention_fwd", fa.flash_attention(q5, k5, v5, m5),
                       fa.flash_attention(q5, k5, v5, m5, plain=True))
    print(f"attention forward ({kind}) at B=2 S={fwd_max} (forward limit): max abs err qkv_native {e4:.3g}, "
          f"head-major ({expected} route) {e6:.3g}; head-major at S={s5} {e5:.3g} (tolerance {tol_text})")
    sys.stdout.flush()

    size = 2 if bf16 else 4
    # the f32 kernels form their products in split TF32: their bound is at
    # the 3xTF32 rate, the CUDA-core f32 one printed and kept beside it
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_3XTF32_FLOPS
    fwd_source = f"dial_rag_tpu_torch/csrc/{'attention_tc' if bf16 else 'flash_attention_fwd'}.cu"
    rows = {}

    def row(name, kernel, plain, library, err, flops, nbytes, replaces, source, shape, device_kernel=None):
        """Times ``kernel`` by CUDA events, or, with ``device_kernel`` (a
        call the host paces: its Python and the mask-bias kernel outlast
        the kernel), by the profiler's device time of the kernels named
        like ``device_kernel``, the call's CUDA-event time printed beside.
        The f32 rows (split-TF32 products) are bound at the 3xTF32 rate and
        also give their bound at the CUDA cores' f32 rate."""
        call_ms = cuda_ms(torch, kernel, iters=20)
        ms = call_ms if device_kernel is None else kernel_device_ms(torch, kernel, device_kernel)
        plain_ms = cuda_ms(torch, plain, iters=5)
        library_ms = cuda_ms(torch, library, iters=20)
        bound_ms, bound_by = bound(flops, nbytes, peak)
        f32_bound = None if bf16 else bound(flops, nbytes, PEAK_F32_FLOPS)
        device = "" if device_kernel is None else (
            f" (device time of its {device_kernel}* kernels; the call {call_ms:.4f} ms; SDPA's kernels "
            f"{kernel_device_ms(torch, library, ''):.4f} ms)")
        print(f"{name} ({kind}): max_abs_err {err:.6g}; kernel {ms:.4f} ms{device}, plain {plain_ms:.4f} ms, SDPA "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP at "
              f"{peak / 1e12:.0f} TFLOP/s{'' if bf16 else ' 3xTF32'}, {nbytes / 1e6:.2f} MB)"
              + (f", CUDA-core f32 bound {f32_bound[0]:.4f} ms by {f32_bound[1]} (at {PEAK_F32_FLOPS / 1e12:.0f} "
                 f"TFLOP/s)" if f32_bound else "") + f", {shape} {card}", flush=True)
        key = instantiation(name, dtype, f"head_dim {dh}")
        rows[key] = {
            "name": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        }
        if f32_bound:
            rows[key].update(status=REDESIGNED_SINGLE_TILE, bound_f32_ms=f32_bound[0])

    # kernel 4 at the serving shape
    b, s = 128, 256
    hid = heads * dh
    qkv, mask, cot = attention_inputs(torch, dev, b, s, heads, dh, seed=1, dtype=dtype)
    keep = fa.mask_bias(mask)[:, None, None, :].to(dtype)
    with torch.no_grad():
        err = check_fwd("qkv_native_attention", fa.fused_qkv_attention(qkv, mask, heads),
                        fa.fused_qkv_attention(qkv, mask, heads, plain=True), packed=True)

        def sdpa_packed():
            q, k, v = qkv.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=keep).transpose(1, 2).reshape(b, s, hid)

        row("qkv_native_attention", lambda: fa.fused_qkv_attention(qkv, mask, heads),
            lambda: fa.fused_qkv_attention(qkv, mask, heads, plain=True), sdpa_packed, err,
            4 * b * heads * s * s * dh, (b * s * 3 * hid + b * s * hid) * size + b * s * 4,
            "dial_rag_tpu/ops/flash_attention.py:638", fwd_source, f"qkv [{b},{s},{3 * hid}]")

    # kernels 5 and 8 at the training shape, head-major
    b, s = 32, 128
    qkv, mask, cot = attention_inputs(torch, dev, b, s, heads, dh, seed=2, dtype=dtype)
    q, k, v = (t.contiguous() for t in fa._split_heads(qkv, heads))
    do = cot.view(b, s, heads, dh).transpose(1, 2).contiguous().to(dtype)
    keep = fa.mask_bias(mask)[:, None, None, :].to(dtype)
    head_bytes = b * heads * s * dh * size
    with torch.no_grad():
        err = check_fwd("flash_attention_fwd", fa.flash_attention(q, k, v, mask),
                        fa.flash_attention(q, k, v, mask, plain=True))
        row("flash_attention_fwd", lambda: fa.flash_attention(q, k, v, mask),
            lambda: fa.flash_attention(q, k, v, mask, plain=True),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), err,
            4 * b * heads * s * s * dh, 4 * head_bytes + b * s * 4,
            "dial_rag_tpu/ops/flash_attention.py:43", fwd_source, f"q, k, v [{b},{heads},{s},{dh}]",
            device_kernel="attention_tc_kernel" if bf16 else "single_tile_tf32_kernel")
    grad_out = [torch.empty_like(t) for t in (q, k, v)]
    got = fa.attention_backward_plain(q, k, v, do, mask)
    fa._backward_kernel(q, k, v, do, *grad_out, mask)
    err = check_grads("flash_attention_bwd", grad_out, got)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa_fwd_bwd():
        for t in leaves:
            t.grad = None
        F.scaled_dot_product_attention(*leaves, attn_mask=keep).backward(do)

    row("flash_attention_bwd", lambda: fa._backward_kernel(q, k, v, do, *grad_out, mask),
        lambda: fa.attention_backward_plain(q, k, v, do, mask), sdpa_fwd_bwd, err,
        10 * b * heads * s * s * dh, 7 * head_bytes + b * s * 4,
        "dial_rag_tpu/ops/flash_attention.py:313", "dial_rag_tpu_torch/csrc/flash_attention_bwd.cu",
        f"q, k, v, dO [{b},{heads},{s},{dh}]",
        device_kernel="single_tile_bwd_tc" if bf16 else "single_tile_bwd_tf32")
    backward_designs(torch, dev, card, heads, dh, dtype)
    return rows


def backward_designs(torch, dev, card, heads: int, dh: int, dtype) -> None:
    """The two designs for the single-tile backward in ``dtype``, timed by
    device time at [32, heads, S, dh] for S = 128 (kernel 8's row) and 64
    (the training phases'): (a) the one-launch kernel (a whole [S, S] tile
    a block, what the wrapper takes up to S = 128) and (b) two passes by
    query and key tiles, the query-blocked backward's code (what it takes
    past that): in f32 both on split-TF32 products, in bf16 both on the
    bf16 tensor cores. Both are gated against the plain version (f32:
    GRAD_ATOL and GRAD_RTOL; bf16: BF16_GRAD_REL of each batch row's
    largest plain gradient) and must give the same bits twice."""
    from dial_rag_tpu_torch.ops import flash_attention as fa

    kind = str(dtype)[6:]
    for s in (128, 64):
        qkv, mask, cot = attention_inputs(torch, dev, 32, s, heads, dh, seed=3 + s, dtype=dtype)
        q, k, v = (t.contiguous() for t in fa._split_heads(qkv, heads))
        do = cot.view(32, s, heads, dh).transpose(1, 2).contiguous().to(dtype)
        want = fa.attention_backward_plain(q, k, v, do, mask)
        times = {}
        for design, kernel, match in (
            ("(a) one launch", fa._backward_kernel, "single_tile_bwd_t"),
            ("(b) two passes", fa._bwd_q_blocked_kernel, "_tc_kernel" if dtype == torch.bfloat16 else "_tf32_kernel"),
        ):
            got = [torch.empty_like(t) for t in (q, k, v)]
            kernel(q, k, v, do, *got, mask)
            again = [torch.empty_like(t) for t in (q, k, v)]
            kernel(q, k, v, do, *again, mask)
            torch.cuda.synchronize()
            for a, w, a2 in zip(got, want, again):
                a, w = a.float(), w.float()
                if dtype == torch.bfloat16:
                    worst = max(((a[r] - w[r]).abs().max() / w[r].abs().max().clamp_min(1e-30)).item()
                                for r in range(a.shape[0]))
                    ok = worst <= BF16_GRAD_REL
                else:
                    worst = ((a - w).abs() - GRAD_RTOL * w.abs()).max().item()
                    ok = worst <= GRAD_ATOL
                if not (ok and torch.equal(a, a2.float())):
                    raise RuntimeError(f"{kind} backward {design} at S={s}, head_dim {dh}: off the plain version "
                                       f"by {worst}, or two calls differ")
            times[design] = kernel_device_ms(torch, lambda: kernel(q, k, v, do, *got, mask), match)
        print(f"{kind} single-tile backward designs at [32, {heads}, {s}, {dh}] (device time): "
              + ", ".join(f"{d} {t:.4f} ms" for d, t in times.items()) + f" {card}", flush=True)


def tensor_core_gates(torch, dev, heads: int) -> None:
    """The bf16 tensor-core forward, which serves kernels 4 (packed qkv),
    5 (head-major, single-tile S) and 6 (head-major, query-blocked S), at
    head_dim 32 and 64 for S in TC_SEQS against the plain versions
    (TOLERANCE and ``head_over``), each call launching it once: B = 3, a
    full row, a ragged one and a fully masked one (its output also held to
    the mean of its S values of v), and ragged S (100, 520, 1700: a ragged
    last 64-key chunk). Two planted faults, emulated on the plain version,
    must read past ``head_over``'s limit: a kernel that skipped the full
    row's middle 64-key chunk, and one that placed the mask one key late.
    Then the KV-blocked tensor-core forward (kernel 7 in bf16) at
    KV_TC_SHAPES and both head widths, the same way, its log-sum-exp also
    against the plain version's (LSE_TOL)."""
    from dial_rag_tpu_torch.ops import flash_attention as fa

    for dh in (32, 64):
        for s in TC_SEQS:
            b = 3
            qkv, mask, _ = attention_inputs(torch, dev, b, s, heads, dh, seed=s + dh, dtype=torch.bfloat16)
            q, k, v = fa._split_heads(qkv, heads)
            fa.reset_launches()
            with torch.no_grad():
                packed = fa.fused_qkv_attention(qkv, mask, heads)
                head_major = fa.flash_attention(q, k, v, mask)
                torch.cuda.synchronize()
                launches = {n: c for n, c in fa.LAUNCHES.items() if c}
                ref = fa.flash_attention(q, k, v, mask, plain=True)
                plain = (fa.fused_qkv_attention(qkv, mask, heads, plain=True), ref)
                errs = [(got.float() - want.float()).abs().max().item()
                        for got, want in zip((packed, head_major), plain)]
                overs = [head_over(packed, plain[0], heads), head_over(head_major, ref)]
                mean = v[-1:].float().mean(dim=2, keepdim=True).expand(-1, -1, s, -1)
                masked = (head_major[-1:].float() - mean).abs().max().item()
                overs.append(head_over(head_major[-1:], mean))
                chunk = (s // 2) // 64 * 64
                dropped = mask.clone()
                dropped[0, chunk : chunk + 64] = 0
                planted = [fa.flash_attention(q, k, v, m, plain=True) for m in (dropped, torch.roll(mask, 1, dims=1))]
                faults = [head_over(f, ref) for f in planted]
                fault_errs = [(f.float() - ref.float()).abs().max().item() for f in planted]
            route = fa.attention_route(s)
            kernel = 5 if route == "single_tile" else 6
            print(f"tensor-core forward at [{b}, {heads}, {s}, {dh}] bf16 (head-major: kernel {kernel}, {route}; "
                  f"row lengths {mask.sum(1).tolist()}): launches {launches}; max abs err packed {errs[0]:.4g}, "
                  f"head-major {errs[1]:.4g}, fully masked row vs the mean of v {masked:.4g} (tolerance "
                  f"{TOLERANCE}); of {BF16_HEAD_REL} of each (batch row, head)'s largest plain value: "
                  f"{overs[0]:.3g}, {overs[1]:.3g}, {overs[2]:.3g}; planted faults: keys {chunk}-{chunk + 63} "
                  f"of row 0 dropped {faults[0]:.3g} (max abs err {fault_errs[0]:.3g}), the mask one key late "
                  f"{faults[1]:.3g} ({fault_errs[1]:.3g})", flush=True)
            if launches != {"attention_tc": 2} or not (max(errs + [masked]) <= TOLERANCE and max(overs) <= 1):
                raise RuntimeError(f"tensor-core forward at S={s} head_dim {dh}: launches {launches}, errors "
                                   f"{errs}, {masked}, of the per-head limit {overs}")
            if not min(faults) > 1:
                raise RuntimeError(f"tensor-core forward at S={s} head_dim {dh}: the per-head limit does not "
                                   f"tell a planted fault from the plain version ({faults})")
            if not (torch.isfinite(packed.float()).all() and torch.isfinite(head_major.float()).all()):
                raise RuntimeError(f"tensor-core forward at S={s} head_dim {dh}: output not finite")

    for dh in (32, 64):
        for b, s in KV_TC_SHAPES:
            g = torch.Generator().manual_seed(b * s + dh)
            qkv = torch.randn(b, s, 3 * heads * dh, generator=g).to(dev, torch.bfloat16)
            # row 0 full at B = 3, else ragged; a ragged row; the last fully masked
            lengths = torch.randint(s // 2, s, (b,), generator=g)
            if b > 2:
                lengths[0] = s
                lengths[-1] = 0
            mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32).to(dev)
            q, k, v = fa._split_heads(qkv, heads)
            assert fa.attention_route(s) == "kv_blocked"
            fa.reset_launches()
            with torch.no_grad():
                o, lse = fa._forward(q, k, v, mask)
                torch.cuda.synchronize()
                launches = {n: c for n, c in fa.LAUNCHES.items() if c}
                ref, ref_lse = fa._forward(q, k, v, mask, plain=True)
                err = (o.float() - ref.float()).abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                overs = [head_over(o, ref)]
                masked = 0.0
                if b > 2:
                    mean = v[-1:].float().mean(dim=2, keepdim=True).expand(-1, -1, s, -1)
                    masked = (o[-1:].float() - mean).abs().max().item()
                    overs.append(head_over(o[-1:], mean))
                chunk = (int(lengths[0]) // 2) // 64 * 64
                dropped = mask.clone()
                dropped[0, chunk : chunk + 64] = 0
                planted = [fa._forward(q, k, v, m, plain=True)[0] for m in (dropped, torch.roll(mask, 1, dims=1))]
                faults = [head_over(f, ref) for f in planted]
            print(f"KV-blocked tensor-core forward (kernel 7) at [{b}, {heads}, {s}, {dh}] bf16 (row lengths "
                  f"{mask.sum(1).tolist()}): launches {launches}; max abs err {err:.4g}, fully masked row vs the "
                  f"mean of v {masked:.4g} (tolerance {TOLERANCE}); of {BF16_HEAD_REL} of each (batch row, head)'s "
                  f"largest plain value: {', '.join(f'{x:.3g}' for x in overs)}; lse {lse_err:.3g} (tolerance "
                  f"{LSE_TOL}); planted faults: keys {chunk}-{chunk + 63} of row 0 dropped {faults[0]:.3g}, the "
                  f"mask one key late {faults[1]:.3g}", flush=True)
            if launches != {"attention_kv_blocked_fwd": 1} or not (
                    max(err, masked) <= TOLERANCE and max(overs) <= 1 and lse_err <= LSE_TOL):
                raise RuntimeError(f"KV-blocked tensor-core forward at B={b} S={s} head_dim {dh}: launches "
                                   f"{launches}, errors {err}, {masked}, of the per-head limit {overs}, lse {lse_err}")
            if not min(faults) > 1:
                raise RuntimeError(f"KV-blocked tensor-core forward at B={b} S={s} head_dim {dh}: the per-head "
                                   f"limit does not tell a planted fault from the plain version ({faults})")
            if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
                raise RuntimeError(f"KV-blocked tensor-core forward at B={b} S={s} head_dim {dh}: not finite")


def tensor_core_waves(torch, dev, card, heads: int) -> None:
    """Times the bf16 tensor-core forward on the query-blocked route at S =
    4096 for B = 1, 2 and 4 at both head widths, beside SDPA with the
    additive mask: B h S / 64 blocks of 64 query rows, so B = 1 runs its
    blocks in one or two waves and leaves a tail, B = 4 in several. The
    time per batch row says how much of the gap to SDPA the tail explains,
    and how much the kernel's work per block."""
    import torch.nn.functional as F

    from dial_rag_tpu_torch.ops import flash_attention as fa

    s = 4096
    for dh in (32, 64):
        for b in (1, 2, 4):
            g = torch.Generator().manual_seed(b * dh)
            q, k, v = (torch.randn(b, heads, s, dh, generator=g).to(dev, torch.bfloat16) for _ in range(3))
            mask = torch.ones(b, s, dtype=torch.int32, device=dev)
            keep = fa.mask_bias(mask)[:, None, None, :].to(torch.bfloat16)
            fa.reset_launches()
            with torch.no_grad():
                fa._forward(q, k, v, mask)
                if fa.LAUNCHES["attention_tc"] != 1:
                    raise RuntimeError(f"[{b}, {heads}, {s}, {dh}] bf16 did not take the tensor-core forward")
                ms = cuda_ms(torch, lambda: fa._forward(q, k, v, mask), iters=10)
                library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), iters=10)
            print(f"tensor-core forward waves at [{b}, {heads}, {s}, {dh}] bf16, {b * heads * s // 64} blocks: "
                  f"{ms:.4f} ms ({ms / b:.4f} a batch row), SDPA {library_ms:.4f} ms ({library_ms / b:.4f}), "
                  f"{ms / library_ms:.2f}x {card}", flush=True)


def long_attention_rows(torch, dev, card, heads: int, dh: int, path) -> dict:
    """Kernels 6 (query-blocked; in bf16 the tensor-core forward) and 7
    (KV-blocked, with its log-sum-exp) against their plain versions in f32
    and bf16 (also ``head_over``) at head width ``dh``, q, k and v read as
    views of a packed qkv as the model reads them. Gated at fixed shapes and at each encode batch
    of the long-document phase (``path``: the lengths of its rows, pad rows
    0), there once with the batch's own lengths and once with a full row,
    ragged rows and a fully masked one; at B = 1 the one row is ragged.
    Each kernel is timed in both dtypes beside its bound, the plain version
    and SDPA with the additive mask, one row per dtype. The f32 kernels
    (split-TF32 products; the KV-blocked one rescales at every 64-key
    chunk, the plain version at every 512 keys) and their plain versions
    are also read against the function evaluated in f64 at each gated
    shape, o and the KV-blocked lse (a reading, not a gate)."""
    import torch.nn.functional as F

    from dial_rag_tpu_torch.ops import flash_attention as fa

    def inputs(b, s, dtype, seed, lengths=None):
        g = torch.Generator().manual_seed(seed)
        qkv = torch.randn(b, s, 3 * heads * dh, generator=g).to(dev, dtype)
        if lengths is None:
            lengths = torch.randint(s // 2, s, (b,), generator=g)
            if b > 2:
                lengths[0] = s
            if b > 1:
                lengths[-1] = 0
        mask = (torch.arange(s)[None, :] < torch.as_tensor(lengths)[:, None]).to(torch.int32)
        return (*fa._split_heads(qkv, heads), mask.to(dev))

    def lse_f64(q, k, mask):
        """Each query row's log-sum-exp of scores * scale + bias in f64,
        256 queries at a time."""
        bias = fa.mask_bias(mask).double()[:, None, None, :]
        kd = k.double().transpose(-1, -2)
        return torch.cat([torch.logsumexp(q[:, :, q0 : q0 + 256].double() @ kd / math.sqrt(dh) + bias, dim=-1)
                          for q0 in range(0, q.shape[2], 256)], dim=2)

    def gate(name, b, s, lengths, what):
        for dtype, tol in ((torch.float32, F32_FWD_TOL), (torch.bfloat16, TOLERANCE)):
            q, k, v, mask = inputs(b, s, dtype, seed=b * s, lengths=lengths)
            with torch.no_grad():
                o, lse = fa._forward(q, k, v, mask)
                ref, ref_lse = fa._forward(q, k, v, mask, plain=True)
            torch.cuda.synchronize()
            if not torch.isfinite(o.float()).all() or (lse is not None and not torch.isfinite(lse).all()):
                raise RuntimeError(f"{name}: kernel output is not finite")
            err = (o.float() - ref.float()).abs().max().item()
            over = head_over(o, ref) if dtype == torch.bfloat16 else 0.0
            lse_err = None if lse is None else (lse - ref_lse).abs().max().item()
            f64 = ""
            if dtype == torch.float32:
                # the exact softmax in f64: the function both routes compute
                with torch.no_grad():
                    exact = fa.attention_q_blocked_plain(q.double(), k.double(), v.double(), mask)
                    f64 = (f"; against f64: kernel {(o.double() - exact).abs().max().item():.3g}, plain "
                           f"{(ref.double() - exact).abs().max().item():.3g}")
                    if lse is not None:
                        exact = lse_f64(q, k, mask)
                        f64 += (f", lse kernel {(lse.double() - exact).abs().max().item():.3g}, plain "
                                f"{(ref_lse.double() - exact).abs().max().item():.3g}")
                del exact
            print(f"{name} at [{b}, {heads}, {s}, {dh}] {str(dtype)[6:]}, {what} (row lengths "
                  f"{mask.sum(1).tolist()}): max abs err {err:.3g} (tolerance {tol}"
                  + (f"; {over:.3g} of {BF16_HEAD_REL} of each (batch row, head)'s largest plain value"
                     if dtype == torch.bfloat16 else "") + ")"
                  + ("" if lse is None else f", lse {lse_err:.3g} (tolerance {LSE_TOL})") + f64, flush=True)
            if not (err <= tol and over <= 1) or (lse is not None and not lse_err <= LSE_TOL):
                raise RuntimeError(f"{name}: kernel disagrees with its plain version at B={b} S={s} {dtype}")

    rows = {}
    for name, route, shapes, timed, replaces in (
        ("attention_q_blocked", "q_blocked", [(4, 1024), (2, 2048), (1, 4096)], (1, 4096),
         "dial_rag_tpu/ops/flash_attention.py:115"),
        ("attention_kv_blocked_fwd", "kv_blocked", [(1, 8192)], (1, 8192),
         "dial_rag_tpu/ops/flash_attention.py:165"),
    ):
        own = [(len(lengths), s, lengths) for s, lengths in path if fa.attention_route(s) == route]
        if not own:
            raise RuntimeError(f"the long-document phase gives the {route} kernel no batch")
        for b, s in shapes + [(b, s) for b, s, _ in own if (b, s) not in shapes]:
            if fa.attention_route(s) != route:
                raise RuntimeError(f"S={s} does not take the {route} kernel")
            gate(name, b, s, None, "ragged rows" + (", one fully masked" if b > 1 else ""))
        for b, s, lengths in own:
            gate(name, b, s, lengths, "the long-document batch's own rows")
        b, s = timed
        for dtype in (torch.float32, torch.bfloat16):
            # the f32 kernels 6 and 7 form their products in split TF32:
            # bound at the 3xTF32 rate, the CUDA-core f32 one beside it
            tf32 = dtype == torch.float32
            peak = (PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_3XTF32_FLOPS if tf32 else PEAK_F32_FLOPS)
            q, k, v, mask = inputs(b, s, dtype, seed=7)
            size = q.element_size()
            keep = fa.mask_bias(mask)[:, None, None, :].to(dtype)
            with torch.no_grad():
                o, ref = fa._forward(q, k, v, mask)[0], fa._forward(q, k, v, mask, plain=True)[0]
                err = (o.float() - ref.float()).abs().max().item()
                over = head_over(o, ref) if dtype == torch.bfloat16 else 0.0
                ms = cuda_ms(torch, lambda: fa._forward(q, k, v, mask), iters=10)
                plain_ms = cuda_ms(torch, lambda: fa._forward(q, k, v, mask, plain=True), iters=3)
                library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), iters=10)
            flops = 4 * b * heads * s * s * dh
            nbytes = 4 * b * heads * s * dh * size + b * s * 4 + (b * heads * s * 4 if route == "kv_blocked" else 0)
            bound_ms, bound_by = bound(flops, nbytes, peak)
            f32_bound = bound(flops, nbytes, PEAK_F32_FLOPS)[0] if tf32 else None
            print(f"{name}: [{b}, {heads}, {s}, {dh}] {str(dtype)[6:]}: max_abs_err {err:.6g}; kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                  f"({flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s{' 3xTF32' if tf32 else ''}, "
                  f"{nbytes / 1e6:.2f} MB)"
                  + (f", CUDA-core f32 bound {f32_bound:.4f} ms (at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s)" if tf32
                     else "") + f" {card}", flush=True)
            if not (err <= (F32_FWD_TOL if dtype == torch.float32 else TOLERANCE) and over <= 1):
                raise RuntimeError(f"{name}: kernel disagrees with its plain version at B={b} S={s} {dtype}")
            key = instantiation(name, dtype, f"head_dim {dh}")
            rows[key] = {
                "name": key, "route": "cuda",
                "source": f"dial_rag_tpu_torch/csrc/"
                          f"{'attention_tc' if dtype == torch.bfloat16 else 'flash_attention_long'}.cu",
                "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            }
            if tf32:
                rows[key].update(status=REDESIGNED if route == "q_blocked" else REDESIGNED_KV_FORWARD,
                                 bound_f32_ms=f32_bound)
    return rows


def alps_questions() -> tuple[list[str], list[str]]:
    """The 155 hand-written questions and the first fact of each."""
    questions = json.loads(QUESTIONS.read_text())["questions"]
    return [q["facts"][0] for q in questions], [q["question"] for q in questions]


def training_setup(base):
    """The fine-tuning run's config and its stream of (question, first
    fact) pairs, no batch holding one fact twice."""
    from dial_rag_tpu_torch.training.data import positive_disjoint_stream
    from dial_rag_tpu_torch.training.loop import TrainConfig

    cfg = TrainConfig(batch_size=32, seq_len=128, learning_rate=2e-5, warmup_steps=2, total_steps=20,
                      checkpoint_every=10)
    facts, questions = alps_questions()
    pairs = [(base.query_instruction + q, f) for q, f in zip(questions, facts)]
    return cfg, positive_disjoint_stream(pairs, cfg.batch_size, cfg.total_steps, seed=0)


def main_path_shapes(base, cfg, stream) -> list[tuple[str, int, int]]:
    """(use, B, S) of every attention call of the training and f32 serve
    phases: each training batch (q and p padded to one S), and each encode
    of the serve (the facts in ``batch_size`` rows, the questions in one
    encode), padded as ``BgeEmbedder`` pads them."""
    from dial_rag_tpu_torch.embeddings.embedder import _bucket_rows
    from dial_rag_tpu_torch.training.loop import pairs_to_batches

    shapes = {("training", *batch["q_ids"].shape) for batch in pairs_to_batches(base.tokenizer, stream, cfg)}
    facts, questions = alps_questions()
    n = base.batch_size
    for i in range(0, len(facts), n):
        ids, _ = base.tokenizer.encode_batch(facts[i : i + n], max_len=base.max_len)
        shapes.add(("f32 serve", n if len(facts) > n else _bucket_rows(len(facts), n), ids.shape[1]))
    ids, _ = base.tokenizer.encode_batch([base.query_instruction + q for q in questions], max_len=base.max_len)
    shapes.add(("f32 serve", _bucket_rows(len(questions), n), ids.shape[1]))
    return sorted(shapes)


def training_phase(torch, card, base, num_layers: int, cfg, stream):
    """Fine-tunes ``base``'s f32 params with ``train()`` on ``stream``;
    returns the trained params and the attention counters of the 20-step
    run."""
    import numpy as np

    from dial_rag_tpu_torch.ops import flash_attention as fa
    from dial_rag_tpu_torch.training.contrastive import contrastive_loss, create_train_state, make_train_step
    from dial_rag_tpu_torch.training.loop import (
        Checkpointer, make_optimizer, pairs_to_batches, train, trainable_params,
    )
    from dial_rag_tpu_torch.weights import param_leaves

    model, dev = base.encoder.config, base.device
    init = {"embeddings": base.params["embeddings"], "layers": base.params["layers"]}
    first = next(pairs_to_batches(base.tokenizer, stream, cfg))
    s = first["q_ids"].shape[1]
    print(f"training: {len(stream)} (question, fact) pairs, batch {cfg.batch_size}, S={s}, "
          f"{cfg.total_steps} steps, lr {cfg.learning_rate}, warmup {cfg.warmup_steps}", flush=True)

    # step 1 through the kernels and through the plain route
    def loss_and_grads(impl):
        params = trainable_params(init, dev)
        loss = contrastive_loss(params, first, num_heads=model.num_heads, temperature=cfg.temperature,
                                attention_impl=impl)
        loss.backward()
        return loss.item(), [t.grad for t in param_leaves(params)]

    loss_k, grads_k = loss_and_grads("pallas")
    loss_p, grads_p = loss_and_grads("pallas_plain")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos_min, zero = 1.0, 0
    for gk, gp in zip(grads_k, grads_p):
        if not gp.abs().max() > 0:
            zero += 1
            continue
        cos = torch.nn.functional.cosine_similarity(gk.flatten().double(), gp.flatten().double(), dim=0).item()
        cos_min = min(cos_min, cos)
    print(f"step 1, kernels vs plain route: loss {loss_k:.8f} vs {loss_p:.8f} (rel {rel:.3g}, limit 1e-5); "
          f"gradient cosine min {cos_min:.8f} over {len(grads_p) - zero} tensors (limit 0.9999; "
          f"{zero} all-zero in the plain route)", flush=True)
    if not (rel <= 1e-5 and cos_min > 0.9999):
        raise RuntimeError("step 1 through the kernels disagrees with the plain route")
    del grads_k, grads_p

    # where one step spends the card's time (profiler, one step)
    params = trainable_params(init, dev)
    state = create_train_state(params, *make_optimizer(cfg, params))
    step_fn = make_train_step(model, temperature=cfg.temperature)
    step_fn(state, first)  # warm-up
    device_profile(torch, lambda: step_fn(state, first), f"one train step (B={cfg.batch_size}, S={s})", card, 16)
    del state, params, step_fn

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        run_dir, resume_dir = Path(tmp) / "run", Path(tmp) / "resume"
        times, snapshot = [], {}
        last = [0.0]

        def on_step(state, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            times.append(now - last[0])
            last[0] = now
            if state.step == 10:
                snapshot["params"] = host_copy(param_leaves(state.params))
                snapshot["optimizer"] = host_copy(state.optimizer.state_dict())
                snapshot["scheduler"] = host_copy(state.scheduler.state_dict())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**20
        fa.reset_launches()
        last[0] = time.perf_counter()
        trained, losses = train(model, cfg, stream, base.tokenizer, checkpoint_dir=str(run_dir), init=init,
                                device=dev, on_step=on_step)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**20
        for i, (loss, dt) in enumerate(zip(losses, times), start=1):
            print(f"  step {i:2d}: loss {loss:.6f}, {dt * 1e3:.2f} ms, {cfg.batch_size / dt:.1f} pairs/s")
        steady = sorted(times[1:])[len(times[1:]) // 2]
        print(f"training: median step {steady * 1e3:.2f} ms, {cfg.batch_size / steady:.1f} pairs/s "
              f"(steps 2-{cfg.total_steps}, host clock ending in synchronize, checkpoint saves included); "
              f"peak memory {peak:.1f} MiB, of which {held:.1f} MiB held before the run {card}")
        expected = num_layers * 2 * cfg.total_steps
        print(f"training launches {launches}; expected {expected} forward and backward "
              f"({num_layers} layers x 2 encodes x {cfg.total_steps} steps)", flush=True)
        if not all(np.isfinite(losses)) or len(losses) != cfg.total_steps:
            raise RuntimeError(f"training losses: {losses}")
        if not np.mean(losses[-4:]) < np.mean(losses[:4]):
            raise RuntimeError(f"training did not reduce the loss: {losses}")
        if launches["qkv_native_attention"] != expected or launches["flash_attention_bwd"] != expected:
            raise RuntimeError("the training path bypassed the attention kernels")

        # restore from the step-10 checkpoint: bit-exact, then resume 11-20
        if Checkpointer(str(run_dir)).steps() != [10, 20]:
            raise RuntimeError(f"checkpoints: {Checkpointer(str(run_dir)).steps()}")
        resume_dir.mkdir()
        step10 = Checkpointer(str(run_dir)).path(10)
        shutil.copy(step10, resume_dir / step10.name)
        params = trainable_params(init, dev)
        state = create_train_state(params, *make_optimizer(cfg, params))
        if Checkpointer(str(resume_dir)).restore(state) != 10:
            raise RuntimeError("no step-10 checkpoint to restore")
        exact = all(torch.equal(a.cpu(), b) for a, b in zip(param_leaves(state.params), snapshot["params"]))
        opt_now, opt_then = state.optimizer.state_dict(), snapshot["optimizer"]
        for i, st in opt_then["state"].items():
            exact &= all(torch.equal(st[key], opt_now["state"][i][key].cpu()) for key in st)
        exact &= opt_now["param_groups"] == opt_then["param_groups"]
        exact &= state.scheduler.state_dict() == snapshot["scheduler"]
        if not exact:
            raise RuntimeError("the step-10 checkpoint does not restore params and optimizer state exactly")
        del state, params
        fa.reset_launches()
        _, resumed = train(model, cfg, stream, base.tokenizer, checkpoint_dir=str(resume_dir), init=init,
                           device=dev)
        resume_launches = dict(fa.LAUNCHES)
        worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[10:]))
        print(f"restore of step 10: params, optimizer and scheduler state bit-exact; resumed steps 11-20 "
              f"losses within rel {worst:.3g} of the first run (limit 1e-6); launches {resume_launches}")
        if len(resumed) != 10 or not worst <= 1e-6:
            raise RuntimeError(f"resume did not reproduce steps 11-20: {resumed} vs {losses[10:]}")
        if resume_launches["qkv_native_attention"] != expected // 2:
            raise RuntimeError(f"resume launches {resume_launches}")
    return trained, launches


def host_copy(obj):
    """A copy of a (nested) state dict with every tensor on the host, so a
    snapshot takes no device memory."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [host_copy(v) for v in obj]
    return copy.deepcopy(obj)


def recall_at_1(embedder, facts, questions) -> float:
    import numpy as np

    d = embedder.embed_documents(facts)
    q = embedder.embed_queries(questions)
    dist = (q**2).sum(1)[:, None] - 2 * q @ d.T + (d**2).sum(1)[None, :]
    return float(np.mean(np.argmin(dist, axis=1) == np.arange(len(questions))))


def f32_serve_phase(torch, card, base, trained) -> int:
    """The trained params served in f32, then exported as an HF checkpoint
    and served from it: returns the forward counter."""
    import numpy as np

    from dial_rag_tpu_torch.documents.model import build_chunks_list
    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.models.bert import BertEncoder, export_hf_state
    from dial_rag_tpu_torch.models.safetensors_io import save_file
    from dial_rag_tpu_torch.ops import flash_attention as fa
    from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever

    facts, queries = alps_questions()
    cfg = base.encoder.config
    params = dict(trained)
    if "pooling_idf" in base.params:
        params["pooling_idf"] = base.params["pooling_idf"]

    def embedder(impl):
        return BgeEmbedder(
            tokenizer=base.tokenizer,
            encoder=BertEncoder(cfg, compute_dtype=torch.float32, attention_impl=impl,
                                pooling=base.encoder.pooling),
            params=params, device=base.device, query_instruction=base.query_instruction, model_id="trained",
        )

    serve, plain = embedder("auto"), embedder("pallas_plain")
    serve.embed_documents(facts[:8])  # warm-up
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    record = type("Record", (), {"embeddings_index": asyncio.run(SemanticRetriever.build_index(
        serve, build_chunks_list([(f, {}) for f in facts])))})()
    retriever = SemanticRetriever.from_doc_records(serve, [record], k=1)
    hits = retriever.retrieve_batch(queries)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = fa.LAUNCHES["qkv_native_attention"]
    # the facts in bulk batches, the questions in one encode
    n_batches = -(-len(facts) // serve.batch_size) + 1
    print(f"f32 serve: {len(facts)} facts indexed and {len(queries)} questions answered in {elapsed:.3f} s; "
          f"launches {dict(fa.LAUNCHES)}; encode batches {n_batches} {card}")
    if launches != cfg.num_layers * n_batches:
        raise RuntimeError(f"f32 serve launched the attention kernel {launches} times, expected "
                           f"{cfg.num_layers * n_batches}: the path bypassed it")
    doc_emb = np.concatenate(record.embeddings_index)
    if doc_emb.shape != (len(facts), cfg.hidden_size) or not np.isfinite(doc_emb).all():
        raise RuntimeError(f"bad f32 fact embeddings: shape {doc_emb.shape}")
    q_kernel = serve.embed_queries(queries)
    d_plain, q_plain = plain.embed_documents(facts), plain.embed_queries(queries)
    print(f"f32 serve, kernel route vs plain route: max abs diff documents "
          f"{np.abs(doc_emb - d_plain).max():.3g}, queries {np.abs(q_kernel - q_plain).max():.3g}")
    ties = top1_agree([h[0].chunk_id for h in hits], nearest(q_plain, d_plain), doc_emb, q_kernel, "f32 serve")
    recall = float(np.mean([h[0].chunk_id == i for i, h in enumerate(hits)]))
    print(f"f32 serve top-1 of {len(queries)} questions: kernel route = plain route ({ties} near-ties "
          f"below {TIE_GAP}); recall@1 before training {recall_at_1(base, facts, queries):.4f}, after "
          f"{recall:.4f} (not gated)", flush=True)

    # the trained encoder exported as an HF checkpoint and served from it
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        t0 = time.perf_counter()
        save_file(export_hf_state(trained, cfg), str(Path(tmp) / "model.safetensors"))
        for name in ("config.json", "vocab.txt", "idf_pooling.npz"):
            shutil.copy(CHECKPOINT / name, Path(tmp) / name)
        t_export = time.perf_counter() - t0
        back = BgeEmbedder.from_hf_checkpoint(tmp, compute_dtype=torch.float32, device=base.device)
        same_docs = np.array_equal(back.embed_documents(facts), serve.embed_documents(facts))
        same_queries = np.array_equal(back.embed_queries(queries), q_kernel)
    print(f"export: export_hf_state + save_file of the trained f32 encoder in {t_export:.3f} s; read back by "
          f"from_hf_checkpoint: {len(facts)} fact and {len(queries)} question embeddings equal bit for bit: "
          f"{same_docs and same_queries}", flush=True)
    if not (same_docs and same_queries):
        raise RuntimeError("the exported checkpoint serves other embeddings than the trained encoder")
    return launches


def leaf_names(tree, prefix="") -> list[str]:
    """The names of ``param_leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


def bf16_gradient_readings(torch, base, cfg, batch) -> dict:
    """One bf16 ``contrastive_loss`` backward on ``batch`` through "auto"
    (on the card: the fused block kernels forward, their recompute
    backward), "fused_plain" and "xla" (a second plain bf16 composition of
    the same layer). The cosines of "auto" and of "xla" against
    "fused_plain", per tensor (tensors the reference leaves all zero are
    skipped) and of the whole gradient."""
    from dial_rag_tpu_torch.ops import fused_encoder as fe
    from dial_rag_tpu_torch.training.contrastive import contrastive_loss
    from dial_rag_tpu_torch.training.loop import trainable_params
    from dial_rag_tpu_torch.weights import param_leaves

    model, dev = base.encoder.config, base.device
    init = {"embeddings": base.params["embeddings"], "layers": base.params["layers"]}

    def loss_and_grads(impl):
        params = trainable_params(init, dev)
        fe.reset_launches()
        loss = contrastive_loss(params, batch, num_heads=model.num_heads, temperature=cfg.temperature,
                                compute_dtype=torch.bfloat16, attention_impl=impl)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), [t.grad for t in param_leaves(params)], dict(fe.LAUNCHES)

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()

    loss_k, grads_k, launches = loss_and_grads("auto")
    loss_p, grads_p, _ = loss_and_grads("fused_plain")
    loss_x, grads_x, _ = loss_and_grads("xla")
    if not all(torch.isfinite(g).all() for g in grads_k):
        raise RuntimeError("a bf16 gradient through the kernels is not finite")
    kept = [i for i, r in enumerate(grads_p) if r.abs().max() > 0]
    names = leaf_names(init)
    whole = [cos(torch.cat([g.flatten() for g in grads]), torch.cat([r.flatten() for r in grads_p]))
             for grads in (grads_k, grads_x)]
    return {
        "loss": {"auto": loss_k, "fused_plain": loss_p, "xla": loss_x}, "launches": launches,
        "names": [names[i] for i in kept], "whole_k": whole[0], "whole_x": whole[1],
        "per_k": [cos(grads_k[i], grads_p[i]) for i in kept], "per_x": [cos(grads_x[i], grads_p[i]) for i in kept],
    }


def bf16_gradient_phase(torch, base, cfg, stream) -> None:
    """bf16 gradients of the kernel route against the "fused_plain" route
    on the first training batch: the whole gradient's cosine must exceed
    GRAD_COS, and each tensor's cosine may fall at most GRAD_COS_EPS below
    the same tensor's cosine between the "xla" and "fused_plain" routes,
    two plain compositions that differ only in bf16 rounding (the loss's
    temperature, 0.02, scales every difference of the embeddings by 50)."""
    from dial_rag_tpu_torch.training.loop import pairs_to_batches

    first = next(pairs_to_batches(base.tokenizer, stream, cfg))
    r = bf16_gradient_readings(torch, base, cfg, first)
    per_k, per_x, names = r["per_k"], r["per_x"], r["names"]
    short = [x - k for k, x in zip(per_k, per_x)]
    worst = max(range(len(short)), key=short.__getitem__)
    expected = base.encoder.config.num_layers * 2
    print(f"bf16 contrastive_loss (B={first['q_ids'].shape[0]}, S={first['q_ids'].shape[1]}), against the "
          f"\"fused_plain\" route: losses {r['loss']}; gradient cosine whole \"auto\" (kernels) "
          f"{r['whole_k']:.8f} (limit {GRAD_COS}), \"xla\" {r['whole_x']:.8f}; per tensor min \"auto\" "
          f"{min(per_k):.8f}, \"xla\" {min(per_x):.8f}; largest shortfall of \"auto\" below \"xla\" "
          f"{short[worst]:.3g} at {names[worst]} ({per_k[worst]:.8f} vs {per_x[worst]:.8f}, limit "
          f"{GRAD_COS_EPS}); {len(per_k)} tensors; launches {r['launches']}, expected {expected} per block",
          flush=True)
    if r["launches"]["fused_attention_block"] != expected or r["launches"]["fused_ffn_block"] != expected:
        raise RuntimeError("the bf16 training forward bypassed the fused block kernels")
    if not r["whole_k"] > GRAD_COS:
        raise RuntimeError(f"bf16 gradients through the kernels disagree with the plain route: whole {r['whole_k']}")
    bad = [(n, k, x) for n, k, x, d in zip(names, per_k, per_x, short) if not d <= GRAD_COS_EPS]
    if bad:
        raise RuntimeError(f"bf16 gradients through the kernels fall more than {GRAD_COS_EPS} below the "
                           f"plain-vs-plain cosine at (tensor, auto, xla): {bad}")


def top1_agree(kernel_top, plain_top, doc_emb, q_emb, what) -> int:
    """Top-1 of the kernel route equal to the plain route's, apart from
    near-ties (distance gap below TIE_GAP); returns the near-ties."""
    ties = 0
    for qi, (ck, cp) in enumerate(zip(kernel_top, plain_top)):
        if ck == cp:
            continue
        d = ((doc_emb[[ck, cp]] - q_emb[qi]) ** 2).sum(axis=1)
        gap = abs(float(d[0] - d[1]))
        print(f"top-1 near-tie, {what} query {qi}: kernel {ck} vs plain {cp}, distance gap {gap:.3g}")
        if gap >= TIE_GAP:
            raise RuntimeError(f"{what}: top-1 of query {qi} differs from the plain route by {gap}")
        ties += 1
    return ties


def nearest(q, d):
    import numpy as np

    return np.argmin(((q[:, None, :] - d[None, :, :]) ** 2).sum(-1), axis=1)


def whole_layer_phase(torch, card, embedder, texts, queries) -> int:
    """A subset of the main path's chunks and queries served in bf16
    through the "fused_layer" route; returns the whole-layer kernel's
    launches in that run."""
    import numpy as np

    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder, _bucket_rows
    from dial_rag_tpu_torch.models.bert import BertEncoder, _layer_weights, embed_tokens
    from dial_rag_tpu_torch.ops import fused_encoder as fe

    cfg = embedder.encoder.config
    docs, queries = texts[:LAYER_SUBSET], queries[:N_TOP1]

    def route(impl):
        return BgeEmbedder(
            tokenizer=embedder.tokenizer,
            encoder=BertEncoder(cfg, compute_dtype=torch.bfloat16, attention_impl=impl,
                                pooling=embedder.encoder.pooling),
            params=embedder.params, device=embedder.device, query_instruction=embedder.query_instruction,
            batch_size=embedder.batch_size, model_id=embedder.model_id,
        )

    layer, plain = route("fused_layer"), route("fused_layer_plain")
    torch.cuda.synchronize()
    fe.reset_launches()
    t0 = time.perf_counter()
    d_layer = layer.embed_documents(docs)
    q_layer = layer.embed_queries(queries)
    elapsed = time.perf_counter() - t0
    launches = fe.LAUNCHES["fused_layer_block"]
    n_batches = -(-len(docs) // layer.batch_size) + 1
    print(f"whole-layer serve: {len(docs)} chunks and {len(queries)} queries in {elapsed:.3f} s; launches "
          f"{dict(fe.LAUNCHES)}; encode batches {n_batches} {card}")
    if launches != cfg.num_layers * n_batches or launches == 0:
        raise RuntimeError(f"the whole-layer route launched its kernel {launches} times, expected "
                           f"{cfg.num_layers * n_batches}: it bypassed the kernel")
    if not np.isfinite(d_layer).all() or d_layer.shape != (len(docs), cfg.hidden_size):
        raise RuntimeError(f"bad whole-layer embeddings: {d_layer.shape}")
    d_fused, d_plain = embedder.embed_documents(docs), plain.embed_documents(docs)
    q_plain = plain.embed_queries(queries)
    # kernel 3 in bf16 runs kernels 1's and 2's launch sequences
    # themselves (csrc/encoder_tc.cuh), so its embeddings equal the
    # "fused" route's bit for bit
    for other, d, limit in (("fused", d_fused, None), ("fused_layer_plain", d_plain, LAYER_PLAIN_COS)):
        cos = (d_layer * d).sum(axis=1)
        print(f"whole-layer route vs \"{other}\" route, {len(docs)} chunks: max abs diff "
              f"{np.abs(d_layer - d).max():.3g}, cosine min {cos.min():.8f} "
              f"({'bit-equal required' if limit is None else f'limit {limit}'})")
        if (limit is None and not np.array_equal(d_layer, d)) or (limit is not None and not cos.min() > limit):
            raise RuntimeError(f"whole-layer embeddings disagree with the {other} route: cosine {cos.min()}")
    ties = top1_agree(nearest(q_layer, d_layer), nearest(q_plain, d_plain), d_layer, q_layer, "whole-layer")
    print(f"whole-layer top-1 of {len(queries)} queries: kernel route = plain route ({ties} near-ties below "
          f"{TIE_GAP})")

    # the kernel against its plain version at each serve shape (layer 0)
    weights = _layer_weights(embedder.params["layers"][0])
    for texts_b, rows in ((docs[: layer.batch_size], layer.batch_size),
                          ([layer.query_instruction + q for q in queries], _bucket_rows(len(queries), layer.batch_size))):
        ids, mask = layer.tokenizer.encode_batch(texts_b, max_len=layer.max_len)
        ids = np.pad(ids, ((0, rows - len(texts_b)), (0, 0)))
        mask = np.pad(mask, ((0, rows - len(texts_b)), (0, 0)))
        ids_t = torch.from_numpy(ids).to(embedder.device, dtype=torch.long)
        mask_t = torch.from_numpy(mask).to(embedder.device)
        x = embed_tokens(embedder.params, ids_t, torch.bfloat16)
        with torch.no_grad():
            out = fe.fused_layer_block(x, mask_t, weights, cfg.num_heads)
            ref = fe.fused_layer_block_plain(x, mask_t, weights, cfg.num_heads)
        err = (out.float() - ref.float()).abs().max().item()
        tol, per_row = block_tolerance(out.dtype, cfg.hidden_size)
        print(f"fused_layer_block at the serve shape B={rows} S={ids.shape[1]} H={cfg.hidden_size}: max abs err "
              f"{err:.3g} (tolerance {tolerance_text(tol, per_row)}: {over_limit(out, ref, tol, per_row):.3g} of it)")
        if not over_limit(out, ref, tol, per_row) <= 1:
            raise RuntimeError(f"fused_layer_block disagrees with its plain version at B={rows} S={ids.shape[1]}")
    sys.stdout.flush()
    return launches


def long_texts(tokenizer, targets) -> list[str]:
    """Long texts made of the Alps oracle chunks: text i repeats chunks i
    and i + 1, whole words, up to ``targets[i]`` tokens with [CLS] and
    [SEP]; the real tokenizer counts them."""
    chunks = [c["text"] for c in json.loads(ORACLE_CHUNKS.read_text())]
    out = []
    for i, target in enumerate(targets):
        words = (chunks[i % len(chunks)] + " " + chunks[(i + 1) % len(chunks)]).split()
        picked, count, j = [], 2, 0
        while True:
            w = words[j % len(words)]
            n = len(tokenizer.encode(w, max_len=1 << 30)) - 2
            if count + n > target:
                break
            picked.append(w)
            count += n
            j += 1
        out.append(" ".join(picked))
    return out


def long_path(tokenizer, docs, max_len) -> list[tuple[int, list[int]]]:
    """(S, row lengths) of each encode batch of ``docs`` at LONG_BATCH
    rows, padded as ``BgeEmbedder`` pads them (pad rows have length 0)."""
    from dial_rag_tpu_torch.embeddings.embedder import _bucket_rows

    rows = _bucket_rows(len(docs), LONG_BATCH) if len(docs) <= LONG_BATCH else LONG_BATCH
    out = []
    for i in range(0, len(docs), LONG_BATCH):
        _, mask = tokenizer.encode_batch(docs[i : i + LONG_BATCH], max_len=max_len)
        lengths = [int(n) for n in mask.sum(axis=1)]
        out.append((mask.shape[1], lengths + [0] * (rows - len(lengths))))
    return out


def long_document_phase(torch, card, dev, config, params, tokenizer, docs, max_len, what) -> dict:
    """Long texts indexed in bf16 and in f32 by an encoder (``what`` names
    its widths) whose "auto" route takes the blocked attention kernels past
    S = 512 (the query-blocked route in bf16 on the tensor-core forward);
    returns the kernels' launches per dtype."""
    import numpy as np

    from dial_rag_tpu_torch.documents.model import build_chunks_list
    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.models.bert import BertEncoder
    from dial_rag_tpu_torch.ops import flash_attention as fa
    from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever

    chunks = [c["text"] for c in json.loads(ORACLE_CHUNKS.read_text())]
    queries = [" ".join(chunks[i].split()[:12]) for i in range(LONG_QUERIES)]
    shapes = [s for s, _ in long_path(tokenizer, docs, max_len)]
    tokens = sum(len(tokenizer.encode(t, max_len)) for t in docs)
    routes = [fa.attention_route(s) for s in shapes]
    print(f"long documents ({what}): {len(docs)} texts, {tokens} tokens, encode batches of {LONG_BATCH} rows at "
          f"S = {shapes} ({routes}); {config.num_layers} layers, H={config.hidden_size}, {config.num_heads} heads, "
          f"FFN {config.intermediate_size}, {config.max_position_embeddings} positions, seeded weights", flush=True)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        def embedder(impl):
            return BgeEmbedder(tokenizer=tokenizer,
                               encoder=BertEncoder(config, compute_dtype=dtype, attention_impl=impl, pooling="mean"),
                               params=params, device=dev, batch_size=LONG_BATCH, max_len=max_len,
                               model_id="long-seeded")

        serve, plain = embedder("auto"), embedder("pallas_plain")
        name = str(dtype)[6:]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        record = type("Record", (), {"embeddings_index": asyncio.run(SemanticRetriever.build_index(
            serve, build_chunks_list([(t, {}) for t in docs])))})()
        retriever = SemanticRetriever.from_doc_records(serve, [record], k=1)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        hits = retriever.retrieve_batch(queries)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**20
        # the queries (S <= 512) take other kernels; count the documents' encodes
        q_key = "attention_tc" if dtype == torch.bfloat16 else "attention_q_blocked"
        expected = {q_key: config.num_layers * routes.count("q_blocked"),
                    "attention_kv_blocked_fwd": config.num_layers * routes.count("kv_blocked")}
        got = {k: launches[k] for k in expected}
        print(f"long-document serve ({what}) {name}: index build {len(docs)} texts, {tokens} tokens in "
              f"{t_build:.3f} s: {len(docs) / t_build:.2f} chunks/s, {tokens / t_build:.0f} tokens/s; peak memory "
              f"{peak:.1f} MiB; launches {launches}, expected {expected} {card}", flush=True)
        if got != expected or not all(got.values()):
            raise RuntimeError(f"long-document serve {name} bypassed the blocked kernels: {got} vs {expected}")
        doc_emb = np.concatenate(record.embeddings_index)
        if doc_emb.shape != (len(docs), config.hidden_size) or not np.isfinite(doc_emb).all():
            raise RuntimeError(f"bad long-document embeddings: {doc_emb.shape}")
        q_kernel = serve.embed_queries(queries)
        d_plain, q_plain = plain.embed_documents(docs), plain.embed_queries(queries)
        cos = (doc_emb * d_plain).sum(axis=1)
        print(f"long-document serve {name}, kernel route vs \"pallas_plain\": max abs diff documents "
              f"{np.abs(doc_emb - d_plain).max():.3g}, cosine min {cos.min():.8f}; queries "
              f"{np.abs(q_kernel - q_plain).max():.3g}")
        if not cos.min() > (0.999 if dtype == torch.bfloat16 else 0.99999):
            raise RuntimeError(f"long-document embeddings ({name}) disagree with the plain route: {cos.min()}")
        ties = top1_agree([h[0].chunk_id for h in hits], nearest(q_plain, d_plain), doc_emb, q_kernel,
                          f"long-document {name}")
        print(f"long-document {name} top-1 of {len(queries)} queries: kernel route = plain route ({ties} "
              f"near-ties below {TIE_GAP})", flush=True)

        # where one encode of the last (longest) batch spends the card's time
        ids, mask = tokenizer.encode_batch(docs[(len(docs) - 1) // LONG_BATCH * LONG_BATCH :], max_len=max_len)
        ids = torch.from_numpy(np.pad(ids, ((0, LONG_BATCH - len(ids)), (0, 0)))).to(dev, dtype=torch.long)
        mask = torch.from_numpy(np.pad(mask, ((0, LONG_BATCH - len(mask)), (0, 0)))).to(dev)
        device_profile(torch, lambda: serve.encoder.encode(serve.params, ids, mask),
                       f"one long-document encode ({name}, B={LONG_BATCH}, S={ids.shape[1]})", card, 6)
        out[name] = launches
        del serve, plain, retriever, record
    return out


def long_backward_rows(torch, dev, card, heads: int, dh: int, batch: int, seqs, timed) -> dict:
    """Kernels 9 (query-blocked backward) and 10, 11 (the KV-blocked dQ and
    dK/dV passes) against their plain versions at [batch, heads, S, dh] for
    every S in ``seqs``, in f32 and bf16: standard-normal qkv and dO (peaked
    attention), a full row, a row padded across a 512-key block, a ragged
    row and a fully masked one. q, k and v are strided views of a packed
    qkv, the gradients are written into a packed dqkv, dO is a transposed
    view; the KV-blocked passes and their plain version get the forward
    kernel's o and lse (gates: ``check``). Each kernel is then gated and
    timed at ``timed[name]`` (B, S) in both dtypes beside its bound, the
    plain version, SDPA forward + backward with the additive mask and
    SDPA's backward alone (``library_bwd_ms``: after one forward,
    ``torch.autograd.grad`` with the graph retained), one row per dtype,
    and run twice on the same inputs, which must give the same bits. The
    f32 kernels (split-TF32 products) and their plain versions are also
    read against the plain version evaluated in f64 at each gated S, every
    row (a reading, not a gate)."""
    import torch.nn.functional as F

    from dial_rag_tpu_torch.ops import flash_attention as fa

    def inputs(b, s, dtype, seed):
        g = torch.Generator().manual_seed(seed)
        qkv = torch.randn(b, s, 3 * heads * dh, generator=g).to(dev, dtype)
        do = torch.randn(b, s, heads, dh, generator=g).to(dev, dtype).transpose(1, 2)
        lengths = torch.randint(s // 2, s, (b,), generator=g)
        lengths[0], lengths[1], lengths[-1] = s, s // 3 + 100, 0
        mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32)
        return (*fa._split_heads(qkv, heads), do, mask.to(dev))

    def run(q, k, v, do, mask, plain):
        """(dq, dk, dv) of the blocked backward, after the forward kernel's
        o and lse (the kernels write into a packed dqkv), and the
        KV-blocked backward's plain version evaluated in f64 (else None)."""
        with torch.no_grad():
            o, lse = fa._forward(q, k, v, mask)
            if plain:
                if lse is None:
                    return fa.attention_bwd_q_blocked_plain(q, k, v, do, mask), None
                return (fa.attention_bwd_kv_blocked_plain(q, k, v, o, lse, do, mask),
                        fa.attention_bwd_kv_blocked_plain(*(t.double() for t in (q, k, v, o)), lse, do.double(), mask))
            b, _, s, _ = q.shape
            grads = fa._split_heads(torch.empty(b, s, 3 * heads * dh, dtype=q.dtype, device=dev), heads)
            if lse is None:
                fa._bwd_q_blocked_kernel(q, k, v, do, *grads, mask)
            else:
                delta = fa._bwd_dq_kv_blocked_kernel(q, k, v, o, lse, do, grads[0], mask)
                err = (delta - (do.float() * o.float()).sum(dim=-1)).abs().max().item()
                if not err <= GRAD_ATOL:
                    raise RuntimeError(f"bwd_dq_kv_blocked: delta off rowsum(dO O) by {err}")
                fa._bwd_dkv_kv_blocked_kernel(q, k, v, do, lse, delta, *grads[1:], mask)
            return grads

    def excess(a, w):
        return ((a - w).abs() - GRAD_RTOL * w.abs()).max().item()

    def check(name, got, want, exact, mask, dtype, which=(0, 1, 2)):
        """f32: the excess of |kernel - plain| over atol after rtol; in a
        fully masked row of the KV-blocked backward, where P = 1 makes every
        gradient a sum of S terms of size 1 whose f32 rounding alone exceeds
        atol, the kernel's excess against the f64 evaluation may not exceed
        the plain version's (or atol). bf16: per (batch row, head), max
        |kernel - plain| over max |plain|, printed also as each batch row's
        largest (the last row is fully masked). ``which``: the gradients (0
        dq, 1 dk, 2 dv) to read."""
        torch.cuda.synchronize()
        masked = mask.sum(dim=1) == 0
        readings = []
        for i in which:
            g, a, w = ("dq", "dk", "dv")[i], got[i].float(), want[i].float()
            if not torch.isfinite(a).all():
                raise RuntimeError(f"{name}: {g} is not finite")
            if dtype == torch.float32:
                apart = ~masked if exact is not None else torch.ones_like(masked)
                err = excess(a[apart], w[apart])
                ok, reading = err <= GRAD_ATOL, f"{g} {err:.3g}"
                if exact is not None and masked.any():
                    e = exact[i][masked]
                    k_ex, p_ex = excess(a[masked].double(), e), excess(w[masked].double(), e)
                    ok = ok and k_ex <= max(GRAD_ATOL, p_ex)
                    reading += f" (fully masked rows against f64: kernel {k_ex:.3g}, plain {p_ex:.3g})"
            else:
                # gradients [B, h, S, Dh]: one ratio per (batch row, head)
                per_head = (a - w).abs().amax(dim=(2, 3)) / w.abs().amax(dim=(2, 3)).clamp_min(1e-30)
                err = per_head.max().item()
                rows = ", ".join(f"{r:.3g}" for r in per_head.amax(dim=1).tolist())
                ok, reading = err <= BF16_GRAD_REL, f"{g} {err:.3g} (by batch row {rows})"
            if not ok:
                raise RuntimeError(f"{name}: {g} off its plain version: {reading}")
            readings.append(reading)
        return ", ".join(readings)

    names = {"q_blocked": "attention_bwd_q_blocked", "kv_blocked": "bwd_dq_kv_blocked + bwd_dkv_kv_blocked"}
    for s in seqs:
        route = fa.attention_route(s)
        if route == "single_tile":
            raise RuntimeError(f"S={s} takes no blocked kernel")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, mask = inputs(batch, s, dtype, seed=s)
            want, exact = run(q, k, v, do, mask, True)
            got = run(q, k, v, do, mask, False)
            reading = check(names[route], got, want, exact, mask, dtype)
            if dtype == torch.float32:
                if route == "q_blocked":
                    with torch.no_grad():
                        exact = fa.attention_bwd_q_blocked_plain(*(t.double() for t in (q, k, v, do)), mask)
                reading += "; against f64 (every row), kernel / plain: " + ", ".join(
                    f"{g} {excess(a.double(), e):.3g} / {excess(w.double(), e):.3g}"
                    for g, a, w, e in zip(("dq", "dk", "dv"), got, want, exact))
            del want, exact, got
            what = (f"excess of |kernel - plain| over atol after rtol (atol {GRAD_ATOL}, rtol {GRAD_RTOL})"
                    if dtype == torch.float32 else
                    f"max abs err / max |plain| per (batch row, head) (limit {BF16_GRAD_REL})")
            print(f"{names[route]} at [{batch}, {heads}, {s}, {dh}] {str(dtype)[6:]} (row lengths "
                  f"{mask.sum(1).tolist()}): {what}: {reading}", flush=True)
            del q, k, v, do

    rows = {}
    f32 = 4
    outputs = {"attention_bwd_q_blocked": (0, 1, 2), "bwd_dq_kv_blocked": (0,), "bwd_dkv_kv_blocked": (1, 2)}
    for name, replaces in (("attention_bwd_q_blocked", "dial_rag_tpu/ops/flash_attention.py:360"),
                           ("bwd_dq_kv_blocked", "dial_rag_tpu/ops/flash_attention.py:417"),
                           ("bwd_dkv_kv_blocked", "dial_rag_tpu/ops/flash_attention.py:461")):
        b, s = timed[name]
        for dtype in (torch.bfloat16, torch.float32):
            # the f32 kernels form their products in split TF32: bound at
            # the 3xTF32 rate, the CUDA-core f32 one beside it
            tf32 = dtype == torch.float32
            peak = PEAK_3XTF32_FLOPS if tf32 else PEAK_BF16_FLOPS
            q, k, v, do, mask = inputs(b, s, dtype, seed=11)
            size, head = q.element_size(), b * heads * s * dh * q.element_size()
            with torch.no_grad():
                o, lse = fa._forward(q, k, v, mask)
            dq, dk, dv = (torch.empty(t.shape, dtype=dtype, device=dev) for t in (q, k, v))
            if name == "attention_bwd_q_blocked":
                if lse is not None:
                    raise RuntimeError(f"S={s} does not take the query-blocked backward")
                kernel = lambda: fa._bwd_q_blocked_kernel(q, k, v, do, dq, dk, dv, mask)  # noqa: E731
                plain = lambda: fa.attention_bwd_q_blocked_plain(q, k, v, do, mask)  # noqa: E731
                flops, nbytes = 10 * b * heads * s * s * dh, 7 * head + b * s * f32
            elif name == "bwd_dq_kv_blocked":
                kernel = lambda: fa._bwd_dq_kv_blocked_kernel(q, k, v, o, lse, do, dq, mask)  # noqa: E731
                plain = lambda: fa.attention_bwd_kv_blocked_plain(q, k, v, o, lse, do, mask)  # noqa: E731
                flops, nbytes = 6 * b * heads * s * s * dh, 6 * head + 2 * b * heads * s * f32 + b * s * f32
            else:
                delta = fa._bwd_dq_kv_blocked_kernel(q, k, v, o, lse, do, dq, mask)
                kernel = lambda: fa._bwd_dkv_kv_blocked_kernel(q, k, v, do, lse, delta, dk, dv, mask)  # noqa: E731
                plain = lambda: fa.attention_bwd_kv_blocked_plain(q, k, v, o, lse, do, mask)  # noqa: E731
                flops, nbytes = 8 * b * heads * s * s * dh, 6 * head + 2 * b * heads * s * f32 + b * s * f32
            want = plain()
            exact = None
            if lse is not None and dtype == torch.float32:
                exact = fa.attention_bwd_kv_blocked_plain(*(t.double() for t in (q, k, v, o)), lse, do.double(), mask)
            kernel()
            check(name, (dq, dk, dv), want, exact, mask, dtype, outputs[name])
            err = max((grad.float() - want[i].float()).abs().max().item()
                      for i, grad in enumerate((dq, dk, dv)) if i in outputs[name])
            # no atomics: a second run on the same inputs gives the same
            # bits (in the gradients it writes: the others stay unwritten)
            first = [(dq, dk, dv)[i].clone() for i in outputs[name]]
            kernel()
            torch.cuda.synchronize()
            if not all(torch.equal(a, (dq, dk, dv)[i]) for a, i in zip(first, outputs[name])):
                raise RuntimeError(f"{name}: two runs on the same inputs differ at B={b} S={s} {dtype}")
            del first
            ms = cuda_ms(torch, kernel, iters=5, warmup=1)
            plain_ms = cuda_ms(torch, plain, iters=2, warmup=1)
            del want, exact

            # SDPA forward + backward, the yardstick (rows 10 and 11 share it)
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            keep = fa.mask_bias(mask)[:, None, None, :].to(dtype)

            def sdpa():
                for t in leaves:
                    t.grad = None
                F.scaled_dot_product_attention(*leaves, attn_mask=keep).backward(do)

            library_ms = cuda_ms(torch, sdpa, iters=5, warmup=1)
            # SDPA's backward alone: the whole backward, the yardstick of the
            # pair of KV-blocked passes (and of kernel 9)
            out = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
            library_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                                     iters=5, warmup=1)
            del leaves, out
            bound_ms, bound_by = bound(flops, nbytes, peak)
            f32_bound = bound(flops, nbytes, PEAK_F32_FLOPS)[0] if tf32 else None
            print(f"{name}: [{b}, {heads}, {s}, {dh}] {str(dtype)[6:]}: max_abs_err {err:.6g}; kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, SDPA forward + backward {library_ms:.4f} ms, SDPA backward "
                  f"{library_bwd_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"by {bound_by} ({flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s{' 3xTF32' if tf32 else ''}, "
                  f"{nbytes / 1e6:.2f} MB)"
                  + (f", CUDA-core f32 bound {f32_bound:.4f} ms (at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s)" if tf32
                     else "") + f"; two runs give the same bits {card}", flush=True)
            key = instantiation(name, dtype, f"head_dim {dh}")
            rows[key] = {
                "name": key, "route": "cuda",
                "source": f"dial_rag_tpu_torch/csrc/{'flash_attention_long_bwd.cu' if tf32 else 'attention_bwd_tc.cuh'}",
                "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                "library_bwd_ms": library_bwd_ms,
            }
            if tf32:
                status = REDESIGNED if name == "attention_bwd_q_blocked" else REDESIGNED_KV_BLOCKED
                rows[key].update(status=status, bound_f32_ms=f32_bound)
            else:
                rows[key].update(status=REDESIGNED_TC_BACKWARD if name == "attention_bwd_q_blocked"
                                 else REDESIGNED_TC_KV_BLOCKED)
            del q, k, v, do, o, lse, dq, dk, dv
            torch.cuda.empty_cache()
    return rows


def long_training_pairs(tokenizer, cycles: int) -> list[tuple[str, str]]:
    """The long-context training stream: batch g holds the (question,
    passage) pairs 4 g .. 4 g + 3 of the Alps questions, each passage its
    question's fact followed by a long text of LONG_TRAIN_TARGETS[g][i]
    tokens; the batches in turn, ``cycles`` times."""
    facts, questions = alps_questions()
    flat = [t for batch in LONG_TRAIN_TARGETS for t in batch]
    texts = long_texts(tokenizer, flat)
    pairs = [(questions[i], f"{facts[i]} {texts[i]}") for i in range(len(flat))]
    return pairs * cycles


def bf16_short_gradient_phase(torch, card, dev, config, params, batch, temperature: float, what: str) -> dict:
    """One bf16 ``contrastive_loss`` backward of ``batch`` (a training
    batch of the main path, S <= 128) through "pallas" (on the card: the
    layout-native kernel 4 forward, the bf16 tensor-core forward, and
    kernel 8's backward, both in bf16), the "pallas_plain" route in bf16
    (their plain versions) and the "pallas" route in f32 (the split-TF32
    kernels), the f32 gradient g32. Gates: kernel 4's counter (in bf16
    ``attention_tc``) and kernel 8's read the layers x 2 encodes and no
    blocked backward runs; the bf16 kernel route's distance to g32, 1 -
    cos, is at most BF16_NOISE_RATIO times the bf16 plain route's. Prints
    the losses, the cosine of the kernel route to the plain one (beside
    GRAD_COS, a reading) and a device profile of one "pallas" backward
    with kernel 8's share. Returns the "pallas" run's counters."""
    from dial_rag_tpu_torch.ops import flash_attention as fa
    from dial_rag_tpu_torch.training.contrastive import contrastive_loss
    from dial_rag_tpu_torch.training.loop import trainable_params
    from dial_rag_tpu_torch.weights import param_leaves

    s = batch["p_ids"].shape[1]
    dh = config.hidden_size // config.num_heads
    limit = fa.single_tile_max_s("bwd", dh, dtype=torch.bfloat16)
    if max(s, batch["q_ids"].shape[1]) > limit or not fa.supports_fused_qkv(s):
        raise RuntimeError(f"the bf16 short-context batch at S = {s} is past kernel 8's bf16 limit {limit}")
    init = {"embeddings": params["embeddings"], "layers": params["layers"]}

    def loss_of(impl, dtype=torch.bfloat16):
        p = trainable_params(init, dev)
        loss = contrastive_loss(p, batch, num_heads=config.num_heads, temperature=temperature,
                                compute_dtype=dtype, attention_impl=impl)
        return loss, p

    def grads_of(impl, dtype=torch.bfloat16):
        loss, p = loss_of(impl, dtype)
        loss.backward()
        return loss.item(), [t.grad for t in param_leaves(p)]

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fa.reset_launches()
    loss_k, grads_k = grads_of("pallas")
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    loss_p, grads_p = grads_of("pallas_plain")
    loss_f, grads_f = grads_of("pallas", torch.float32)
    if not all(torch.isfinite(g).all() for g in grads_k):
        raise RuntimeError(f"a bf16 short-context gradient through the kernels ({what}) is not finite")
    kept = [i for i, r in enumerate(grads_p) if r.abs().max() > 0]

    def whole(grads, ref):
        return cos(torch.cat([grads[i].flatten() for i in kept]), torch.cat([ref[i].flatten() for i in kept]))

    plain_cos = whole(grads_k, grads_p)
    dist_k, dist_p = 1 - whole(grads_k, grads_f), 1 - whole(grads_p, grads_f)
    per_min = min(cos(grads_k[i], grads_p[i]) for i in kept)
    expected = {"attention_tc": config.num_layers * 2, "flash_attention_bwd": config.num_layers * 2}
    print(f"bf16 short-context gradient ({what}, B={batch['p_ids'].shape[0]}, S={s}): losses \"pallas\" "
          f"{loss_k:.8f}, \"pallas_plain\" {loss_p:.8f}, f32 {loss_f:.8f}; distance 1 - cos to the f32 gradient: "
          f"kernels {dist_k:.6g}, plain {dist_p:.6g} (ratio {dist_k / dist_p:.4f}, limit {BF16_NOISE_RATIO}); cosine "
          f"of kernels to plain whole {plain_cos:.8f} (GRAD_COS {GRAD_COS}: a reading), per tensor min "
          f"{per_min:.8f} over {len(kept)} tensors; launches { {n: c for n, c in launches.items() if c} }, expected "
          f"{expected}; three gradients in {time.perf_counter() - t0:.2f} s {card}", flush=True)
    del grads_p, grads_k, grads_f
    if {n: c for n, c in launches.items() if c} != expected:
        raise RuntimeError(f"the bf16 short-context gradient ({what}) did not run kernels 4 and 8 alone: {launches}")
    if not dist_k <= BF16_NOISE_RATIO * dist_p:
        raise RuntimeError(f"bf16 short-context gradients through the kernels ({what}) are farther from the f32 "
                           f"gradient than the plain route's: 1 - cos {dist_k} against {dist_p}")
    loss, p = loss_of("pallas")
    device_profile(torch, loss.backward, f"one bf16 short-context backward ({what}, S={s}, \"pallas\")", card,
                   top=6, share_of="single_tile_bwd_tc")
    del loss, p
    return launches


def bf16_long_gradient_phase(torch, card, dev, config, params, tokenizer, cfg, stream, what: str) -> dict:
    """One bf16 ``contrastive_loss`` backward on the long-context training's
    S = 8192 batch (``stream``'s batch at LONG_TRAIN_SEQS[-1]) through
    "auto" (on the card: kernel 7 forward, kernels 10 and 11 backward, all
    in bf16), the "pallas_plain" route in bf16 (their plain versions) and
    the "pallas" route in f32 (the split-TF32 kernels, held to f32 gates),
    the f32 gradient g32. Gates: the counters of the three bf16 kernels
    read the layers x 2 encodes, and the bf16 kernel route's distance to
    g32, 1 - cos, is at most BF16_NOISE_RATIO times the bf16 plain route's.
    Prints the losses, the cosine of the kernel route to the plain one
    (whole, beside GRAD_COS, and per tensor; tensors the plain route
    leaves all zero skipped) and a device profile of one "auto" backward.
    Returns the "auto" run's counters. No "xla" witness: at S = 8192 it
    would hold [B, h, S, S] f32 scores in every layer."""
    from dial_rag_tpu_torch.ops import flash_attention as fa
    from dial_rag_tpu_torch.training.contrastive import contrastive_loss
    from dial_rag_tpu_torch.training.loop import pairs_to_batches, trainable_params
    from dial_rag_tpu_torch.weights import param_leaves

    s = LONG_TRAIN_SEQS[-1]
    batch = next(b for b in pairs_to_batches(tokenizer, stream, cfg) if b["p_ids"].shape[1] == s)
    if batch["q_ids"].shape[1] != s or fa.attention_route(s) != "kv_blocked":
        raise RuntimeError(f"the bf16 long-context batch at S = {batch['q_ids'].shape[1]} / {s} takes no "
                           f"KV-blocked kernel")

    def loss_of(impl, dtype=torch.bfloat16):
        p = trainable_params(params, dev)
        loss = contrastive_loss(p, batch, num_heads=config.num_heads, temperature=cfg.temperature,
                                compute_dtype=dtype, attention_impl=impl)
        return loss, p

    def grads_of(impl, dtype=torch.bfloat16):
        loss, p = loss_of(impl, dtype)
        loss.backward()
        return loss.item(), [t.grad for t in param_leaves(p)]

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()

    fa.reset_launches()
    loss_k, grads_k = grads_of("auto")
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    loss_p, grads_p = grads_of("pallas_plain")
    loss_f, grads_f = grads_of("pallas", torch.float32)
    if not all(torch.isfinite(g).all() for g in grads_k):
        raise RuntimeError(f"a bf16 long-context gradient through the kernels ({what}) is not finite")
    names = leaf_names(params)
    kept = [i for i, r in enumerate(grads_p) if r.abs().max() > 0]

    def whole(grads, ref):
        return cos(torch.cat([grads[i].flatten() for i in kept]), torch.cat([ref[i].flatten() for i in kept]))

    plain_cos = whole(grads_k, grads_p)
    dist_k, dist_p = 1 - whole(grads_k, grads_f), 1 - whole(grads_p, grads_f)
    per = {names[i]: cos(grads_k[i], grads_p[i]) for i in kept}
    expected = {name: config.num_layers * 2
                for name in ("attention_kv_blocked_fwd", "bwd_dq_kv_blocked", "bwd_dkv_kv_blocked")}
    print(f"bf16 long-context gradient ({what}, B={batch['p_ids'].shape[0]}, S={s}, passage lengths "
          f"{batch['p_mask'].sum(1).tolist()}): losses \"auto\" {loss_k:.8f}, \"pallas_plain\" {loss_p:.8f}, f32 "
          f"{loss_f:.8f}; distance 1 - cos to the f32 gradient: kernels {dist_k:.6g}, plain {dist_p:.6g} (ratio "
          f"{dist_k / dist_p:.4f}, limit {BF16_NOISE_RATIO}); cosine of kernels to plain whole {plain_cos:.8f} "
          f"(GRAD_COS {GRAD_COS}: a reading), per tensor min {min(per.values()):.8f} over {len(per)} tensors; "
          f"launches { {n: c for n, c in launches.items() if c} }, expected {expected} {card}", flush=True)
    print("  per tensor, kernels to plain: " + ", ".join(f"{n} {c:.6f}" for n, c in per.items()), flush=True)
    del grads_p, grads_k, grads_f
    if any(launches[name] != n for name, n in expected.items()):
        raise RuntimeError(f"the bf16 long-context gradient ({what}) bypassed the KV-blocked kernels")
    if not dist_k <= BF16_NOISE_RATIO * dist_p:
        raise RuntimeError(f"bf16 long-context gradients through the kernels ({what}) are farther from the f32 "
                           f"gradient than the plain route's: 1 - cos {dist_k} against {dist_p}")
    loss, p = loss_of("auto")
    device_profile(torch, loss.backward, f"one bf16 long-context backward ({what}, B={batch['p_ids'].shape[0]}, "
                   f"S={s}, \"auto\")", card)
    del loss, p
    torch.cuda.empty_cache()
    return launches


def long_training_phase(torch, card, dev, config, params, tokenizer, cfg, stream, cycles: int, what: str) -> dict:
    """Contrastive training of a seeded long-context encoder (``what``
    names its widths) in f32 with ``train()`` on ``stream`` (the same few
    batches repeated ``cycles`` times): each distinct batch's loss and
    gradients through the kernels against the "pallas_plain" route, one
    profiled step per S, then the run; returns the attention counters of
    the run."""
    import numpy as np

    from dial_rag_tpu_torch.ops import flash_attention as fa
    from dial_rag_tpu_torch.training.contrastive import contrastive_loss, create_train_state, make_train_step
    from dial_rag_tpu_torch.training.loop import make_optimizer, pairs_to_batches, train, trainable_params
    from dial_rag_tpu_torch.weights import param_leaves

    batches = list(pairs_to_batches(tokenizer, stream, cfg))
    n_distinct = len(stream) // cfg.batch_size // cycles
    distinct = batches[:n_distinct]
    seqs = [b["p_ids"].shape[1] for b in distinct]
    routes = [fa.attention_route(s) for s in seqs]
    print(f"long-context training ({what}): {config.num_layers} layers, H={config.hidden_size}, "
          f"{config.max_position_embeddings} positions, seeded weights, f32; {len(batches)} steps of "
          f"{cfg.batch_size} pairs: {n_distinct} batches at S = {seqs} ({routes}; the questions padded to the "
          f"passages' S), each seen {cycles} times; passage lengths "
          f"{[b['p_mask'].sum(1).tolist() for b in distinct]}; lr {cfg.learning_rate}, warmup "
          f"{cfg.warmup_steps}", flush=True)
    if seqs != [b["q_ids"].shape[1] for b in distinct] or "single_tile" in routes:
        raise RuntimeError(f"long-context batches at S = {seqs}: each must take a blocked kernel")

    # each distinct batch through the kernels and through the plain route
    for s, batch in zip(seqs, distinct):
        def loss_and_grads(impl):
            p = trainable_params(params, dev)
            loss = contrastive_loss(p, batch, num_heads=config.num_heads, temperature=cfg.temperature,
                                    attention_impl=impl)
            loss.backward()
            return loss.item(), [t.grad for t in param_leaves(p)]

        loss_k, grads_k = loss_and_grads("pallas")
        loss_p, grads_p = loss_and_grads("pallas_plain")
        rel = abs(loss_k - loss_p) / abs(loss_p)
        cos = [torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()
               for a, b in zip(grads_k, grads_p) if b.abs().max() > 0]
        print(f"long-context batch at S={s}, kernels vs \"pallas_plain\": loss {loss_k:.8f} vs {loss_p:.8f} "
              f"(rel {rel:.3g}, limit 1e-5); gradient cosine min {min(cos):.8f} over {len(cos)} tensors (limit "
              f"{GRAD_COS})", flush=True)
        if not (rel <= 1e-5 and min(cos) > GRAD_COS and all(torch.isfinite(g).all() for g in grads_k)):
            raise RuntimeError(f"long-context training at S={s} through the kernels disagrees with the plain route")
        del grads_k, grads_p

    # where one step at each S spends the card's time (profiler, one step
    # each, after a step that sets up the optimizer's state)
    trainable = trainable_params(params, dev)
    state = create_train_state(trainable, *make_optimizer(cfg, trainable))
    step_fn = make_train_step(config, temperature=cfg.temperature)
    step_fn(state, distinct[0])
    for s, batch in zip(seqs, distinct):
        device_profile(torch, lambda: step_fn(state, batch),
                       f"one long-context train step ({what}, B={cfg.batch_size}, S={s})", card)
    del state, step_fn, trainable

    times, last = [], [0.0]

    def on_step(state, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**20
    fa.reset_launches()
    last[0] = time.perf_counter()
    _, losses = train(config, cfg, stream, tokenizer, init=params, device=dev, on_step=on_step)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    for i, (loss, dt) in enumerate(zip(losses, times)):
        s = seqs[i % n_distinct]
        print(f"  step {i + 1:2d}: S={s}, loss {loss:.6f}, {dt * 1e3:.2f} ms, {cfg.batch_size / dt:.2f} pairs/s")
    for g, s in enumerate(seqs):
        steady = sorted(times[g + n_distinct :: n_distinct])
        median = steady[len(steady) // 2]
        print(f"long-context training ({what}) at S={s}: median step {median * 1e3:.2f} ms, "
              f"{cfg.batch_size / median:.2f} pairs/s (appearances 2-{cycles}; host clock ending in synchronize) "
              f"{card}")
    print(f"long-context training ({what}): peak memory {peak:.1f} MiB, of which {held:.1f} MiB held before the run "
          f"{card}")
    steps = {r: routes.count(r) * cycles for r in ("q_blocked", "kv_blocked")}
    per = config.num_layers * 2  # layers x (question and passage encodes)
    expected = {
        "attention_q_blocked": per * steps["q_blocked"], "attention_bwd_q_blocked": per * steps["q_blocked"],
        "attention_kv_blocked_fwd": per * steps["kv_blocked"], "bwd_dq_kv_blocked": per * steps["kv_blocked"],
        "bwd_dkv_kv_blocked": per * steps["kv_blocked"],
    }
    print(f"long-context training ({what}) launches {launches}; expected {expected} ({config.num_layers} layers x 2 "
          f"encodes x the steps at each route)", flush=True)
    if not all(np.isfinite(losses)) or len(losses) != len(batches):
        raise RuntimeError(f"long-context training losses: {losses}")
    if any(launches[name] != n or n == 0 for name, n in expected.items()):
        raise RuntimeError("the long-context training path bypassed the blocked attention kernels")
    for g, s in enumerate(seqs):
        first, final = losses[g], losses[g + n_distinct * (cycles - 1)]
        print(f"long-context batch at S={s}: loss {first:.6f} at its first appearance, {final:.6f} at its last")
        if not final < first:
            raise RuntimeError(f"long-context training did not reduce the loss of the S={s} batch: {losses}")
    return launches


def f64_attention_block(x, mask, wqkv, bqkv, wout, bout, g, beta, heads):
    """Kernel 1's function evaluated in f64 (no cast to the compute type)."""
    import torch

    from dial_rag_tpu_torch.ops import fused_encoder as fe

    b, s, hid = x.shape
    dh = hid // heads
    x = x.double()
    qkv = (x @ wqkv.double() + bqkv.double()).view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4)
    scores = qkv[0] @ qkv[1].transpose(-1, -2) / math.sqrt(dh) + fe.mask_bias(mask).double()[:, None, None, :]
    ctx = (torch.softmax(scores, dim=-1) @ qkv[2]).transpose(1, 2).reshape(b, s, hid)
    return f64_layernorm(x + (ctx @ wout.double() + bout.double()), g, beta)


def f64_ffn_block(x, w1, b1, w2, b2, g, beta):
    """Kernel 2's function evaluated in f64."""
    import torch

    x = x.double()
    h = torch.nn.functional.gelu(x @ w1.double() + b1.double(), approximate="tanh")
    return f64_layernorm(x + (h @ w2.double() + b2.double()), g, beta)


def f64_layernorm(r, g, beta):
    mean = r.mean(dim=-1, keepdim=True)
    var = ((r - mean) ** 2).mean(dim=-1, keepdim=True)
    return (r - mean) / (var + 1e-12).sqrt() * g.double() + beta.double()


def block_rows(torch, card, layer, x, mask, heads: int) -> dict:
    """Kernels 1-3 in x's dtype at x's width (kernel 2 on the plain
    attention block's output) against their plain versions on one layer's
    weights (``layer``: matrices in x's dtype, vectors f32) at x's shape,
    each timed (CUDA events) beside its bound, the plain version and a
    PyTorch composition of the same block (cuBLAS products, SDPA with a
    boolean mask, ``layer_norm``): a yardstick used nowhere in the port.
    Kernel 3 must equal kernels 1 then 2 bit for bit. In f32 (products in
    split TF32: bound at the 3xTF32 rate, the CUDA-core f32 bound beside
    it) each block's largest distance from the block evaluated in f64 may
    be at most F64_RATIO times the plain version's. Kernel 1 in bf16, and
    kernels 1 and 2 in f32, are profiled by stage (their launches)."""
    from dial_rag_tpu_torch.ops import fused_encoder as fe

    dtype = x.dtype
    b, s, hid = x.shape
    inter = layer["ffn_in"]["kernel"].shape[1]
    tol, per_row = block_tolerance(dtype, hid)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_3XTF32_FLOPS
    attn_args = (
        x, mask, layer["qkv"]["kernel"], layer["qkv"]["bias"], layer["attn_out"]["kernel"],
        layer["attn_out"]["bias"], layer["attn_ln"]["scale"], layer["attn_ln"]["bias"], heads,
    )
    a = fe.fused_attention_block_plain(*attn_args)
    ffn_args = (
        a, layer["ffn_in"]["kernel"], layer["ffn_in"]["bias"], layer["ffn_out"]["kernel"],
        layer["ffn_out"]["bias"], layer["ffn_ln"]["scale"], layer["ffn_ln"]["bias"],
    )
    m, e, f32 = b * s, x.element_size(), 4
    vec_bytes = (3 * hid + 3 * hid) * f32  # bqkv + bout, gamma, beta
    attn_flops = 2 * m * hid * 3 * hid + 2 * 2 * b * heads * s * s * (hid // heads) + 2 * m * hid * hid
    attn_bytes = 2 * m * hid * e + m * f32 + (hid * 3 * hid + hid * hid) * e + vec_bytes
    ffn_flops = 2 * 2 * m * hid * inter
    ffn_bytes = 2 * m * hid * e + 2 * hid * inter * e + (inter + 3 * hid) * f32

    lib_bias = {k: layer[k]["bias"].to(dtype) for k in ("qkv", "attn_out", "ffn_in", "ffn_out")}
    keep = mask.bool()[:, None, None, :]

    def attn_library():
        xx = attn_args[0].view(m, hid)
        qkv = torch.addmm(lib_bias["qkv"], xx, layer["qkv"]["kernel"])
        q, k, v = qkv.view(b, s, 3, heads, hid // heads).permute(2, 0, 3, 1, 4)
        ctx = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        o = torch.addmm(lib_bias["attn_out"], ctx.transpose(1, 2).reshape(m, hid), layer["attn_out"]["kernel"])
        return torch.nn.functional.layer_norm(
            (xx + o).float(), (hid,), layer["attn_ln"]["scale"], layer["attn_ln"]["bias"], 1e-12
        ).to(dtype)

    def ffn_library(a=None):
        xx = (ffn_args[0] if a is None else a).view(m, hid)
        h = torch.addmm(lib_bias["ffn_in"], xx, layer["ffn_in"]["kernel"])
        h = torch.nn.functional.gelu(h, approximate="tanh")
        y = torch.addmm(lib_bias["ffn_out"], h, layer["ffn_out"]["kernel"])
        return torch.nn.functional.layer_norm(
            (xx + y).float(), (hid,), layer["ffn_ln"]["scale"], layer["ffn_ln"]["bias"], 1e-12
        ).to(dtype)

    layer_args = (x, mask, tuple(attn_args[2:8]) + tuple(ffn_args[1:]), heads)
    # x in, out, the mask, every weight once (a counted on chip, as the TPU
    # kernel keeps it)
    layer_bytes = attn_bytes + ffn_bytes - 2 * m * hid * e

    bf16 = dtype == torch.bfloat16
    rows = {}
    for name, kernel, plain, args, library, exact, flops, nbytes, source, replaces in (
        ("fused_attention_block", fe.fused_attention_block, fe.fused_attention_block_plain, attn_args,
         attn_library, lambda: f64_attention_block(*attn_args), attn_flops, attn_bytes,
         f"dial_rag_tpu_torch/csrc/{'encoder_tc.cuh' if bf16 else 'encoder_tf32.cuh'}",
         "dial_rag_tpu/ops/fused_encoder.py:177"),
        ("fused_ffn_block", fe.fused_ffn_block, fe.fused_ffn_block_plain, ffn_args,
         ffn_library, lambda: f64_ffn_block(*ffn_args), ffn_flops, ffn_bytes,
         f"dial_rag_tpu_torch/csrc/{'ffn_tc' if bf16 else 'fused_ffn'}.cu",
         "dial_rag_tpu/ops/fused_encoder.py:76"),
        ("fused_layer_block", fe.fused_layer_block, fe.fused_layer_block_plain, layer_args,
         lambda: ffn_library(attn_library()), lambda: f64_ffn_block(f64_attention_block(*attn_args), *ffn_args[1:]),
         attn_flops + ffn_flops, layer_bytes,
         f"dial_rag_tpu_torch/csrc/{'encoder_tc.cuh' if bf16 else 'encoder_tf32.cuh'}",
         "dial_rag_tpu/ops/fused_encoder.py:365"),
    ):
        out = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all() or out.dtype != dtype:
            raise RuntimeError(f"{name}: kernel output is not finite {dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        lib_err = (library().float().view_as(ref) - ref.float()).abs().max().item()
        key = instantiation(name, dtype, f"H {hid}")
        if not bf16:
            with torch.no_grad():
                want = exact()
            dist, plain_dist = ((t.double() - want).abs().max().item() for t in (out, ref))
            del want
            print(f"{key} vs the block in f64: max abs {dist:.4g}, the plain version's {plain_dist:.4g}: "
                  f"{dist / plain_dist:.3f} of it (limit {F64_RATIO})", flush=True)
            if not dist <= F64_RATIO * plain_dist:
                raise RuntimeError(f"{key}: {dist} from the f64 block, over {F64_RATIO} x the plain version's "
                                   f"{plain_dist}")
        ms = cuda_ms(torch, lambda: kernel(*args), iters=20)
        plain_ms = cuda_ms(torch, lambda: plain(*args), iters=5)
        library_ms = cuda_ms(torch, library, iters=20)
        bound_ms, bound_by = bound(flops, nbytes, peak)
        f32_bound = None if bf16 else bound(flops, nbytes, PEAK_F32_FLOPS)
        print(f"{key}: max_abs_err {err:.6g} (tolerance {tolerance_text(tol, per_row)}"
              f": {over_limit(out, ref, tol, per_row):.3g} of it); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, composition {library_ms:.4f} ms (its err {lib_err:.3g}), "
              f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s"
              f"{'' if bf16 else ' 3xTF32'}, {nbytes / 1e6:.2f} MB)"
              + (f", CUDA-core f32 bound {f32_bound[0]:.4f} ms by {f32_bound[1]}" if f32_bound else "")
              + f", B={b} S={s} H={hid} {str(dtype)[6:]} {card}", flush=True)
        if not over_limit(out, ref, tol, per_row) <= 1:
            raise RuntimeError(f"{key}: kernel disagrees with its plain version by {err}")
        if name == "fused_layer_block":
            two = fe.fused_ffn_block(fe.fused_attention_block(*attn_args), *ffn_args[1:])
            print(f"{key} vs kernels 1 then 2: max abs diff {(out.float() - two.float()).abs().max().item():.3g} "
                  f"(bit-equal required)")
            if not torch.equal(out, two):
                raise RuntimeError(f"{key} differs from kernels 1 then 2")
        elif name == "fused_attention_block" or not bf16:
            device_profile(torch, lambda: kernel(*args), f"{key}'s stages at B={b} S={s}", card)
        rows[key] = {
            "name": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        }
        if f32_bound:
            rows[key].update(status=REDESIGNED_BLOCKS, bound_f32_ms=f32_bound[0])
    return rows


def auto_repair_phase(torch, dev, vocab_size: int) -> dict:
    """"auto" on the card where the port once raised, on a seeded 1-layer
    encoder at bge-small and bge-base widths, forward and backward (to
    the word embeddings): (f32, tanh GELU, S = 64) through kernels 1-2,
    and the same through "fused_layer" (kernel 3); (bf16, exact, S = 64)
    through kernel 4 (the tensor-core forward) and its backward (kernel
    8); bf16 and f32 at S = 520 through kernel 5 (in bf16 the tensor-core
    forward) and kernel 8's route past its S = 128 (kernel 9's code);
    bf16 and f32 at S = PAST_LIMIT_S, past the
    single-tile kernels' shared memory, through the tensor-core forward
    (bf16) or kernel 6's code (f32) and kernel 9's code. Each hidden state
    must match the plain route (f32 F32_FWD_TOL, bf16 TOLERANCE; at S =
    PAST_LIMIT_S ``block_tolerance``), a bf16 one be no farther from it
    than the "xla" route's plus one ulp, each gradient's cosine to it
    exceed GRAD_COS, each kernel launch once.
    Returns the launches by kernels JSON row."""
    from dial_rag_tpu_torch.models.bert import BertConfig, bert_forward, init_params, prepare_params
    from dial_rag_tpu_torch.ops import flash_attention as fa
    from dial_rag_tpu_torch.ops import fused_encoder as fe

    f32, bf16 = torch.float32, torch.bfloat16
    # (dtype, GELU, S, route, plain route, {launch counter: kernels JSON row})
    cases = [
        (f32, "tanh", 64, "auto", "fused_plain",
         {"fused_attention_block": "fused_attention_block", "fused_ffn_block": "fused_ffn_block"}),
        (f32, "tanh", 64, "fused_layer", "fused_layer_plain", {"fused_layer_block": "fused_layer_block"}),
        (bf16, "exact", 64, "auto", "pallas_plain",
         {"attention_tc": "qkv_native_attention", "flash_attention_bwd": "flash_attention_bwd"}),
        (bf16, "exact", 520, "auto", "pallas_plain",
         {"attention_tc": "flash_attention_fwd", "attention_bwd_q_blocked": "attention_bwd_q_blocked"}),
        (f32, "exact", 520, "auto", "pallas_plain",
         {"flash_attention_fwd": "flash_attention_fwd", "attention_bwd_q_blocked": "attention_bwd_q_blocked"}),
        (bf16, "exact", PAST_LIMIT_S, "auto", "pallas_plain",
         {"attention_tc": "flash_attention_fwd", "attention_bwd_q_blocked": "attention_bwd_q_blocked"}),
        (f32, "exact", PAST_LIMIT_S, "auto", "pallas_plain",
         {"attention_q_blocked": "attention_q_blocked", "attention_bwd_q_blocked": "attention_bwd_q_blocked"}),
    ]
    launched = {}
    for hid in (384, 768):
        config = BertConfig(vocab_size=vocab_size, hidden_size=hid, num_layers=1, num_heads=12,
                            intermediate_size=4 * hid, max_position_embeddings=2048)
        raw = init_params(config, torch.Generator().manual_seed(0))
        for dtype, gelu, s, impl, plain, kernels in cases:
            params = prepare_params(raw, dev, dtype)
            g = torch.Generator().manual_seed(s)
            ids = torch.randint(5, vocab_size, (2, s), generator=g).to(dev)
            mask = torch.ones(2, s, dtype=torch.int32)
            mask[1, s // 3 :] = 0
            mask = mask.to(dev)
            word = params["embeddings"]["word"].requires_grad_(True)
            # a random cotangent: the sum of a LayerNorm output has no gradient
            cot = torch.randn(2, s, hid, generator=g).to(dev)

            def run(route):
                word.grad = None
                out = bert_forward(params, ids, mask, num_heads=12, compute_dtype=dtype, gelu=gelu,
                                   attention_impl=route)
                (out.float() * cot).sum().backward()
                torch.cuda.synchronize()
                return out.detach(), word.grad.clone()

            fe.reset_launches()
            fa.reset_launches()
            out, grad = run(impl)
            counts = {**fe.LAUNCHES, **fa.LAUNCHES}
            ref, ref_grad = run(plain)
            # the S <= 520 cases are held to a plain tolerance; the S =
            # PAST_LIMIT_S cases (3400 tokens) to the gate the
            # repository holds bf16 LayerNorm outputs at H 768 to
            # (block_tolerance). Every bf16 case is also held to the "xla"
            # route, another sound bf16 route: the kernel route may be no
            # farther from the plain route than it, plus one bf16 ulp of the
            # largest plain value
            tol, per_row = (block_tolerance(dtype, hid) if s == PAST_LIMIT_S
                            else (F32_FWD_TOL if dtype == f32 else TOLERANCE, False))
            err = (out.float() - ref.float()).abs().max().item()
            within = over_limit(out, ref, tol, per_row)
            cos = torch.nn.functional.cosine_similarity(grad.flatten().double(), ref_grad.flatten().double(), dim=0)
            ran = {k: n for k, n in counts.items() if n}
            xla, witness = "", True
            if dtype == bf16 or s == PAST_LIMIT_S:
                xla_out = run("xla")[0]
                xla_err = (xla_out.float() - ref.float()).abs().max().item()
                xla = f", the \"xla\" route's {xla_err:.3g} ({over_limit(xla_out, ref, tol, per_row):.3g} of it)"
                if dtype == bf16:
                    ulp = bf16_ulp(ref)
                    witness = err <= xla_err + ulp
                    xla += f"; limit the \"xla\" route's + one ulp {xla_err + ulp:.3g}"
            print(f"\"{impl}\" at H={hid}, {str(dtype)[6:]}, {gelu} GELU, S={s}: launches {ran}; hidden states vs "
                  f"\"{plain}\" max abs err {err:.3g} (tolerance {tolerance_text(tol, per_row)}: {within:.3g} of it"
                  f"{xla}); gradient cosine {cos.item():.8f} (limit {GRAD_COS})", flush=True)
            if not (ran == dict.fromkeys(kernels, 1) and within <= 1 and witness and cos.item() > GRAD_COS
                    and torch.isfinite(out.float()).all()):
                raise RuntimeError(f"\"{impl}\" at H={hid} {dtype} {gelu} S={s} did not run its kernels "
                                   f"({ran}, expected {list(kernels)} once each) or disagrees with the plain route")
            for k, row in kernels.items():
                width = f"H {hid}" if k.startswith("fused_") else f"head_dim {hid // 12}"
                key = instantiation(row, dtype, width)
                launched[key] = launched.get(key, 0) + counts[k]
    return launched


def f32_encode_phase(torch, card, dev, encoders, tokenizer, instruction: str, docs, queries) -> dict:
    """One encode batch of the main path's chunks (``docs``: B=128, S=256)
    and its queries in f32 with tanh GELU through "auto" (resolving to
    "fused": kernels 1 and 2), "fused_layer" (kernel 3) and "fused_plain"
    (the plain route, the reference), for each of ``encoders`` (name,
    f32 params, BertConfig, pooling). Each kernel must launch once a layer
    and encode; each last hidden state lie within F32_ENCODE_TOL of the
    plain route's, "fused_layer" equal to "auto" bit for bit; the pooled,
    L2-normalised embeddings' cosine to the plain route's exceed
    F32_ENCODE_COS; the queries' top-1 among the batch's chunks equal the
    plain route's. Prints each route's device time per encode and its
    kernels' shares. Returns the launches by kernels JSON row."""
    from dial_rag_tpu_torch.models.bert import bert_forward, pool
    from dial_rag_tpu_torch.models.bert import resolve_attention_impl
    from dial_rag_tpu_torch.ops import fused_encoder as fe

    batches = [tuple(torch.from_numpy(t).to(dev) for t in tokenizer.encode_batch(texts))
               for texts in (docs, [instruction + q for q in queries])]
    routes = {"fused_plain": {}, "auto": {"fused_attention_block": 1, "fused_ffn_block": 1},
              "fused_layer": {"fused_layer_block": 1}}
    launched = collections.Counter()
    for what, params, cfg, pooling in encoders:
        hid, layers = cfg.hidden_size, cfg.num_layers

        def encode(route, ids, mask):
            with torch.no_grad():
                return bert_forward(params, ids.long(), mask, num_heads=cfg.num_heads, compute_dtype=torch.float32,
                                    gelu="tanh", attention_impl=route)

        if resolve_attention_impl("auto", batches[0][0], "tanh") != "fused":
            raise RuntimeError("\"auto\" in f32 with tanh GELU does not resolve to \"fused\"")
        out = {}
        for route, per_layer in routes.items():
            fe.reset_launches()
            hidden = [encode(route, ids, mask) for ids, mask in batches]
            torch.cuda.synchronize()
            counts = {k: n for k, n in fe.LAUNCHES.items() if n}
            want = {k: n * layers * len(batches) for k, n in per_layer.items()}
            if counts != want:
                raise RuntimeError(f"f32 encode ({what}, \"{route}\"): launches {counts}, expected {want}")
            for k, n in counts.items():
                launched[instantiation(k, torch.float32, f"H {hid}")] += n
            emb = [pool(h, ids, mask, pooling, params.get("pooling_idf")) for h, (ids, mask) in zip(hidden, batches)]
            if not all(torch.isfinite(t).all() for t in hidden):
                raise RuntimeError(f"f32 encode ({what}, \"{route}\"): hidden states are not finite")
            ms = device_profile(torch, lambda: encode(route, *batches[0]),
                                f"one f32 tanh-GELU encode ({what}, \"{route}\", B={batches[0][0].shape[0]}, "
                                f"S={batches[0][0].shape[1]}, {layers} layers)", card)
            out[route] = (hidden, emb, ms)
            print(f"f32 encode ({what}, \"{route}\"): launches {counts}; device time {ms:.3f} ms an encode "
                  f"{card}", flush=True)
        (ref_hidden, ref_emb, ref_ms) = out["fused_plain"]
        ref_doc, ref_q = (t.cpu().numpy() for t in ref_emb)
        for route in ("auto", "fused_layer"):
            hidden, emb, ms = out[route]
            err = max((h - r).abs().max().item() for h, r in zip(hidden, ref_hidden))
            cos = min((e * r).sum(dim=1).min().item() for e, r in zip(emb, ref_emb))
            doc, q = (t.cpu().numpy() for t in emb)
            ties = top1_agree(nearest(q, doc), nearest(ref_q, ref_doc), doc, q, f"f32 encode ({what}, {route})")
            print(f"f32 encode ({what}, \"{route}\") vs \"fused_plain\": hidden states max abs err {err:.4g} "
                  f"(limit {F32_ENCODE_TOL}); embeddings cosine min {cos:.9f} (limit {F32_ENCODE_COS}); top-1 "
                  f"of {len(queries)} queries equal ({ties} near-ties); device time {ms:.3f} ms, plain route "
                  f"{ref_ms:.3f} ms", flush=True)
            if not (err <= F32_ENCODE_TOL and cos > F32_ENCODE_COS):
                raise RuntimeError(f"f32 encode ({what}, \"{route}\") disagrees with the plain route")
        same = all(torch.equal(a, b) for a, b in zip(out["fused_layer"][0], out["auto"][0]))
        print(f"f32 encode ({what}): \"fused_layer\" = \"auto\" bit for bit: {same}", flush=True)
        if not same:
            raise RuntimeError(f"f32 encode ({what}): kernel 3 differs from kernels 1 then 2")
        del out
        torch.cuda.empty_cache()
    return launched


def base_serve_phase(torch, card, base, texts, queries, tokens: int) -> dict:
    """The seeded bge-base-width encoder (``base``, bf16, "auto") indexes
    ``texts`` into a SemanticRetriever and answers ``queries``: kernels 1
    and 2 must launch 12 x the encode batches, the embeddings be unit norm
    and within BASE_PLAIN_COS cosine of the "fused_plain" route's, and
    top-1 of every query equal that route's (near-ties below TIE_GAP
    allowed). Prints the build, query and memory numbers and
    one encode batch's device time by kernel; returns the launches."""
    import numpy as np

    from dial_rag_tpu_torch.documents.model import build_chunks_list
    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.models.bert import BertEncoder
    from dial_rag_tpu_torch.ops import fused_encoder as fe
    from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever

    cfg = base.encoder.config
    print(f"bge-base serve: {cfg.num_layers} layers, H={cfg.hidden_size}, {cfg.num_heads} heads of "
          f"{cfg.hidden_size // cfg.num_heads}, FFN {cfg.intermediate_size}, {cfg.max_position_embeddings} positions, "
          f"seeded weights, bf16, {base.encoder.pooling} pooling; {len(texts)} chunks, {len(queries)} queries",
          flush=True)
    chunks = build_chunks_list([(t, {}) for t in texts])
    base.embed_documents(texts[: base.batch_size])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fe.reset_launches()
    t0 = time.perf_counter()
    record = type("Record", (), {"embeddings_index": asyncio.run(SemanticRetriever.build_index(base, chunks))})()
    retriever = SemanticRetriever.from_doc_records(base, [record], k=1)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    retriever.retrieve_batch(queries)  # warm-up at the query shapes
    t0 = time.perf_counter()
    hits = retriever.retrieve_batch(queries)
    t_batch = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(fe.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    n_batches = -(-len(texts) // base.batch_size) + 2  # the queries in one encode, twice
    print(f"bge-base index build: {len(texts)} chunks, {tokens} tokens in {t_build:.3f} s: "
          f"{len(texts) / t_build:.1f} chunks/s, {tokens / t_build:.0f} tokens/s; {len(queries)} queries in one "
          f"batch {t_batch * 1e3:.2f} ms; peak memory {peak:.1f} MiB; launches {launches}; encode batches "
          f"{n_batches} {card}", flush=True)
    for name in ("fused_attention_block", "fused_ffn_block"):
        if launches[name] != cfg.num_layers * n_batches:
            raise RuntimeError(f"bge-base serve: {name} launched {launches[name]} times, expected "
                               f"{cfg.num_layers * n_batches}")
    doc_emb = np.concatenate(record.embeddings_index)
    norms = np.linalg.norm(doc_emb, axis=1)
    if doc_emb.shape != (len(texts), cfg.hidden_size) or not np.allclose(norms, 1.0, atol=1e-3):
        raise RuntimeError(f"bad bge-base embeddings: shape {doc_emb.shape}, norms {norms.min()}..{norms.max()}")

    plain = BgeEmbedder(tokenizer=base.tokenizer,
                        encoder=BertEncoder(cfg, compute_dtype=torch.bfloat16, attention_impl="fused_plain",
                                            pooling=base.encoder.pooling),
                        params=base.params, device=base.device, query_instruction=base.query_instruction,
                        model_id=base.model_id)
    d_plain, q_plain = plain.embed_documents(texts), plain.embed_queries(queries)
    q_kernel = base.embed_queries(queries)
    cos, q_cos = (doc_emb * d_plain).sum(axis=1), (q_kernel * q_plain).sum(axis=1)
    print(f"bge-base, kernel route vs \"fused_plain\": documents max abs diff {np.abs(doc_emb - d_plain).max():.3g}, "
          f"cosine min {cos.min():.8f}; queries max abs diff {np.abs(q_kernel - q_plain).max():.3g}, cosine min "
          f"{q_cos.min():.8f} (limit {BASE_PLAIN_COS})")
    if not (cos.min() > BASE_PLAIN_COS and q_cos.min() > BASE_PLAIN_COS):
        raise RuntimeError(f"bge-base serve: kernel route off the plain route, cosine min {cos.min()} (documents), "
                           f"{q_cos.min()} (queries)")
    ties = top1_agree([h[0].chunk_id for h in hits], nearest(q_plain, d_plain), doc_emb, q_kernel, "bge-base serve")
    print(f"bge-base top-1 of {len(queries)} queries: kernel route = plain route ({ties} near-ties below {TIE_GAP}, "
          f"{ties / len(queries):.1%} of the queries)")

    ids, mask = base.tokenizer.encode_batch(texts[-base.batch_size :])  # synthetic texts: S = 256
    ids = torch.from_numpy(ids).to(base.device, dtype=torch.long)
    mask = torch.from_numpy(mask).to(base.device)
    device_profile(torch, lambda: base.encoder.encode(base.params, ids, mask),
                   f"one bge-base encode batch (B={ids.shape[0]}, S={ids.shape[1]})", card)
    return launches


def base_training_phase(torch, card, dev, model, params, tokenizer, stream) -> dict:
    """The seeded bge-base-width encoder (``model``, f32 ``params``)
    trained by ``train()`` in f32 on ``stream`` (Alps (question, fact)
    pairs), BASE_TRAIN_STEPS steps of 32 pairs at S = 64. Each batch through the kernels (kernels 4 and 8 at
    head_dim 64) must match the "pallas_plain" route at the initial
    params (loss rel 1e-5, cosine > GRAD_COS per tensor); the losses must
    be finite and fall; the counters must read 12 layers x 2 encodes x the
    steps. Returns the attention counters of the run."""
    import numpy as np

    from dial_rag_tpu_torch.ops import flash_attention as fa
    from dial_rag_tpu_torch.training.contrastive import contrastive_loss
    from dial_rag_tpu_torch.training.loop import TrainConfig, pairs_to_batches, train, trainable_params
    from dial_rag_tpu_torch.weights import param_leaves

    cfg = TrainConfig(batch_size=32, seq_len=128, learning_rate=BASE_TRAIN_LR, warmup_steps=2,
                      total_steps=BASE_TRAIN_STEPS, checkpoint_every=BASE_TRAIN_STEPS)
    stream = stream[: cfg.batch_size * cfg.total_steps]
    init = {"embeddings": params["embeddings"], "layers": params["layers"]}
    batches = list(pairs_to_batches(tokenizer, stream, cfg))
    seqs = sorted({b["q_ids"].shape[1] for b in batches})
    print(f"bge-base training: f32, {len(batches)} steps of {cfg.batch_size} (question, fact) pairs at S = {seqs}, "
          f"lr {cfg.learning_rate}, warmup {cfg.warmup_steps}", flush=True)
    worst_rel, worst_cos = 0.0, 1.0
    for batch in batches:
        def loss_and_grads(impl):
            params = trainable_params(init, dev)
            loss = contrastive_loss(params, batch, num_heads=model.num_heads, temperature=cfg.temperature,
                                    attention_impl=impl)
            loss.backward()
            return loss.item(), [t.grad for t in param_leaves(params)]

        loss_k, grads_k = loss_and_grads("pallas")
        loss_p, grads_p = loss_and_grads("pallas_plain")
        rel = abs(loss_k - loss_p) / abs(loss_p)
        cos = min(torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()
                  for a, b in zip(grads_k, grads_p) if b.abs().max() > 0)
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        if not (rel <= 1e-5 and cos > GRAD_COS and all(torch.isfinite(g).all() for g in grads_k)):
            raise RuntimeError(f"bge-base training batch through the kernels disagrees with the plain route: "
                               f"loss rel {rel}, cosine {cos}")
        del grads_k, grads_p
    print(f"bge-base training, each of the {len(batches)} batches at the initial params, kernels vs "
          f"\"pallas_plain\": loss rel at most {worst_rel:.3g} (limit 1e-5), gradient cosine per tensor at least "
          f"{worst_cos:.8f} (limit {GRAD_COS})", flush=True)

    times, last = [], [0.0]

    def on_step(state, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    last[0] = time.perf_counter()
    _, losses = train(model, cfg, stream, tokenizer, init=init, device=dev, on_step=on_step)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    for i, (loss, dt) in enumerate(zip(losses, times), start=1):
        print(f"  step {i:2d}: loss {loss:.6f}, {dt * 1e3:.2f} ms, {cfg.batch_size / dt:.1f} pairs/s")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    expected = model.num_layers * 2 * cfg.total_steps
    print(f"bge-base training: median step {steady * 1e3:.2f} ms, {cfg.batch_size / steady:.1f} pairs/s (steps "
          f"2-{cfg.total_steps}, host clock ending in synchronize); peak memory {peak:.1f} MiB; launches "
          f"{launches}, expected {expected} forward and backward {card}", flush=True)
    if not all(np.isfinite(losses)) or len(losses) != cfg.total_steps:
        raise RuntimeError(f"bge-base training losses: {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise RuntimeError(f"bge-base training did not reduce the loss: {losses}")
    if launches["qkv_native_attention"] != expected or launches["flash_attention_bwd"] != expected:
        raise RuntimeError("the bge-base training path bypassed the attention kernels")
    return launches


def list_near_ties(card_lists, ref_lists, gap_ok, what) -> int:
    """Ranked id lists of the card equal to the reference's, apart from
    near-ties: at each position where they differ, ``gap_ok(query, card
    id, reference id)`` must hold. Returns the lists that differ."""
    ties = 0
    for qi, (got, ref) in enumerate(zip(card_lists, ref_lists)):
        got, ref = [int(i) for i in got], [int(i) for i in ref]
        if got == ref:
            continue
        if len(got) != len(ref):
            raise RuntimeError(f"{what}: query {qi} returned {len(got)} ids, the reference {len(ref)}")
        for x, y in zip(got, ref):
            if x != y and not gap_ok(qi, x, y):
                raise RuntimeError(f"{what}: query {qi} ranks {got}, the reference {ref}, apart by more than a near-tie")
        print(f"near-tie, {what} query {qi}: card {got} vs reference {ref}")
        ties += 1
    return ties


def bm25_gap_ok(scores):
    """Two items' reference scores within the BM25 tolerance of each other."""

    def ok(qi, x, y) -> bool:
        sx, sy = float(scores[qi][x]), float(scores[qi][y])
        return abs(sx - sy) <= BM25_ATOL + BM25_RTOL * max(abs(sx), abs(sy))

    return ok


def bm25_scores_within(card_scores, ref_scores, what) -> float:
    """Every card score within BM25_RTOL / BM25_ATOL of the reference's;
    returns the largest |difference|."""
    import numpy as np

    diff = np.abs(card_scores.astype(np.float64) - ref_scores)
    over = diff - (BM25_ATOL + BM25_RTOL * np.abs(ref_scores))
    if not np.isfinite(card_scores).all() or over.max() > 0:
        raise RuntimeError(f"{what}: scores off the reference by up to {diff.max():.3g} "
                           f"(rtol {BM25_RTOL}, atol {BM25_ATOL})")
    return float(diff.max())


def hybrid_retrieval_phase(torch, card, embedder, embeddings_index, chunks, queries) -> dict:
    """The main path's chunks and queries through BM25 (keyword
    preprocessing, the index build, batched and single queries) and the
    RRF ensemble of the semantic and BM25 arms, each held to the same port
    code on the CPU. Returns kernels 1-2's launches in the ensemble's run."""
    import asyncio

    import numpy as np

    from dial_rag_tpu_torch.documents.model import DocumentRecord, IndexSettings
    from dial_rag_tpu_torch.index.bm25 import Bm25Index
    from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
    from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
    from dial_rag_tpu_torch.ops import fused_encoder as fe
    from dial_rag_tpu_torch.retrieval import Bm25Retriever, EnsembleRetriever, SemanticRetriever
    from dial_rag_tpu_torch.retrieval.ensemble import weighted_reciprocal_rank
    from dial_rag_tpu_torch.text import keywords as kw

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kw.reset_paths()
    t0 = time.perf_counter()
    text_index = asyncio.run(Bm25Retriever.build_index(chunks))
    t_kw = time.perf_counter() - t0
    print(f"keyword preprocessing: {len(chunks)} texts in {t_kw:.3f} s; C++ core {kw.PATHS['native']} texts, "
          f"Python path {kw.PATHS['python']} (nltk imported: {kw.nltk_available()}; without it the Python "
          f"path splits words by regex and stems with porter_lite) {card}")
    record = DocumentRecord(format_version=None, index_settings=IndexSettings(), chunks=chunks,
                            text_index=text_index, embeddings_index=embeddings_index,
                            multimodal_embeddings_index=None, description_embeddings_index=None,
                            mime_type="text/plain", document_bytes=b"")
    t0 = time.perf_counter()
    bm25 = Bm25Retriever.from_doc_records([record], k=HYBRID_K)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    index = bm25._index
    if index.layout != "dense":
        raise RuntimeError(f"the main path's BM25 index took the {index.layout} layout, not the dense [N, V] one")
    print(f"BM25 build: {index.n_items} items, {len(index.vocab)} terms, layout dense "
          f"{tuple(index._weights.shape)} f32, {index.nbytes / 2**20:.1f} MiB, in {t_build:.3f} s {card}")

    bm25.retrieve_batch(queries)  # warm-up at the query shapes
    t0 = time.perf_counter()
    bm25_hits = bm25.retrieve_batch(queries)
    t_batch = time.perf_counter() - t0
    single_ms = []
    for q in queries[:5]:
        t0 = time.perf_counter()
        bm25.retrieve(q)
        single_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"BM25 query (keyword preprocessing included): {len(queries)} queries in one batch "
          f"{t_batch * 1e3:.2f} ms; single query median {sorted(single_ms)[2]:.2f} ms {card}")
    device_profile(torch, lambda: bm25.retrieve(queries[0]), "one single BM25 query", card, top=4)

    # gates: the same port code on the CPU, which the CPU tests hold to the JAX package
    toks = [kw.keywords_preprocess(q) for q in queries]
    cpu_index = Bm25Index.build(text_index, device="cpu")
    cpu_scores = cpu_index.get_scores_batch(toks)
    err = bm25_scores_within(index.get_scores_batch(toks), cpu_scores, "BM25 main path")
    cpu_bm25 = cpu_index.top_n_batch_with_scores(toks, HYBRID_K)
    ties = list_near_ties([[h.chunk_id for h in hits] for hits in bm25_hits], [idx for idx, _ in cpu_bm25],
                          bm25_gap_ok(cpu_scores), "BM25 main path top-7")
    print(f"BM25 scores of {len(queries)} queries, card vs CPU: max abs diff {err:.3g} (rtol {BM25_RTOL}, "
          f"atol {BM25_ATOL}); top-{HYBRID_K} equal apart from {ties} near-ties")

    semantic = SemanticRetriever.from_doc_records(embedder, [record], k=HYBRID_K)
    ensemble = EnsembleRetriever([semantic, bm25])
    asyncio.run(ensemble.aretrieve_batch(queries))  # warm-up
    torch.cuda.synchronize()
    fe.reset_launches()
    t0 = time.perf_counter()
    fused = asyncio.run(ensemble.aretrieve_batch(queries))
    t_ens = time.perf_counter() - t0
    ens_ms = []
    for q in queries[:5]:
        t0 = time.perf_counter()
        asyncio.run(ensemble.aretrieve(q))
        ens_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = {name: fe.LAUNCHES[name] for name in ("fused_attention_block", "fused_ffn_block")}
    n_batches = -(-len(queries) // embedder.batch_size) + 5
    arms_ms = []  # the two arms one after the other in this thread, for comparison
    for q in queries[:5]:
        t0 = time.perf_counter()
        semantic.retrieve(q)
        bm25.retrieve(q)
        arms_ms.append((time.perf_counter() - t0) * 1e3)
    layers = embedder.encoder.config.num_layers
    for name, n in launches.items():
        if n != layers * n_batches:
            raise RuntimeError(f"{name} launched {n} times in the ensemble's run, expected {layers * n_batches}")
    print(f"RRF ensemble (semantic k={HYBRID_K} + BM25 k={HYBRID_K}): {len(queries)} queries through "
          f"aretrieve_batch {t_ens * 1e3:.2f} ms; single aretrieve median {sorted(ens_ms)[2]:.2f} ms (the two "
          f"arms' retrieve one after the other in one thread {sorted(arms_ms)[2]:.2f} ms); launches {launches} "
          f"({layers} layers x {n_batches} encode batches) {card}")

    def keys(hits):
        return [h.key for h in hits]

    # the fused lists against the fusion of the CPU arms' lists, wherever each arm agrees
    q_emb = embedder.embed_queries(queries)
    doc_emb = np.concatenate(embeddings_index)
    card_sem = semantic.retrieve_batch(queries)
    cpu_sem = DenseIndex(RetrievalType.TEXT, [DocEmbeddings(np.arange(len(doc_emb)), doc_emb)],
                         limit=HYBRID_K, device="cpu").find_batch(q_emb)

    def dist_ok(qi, x, y) -> bool:
        d = ((doc_emb[[x, y]].astype(np.float64) - q_emb[qi]) ** 2).sum(axis=1)
        return abs(float(d[0] - d[1])) < TIE_GAP

    sem_ties = list_near_ties([[h.chunk_id for h in hits] for hits in card_sem],
                              [[h.chunk_id for h in hits] for hits in cpu_sem], dist_ok, "semantic arm top-7")
    agree = 0
    for qi, hits in enumerate(fused):
        if keys(hits) != keys(weighted_reciprocal_rank([card_sem[qi], bm25_hits[qi]], [1.0, 1.0])):
            raise RuntimeError(f"ensemble query {qi}: the fused list is not the fusion of the card's arms")
        cpu_arm = [SearchHit(0, int(i), RetrievalType.TEXT, float(v)) for i, v in zip(*cpu_bm25[qi])]
        if keys(card_sem[qi]) != keys(cpu_sem[qi]) or keys(bm25_hits[qi]) != keys(cpu_arm):
            continue
        if keys(hits) != keys(weighted_reciprocal_rank([cpu_sem[qi], cpu_arm], [1.0, 1.0])):
            raise RuntimeError(f"ensemble query {qi}: the fused list differs from the fusion of the CPU arms")
        agree += 1
    print(f"RRF ensemble: fused list = fusion of the CPU arms' lists on {agree} of {len(queries)} queries, "
          f"the rest with an arm at a near-tie (semantic {sem_ties}, BM25 {ties})")
    print(f"peak memory (hybrid retrieval): {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB {card}", flush=True)
    return launches


def zipf_terms(rng, shape, vocab: int, s: float):
    """Term ids in [0, vocab) drawn from a Zipf law of exponent ``s``
    truncated to the vocabulary (id 0 the most frequent)."""
    import numpy as np

    cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64) ** -s)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(shape), side="right"), vocab - 1)


def bm25_1m_phase(torch, card) -> None:
    """A seeded BM25 index at the dense 1M x 384 index's scale: 1M items of
    48 unique Zipf(1.1) terms over 262,144, built through
    ``from_term_weight_arrays`` (the band + CSC layout), queried in a batch
    of 64 and singly, and held to a host scoring of the same weights."""
    import numpy as np
    import scipy.sparse

    from dial_rag_tpu_torch.index.bm25 import Bm25Index

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    n, v, p = BM25_1M_ITEMS, BM25_1M_VOCAB, BM25_1M_POSTINGS
    t0 = time.perf_counter()
    terms = zipf_terms(rng, (n, p), v, BM25_1M_ZIPF).astype(np.int64)
    todo = np.arange(n)
    while todo.size:  # draw again the repeats within an item until its terms are unique
        sub = np.sort(terms[todo], axis=1)
        dup = np.zeros(sub.shape, dtype=bool)
        dup[:, 1:] = sub[:, 1:] == sub[:, :-1]
        has = dup.any(axis=1)
        todo, sub, dup = todo[has], sub[has], dup[has]
        sub[dup] = zipf_terms(rng, int(dup.sum()), v, BM25_1M_ZIPF)
        terms[todo] = sub
    weights = rng.uniform(0.5, 1.5, size=(n, p)).astype(np.float32)
    # a planted group of identical items, spread over the index: ranked
    # first for their own terms, latest first
    group = n // 81 + (n // BM25_1M_GROUP) * np.arange(BM25_1M_GROUP)
    terms[group] = terms[group[0]]
    weights[group] = 4.0
    vocab = {f"t{i}": i for i in range(v)}
    item_ids = np.repeat(np.arange(n), p)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = Bm25Index.from_term_weight_arrays(vocab, np.ones(v), item_ids, terms.ravel(), weights.ravel(), n)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if index.layout != "band+csc":
        raise RuntimeError(f"the 1M index took the {index.layout} layout")
    nnz = index._postings[1].numel()
    print(f"BM25 1M: {n} items x {p} postings, Zipf({BM25_1M_ZIPF}) terms over {v}; layout band+csc: band "
          f"{tuple(index._band.shape)} ({index._band.numel() * 4 / 2**20:.0f} MiB), CSC tail {nnz} postings "
          f"({nnz * 8 / 1e9:.3f} GB), nbytes {index.nbytes / 1e9:.3f} GB; data {t_data:.1f} s, build {t_build:.1f} s "
          f"{card}", flush=True)

    qterms = zipf_terms(rng, (N_QUERIES, BM25_1M_QUERY_TERMS), v, BM25_1M_ZIPF)
    queries = [[f"t{int(t)}" for t in row] for row in qterms]
    index.top_n_batch_with_scores(queries, HYBRID_K)  # warm-up
    t0 = time.perf_counter()
    batch = index.top_n_batch_with_scores(queries, HYBRID_K)
    t_batch = time.perf_counter() - t0
    single_ms = []
    for q in queries[:5]:
        t0 = time.perf_counter()
        index.top_n_with_scores(q, HYBRID_K)
        single_ms.append((time.perf_counter() - t0) * 1e3)
    tail = [sum(int(index._postings[0][t + 1] - index._postings[0][t]) for t in set(row.tolist())
                if t not in index._band_cols) for row in qterms]
    print(f"BM25 1M query: {N_QUERIES} queries of {BM25_1M_QUERY_TERMS} terms through top_n_batch_with_scores "
          f"{t_batch * 1e3:.2f} ms; single top_n_with_scores median {sorted(single_ms)[2]:.2f} ms; CSC postings "
          f"a query median {int(np.median(tail))}, max {max(tail)} {card}")
    device_profile(torch, lambda: index.top_n_with_scores(queries[0], HYBRID_K), "one single BM25 1M query",
                   card, top=6)

    # gates: a host scoring of the same weights on 4 queries
    host = scipy.sparse.csr_matrix((weights.ravel().astype(np.float64), (item_ids, terms.ravel())), shape=(n, v))
    qmat = np.zeros((v, 4))
    for j, row in enumerate(qterms[:4]):
        np.add.at(qmat[:, j], row, 1.0)
    host_scores = (host @ qmat).T
    err = bm25_scores_within(index.get_scores_batch(queries[:4]), host_scores, "BM25 1M")
    host_top = [np.argsort(row, kind="stable")[::-1][:HYBRID_K] for row in host_scores]
    ties = list_near_ties([idx for idx, _ in batch[:4]], host_top, bm25_gap_ok(host_scores), "BM25 1M top-7")
    del host
    first = index.get_scores_batch(queries)
    again = index.get_scores_batch(queries)
    if not np.array_equal(first.view(np.int32), again.view(np.int32)):
        raise RuntimeError("BM25 1M: the same queries scored twice gave other bits")
    if any(not np.array_equal(a[0], b[0]) or not np.array_equal(a[1], b[1])
           for a, b in zip(batch, index.top_n_batch_with_scores(queries, HYBRID_K))):
        raise RuntimeError("BM25 1M: the same queries ranked twice gave other results")
    planted = [f"t{int(t)}" for t in terms[group[0]]]
    idx, vals = index.top_n_with_scores(planted, BM25_1M_GROUP)
    in_batch = index.top_n_batch_with_scores([planted] + queries[:3], BM25_1M_GROUP)[0]
    if (idx.tolist() != group[::-1].tolist() or len(set(vals.tolist())) != 1
            or not np.array_equal(in_batch[0], idx)):
        raise RuntimeError(f"BM25 1M: the planted group ranks {idx.tolist()}, scores {vals.tolist()}; "
                           f"expected {group[::-1].tolist()}, one score")
    print(f"BM25 1M gates: scores of 4 queries vs a host scipy scoring max abs diff {err:.3g} (rtol {BM25_RTOL}, "
          f"atol {BM25_ATOL}), top-{HYBRID_K} equal apart from {ties} near-ties; {N_QUERIES} queries scored twice "
          f"give the same bits; the planted {BM25_1M_GROUP} identical items rank latest first (score {vals[0]})")
    print(f"peak memory (BM25 1M): {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB {card}", flush=True)
    del index, first, again


def device_ms(torch, fn) -> float:
    """The device time of one call of ``fn`` (the profiler's kernels), ms."""
    fn()
    return sum(e.self_device_time_total for e in device_events(torch, fn)) / 1e3


def scan_bound(queries: int, rows: int, dim: int, nbytes: float, peak_ops: float) -> tuple[float, str]:
    """The least time of ``queries`` dot products against ``rows`` stored
    rows of ``dim`` (the matrix of ``nbytes`` read once)."""
    return bound(2.0 * queries * rows * dim, nbytes, peak_ops)


def dense_layouts_phase(torch, card, dev, qs, n_rows: int = DENSE_ROWS) -> None:
    """The main path's seeded 1M x 384 matrix, with a planted group of tied
    rows, as float32, bfloat16, two_pass and int8 ``DenseIndex``es built
    from the host rows: each answers ``find_batch`` of the 64 queries and
    ``find`` of 5, timed, with its scan's transient memory; a lone query
    (float32 and bfloat16) ranked whole against a block at a time; two_pass
    against float32 with its fallbacks counted; int8 against the same code
    on the CPU and against float32."""
    import numpy as np

    from dial_rag_tpu_torch.index import dense_index as di
    from dial_rag_tpu_torch.index.dense_index import _TP_BLK, _TP_CBLK, DenseIndex, DocEmbeddings
    from dial_rag_tpu_torch.index.records import RetrievalType

    hid = qs.shape[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    mat = torch.randn((n_rows, hid), generator=gen, device=dev)
    mat /= mat.norm(dim=1, keepdim=True)
    rng = np.random.default_rng(2)
    base = rng.standard_normal(hid).astype(np.float32)
    base /= np.linalg.norm(base)
    planted = np.sort(rng.choice(n_rows, 2 * PLANTED, replace=False))
    mat[torch.from_numpy(planted[:PLANTED]).to(dev)] = torch.from_numpy(base).to(dev)
    near = base + 1e-7 * rng.standard_normal((PLANTED, hid)).astype(np.float32)
    mat[torch.from_numpy(planted[PLANTED:]).to(dev)] = torch.from_numpy(near).to(dev)
    host = mat.cpu().numpy()
    del mat
    docs = [DocEmbeddings(np.arange(n_rows), host)]
    indexes, build_s = {}, {}
    for storage in ("float32", "bfloat16", "two_pass", "int8"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        indexes[storage] = DenseIndex(RetrievalType.TEXT, docs, limit=HYBRID_K, storage_dtype=storage, device=dev)
        torch.cuda.synchronize()
        build_s[storage] = time.perf_counter() - t0
    n_pad = indexes["float32"]._emb.shape[0]

    hits = {}
    for storage, index in indexes.items():
        index.find_batch(qs)  # warm-up at the query shapes
        index.find(qs[0])
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hits[storage] = index.find_batch(qs)
        t_batch = time.perf_counter() - t0
        batch_peak = torch.cuda.max_memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        single_ms = []
        for q in qs[:5]:
            t0 = time.perf_counter()
            index.find(q)
            single_ms.append((time.perf_counter() - t0) * 1e3)
        single_peak = torch.cuda.max_memory_allocated() - before
        peak_ops = PEAK_INT8_OPS if storage == "int8" else PEAK_F32_FLOPS
        scanned, window = index.nbytes, 0
        if storage == "two_pass":  # pass 1 reads the bf16 copy, pass 2 each query's window of f32 rows
            scanned, window = index._emb.numel() * 2, _TP_CBLK * _TP_BLK * hid * 4
        b_ms, b_by = scan_bound(len(qs), n_pad, hid, scanned + len(qs) * window, peak_ops)
        b1_ms, b1_by = scan_bound(1, n_pad, hid, scanned + window, peak_ops)
        print(f"dense {n_rows} x {hid} {storage}: {index.nbytes / 1e9:.3f} GB ({n_pad} rows) built in {build_s[storage]:.2f} s; "
              f"find_batch of {len(qs)} {t_batch * 1e3:.2f} ms (bound {b_ms:.3f} ms, {b_by}); find median "
              f"{sorted(single_ms)[2]:.2f} ms (bound {b1_ms:.3f} ms, {b1_by}); scan transient find_batch "
              f"{batch_peak / 2**20:.1f} MiB ({batch_peak / index.nbytes:.1%} of the index), find "
              f"{single_peak / 2**20:.1f} MiB ({single_peak / index.nbytes:.1%}) {card}", flush=True)
        if storage == "bfloat16" and max(batch_peak, single_peak) > SCAN_SHARE * index.nbytes:
            raise RuntimeError(f"the bf16 scan held {max(batch_peak, single_peak)} bytes beyond a "
                               f"{index.nbytes}-byte index, more than {SCAN_SHARE:.0%} of it")

    def ids(hs):
        return [h.chunk_id for h in hs]

    # a lone query ranks its whole scores once; the same query ranked a
    # block at a time and merged (a 16 MiB scan budget; its products have
    # other shapes, so f32 rounding may differ) gives the same hits
    for storage in ("float32", "bfloat16"):
        index = indexes[storage]
        whole = [index.find_with_distances(q) for q in qs]
        budget = di._SCAN_BYTES
        di._SCAN_BYTES = (16 << 20, 16 << 20)
        try:
            if index._per_row_bytes(1, False) * n_pad <= index._scan_budget():
                raise RuntimeError("a 16 MiB scan budget still ranks a lone query's scores whole")
            blocked = [index.find_with_distances(q) for q in qs]
        finally:
            di._SCAN_BYTES = budget
        dist = [dict(zip(ids(h), d)) | dict(zip(ids(bh), bd)) for (h, d), (bh, bd) in zip(whole, blocked)]
        worst = max(abs(dx - dict(zip(ids(bh), bd)).get(x, dx)) for (h, d), (bh, bd) in zip(whole, blocked)
                    for x, dx in zip(ids(h), d))
        if worst > DENSE_ATOL:
            raise RuntimeError(f"{storage}: a lone query's distances ranked whole and a block at a time differ by {worst}")
        ties = list_near_ties([ids(bh) for bh, _ in blocked], [ids(h) for h, _ in whole],
                              lambda qi, x, y: abs(dist[qi][x] - dist[qi][y]) <= DENSE_ATOL,
                              f"dense {storage} lone query ranked a block at a time vs whole")
        one_ms = device_ms(torch, lambda: index.find(qs[0]))
        print(f"dense {n_rows} {storage} single query, device time {one_ms:.3f} ms; ranked whole = ranked a "
              f"block at a time on all {len(qs)} queries apart from {ties} near-ties, distances within "
              f"{worst:.3g} (limit {DENSE_ATOL}) {card}")

    # two_pass: the f32 index's hits and distances, its fallbacks counted
    tp, f32 = indexes["two_pass"], indexes["float32"]
    qt, q_sq = tp._prepare(qs)
    ok, _ = tp._two_pass_window(qt, q_sq, HYBRID_K)
    fallbacks = int((~ok).sum())
    worst = 0.0
    for qi, q in enumerate(qs):
        h, d = tp.find_with_distances(q)
        fh, fd = f32.find_with_distances(q)
        worst = max(worst, float(np.max(np.abs(np.asarray(d) - np.asarray(fd)))))
        if ids(h) != ids(fh) or ids(hits["two_pass"][qi]) != ids(hits["float32"][qi]) or worst > DENSE_ATOL:
            raise RuntimeError(f"two_pass query {qi}: {ids(h)} / batch {ids(hits['two_pass'][qi])}, float32 "
                               f"{ids(fh)} / batch {ids(hits['float32'][qi])}, distances apart by {worst}")
    tied = np.stack([base, base + np.float32(1e-8)])
    qt, q_sq = tp._prepare(torch.from_numpy(tied))
    tied_ok, _ = tp._two_pass_window(qt, q_sq, HYBRID_K)
    for q in tied:
        h, fh = tp.find(q), f32.find(q)
        if ids(h) != ids(fh) or not set(ids(h)) <= set(planted.tolist()):
            raise RuntimeError(f"two_pass on the planted rows ranks {ids(h)}, float32 {ids(fh)}")
    if bool(tied_ok.any()):
        raise RuntimeError("the planted tied rows did not force the two_pass fallback")
    print(f"two_pass gates: float32's hits on all {len(qs)} queries, alone and in the batch, distances within "
          f"{worst:.3g} (limit {DENSE_ATOL}); {fallbacks} of {len(qs)} queries fell back to the f32 scan; the "
          f"{2 * PLANTED} planted rows force the fallback and rank as float32 does {card}")

    # int8: the same code on the CPU, and float32's top-7
    i8 = indexes["int8"]
    cpu8 = DenseIndex(RetrievalType.TEXT, docs, limit=3 * HYBRID_K, storage_dtype="int8", device="cpu")
    worst, ties = 0.0, 0
    for qi in range(4):
        h, d = i8.find_with_distances(qs[qi])
        ch, cd = cpu8.find_with_distances(qs[qi])
        cpu_d = dict(zip(ids(ch), cd))
        for x, dx in zip(ids(h), d):
            if x not in cpu_d or abs(dx - cpu_d[x]) > 1e-6 * abs(cpu_d[x]):
                raise RuntimeError(f"int8 query {qi}: row {x} at {dx} on the card, {cpu_d.get(x)} on the CPU")
            worst = max(worst, abs(dx - cpu_d[x]) / abs(cpu_d[x]))

        def gap_ok(_, x, y):
            return abs(cpu_d[x] - cpu_d[y]) <= 1e-6 * abs(cpu_d[y])

        ties += list_near_ties([ids(h)], [ids(ch)[:HYBRID_K]], gap_ok, f"int8 query {qi} top-7")
    overlap = float(np.mean([len(set(ids(a)) & set(ids(b))) / HYBRID_K
                             for a, b in zip(hits["int8"], hits["float32"])]))
    if overlap < INT8_OVERLAP:
        raise RuntimeError(f"int8 top-{HYBRID_K} overlaps float32's by {overlap}, below {INT8_OVERLAP}")
    print(f"int8 gates: 4 queries' distances within rtol {worst:.3g} of the CPU's (limit 1e-6), top-{HYBRID_K} "
          f"equal apart from {ties} near-ties; top-{HYBRID_K} overlap with float32 {overlap:.3f} over "
          f"{len(qs)} queries (at least {INT8_OVERLAP}) {card}")
    print(f"peak memory (dense layouts): {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB {card}", flush=True)


def late_interaction_phase(torch, card, li_emb, texts, chunks, queries) -> tuple[dict, list]:
    """``checkpoints/alps-maxsim`` in bf16 token-encodes the main path's
    chunks; float32, bfloat16 and int8 ``LateInteractionIndex``es answer the
    64 queries through ``retrieve_batch`` and 5 through ``retrieve`` and
    ``aretrieve``, timed; each MaxSim scan timed beside its bound; the card
    held to the same code on the CPU. Returns kernels 1-2's launches and the
    chunks' token embeddings."""
    import asyncio

    import numpy as np

    from dial_rag_tpu_torch.documents.model import DocumentRecord, IndexSettings
    from dial_rag_tpu_torch.index import late_interaction as li
    from dial_rag_tpu_torch.index.late_interaction import LateInteractionIndex
    from dial_rag_tpu_torch.index.records import RetrievalType
    from dial_rag_tpu_torch.ops import fused_encoder as fe
    from dial_rag_tpu_torch.retrieval import LateInteractionRetriever

    # warm-up: first use of each op at the encode shapes
    li_emb.embed_documents_tokens(texts[: li_emb.batch_size], LI_MAX_TOKENS)
    li_emb.embed_documents_tokens(queries, max_tokens=64)
    li_emb.embed_query_tokens_device(queries[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fe.reset_launches()
    t0 = time.perf_counter()
    tokens = asyncio.run(LateInteractionRetriever.build_index(li_emb, chunks, LI_MAX_TOKENS))
    t_encode = time.perf_counter() - t0
    n_tokens = sum(t.shape[0] for t in tokens)
    record = DocumentRecord(format_version=None, index_settings=IndexSettings(), chunks=chunks, text_index=None,
                            embeddings_index=None, multimodal_embeddings_index=None,
                            description_embeddings_index=None, mime_type="text/plain", document_bytes=b"",
                            late_interaction_index=tokens)
    print(f"late-interaction token encode (alps-maxsim, bf16): {len(chunks)} chunks, {n_tokens} tokens in "
          f"{t_encode:.3f} s ({len(chunks) / t_encode:.1f} chunks/s) {card}", flush=True)
    retrievers, results = {}, {}
    for storage in ("float32", "bfloat16", "int8"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = LateInteractionRetriever.from_doc_records(li_emb, [record], k=HYBRID_K, max_chunk_tokens=LI_MAX_TOKENS,
                                                      storage_dtype=storage)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        r.retrieve_batch(queries)  # warm-up at the query shapes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = r.retrieve_batch(queries)
        t_batch = time.perf_counter() - t0
        single, single_ms, async_hits, async_ms = [], [], [], []
        for q in queries[:5]:
            t0 = time.perf_counter()
            single.append(r.retrieve(q))
            single_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            async_hits.append(asyncio.run(r.aretrieve(q)))
            async_ms.append((time.perf_counter() - t0) * 1e3)
        retrievers[storage], results[storage] = r, (batch, single, async_hits)
        print(f"late interaction {storage}: index {r.index.nbytes / 1e9:.3f} GB {tuple(r.index._x.shape)} built in "
              f"{t_build:.3f} s; {len(queries)} queries through retrieve_batch {t_batch * 1e3:.2f} ms; retrieve "
              f"median {sorted(single_ms)[2]:.2f} ms, aretrieve median {sorted(async_ms)[2]:.2f} ms {card}",
              flush=True)
    torch.cuda.synchronize()
    launches = {name: fe.LAUNCHES[name] for name in ("fused_attention_block", "fused_ffn_block")}
    n_batches = -(-len(chunks) // li_emb.batch_size) + 3 * (2 + 5 + 5)
    layers = li_emb.encoder.config.num_layers
    for name, n in launches.items():
        if n != layers * n_batches:
            raise RuntimeError(f"{name} launched {n} times in the late-interaction run, expected "
                               f"{layers * n_batches}: the token encode bypassed it")
    print(f"late-interaction launches {launches} ({layers} layers x {n_batches} encode batches)")
    device_profile(torch, lambda: retrievers["float32"].retrieve(queries[0]), "one late-interaction query (f32)",
                   card, top=5)

    # each MaxSim scan on the card: one query, and one group of the batch
    q_tokens = li_emb.embed_documents_tokens(queries, max_tokens=64)
    q_tok, q_counts = li.pack_query_batch(q_tokens, li_emb.dim)
    lone_tok, lone_counts = li.pack_query_batch([li_emb.embed_query_tokens(q) for q in queries], li_emb.dim)
    if lone_tok.shape != q_tok.shape or not np.array_equal(lone_counts, q_counts):
        raise RuntimeError("a query's lone token encode has other tokens than its batch encode")
    g = max(1, li._MAX_Q_LANES // q_tok.shape[1])
    for storage, r in retrievers.items():
        idx = r.index
        peak = PEAK_INT8_OPS if storage == "int8" else PEAK_F32_FLOPS
        for what, n_q in (("one query", 1), (f"a group of {g} queries", g)):
            qt = torch.from_numpy(q_tok[:n_q]).to(li_emb.device)
            qc = torch.from_numpy(q_counts[:n_q]).to(li_emb.device)
            ms = cuda_ms(torch, lambda: li._maxsim_scores(idx._x, idx._counts, qt, qc, idx._x_scales), iters=5)
            b_ms, b_by = bound(2.0 * idx._x.shape[0] * idx.t * idx.dim * n_q * q_tok.shape[1], idx.nbytes, peak)
            print(f"MaxSim scan {storage}, {what} ({n_q * q_tok.shape[1]} lanes): {ms:.3f} ms (bound {b_ms:.3f} ms, "
                  f"{b_by}) {card}")
        device_profile(torch, lambda: li._maxsim_scores(idx._x, idx._counts, qt, qc, idx._x_scales),
                       f"one MaxSim scan ({storage}, {what})", card, top=4)

    # gates: the same code on the CPU over the first chunks, 4 queries
    sub = [tokens[:LI_GATE_CHUNKS]]
    qt = torch.from_numpy(q_tok[:4])
    qc = torch.from_numpy(q_counts[:4])
    for storage in retrievers:
        cpu = LateInteractionIndex(RetrievalType.TEXT, sub, LI_MAX_TOKENS, HYBRID_K, storage, device="cpu")
        gpu = LateInteractionIndex(RetrievalType.TEXT, sub, LI_MAX_TOKENS, HYBRID_K, storage, device=li_emb.device)
        want = li._maxsim_scores(cpu._x, cpu._counts, qt, qc, cpu._x_scales).numpy()
        got = li._maxsim_scores(gpu._x, gpu._counts, qt.to(li_emb.device), qc.to(li_emb.device),
                                gpu._x_scales).cpu().numpy()
        finite = np.isfinite(want)
        err = float(np.max(np.abs(got[finite] - want[finite])))
        if not np.array_equal(finite, np.isfinite(got)) or err > MAXSIM_ATOL:
            raise RuntimeError(f"MaxSim {storage}: the card's scores are off the CPU's by {err} (atol {MAXSIM_ATOL})")

        def gap_ok(qi, x, y):
            return abs(float(want[x, qi]) - float(want[y, qi])) <= MAXSIM_ATOL

        ties = list_near_ties([[h.chunk_id for h in hs] for hs in gpu.find_batch(q_tokens[:4])],
                              [[h.chunk_id for h in hs] for hs in cpu.find_batch(q_tokens[:4])], gap_ok,
                              f"MaxSim {storage} top-7")
        # batch and single on the same token rows, and the same bits twice
        batch_hits = retrievers[storage].index.find_batch(q_tokens)
        again = retrievers[storage].index.find_batch(q_tokens)
        if [[h.score for h in hs] for hs in again] != [[h.score for h in hs] for hs in batch_hits]:
            raise RuntimeError(f"MaxSim {storage}: a batch scored twice gave other bits")
        alone = [retrievers[storage].index.find_with_scores(q) for q in q_tokens[:5]]
        scores = [{h.chunk_id: h.score for h in hs} for hs in batch_hits[:5]]
        for (h, s), sc in zip(alone, scores):
            sc.update({x.chunk_id: v for x, v in zip(h, s)})
        lone_ties = list_near_ties([[h.chunk_id for h in hs] for hs in batch_hits[:5]],
                                   [[x.chunk_id for x in h] for h, _ in alone],
                                   lambda qi, x, y: abs(scores[qi][x] - scores[qi][y]) <= MAXSIM_ATOL,
                                   f"MaxSim {storage} batch vs single")
        batch, single, async_hits = results[storage]
        for qi in range(5):
            if [h.key for h in async_hits[qi]] != [h.key for h in single[qi]]:
                raise RuntimeError(f"late interaction {storage} query {qi}: aretrieve is not retrieve")
        # retrieve_batch against retrieve on every query: swaps only where the
        # scores of the lone and the batch encode, over every chunk, drift
        idx, drift = retrievers[storage].index, 0.0
        for g0 in range(0, len(queries), g):
            scored = [li._maxsim_scores(idx._x, idx._counts, torch.from_numpy(t[g0 : g0 + g]).to(li_emb.device),
                                        torch.from_numpy(c[g0 : g0 + g]).to(li_emb.device), idx._x_scales).cpu()
                      for t, c in ((q_tok, q_counts), (lone_tok, lone_counts))]
            finite = torch.isfinite(scored[0])
            if not torch.equal(finite, torch.isfinite(scored[1])):
                raise RuntimeError(f"MaxSim {storage}: the lone and batch encodes score other chunks")
            drift = max(drift, float((scored[0] - scored[1])[finite].abs().max()))
        if drift > MAXSIM_ATOL:
            raise RuntimeError(f"MaxSim {storage}: lone and batch encodes' scores drift {drift}, above {MAXSIM_ATOL}")
        lone_hits = [retrievers[storage].retrieve(q) for q in queries]
        sc = [{h.chunk_id: h.score for h in hs + b} for hs, b in zip(lone_hits, batch)]
        retr_ties = list_near_ties([[h.chunk_id for h in hs] for hs in batch],
                                   [[h.chunk_id for h in hs] for hs in lone_hits],
                                   lambda qi, x, y: abs(sc[qi][x] - sc[qi][y]) <= 2 * drift,
                                   f"late interaction {storage} retrieve_batch vs retrieve")
        print(f"MaxSim {storage} gates: scores of 4 queries over {LI_GATE_CHUNKS} chunks within {err:.3g} of the "
              f"CPU's (atol {MAXSIM_ATOL}), top-{HYBRID_K} equal apart from {ties} near-ties; a batch scored twice "
              f"gives the same bits; index batch = single apart from {lone_ties} near-ties; lone vs batch encode "
              f"score drift over {len(queries)} queries x {idx.n_rows} chunks {drift:.3g} (limit {MAXSIM_ATOL}); "
              f"retrieve_batch = retrieve on {len(queries)} queries apart from {retr_ties} near-ties within "
              f"{2 * drift:.3g}; aretrieve = retrieve")
    for q in queries[:5]:
        dev_rows = li_emb.embed_query_tokens_device(q).cpu().numpy()
        host = li_emb.embed_query_tokens(q)
        if not np.array_equal(dev_rows[: host.shape[0]], host) or dev_rows[host.shape[0] :].any():
            raise RuntimeError(f"embed_query_tokens_device rows of {q!r} are not the host rows")
    print(f"embed_query_tokens_device: 5 queries' rows equal the host rows bit for bit, padding exactly zero")
    print(f"peak memory (late interaction): {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB {card}", flush=True)
    return launches, tokens


def local_arms_phase(torch, card, embedder, li_emb, embeddings_index, tokens, chunks, queries) -> dict:
    """The chargram arm (the C++ core) and the word-vector expansion of
    BM25 over the main path's chunks, built and timed, then the RRF
    ensemble of the four local arms (semantic, late_interaction, bm25 with
    expansion, chargram; k = 7 each) through ``aretrieve_batch`` and 5
    ``aretrieve`` calls, each arm held to the same code on the CPU.
    Returns kernels 1-2's launches in the ensemble's run."""
    import asyncio

    import numpy as np

    from dial_rag_tpu_torch.documents.model import DocumentRecord, IndexSettings
    from dial_rag_tpu_torch.index import chargram as cgi
    from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
    from dial_rag_tpu_torch.index.late_interaction import LateInteractionIndex
    from dial_rag_tpu_torch.index.records import RetrievalType
    from dial_rag_tpu_torch.ops import fused_encoder as fe
    from dial_rag_tpu_torch.retrieval import (
        Bm25Retriever,
        ChargramRetriever,
        EnsembleRetriever,
        LateInteractionRetriever,
        SemanticRetriever,
    )
    from dial_rag_tpu_torch.retrieval.ensemble import weighted_reciprocal_rank
    from dial_rag_tpu_torch.text.word_vectors import QueryExpansionConfig, build_word_vectors

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    text_index = asyncio.run(Bm25Retriever.build_index(chunks))
    cgi.reset_paths()
    t0 = time.perf_counter()
    words = asyncio.run(ChargramRetriever.build_index(chunks))
    t_words = time.perf_counter() - t0
    record = DocumentRecord(format_version=None, index_settings=IndexSettings(), chunks=chunks, text_index=text_index,
                            embeddings_index=embeddings_index, multimodal_embeddings_index=None,
                            description_embeddings_index=None, mime_type="text/plain", document_bytes=b"",
                            late_interaction_index=tokens, chargram_index=words)
    t0 = time.perf_counter()
    chargram = ChargramRetriever.from_doc_records([record], k=HYBRID_K)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    inner = chargram._index.inner
    print(f"chargram build: words of {len(chunks)} chunks {t_words:.3f} s; index {inner.n_items} items, "
          f"{len(inner.vocab)} grams, layout {inner.layout}, {inner.nbytes / 2**20:.1f} MiB, in {t_cg:.3f} s; "
          f"triples: C++ core {cgi.PATHS['native']} texts, numpy path {cgi.PATHS['numpy']} {card}")
    cfg = QueryExpansionConfig()
    t0 = time.perf_counter()
    wv = build_word_vectors([c.text for c in chunks], window=cfg.window, dim=cfg.dim, min_count=cfg.min_count,
                            max_vocab=cfg.max_vocab)
    t_wv = time.perf_counter() - t0
    t0 = time.perf_counter()
    bm25 = Bm25Retriever.from_doc_records([record], k=HYBRID_K, expansion_config=cfg)
    torch.cuda.synchronize()
    t_bm25 = time.perf_counter() - t0
    print(f"word vectors (host numpy): {wv.vecs.shape[0]} words x {wv.vecs.shape[1]} in {t_wv:.3f} s; BM25 "
          f"with query expansion built in {t_bm25:.3f} s {card}")
    for name, arm in (("BM25 expanded", bm25), ("chargram", chargram)):
        arm.retrieve_batch(queries)  # warm-up
        t0 = time.perf_counter()
        arm.retrieve_batch(queries)
        t_batch = time.perf_counter() - t0
        single_ms = []
        for q in queries[:5]:
            t0 = time.perf_counter()
            arm.retrieve(q)
            single_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"{name} query: {len(queries)} queries in one batch {t_batch * 1e3:.2f} ms; single query median "
              f"{sorted(single_ms)[2]:.2f} ms {card}")

    semantic = SemanticRetriever.from_doc_records(embedder, [record], k=HYBRID_K)
    late = LateInteractionRetriever.from_doc_records(li_emb, [record], k=HYBRID_K, max_chunk_tokens=LI_MAX_TOKENS)
    arms = [semantic, late, bm25, chargram]
    ensemble = EnsembleRetriever(arms)
    asyncio.run(ensemble.aretrieve_batch(queries))  # warm-up
    torch.cuda.synchronize()
    fe.reset_launches()
    t0 = time.perf_counter()
    fused = asyncio.run(ensemble.aretrieve_batch(queries))
    t_ens = time.perf_counter() - t0
    ens_ms = []
    for q in queries[:5]:
        t0 = time.perf_counter()
        asyncio.run(ensemble.aretrieve(q))
        ens_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = {name: fe.LAUNCHES[name] for name in ("fused_attention_block", "fused_ffn_block")}
    n_batches = 2 * (1 + 5)  # the semantic and the late-interaction arm's encodes
    layers = embedder.encoder.config.num_layers
    for name, n in launches.items():
        if n != layers * n_batches:
            raise RuntimeError(f"{name} launched {n} times in the four-arm ensemble's run, expected "
                               f"{layers * n_batches}")
    print(f"RRF ensemble of four local arms (semantic, late_interaction, BM25 expanded, chargram; k={HYBRID_K} "
          f"each): {len(queries)} queries through aretrieve_batch {t_ens * 1e3:.2f} ms; single aretrieve median "
          f"{sorted(ens_ms)[2]:.2f} ms; launches {launches} ({layers} layers x {n_batches} encode batches) {card}",
          flush=True)

    # gates: chargram scores on the card against the CPU's
    cpu_cg = cgi.ChargramIndex.build(words, device="cpu")
    weights = [cpu_cg.query_weights(q) for q in queries]
    cpu_scores = cpu_cg.inner.get_scores_batch(weights)
    err = bm25_scores_within(inner.get_scores_batch(weights), cpu_scores, "chargram")
    print(f"chargram scores of {len(queries)} queries, card vs CPU: max abs diff {err:.3g} (rtol {BM25_RTOL}, "
          f"atol {BM25_ATOL})")

    # the fused lists against the fusion of the CPU arms' lists, wherever every arm agrees
    def keys(hits):
        return [h.key for h in hits]

    q_emb = embedder.embed_queries(queries)
    doc_emb = np.concatenate(embeddings_index)
    q_tokens = li_emb.embed_documents_tokens(queries, max_tokens=64)
    cpu_lists = [
        DenseIndex(RetrievalType.TEXT, [DocEmbeddings(np.arange(len(doc_emb)), doc_emb)], limit=HYBRID_K,
                   device="cpu").find_batch(q_emb),
        LateInteractionIndex(RetrievalType.TEXT, [tokens], LI_MAX_TOKENS, HYBRID_K, device="cpu").find_batch(q_tokens),
        Bm25Retriever.from_doc_records([record], k=HYBRID_K, device="cpu", expansion_config=cfg).retrieve_batch(queries),
        ChargramRetriever.from_doc_records([record], k=HYBRID_K, device="cpu").retrieve_batch(queries),
    ]
    card_lists = [arm.retrieve_batch(queries) for arm in arms]
    agree, differ = 0, collections.Counter()
    for qi, hits in enumerate(fused):
        card_arms = [lists[qi] for lists in card_lists]
        if keys(hits) != keys(weighted_reciprocal_rank(card_arms, [1.0] * len(arms))):
            raise RuntimeError(f"four-arm query {qi}: the fused list is not the fusion of the card's arms")
        cpu_arms = [lists[qi] for lists in cpu_lists]
        off = [name for name, a, b in zip(("semantic", "late_interaction", "bm25", "chargram"), card_arms, cpu_arms)
               if keys(a) != keys(b)]
        if off:
            differ.update(off)
            continue
        if keys(hits) != keys(weighted_reciprocal_rank(cpu_arms, [1.0] * len(arms))):
            raise RuntimeError(f"four-arm query {qi}: the fused list differs from the fusion of the CPU arms")
        agree += 1
    print(f"four-arm RRF: fused list = fusion of the CPU arms' lists on {agree} of {len(queries)} queries; the "
          f"rest have an arm whose list differs from the CPU's (arms: {dict(differ)}) {card}")
    if not agree:
        raise RuntimeError("no query has every arm's list equal to the CPU's: the fusion gate held nothing")
    print(f"peak memory (local arms ensemble): {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB {card}",
          flush=True)
    return launches, record


def pdf_safe(text: str) -> str:
    """``text`` as a WinAnsi page written in Latin-1 holds it: printable
    ASCII and Latin-1 letters stay, any other character becomes a space."""
    return "".join(c if " " <= c <= "~" or "\xc0" <= c <= "\xff" else " " for c in text)


def pdf_page(text: str) -> list[tuple[float, float, float, str]]:
    """One text as a page of 10 pt lines, wrapped at whole words."""
    lines = textwrap.wrap(pdf_safe(text), PDF_LINE_CHARS, break_long_words=False, break_on_hyphens=False)
    return [(72, 750 - 14 * i, 10, line) for i, line in enumerate(lines)]


def load_office_builder():
    """``tests/utils/office_builder.py`` (io and zipfile only), loaded from its file."""
    spec = importlib.util.spec_from_file_location("office_builder", OFFICE_BUILDER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def document_corpus(texts, extra, pdf_docs: int = PDF_DOCS,
                    other_docs=OTHER_DOCS) -> list[tuple[str, bytes, list | None]]:
    """(name, bytes, each page's source text for a PDF, else None): ``texts``
    one a page in ``pdf_docs`` PDFs of equal page counts, alternately
    plain, Flate-compressed and with an xref stream; ``extra`` (OFFICE_TEXTS
    a document) in the office, Markdown, text and CSV documents."""
    from dial_rag_tpu_torch.documents.pdf.writer import build_pdf

    office = load_office_builder()
    variants = ({}, {"compress": True}, {"compress": True, "use_xref_stream": True})
    docs = []
    pdf_pages = len(texts) // pdf_docs
    for d in range(pdf_docs):
        pages = texts[d * pdf_pages : (d + 1) * pdf_pages]
        data = build_pdf([pdf_page(t) for t in pages], **variants[d % len(variants)])
        docs.append((f"manual-{d:02d}.pdf", data, [pdf_safe(t) for t in pages]))
    parts = iter(extra)
    for fmt, count in other_docs:
        for d in range(count):
            body = [next(parts) for _ in range(OFFICE_TEXTS)]
            heads = [f"Part {i + 1} " + " ".join(t.split()[:3]).title() for i, t in enumerate(body)]
            words = [t.split() for t in body]
            if fmt == "docx":
                data = office.build_docx([b for h, t in zip(heads, body) for b in ((h, "Heading1"), (t, None))])
            elif fmt == "pptx":
                data = office.build_pptx([[(h, True), (t, False)] for h, t in zip(heads, body)])
            elif fmt == "xlsx":
                data = office.build_xlsx({h: [[" ".join(w[j : j + 6]) for j in range(i, min(i + 24, len(w)), 6)]
                                              for i in range(0, len(w), 24)] for h, w in zip(heads, words)})
            elif fmt == "md":
                data = "\n\n".join(f"# {h}\n\n{t}" for h, t in zip(heads, body)).encode()
            elif fmt == "txt":
                data = "\n\n".join(body).encode()
            else:
                data = "\n".join(["term,first,second,third"] + [",".join(w[i : i + 4]) for w in words
                                                                for i in range(0, len(w), 4)]).encode()
            docs.append((f"{fmt}-{d}.{fmt}", data, None))
    return docs


def parse_one(name: str, data: bytes):
    """``detect_mime`` -> ``parse_document`` of one attachment, timed (run
    in a spawned worker process)."""
    from dial_rag_tpu_torch.documents.mime import detect_mime
    from dial_rag_tpu_torch.documents.parser import parse_document

    t0 = time.perf_counter()
    mime = detect_mime(None, name, data)
    chunks = parse_document(data, mime, source_link=f"files/chip-smoke/{name}", display_name=name)
    return mime, chunks, time.perf_counter() - t0


def check_pdf_words(name: str, chunks, page_texts: list[str]) -> None:
    """Each page's chunks, joined, hold the page's text word for word."""
    by_page = collections.defaultdict(list)
    for c in chunks:
        by_page[c.metadata.get("page_number")].append(c.text)
    if set(by_page) != set(range(1, len(page_texts) + 1)):
        raise RuntimeError(f"{name}: chunks name pages {sorted(by_page, key=str)[:8]}..., expected 1..{len(page_texts)}")
    for page, text in enumerate(page_texts, start=1):
        got = " ".join(by_page[page]).split()
        if got != text.split():
            at = next((i for i, (a, b) in enumerate(zip(got, text.split())) if a != b), min(len(got), len(text.split())))
            raise RuntimeError(f"{name} page {page}: parsed words differ from the page's text at word {at}: "
                               f"{got[at : at + 4]} vs {text.split()[at : at + 4]}")


def record_fields(record) -> dict:
    """A record's stored fields, each array as (dtype, shape, bytes)."""
    out = {}
    for name in ("format_version", "mime_type", "document_bytes", "text_index", "chargram_index"):
        out[name] = getattr(record, name)
    out["index_settings"] = record.index_settings.indexes
    out["chunks"] = [(c.text, c.metadata) for c in record.chunks]
    for name in ("embeddings_index", "multimodal_embeddings_index", "description_embeddings_index",
                 "late_interaction_index"):
        multi = getattr(record, name)
        out[name] = None if multi is None else [(a.dtype.str, a.shape, a.tobytes()) for a in multi]
    return out


def document_indexing_phase(torch, card, embedder, texts, queries, workers: int | None = None) -> dict:
    """One indexing request over ``texts`` laid out as documents
    (``document_corpus``), stored and loaded back, then retrieval of
    ``queries`` over the loaded records against the records as built, and
    a second request for the same records. Returns kernels 1-2's launches
    in the request (the encode and the query encodes)."""
    import asyncio
    import gzip
    import hashlib

    import numpy as np

    from dial_rag_tpu_torch import telemetry
    from dial_rag_tpu_torch.documents.model import FORMAT_VERSION, DocumentRecord, IndexSettings
    from dial_rag_tpu_torch.documents.parser import ParserConfig
    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
    from dial_rag_tpu_torch.index.device_cache import DeviceIndexCache
    from dial_rag_tpu_torch.index.records import RetrievalType
    from dial_rag_tpu_torch.models.bert import BertEncoder
    from dial_rag_tpu_torch.ops import fused_encoder as fe
    from dial_rag_tpu_torch.retrieval import Bm25Retriever, EnsembleRetriever, SemanticRetriever
    from dial_rag_tpu_torch.storage import IndexStorageHolder, LocalFileStorage, serialize_record
    from dial_rag_tpu_torch.storage.storage import link_to_index_url

    t_phase = time.perf_counter()
    n_extra = OFFICE_TEXTS * sum(n for _, n in OTHER_DOCS)
    extra = synthetic_texts(embedder.tokenizer.vocab, n_extra, seed=2)
    t0 = time.perf_counter()
    docs = document_corpus(texts, extra)
    t_corpus = time.perf_counter() - t0
    by_format = collections.defaultdict(lambda: collections.Counter())
    for name, data, _ in docs:
        by_format[name.rsplit(".", 1)[1]].update(documents=1, bytes=len(data))
    print(f"document corpus: {len(docs)} documents, {sum(len(d) for _, d, _ in docs) / 2**20:.2f} MiB, written in "
          f"{t_corpus:.2f} s (host)", flush=True)

    # parse: every document in spawned worker processes (the parser is pure Python)
    workers = workers or min(len(docs), os.cpu_count() or 1, 8)
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        parsed = list(pool.map(parse_one, [n for n, _, _ in docs], [d for _, d, _ in docs]))
    t_parse = time.perf_counter() - t0
    for (name, _, page_texts), (mime, chunks, seconds) in zip(docs, parsed):
        fmt = name.rsplit(".", 1)[1]
        pages = {c.metadata.get("page_number") for c in chunks} - {None}
        by_format[fmt].update(pages=len(pages), chunks=len(chunks), parse_us=int(seconds * 1e6))
        if page_texts is not None:
            check_pdf_words(name, chunks, page_texts)
    n_chunks = sum(len(c) for _, c, _ in parsed)
    for fmt, c in by_format.items():
        rate = f"{c['pages'] / (c['parse_us'] / 1e6):.1f} pages/s, " if c["pages"] else ""
        print(f"  {fmt}: {c['documents']} documents, {c['pages'] or '-'} pages, {c['chunks']} chunks, "
              f"{c['bytes'] / 2**10:.0f} KiB; parse {c['parse_us'] / 1e6:.3f} s in one worker, {rate}"
              f"{c['chunks'] / (c['parse_us'] / 1e6):.1f} chunks/s")
    print(f"parse: {len(docs)} documents, {n_chunks} chunks in {t_parse:.2f} s of wall over {workers} spawned "
          f"worker processes, their start and imports included; every PDF page's chunks hold its text word for "
          f"word (host)", flush=True)

    # index: the bf16 semantic index on the card (kernels 1-2), the BM25 text index on the host
    chunk_lists = [c for _, c, _ in parsed]
    torch.cuda.synchronize()
    fe.reset_launches()
    t0 = time.perf_counter()
    embeddings = [asyncio.run(SemanticRetriever.build_index(embedder, chunks)) for chunks in chunk_lists]
    torch.cuda.synchronize()
    t_encode = time.perf_counter() - t0
    build_launches = {name: fe.LAUNCHES[name] for name in ("fused_attention_block", "fused_ffn_block")}
    layers = embedder.encoder.config.num_layers
    n_batches = sum(-(-len(c) // embedder.batch_size) for c in chunk_lists if c)
    for name, n in build_launches.items():
        if n != layers * n_batches:
            raise RuntimeError(f"{name} launched {n} times in the document encode, expected {layers * n_batches}")
    t0 = time.perf_counter()
    text_indexes = [asyncio.run(Bm25Retriever.build_index(chunks)) for chunks in chunk_lists]
    t_bm25 = time.perf_counter() - t0
    settings = IndexSettings(indexes={"parser": ParserConfig().index_settings(),
                                      "embedder": {"model_id": embedder.model_id}})
    built = [DocumentRecord(FORMAT_VERSION, settings, chunks, text_index, emb, None, None, mime, data)
             for (_, data, _), (mime, chunks, _), text_index, emb in zip(docs, parsed, text_indexes, embeddings)]

    # storage: serialize, store through a holder over a local directory, load in a fresh holder
    t0 = time.perf_counter()
    blobs = [serialize_record(r) for r in built]
    t_serialize = time.perf_counter() - t0
    raw_bytes = sum(len(gzip.decompress(b)) for b in blobs)
    urls = [link_to_index_url(f"files/chip-smoke/{name}", "chip-smoke") for name, _, _ in docs]
    telemetry.metrics().reset()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_index_") as root:
        async def store_all(storage):
            for url, record in zip(urls, built):
                await storage.store(url, record)

        async def load_all(storage):
            return [await storage.load(url, settings) for url in urls]

        t0 = time.perf_counter()
        asyncio.run(store_all(IndexStorageHolder().get_storage(LocalFileStorage(root))))
        t_store = time.perf_counter() - t0
        stored = [(Path(root) / url).read_bytes() for url in urls]
        holder = IndexStorageHolder()
        t0 = time.perf_counter()
        loaded = asyncio.run(load_all(holder.get_storage(LocalFileStorage(root))))
        t_load = time.perf_counter() - t0
        for url, data, record, before in zip(urls, stored, loaded, built):
            if record is None:
                raise RuntimeError(f"{url}: a fresh load of the stored record missed")
            if record_fields(record) != record_fields(before):
                raise RuntimeError(f"{url}: the loaded record differs from the stored one")
            if record.cache_token != (url, hashlib.sha256(data).hexdigest()) or record.cache_token != before.cache_token:
                raise RuntimeError(f"{url}: cache_token {record.cache_token} is not (url, sha256 of the stored bytes)")
        print(f"storage: serialize {t_serialize:.3f} s, store {t_store:.3f} s (serializes again), fresh load "
              f"{t_load:.3f} s (read, sha256, decode) of {len(built)} records; {raw_bytes / 2**20:.2f} MiB raw, "
              f"{sum(len(b) for b in blobs) / 2**20:.2f} MiB gzipped ({sum(map(len, stored)) / 2**20:.2f} MiB "
              f"stored); every loaded record equals the stored one bit for bit, cache_token (url, sha256) (host)",
              flush=True)

        # retrieval over the loaded records, against the records as built
        cache = DeviceIndexCache()

        def arms(records, device_cache=None):
            return [SemanticRetriever.from_doc_records(embedder, records, k=HYBRID_K, device_cache=device_cache),
                    Bm25Retriever.from_doc_records(records, k=HYBRID_K, device_cache=device_cache)]

        def keys(lists):
            return [[h.key for h in hits] for hits in lists]

        got, ref = {}, {}
        for out, records, device_cache in ((ref, built, None), (got, loaded, cache)):
            semantic, bm25 = arms(records, device_cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out["semantic"] = keys(semantic.retrieve_batch(queries))
            out["bm25"] = keys(bm25.retrieve_batch(queries))
            out["rrf"] = keys(asyncio.run(EnsembleRetriever([semantic, bm25]).aretrieve_batch(queries)))
            torch.cuda.synchronize()
            out["ms"] = (time.perf_counter() - t0) * 1e3
        for arm in ("semantic", "bm25", "rrf"):
            if got[arm] != ref[arm]:
                qi = next(i for i, (a, b) in enumerate(zip(got[arm], ref[arm])) if a != b)
                raise RuntimeError(f"{arm}: query {qi}'s hits over the loaded records {got[arm][qi]} differ from "
                                   f"those over the records as built {ref[arm][qi]}")
        if not cache.wait_warm(REQUEST_TIMEOUT):
            raise RuntimeError("a warm-up thread of the device cache is still running after wait_warm")
        print(f"retrieval of {len(queries)} queries over the {len(loaded)} loaded records (semantic, BM25, RRF; k="
              f"{HYBRID_K}): {got['ms']:.2f} ms, as built {ref['ms']:.2f} ms; hits id for id equal in every arm {card}",
              flush=True)
        launches = {name: fe.LAUNCHES[name] for name in build_launches}

        # a second request for the same records: each load a storage memo hit (the holder's
        # record memo keeps 4 records) or a byte-LRU hit, the indexes device-cache hits, no encode
        hits0, misses0 = cache.hits, cache.misses
        first_counters = {name: telemetry.metrics().total(name) for name in sorted(telemetry.metrics().snapshot())}
        telemetry.metrics().reset()
        t0 = time.perf_counter()
        again = asyncio.run(load_all(holder.get_storage(LocalFileStorage(root))))
        semantic, bm25 = arms(again, cache)
        t_again = time.perf_counter() - t0
        counters = {name: telemetry.metrics().total(name) for name in sorted(telemetry.metrics().snapshot())}
        memo_hits = counters.get("dial_rag.record_memo.validated_hits", 0)
        lru_hits = counters.get("dial_rag.index_cache.hits", 0)
        if memo_hits + lru_hits != len(loaded) or counters.get("dial_rag.index_cache.misses", 0):
            raise RuntimeError(f"the second request's loads: {counters}; expected a memo or LRU hit each")
        if any(a.cache_token != b.cache_token for a, b in zip(again, loaded)):
            raise RuntimeError("the second request's records carry other cache tokens")
        if (cache.hits - hits0, cache.misses - misses0) != (2, 0):
            raise RuntimeError(f"the second request's indexes: {cache.hits - hits0} device-cache hits, "
                               f"{cache.misses - misses0} misses; expected 2 hits")
        if {name: fe.LAUNCHES[name] for name in launches} != launches:
            raise RuntimeError("the second request for stored records launched the encoder")
        print(f"second request for the same {len(again)} records: {t_again * 1e3:.2f} ms, {memo_hits:g} record-memo "
              f"hits and {lru_hits:g} byte-LRU hits, device cache {cache.hits - hits0} hits, 0 misses, no encoder "
              f"launch; storage counters of the store and first load {first_counters}, of the second request "
              f"{counters}; device cache {cache.hits} hits, {cache.misses} misses, {len(cache)} entries, "
              f"{cache.size_bytes / 2**20:.1f} MiB {card}", flush=True)
        del cache, semantic, bm25

    # the encode's device time, and its top-1 against the plain version (after the counted run)
    texts_all = [c.text for chunks in chunk_lists for c in chunks]
    enc_ms = device_ms(torch, lambda: [embedder.embed_documents([c.text for c in chunks])
                                       for chunks in chunk_lists if chunks])
    print(f"document encode: {n_chunks} chunks of {len(docs)} documents in {t_encode:.3f} s of wall, "
          f"{n_batches} encode batches, device {enc_ms:.3f} ms; BM25 text index {t_bm25:.3f} s (host); "
          f"launches {build_launches} ({layers} layers x {n_batches}) {card}", flush=True)
    plain = BgeEmbedder(
        tokenizer=embedder.tokenizer,
        encoder=BertEncoder(embedder.encoder.config, compute_dtype=embedder.encoder.compute_dtype,
                            attention_impl="fused_plain", pooling=embedder.encoder.pooling),
        params=embedder.params, device=embedder.device, query_instruction=embedder.query_instruction,
        model_id=embedder.model_id,
    )
    doc_emb = np.concatenate([np.concatenate(e) for e in embeddings if e])
    plain_emb = plain.embed_documents(texts_all)
    q_kernel = embedder.embed_queries(queries[:N_TOP1])
    q_plain = plain.embed_queries(queries[:N_TOP1])
    ids = np.arange(len(doc_emb))
    tops = [[h[0].chunk_id for h in DenseIndex(RetrievalType.TEXT, [DocEmbeddings(ids, e)], limit=1,
                                                 device=embedder.device).find_batch(q)]
            for e, q in ((doc_emb, q_kernel), (plain_emb, q_plain))]
    ties = top1_agree(tops[0], tops[1], doc_emb, q_kernel, "document indexing")
    print(f"document embeddings, kernel vs plain path: max abs diff {np.abs(doc_emb - plain_emb).max():.3g}; top-1 "
          f"of {N_TOP1} queries equal ({ties} near-ties below {TIE_GAP})")
    print(f"document indexing phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def concurrent_serving_phase(torch, card, embedder, li_emb, record, queries) -> dict:
    """``record``'s four arms (semantic, expanded BM25, chargram, late
    interaction in bfloat16; k = 7), the record stored through
    ``IndexStorage`` and loaded back, rebuilt per request through one
    ``DeviceIndexCache``, 64 requests on one event loop against the same
    64 one at a time; the cache's eviction rule on a second cache. Returns
    kernels 1-2's launches in the timed concurrent wave."""
    import asyncio
    import dataclasses

    import numpy as np

    from dial_rag_tpu_torch.index.device_cache import DeviceIndexCache
    from dial_rag_tpu_torch.ops import fused_encoder as fe
    from dial_rag_tpu_torch.retrieval import (
        Bm25Retriever,
        ChargramRetriever,
        EnsembleRetriever,
        LateInteractionRetriever,
        SemanticRetriever,
    )
    from dial_rag_tpu_torch.runtime import micro_batcher as mb
    from dial_rag_tpu_torch.documents.model import FORMAT_VERSION, IndexSettings
    from dial_rag_tpu_torch.storage import IndexStorage, LocalFileStorage
    from dial_rag_tpu_torch.storage.storage import link_to_index_url
    from dial_rag_tpu_torch.text.word_vectors import QueryExpansionConfig

    t_phase = time.perf_counter()
    # the record through storage: the load stamps its cache token (url, sha256 of the stored bytes)
    settings = IndexSettings(indexes={"embedder": {"model_id": embedder.model_id}})
    record = dataclasses.replace(record, format_version=FORMAT_VERSION, index_settings=settings)
    url = link_to_index_url("files/chip-smoke/main-path", "chip-smoke")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_index_") as root:
        t0 = time.perf_counter()
        asyncio.run(IndexStorage(LocalFileStorage(root)).store(url, record))
        t_store = time.perf_counter() - t0
        nbytes = (Path(root) / url).stat().st_size
        t0 = time.perf_counter()
        record = asyncio.run(IndexStorage(LocalFileStorage(root)).load(url, settings))
        t_load = time.perf_counter() - t0
    if record is None or record.cache_token[0] != url:
        raise RuntimeError(f"the stored four-arm record did not load back with its cache token: {record}")
    print(f"concurrent serving record through storage: {nbytes / 2**20:.1f} MiB stored in {t_store:.2f} s, loaded "
          f"in {t_load:.2f} s; cache_token {record.cache_token[1][:16]}... (host)", flush=True)
    expansion = QueryExpansionConfig()
    # the late-interaction arm last: it is built last, so a cache below its
    # bytes keeps it alone (gate 4)
    names = ("semantic", "bm25", "chargram", "late_interaction")
    arm_hits: dict = {}  # (arm, query) -> the arm's hits in the last request of the query

    class Arm:
        """An arm whose hits the gates read after the fusion."""

        def __init__(self, name, inner):
            self.name, self.inner = name, inner

        async def aretrieve(self, query):
            hits = await self.inner.aretrieve(query)
            arm_hits[(self.name, query)] = hits
            return hits

    def arms(cache):
        return [Arm(name, inner) for name, inner in zip(names, (
            SemanticRetriever.from_doc_records(embedder, [record], k=HYBRID_K, device_cache=cache),
            Bm25Retriever.from_doc_records([record], k=HYBRID_K, device_cache=cache, expansion_config=expansion),
            ChargramRetriever.from_doc_records([record], k=HYBRID_K, device_cache=cache),
            LateInteractionRetriever.from_doc_records(li_emb, [record], k=HYBRID_K, max_chunk_tokens=LI_MAX_TOKENS,
                                                      storage_dtype="bfloat16", device_cache=cache),
        ))]

    async def request(query, cache):
        t0 = time.perf_counter()
        hits = await EnsembleRetriever(arms(cache)).aretrieve(query)
        return hits, time.perf_counter() - t0

    async def concurrent(cache):
        return await asyncio.gather(*(asyncio.wait_for(request(q, cache), REQUEST_TIMEOUT) for q in queries))

    async def serial(cache, some=queries):
        return [await asyncio.wait_for(request(q, cache), REQUEST_TIMEOUT) for q in some]

    def served(run, cache):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = asyncio.run(run(cache))
        torch.cuda.synchronize()
        return [hits for hits, _ in out], [dt for _, dt in out], time.perf_counter() - t0

    def held(c):  # the cached objects by their config key's name
        return {key[1][0]: idx for key, idx in c._entries.items()}

    cache = DeviceIndexCache()
    t0 = time.perf_counter()
    served(concurrent, cache)  # warm-up wave: builds the cache
    t_warm = time.perf_counter() - t0
    if not cache.wait_warm(REQUEST_TIMEOUT):
        raise RuntimeError("a warm-up thread is still running after wait_warm")
    sizes = {name: f"{idx.nbytes / 2**20:.1f} MiB" for name, idx in held(cache).items()}
    print(f"concurrent serving: cache built in the warm-up wave ({t_warm:.2f} s): {len(cache)} objects, "
          f"{cache.size_bytes / 2**20:.1f} MiB of {cache.capacity_bytes / 2**20:.0f} MiB: {sizes} {card}", flush=True)

    torch.cuda.synchronize()
    fe.reset_launches()
    mb.reset_counts()
    fused, lat, wall = served(concurrent, cache)
    launches = {name: fe.LAUNCHES[name] for name in ("fused_attention_block", "fused_ffn_block")}
    waves, items = dict(mb.WAVES), dict(mb.ITEMS)
    coalesced = dict(arm_hits)
    lone, lone_lat, lone_wall = served(serial, cache)
    if not cache.wait_warm(REQUEST_TIMEOUT):
        raise RuntimeError("a warm-up thread is still running after wait_warm")

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs) * 1e3, p))

    n = len(queries)
    print(f"concurrent serving, {n} requests (four-arm RRF, k={HYBRID_K}): concurrent {n / wall:.1f} requests/s "
          f"({wall * 1e3:.2f} ms), latency p50 {pct(lat, 50):.2f} ms, p99 {pct(lat, 99):.2f} ms; serial "
          f"{n / lone_wall:.1f} requests/s ({lone_wall * 1e3:.2f} ms), latency p50 {pct(lone_lat, 50):.2f} ms, "
          f"p99 {pct(lone_lat, 99):.2f} ms {card}")
    per_wave = ", ".join(f"{name} {waves[name]} waves, {items[name] / waves[name]:.2f} items a wave"
                         for name in sorted(waves))
    print(f"concurrent serving waves: {per_wave} {card}", flush=True)

    # gate 2: coalesced encodes, and every encode through kernels 1-2
    encodes = waves["query_encode"] * embedder.encoder.config.num_layers + n * li_emb.encoder.config.num_layers
    if waves["query_encode"] > MAX_QUERY_WAVES or items["query_encode"] != n:
        raise RuntimeError(f"{n} requests took {waves['query_encode']} query-encode waves (at most "
                           f"{MAX_QUERY_WAVES}) for {items['query_encode']} items")
    for name, got in launches.items():
        if got != encodes:
            raise RuntimeError(f"{name} launched {got} times in the concurrent wave, expected {encodes} "
                               f"(layers x ({waves['query_encode']} encode waves + {n} MaxSim token encodes))")

    # gate 1: each request's fused hits are its lone run's. BM25 and chargram
    # score a query with the same bits batched and alone, so their lists must
    # be equal. The semantic and MaxSim arms may swap two hits only within
    # twice the largest change of a hit's score, coalesced against lone, that
    # this run reads: a swap moves each of the two scores by half the gap.
    lone_arms = dict(arm_hits)
    score_drift = {}
    for name in ("semantic", "late_interaction"):
        score_drift[name] = 0.0
        for q in queries:
            lone_score = {h.key: h.score for h in lone_arms[(name, q)]}
            for h in coalesced[(name, q)]:
                if h.key in lone_score:
                    score_drift[name] = max(score_drift[name], abs(float(h.score) - float(lone_score[h.key])))
    excused, tied = collections.Counter(), 0
    for qi, q in enumerate(queries):
        differ = []
        for name in names:
            a, b = coalesced[(name, q)], lone_arms[(name, q)]
            if [h.key for h in a] == [h.key for h in b]:
                continue
            if name not in score_drift:
                raise RuntimeError(f"concurrent request {qi}: the {name} arm's hits differ coalesced and alone")
            score = {h.chunk_id: float(h.score) for h in a + b}

            def gap_ok(_, x, y, limit=2 * score_drift[name], score=score):
                return abs(score[x] - score[y]) <= limit

            list_near_ties([[h.chunk_id for h in a]], [[h.chunk_id for h in b]], gap_ok,
                           f"concurrent serving {name} arm, query {qi}")
            differ.append(name)
        excused.update(differ)
        if [h.key for h in fused[qi]] != [h.key for h in lone[qi]]:
            tied += 1
            if not differ:
                raise RuntimeError(f"concurrent request {qi}: its fused list differs from its lone run's, "
                                   "every arm equal")
    wave_out, n_real = embedder._embed_queries_wave(queries)
    rows = wave_out[:n_real].cpu().numpy()
    lone_rows = np.stack([embedder._embed_queries_wave([q])[0][0].cpu().numpy() for q in queries])
    drift = float(np.abs(rows - lone_rows).max())
    if drift > MAXSIM_ATOL:
        raise RuntimeError(f"the coalesced and the lone dense query rows differ by {drift} (limit {MAXSIM_ATOL})")
    drifts = ", ".join(f"{name} {d:.3g}" for name, d in score_drift.items())
    print(f"concurrent serving gates: fused hits = lone hits on {n - tied} of {n} requests; arm lists that "
          f"differ within twice their score drift (swaps excused): {dict(excused) or 0}; score drift coalesced vs "
          f"lone: {drifts}; BM25 and chargram lists equal on all {n}; dense query rows coalesced vs lone within "
          f"{drift:.3g} (limit {MAXSIM_ATOL}); {waves['query_encode']} query-encode waves (limit "
          f"{MAX_QUERY_WAVES}); launches {launches} = {encodes}", flush=True)

    # gate 3: one miss per cached object
    objects = len(names) + 1  # the four arms' indexes and the word vectors
    lookups = 3 * n * objects  # warm-up, concurrent and serial waves
    if (cache.misses, cache.hits, len(cache)) != (objects, lookups - objects, objects):
        raise RuntimeError(f"cache: {cache.misses} misses, {cache.hits} hits, {len(cache)} entries; expected "
                           f"{objects} misses of {lookups} lookups")
    if cache.size_bytes > cache.capacity_bytes:
        raise RuntimeError(f"cache holds {cache.size_bytes} bytes over its capacity {cache.capacity_bytes}")
    print(f"concurrent serving cache: {cache.misses} misses, {cache.hits} hits of {lookups} lookups, "
          f"{cache.size_bytes / 2**20:.1f} MiB held; no warm-up thread alive {card}")

    # a wave of one encode output's rows: scanned in place against stacked
    # copies of the same rows (the dense arm's two wave paths)
    from dial_rag_tpu_torch.runtime.micro_batcher import wave_rows

    tagged = wave_rows(wave_out, n_real)
    copies = [row.clone() for row in tagged]
    dense = held(cache)["semantic"]
    if dense._scan_wave(tagged) != dense._scan_wave(copies):
        raise RuntimeError("a dense wave scanned in place and the same rows stacked give different hits")
    scan_ms = {"in place": [], "stacked": []}
    for _ in range(15):
        for how, wave in (("in place", tagged), ("stacked", copies)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dense._scan_wave(wave)
            torch.cuda.synchronize()
            scan_ms[how].append((time.perf_counter() - t0) * 1e3)
    medians = ", ".join(f"{how} {float(np.median(v)):.3f} ms" for how, v in scan_ms.items())
    print(f"dense wave of {n_real} rows, wall per _scan_wave (median of 15, alternated): {medians} {card}",
          flush=True)

    # the scan batchers' window: a wall-clock 2 ms against the default, one
    # loop iteration (SCAN_WINDOW_S); a concurrent wave and 16 lone requests each
    default_window = mb.SCAN_WINDOW_S

    async def serial16(c):
        return await serial(c, queries[:16])

    for window in (0.002, default_window):
        mb.SCAN_WINDOW_S = window
        try:
            mb.reset_counts()
            _, w_lat, w_wall = served(concurrent, cache)
            w_waves = ", ".join(f"{k} {v}" for k, v in sorted(mb.WAVES.items()))
            _, s_lat, _ = served(serial16, cache)
        finally:
            mb.SCAN_WINDOW_S = default_window
        print(f"scan window {window * 1e3:g} ms: concurrent {n / w_wall:.1f} requests/s, p50 {pct(w_lat, 50):.2f} "
              f"ms, waves {w_waves}; lone requests p50 {pct(s_lat, 50):.2f} ms, p99 {pct(s_lat, 99):.2f} ms "
              f"{card}", flush=True)

    # where one coalesced wave spends the card's time, beside its wall time
    t0 = time.perf_counter()
    dev_ms = device_profile(torch, lambda: asyncio.run(concurrent(cache)), f"one coalesced wave of {n} requests",
                            card, top=10, cpu=False)
    if not dev_ms > 0:
        raise RuntimeError("the profile of a coalesced wave shows no device time")
    print(f"one coalesced wave of {n} requests: device {dev_ms:.3f} ms against the timed wave's wall "
          f"{wall * 1e3:.2f} ms: the card idles {100 * (1 - dev_ms / (wall * 1e3)):.1f}% of it (under the "
          f"profiler, device only, wall {(time.perf_counter() - t0) * 1e3:.2f} ms) {card}", flush=True)

    # gate 4: a cache below the late-interaction index's bytes keeps it alone
    small = DeviceIndexCache(capacity_bytes=held(cache)["late_interaction"].nbytes - 1)
    asyncio.run(asyncio.wait_for(request(queries[0], small), REQUEST_TIMEOUT))
    kept = list(held(small))
    if kept != ["late_interaction"] or small.misses != objects:
        raise RuntimeError(f"a cache of {small.capacity_bytes} bytes kept {kept} after {small.misses} misses")
    again, _ = asyncio.run(asyncio.wait_for(request(queries[0], small), REQUEST_TIMEOUT))
    if (small.misses, small.hits) != (2 * objects, 0) or [h.key for h in again] != [h.key for h in lone[0]]:
        raise RuntimeError(f"the evicting cache: {small.misses} misses, {small.hits} hits; the rebuilt request's "
                           f"hits equal the lone run's: {[h.key for h in again] == [h.key for h in lone[0]]}")
    if not small.wait_warm(REQUEST_TIMEOUT):
        raise RuntimeError("a warm-up thread of the evicting cache is still running after wait_warm")
    print(f"concurrent serving eviction: a {small.capacity_bytes / 2**20:.1f} MiB cache kept {kept} alone; the next "
          f"request rebuilt all {objects} objects ({small.misses} misses, {small.hits} hits) and its hits are the "
          f"lone run's")
    del small
    torch.cuda.empty_cache()
    print(f"concurrent serving phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def load_fake_dial():
    """``tests/utils/fake_dial_stdlib.py`` (standard library and numpy), loaded from its file."""
    spec = importlib.util.spec_from_file_location("fake_dial_stdlib", FAKE_DIAL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SERVICE_TYPES = {"pdf": "application/pdf", "md": "text/markdown", "txt": "text/plain", "csv": "text/csv",
                 "docx": "application/vnd.openxmlformats-officedocument.wordprocessingml.document",
                 "pptx": "application/vnd.openxmlformats-officedocument.presentationml.presentation",
                 "xlsx": "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet"}


def sse_events(raw: bytes) -> list:
    """The payloads of an SSE body, each event parsed ("[DONE]" as is); a
    malformed event raises."""
    text = raw.decode("utf-8")
    if not text.endswith("\n\n"):
        raise RuntimeError(f"the SSE body does not end with a blank line: {text[-80:]!r}")
    events = []
    for block in text[:-2].split("\n\n"):
        if not block.startswith("data: ") or "\n" in block:
            raise RuntimeError(f"malformed SSE event {block[:120]!r}")
        payload = block[len("data: "):]
        events.append(payload if payload == "[DONE]" else json.loads(payload))
    return events


def service_phase(torch, card, texts) -> dict:
    """The port's DIAL app (``service/app.py`` on ``service/http.py``) booted
    through ``load_app_config`` on config/zero_egress_tuned.yaml (semantic,
    expanded BM25, chargram and MaxSim on alps-maxsim, CombMNZ), serving on
    an ephemeral port of 127.0.0.1 against the standard-library fake Dial
    Core, driven through the port's own HTTP client: two indexing requests
    over every attachment, SERVICE_RETRIEVALS retrieval requests of
    SERVICE_GROUP_DOCS attachments one at a time and all at once, a streamed
    and a two-turn rag request, the error cases, /health and /configuration.
    Returns kernels 1-2's launches in the first indexing request."""
    import asyncio

    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.index.device_cache import DeviceIndexCache
    from dial_rag_tpu_torch.ops import fused_encoder as fe
    from dial_rag_tpu_torch.service import app as app_module
    from dial_rag_tpu_torch.service import documents as documents_module
    from dial_rag_tpu_torch.service import http
    from dial_rag_tpu_torch.service.citations import rewrite_citations
    from dial_rag_tpu_torch.service.config import Configuration, load_app_config, merge_config
    from dial_rag_tpu_torch.service.retrieval_chain import create_retriever
    from dial_rag_tpu_torch.storage.storage import IndexStorage

    t_phase = time.perf_counter()
    if Path.cwd().resolve() != ROOT:
        raise RuntimeError(f"run chip_smoke.py from the checkout's root ({ROOT}): the preset names its "
                           "checkpoints relative to it")
    extra = synthetic_texts(load_vocab(), OFFICE_TEXTS * sum(n for _, n in OTHER_DOCS), seed=2)
    docs = document_corpus(texts[:SERVICE_PDF_TEXTS], extra, pdf_docs=SERVICE_PDF_DOCS)
    links = [f"files/chip-smoke/{name}" for name, _, _ in docs]
    fake_dial = load_fake_dial()
    fake = fake_dial.FakeDialCore()
    dial_url = fake.start_sync()
    for (name, data, _), link in zip(docs, links):
        fake.add_file(link, data, SERVICE_TYPES[name.rsplit(".", 1)[1]])
    text_only = {"qa_chain": {"chat_chain": {"num_page_images_to_use": 0}}}

    def message(content, attach=()):
        return {"role": "user", "content": content,
                "custom_content": {"attachments": [{"url": link} for link in attach]}}

    def body(messages, kind=None, stream=False):
        configuration = dict(text_only, **({"request": {"type": kind}} if kind else {}))
        return {"messages": messages, "stream": stream, "custom_fields": {"configuration": configuration}}

    # the stages of an indexing request: each stage's calls as (start, end) on
    # the host clock, reported as the wall time during which one ran (the
    # documents run concurrently, so the stages overlap)
    spans = collections.defaultdict(list)
    restore = []

    def timed(owner, attr, key, is_async, static=False):
        original = getattr(owner, attr)

        if is_async:
            async def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return await original(*args, **kwargs)
                finally:
                    spans[key].append((t0, time.perf_counter()))
        else:
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return original(*args, **kwargs)
                finally:
                    spans[key].append((t0, time.perf_counter()))

        restore.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, staticmethod(wrapper) if static else wrapper)

    loaded_records = {}
    original_load_documents = app_module.load_documents

    async def capturing_load_documents(request_context, embedder, tasks, *args, **kwargs):
        results = await original_load_documents(request_context, embedder, tasks, *args, **kwargs)
        loaded_records[tuple(t.attachment_link.dial_link for t in tasks)] = [
            getattr(r, "doc_record", None) for r in results]
        return results

    with tempfile.TemporaryDirectory(prefix="chip_smoke_service_") as root:
        app_config = load_app_config(environ={"DIAL_RAG__CONFIG_PATH": SERVICE_PRESET, "DIAL_URL": dial_url,
                                              "DIAL_RAG__INDEX_STORAGE__LOCAL_STORAGE_PATH": root})
        t0 = time.perf_counter()
        app = app_module.create_app(app_config)
        t_boot = time.perf_counter() - t0
        application = app["dial_rag"]
        timed(documents_module, "load_attachment", "download", True)
        timed(documents_module, "parse_document", "parse", False)
        timed(BgeEmbedder, "embed_documents", "encode", False)
        timed(BgeEmbedder, "embed_documents_tokens", "encode", False)
        timed(IndexStorage, "store", "store", True)
        app_module.load_documents = capturing_load_documents
        try:
            result = asyncio.run(serve_requests(torch, card, http, app, application, fake, links, docs, message,
                                                body, spans, loaded_records, create_retriever,
                                                rewrite_citations, merge_config, Configuration, fe,
                                                DeviceIndexCache))
        finally:
            for owner, attr, value in restore:
                setattr(owner, attr, value)
            app_module.load_documents = original_load_documents
            fake.stop_sync()
    tensors = [t for emb in [application.embedder, *application._li_embedders.values()]
               for t in torch_leaves(emb.params)]
    if not tensors or any(t.device.type != "cuda" for t in tensors):
        raise RuntimeError("a tensor of the app's embedders is not on the card")
    print(f"service: the app's embedders (alps-semantic and {len(application._li_embedders)} late-interaction "
          f"checkpoint) hold {len(tensors)} tensors, every one on cuda; app boot {t_boot:.2f} s {card}")
    print(f"service phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return result


def torch_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in torch_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in torch_leaves(v)]
    return [tree] if hasattr(tree, "device") else []


def load_vocab() -> dict:
    from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer

    return WordPieceTokenizer.from_vocab_file(str(CHECKPOINT / "vocab.txt")).vocab


def busy_seconds(spans) -> float:
    """The time during which at least one of ``spans`` (start, end) ran."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


async def serve_requests(torch, card, http, app, application, fake, links, docs, message, body, spans,
                         loaded_records, create_retriever, rewrite_citations, merge_config,
                         Configuration, fe, DeviceIndexCache) -> dict:
    """The service phase's requests and gates, on one event loop (see
    ``service_phase``)."""
    import numpy as np

    server = await http.serve(app)
    base = f"http://127.0.0.1:{server.port}/"
    headers = {"api-key": "chip-smoke"}
    try:
        async with http.ClientSession(base_url=base, timeout=http.ClientTimeout(total=600, sock_read=300)) as s:

            async def post(payload, raw=False):
                kw = {"data": payload} if raw else {"json": payload}
                async with s.post(CHAT_PATH, headers=headers, **kw) as r:
                    return r.status, await r.read()

            def custom_of(status, raw):
                if status != 200:
                    raise RuntimeError(f"request failed: {status} {raw[:400]!r}")
                return json.loads(raw)["choices"][0]["message"]

            # indexing, twice
            torch.cuda.synchronize()
            fe.reset_launches()
            t0 = time.perf_counter()
            first = custom_of(*await post(body([message("", links)], "indexing")))
            torch.cuda.synchronize()
            t_index = time.perf_counter() - t0
            launches = {name: fe.LAUNCHES[name] for name in ("fused_attention_block", "fused_ffn_block")}
            stages = first["custom_content"]["stages"]
            result = json.loads(first["custom_content"]["attachments"][-1]["data"])
            if result != {"indexing_result": {}}:
                raise RuntimeError(f"the indexing request reported errors: {str(result)[:600]}")
            index_atts = [a for a in first["custom_content"]["attachments"] if a.get("type", "").startswith(
                "application/x.aidial-rag.index.")]
            if sorted(a["reference_url"] for a in index_atts) != sorted(links):
                raise RuntimeError(f"{len(index_atts)} index attachments for {len(links)} documents")
            if not all(launches.values()):
                raise RuntimeError(f"the indexing request launched no encoder kernel: {launches}")
            failed = [st["name"] for st in stages if st.get("status") == "failed" and "Load indexes" not in st["name"]]
            if failed:
                raise RuntimeError(f"indexing stages failed: {failed}")
            chunks = sum(int(st["content"].rsplit("Chunks: ", 1)[1].split()[0]) for st in stages
                         if st["name"].startswith("Processing document"))
            split = {key: busy_seconds(spans[key]) for key in ("download", "parse", "encode", "store")}
            print(f"service indexing request: {len(links)} attachments ({SERVICE_PDF_DOCS} PDFs of "
                  f"{SERVICE_PDF_TEXTS // SERVICE_PDF_DOCS} pages, {len(links) - SERVICE_PDF_DOCS} office, Markdown, "
                  f"text and CSV documents), {chunks} chunks, {t_index:.3f} s of wall; the wall during which each "
                  f"stage ran (stages overlap across documents): download {split['download']:.3f} s, parse "
                  f"{split['parse']:.3f} s, encode (semantic + MaxSim tokens) {split['encode']:.3f} s, store "
                  f"{split['store']:.3f} s; kernels 1-2 launches {launches}; no indexing error {card}", flush=True)
            fe.reset_launches()
            t0 = time.perf_counter()
            again = custom_of(*await post(body([message("", links)], "indexing")))
            t_again = time.perf_counter() - t0
            names = [st["name"] for st in again["custom_content"]["stages"]]
            if any(n.startswith("Processing document") for n in names) or any(fe.LAUNCHES.values()):
                raise RuntimeError(f"the second indexing request processed documents again: {names[:6]}, "
                                   f"launches {dict(fe.LAUNCHES)}")
            print(f"service second indexing request: {t_again:.3f} s, every record from storage or the memo, "
                  f"no encoder launch {card}", flush=True)

            # retrieval: groups of attachments, each request's chunks against create_retriever's hits
            pdf_pages = SERVICE_PDF_TEXTS // SERVICE_PDF_DOCS
            groups, requests = [], []
            for g in range(SERVICE_GROUPS):
                others = [SERVICE_PDF_DOCS + (2 * g + j) % (len(links) - SERVICE_PDF_DOCS) for j in (0, 1, 5)]
                groups.append([g % SERVICE_PDF_DOCS] + others)
            for i in range(SERVICE_RETRIEVALS):
                group = groups[i % SERVICE_GROUPS]
                page = docs[group[0]][2][(7 * i) % pdf_pages].split()
                j = (13 * i) % max(1, len(page) - 8)
                requests.append((group, " ".join(page[j : j + 8])))
            request_config = merge_config(merge_config(
                Configuration(), application.app_config.request.model_dump(exclude_unset=True)),
                {**body([])["custom_fields"]["configuration"], "request": {"type": "retrieval"}})

            stage_seconds = []

            async def retrieve(group, query):
                t0 = time.perf_counter()
                status, raw = await post(body([message(query, [links[d] for d in group])], "retrieval"))
                ms = (time.perf_counter() - t0) * 1e3
                got = custom_of(status, raw)
                att = [a for a in got["custom_content"]["attachments"]
                       if a.get("type") == "application/x.aidial-rag.retrieval-response+json"]
                seconds = collections.Counter()
                for st in got["custom_content"]["stages"]:
                    m = re.fullmatch(r"(.*?)(?: '.*')? \[(\d+\.\d+)s\]", st["name"])
                    if m:
                        seconds[m.group(1)] += float(m.group(2))
                stage_seconds.append(seconds)
                return ms, json.loads(att[0]["data"])["chunks"]

            # the reference retrievers' indexes, built once a group: a cache of their own
            reference_cache = DeviceIndexCache()

            async def reference(group, query):
                records = loaded_records[tuple(links[d] for d in group)]
                retriever = create_retriever(
                    application.embedder, application.app_config.dial_url, "chip-smoke", records,
                    request_config.indexing, device_cache=reference_cache,
                    li_embedder=application._get_li_embedder(request_config),
                    ensemble_weights=request_config.retrieval.ensemble_weights,
                    fusion_method=request_config.retrieval.fusion_method,
                    fusion_norm=request_config.retrieval.fusion_norm,
                    fusion_depth=request_config.retrieval.fusion_depth,
                    query_expansion=request_config.retrieval.query_expansion,
                    index_dtype=application.app_config.parallel.index_dtype,
                )
                hits = await retriever.aretrieve(query)
                return [(links[group[h.doc_id]], records[h.doc_id].chunks[h.chunk_id].text,
                         records[h.doc_id].chunks[h.chunk_id].metadata.get("page_number")) for h in hits]

            def as_hits(chunks_):
                return [(c["attachment_url"], c["text"], (c["page"] or {}).get("number")) for c in chunks_]

            await retrieve(*requests[0])  # first use of each group's records: loads and index builds
            for group in groups[1:]:
                await retrieve(group, requests[0][1])
            stage_seconds.clear()
            serial = [await retrieve(group, query) for group, query in requests]
            stages_serial = {name: float(np.median([c[name] for c in stage_seconds]))
                             for name in sorted({n for c in stage_seconds for n in c})}
            t0 = time.perf_counter()
            concurrent = await asyncio.gather(*(retrieve(group, query) for group, query in requests))
            t_concurrent = time.perf_counter() - t0
            t_serial = sum(ms for ms, _ in serial) / 1e3
            for i, ((group, query), (_, a), (_, b)) in enumerate(zip(requests, serial, concurrent)):
                want = await reference(group, query)
                if not want:
                    raise RuntimeError(f"retrieval {i}: no hit for {query!r}")
                for what, got_chunks in (("one at a time", a), ("all at once", b)):
                    if as_hits(got_chunks) != want:
                        raise RuntimeError(f"retrieval {i} ({what}): the response's chunks differ from "
                                           f"create_retriever's hits over the loaded records for {query!r}")

            def pct(values, q):
                return float(np.percentile(values, q))

            lat_s, lat_c = [ms for ms, _ in serial], [ms for ms, _ in concurrent]
            print(f"service retrieval: {SERVICE_RETRIEVALS} requests of {SERVICE_GROUP_DOCS} attachments "
                  f"({SERVICE_GROUPS} groups), one at a time {SERVICE_RETRIEVALS / t_serial:.1f} requests/s, p50 "
                  f"{pct(lat_s, 50):.2f} ms, p99 {pct(lat_s, 99):.2f} ms; all at once "
                  f"{SERVICE_RETRIEVALS / t_concurrent:.1f} requests/s, p50 {pct(lat_c, 50):.2f} ms, p99 "
                  f"{pct(lat_c, 99):.2f} ms; every response's chunks = create_retriever's hits over the loaded "
                  f"records, in order {card}", flush=True)
            print("service retrieval one at a time, median s a request by stage (the stages' own timings, "
                  "summed over a request's documents): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                                      stages_serial.items()) + f" {card}",
                  flush=True)

            # a streamed rag request whose scripted answer cites [1] and [2]
            group, query = requests[1]
            answer = f"The manual answers it <[1]>, and a second part agrees <[2]>. Query: {query[:20]}"
            fake.script_llm(answer)
            t0 = time.perf_counter()
            first_content = None
            async with s.post(CHAT_PATH, headers=headers,
                              json=body([message(query, [links[d] for d in group])], stream=True)) as r:
                if r.status != 200:
                    raise RuntimeError(f"streamed rag request: {r.status}")
                raw = bytearray()
                async for line in r.content:
                    raw += line
                    if first_content is None and line.startswith(b"data: {") and b'"content":"' in line:
                        delta = json.loads(line[len(b"data: "):])["choices"][0]["delta"]
                        if delta.get("content"):
                            first_content = time.perf_counter() - t0
            t_rag = time.perf_counter() - t0
            events = sse_events(bytes(raw))
            if events[-1] != "[DONE]" or events[-2]["choices"][0]["finish_reason"] != "stop":
                raise RuntimeError(f"the stream does not end with a finish chunk and [DONE]: {events[-2:]}")
            content = "".join(e["choices"][0]["delta"].get("content", "") for e in events[:-1])
            found = await reference(group, query)

            async def rewritten():
                async def one():
                    yield answer
                out = []
                async for piece, used in rewrite_citations(one(), len(found)):
                    if used is None:
                        out.append(piece)
                return "".join(out)

            expected = await rewritten()
            if content != expected or "[1]" not in content or "[2]" not in content:
                raise RuntimeError(f"streamed content {content!r} is not the rewritten answer {expected!r}")
            refs = [a for e in events[:-1] for a in e["choices"][0]["delta"].get("custom_content", {}).get(
                "attachments", []) if a.get("title", "").startswith(("[1] ", "[2] "))]
            if [a["data"] for a in refs] != [found[0][1] or " ", found[1][1] or " "]:
                raise RuntimeError(f"the reference attachments are not hits 1 and 2: {[a['title'] for a in refs]}")
            print(f"service streamed rag request: {len(events)} SSE events, the last [DONE]; first content "
                  f"chunk {first_content * 1e3:.1f} ms, whole answer {t_rag * 1e3:.1f} ms; content = the scripted "
                  f"answer with rewritten citations, reference attachments [1] and [2] {card}", flush=True)

            # a two-turn rag request: the standalone question comes from a scripted tool call
            group, query = requests[2]
            standalone = requests[3][1]
            fake.script_llm(standalone, "The answer <[1]>.")
            turns = [message("first question", [links[d] for d in group]),
                     {"role": "assistant", "content": "an earlier answer [1]"}, message(query)]
            two = custom_of(*await post(body(turns)))
            stage = next(st for st in two["custom_content"]["stages"] if st["name"].startswith("Standalone"))
            top = (await reference(group, standalone))[0]
            cited = [a for a in two["custom_content"].get("attachments", []) if a["title"].startswith("[1] ")]
            if stage.get("content") != standalone or [a["data"] for a in cited] != [top[1]]:
                raise RuntimeError(f"the two-turn request did not retrieve with the standalone question: "
                                   f"{stage.get('content')!r}, cited {[a['title'] for a in cited]}")
            tool_calls = [r for r in fake.llm_requests if r.get("tool_choice")]
            print(f"service two-turn rag request: standalone question from the scripted tool call "
                  f"({len(tool_calls)} tool call), cited [1] = create_retriever's top hit for it {card}", flush=True)

            # the error cases, /health and /configuration
            for what, payload, status, want in SERVICE_ERRORS:
                got_status, raw = await post(payload, raw=isinstance(payload, bytes))
                got = json.loads(raw)
                prefix = want["error"]["message"]
                ok = got_status == status and {k: v for k, v in got["error"].items() if k != "message"} == {
                    k: v for k, v in want["error"].items() if k != "message"}
                ok = ok and (got["error"]["message"].startswith(prefix) if prefix.endswith(": ")
                             else got == want)
                if not ok:
                    raise RuntimeError(f"error case {what}: {got_status} {got}, expected {status} {want}")
            async with s.get("health") as r:
                if (r.status, await r.json()) != (200, {"status": "ok"}):
                    raise RuntimeError("/health did not answer")
            for method in ("get", "post"):
                async with getattr(s, method)("openai/deployments/dial-rag/configuration") as r:
                    if (r.status, await r.json()) != (200, Configuration.model_json_schema()):
                        raise RuntimeError(f"/configuration ({method}) is not Configuration.model_json_schema()")
            print(f"service: {len(SERVICE_ERRORS)} error cases with the JAX package's status and body; /health; "
                  f"/configuration (GET, POST) = Configuration.model_json_schema()", flush=True)
    finally:
        await server.close()
    return launches


def main() -> int:
    phase("device")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "dial_rag_tpu_torch").is_dir() or not CHECKPOINT.is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from dial_rag_tpu_torch.index.dense_index import DenseIndex
    from dial_rag_tpu_torch.index.records import RetrievalType
    from dial_rag_tpu_torch.models import tokenizer as wordpiece
    from dial_rag_tpu_torch.models.bert import BertEncoder, embed_tokens
    from dial_rag_tpu_torch.ops import fused_encoder as fe
    from dial_rag_tpu_torch.native.build import load_native
    from dial_rag_tpu_torch.ops._build import build_kernels
    from dial_rag_tpu_torch.training.loop import pairs_to_batches
    from dial_rag_tpu_torch.documents.model import build_chunks_list
    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"count {torch.cuda.device_count()}")
    print(smi, flush=True)
    dev = torch.device("cuda")

    phase("build")
    def build_cores() -> float:
        t0 = time.perf_counter()
        for name in ("keywords", "wordpiece", "chargram"):
            load_native(name)
        return time.perf_counter() - t0

    # the C++ host cores (g++) build while nvcc builds the kernels; a failed build raises
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cores = pool.submit(build_cores)
        build = build_kernels()
        print(f"build: C++ host cores native/keywords.cpp, native/wordpiece.cpp and native/chargram.cpp (g++) "
              f"{cores.result():.2f} s")
    print(f"build: {build.seconds:.2f} s (nvcc, all sources in parallel)"
          if build.seconds else "build: found built for these sources in dial_rag_tpu_torch/_build")
    for stem, lines in build.ptxas.items():
        for line in lines:
            print(f"ptxas {stem}: {line}")
    kernel_resources(build)
    sys.stdout.flush()

    phase("kernels")
    from dial_rag_tpu_torch.models.bert import BertConfig, init_params, prepare_params

    embedder = BgeEmbedder.from_hf_checkpoint(str(CHECKPOINT), compute_dtype=torch.bfloat16, device="cuda")
    cfg = embedder.encoder.config
    oracle = [c["text"] for c in json.loads(ORACLE_CHUNKS.read_text())]
    texts = oracle + synthetic_texts(embedder.tokenizer.vocab, N_DOCS - len(oracle), seed=0)
    b, s, hid = 128, 256, cfg.hidden_size
    ids, mask = embedder.tokenizer.encode_batch(texts[len(oracle) : len(oracle) + b])
    assert ids.shape == (b, s), ids.shape
    ids_t = torch.from_numpy(ids).to(dev, dtype=torch.long)
    mask_t = torch.from_numpy(mask).to(dev)
    # the seeded encoder at BAAI/bge-base-en-v1.5's widths, with the
    # alps-semantic vocabulary and CLS pooling
    base_cfg = BertConfig(vocab_size=cfg.vocab_size, type_vocab_size=cfg.type_vocab_size, **BASE_WIDTHS)
    base_params = init_params(base_cfg, torch.Generator().manual_seed(0))
    bge_base = BgeEmbedder(tokenizer=embedder.tokenizer,
                           encoder=BertEncoder(base_cfg, compute_dtype=torch.bfloat16, pooling="cls"),
                           params=base_params, device="cuda", model_id="bge-base-seeded")
    # kernels 1-3 in each instantiation at B=128, S=256: bge-small widths on
    # the checkpoint's layer 0, bge-base widths on the seeded encoder's
    rows = {}
    # main-path launches by kernels JSON row, read by the phases below
    launched = collections.Counter()
    for params, heads in ((embedder.params, cfg.num_heads), (bge_base.params, base_cfg.num_heads)):
        for dtype in (torch.bfloat16, torch.float32):
            layer = {name: {k: v.to(dtype) if k == "kernel" else v for k, v in sub.items()}
                     for name, sub in params["layers"][0].items()}
            x = embed_tokens(params, ids_t, dtype)
            rows.update(block_rows(torch, card, layer, x, mask_t, heads))
            del layer, x
    # kernels 1-3 in bf16 and f32 at bge-large's width, on a seeded layer's weights
    large_cfg = BertConfig(vocab_size=cfg.vocab_size, type_vocab_size=cfg.type_vocab_size,
                           max_position_embeddings=cfg.max_position_embeddings, **LARGE_WIDTHS)
    large_raw = init_params(large_cfg, torch.Generator().manual_seed(0))
    for dtype in (torch.bfloat16, torch.float32):
        large = prepare_params(large_raw, dev, dtype)
        rows.update(block_rows(torch, card, large["layers"][0], embed_tokens(large, ids_t, dtype), mask_t,
                               large_cfg.num_heads))
        del large
        torch.cuda.empty_cache()
    del large_raw

    phase("main path")
    # host tokenization of the same texts, timed apart: the build's host share
    t0 = time.perf_counter()
    tokens = sum(len(embedder.tokenizer.encode(t, embedder.max_len)) for t in texts)
    t_tok = time.perf_counter() - t0
    chunks = build_chunks_list([(t, {"source": "oracle" if i < len(oracle) else "synthetic"})
                                for i, t in enumerate(texts)])
    rng = np.random.default_rng(1)
    queries = []
    for i in rng.choice(len(texts), size=N_QUERIES, replace=False):
        words = texts[i].split()
        j = int(rng.integers(0, max(1, len(words) - 8)))
        queries.append(" ".join(words[j : j + 8]))
    embedder.embed_documents(texts[: embedder.batch_size])  # warm-up: first use of each op
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fe.reset_launches()
    wordpiece.reset_paths()
    t0 = time.perf_counter()
    record = type("Record", (), {"embeddings_index": asyncio.run(SemanticRetriever.build_index(embedder, chunks))})()
    retriever = SemanticRetriever.from_doc_records(embedder, [record], k=1)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    retriever.retrieve_batch(queries)  # warm-up at the query shapes
    t0 = time.perf_counter()
    hits = retriever.retrieve_batch(queries)
    t_batch = time.perf_counter() - t0
    single_ms = []
    for q in queries[:5]:
        t0 = time.perf_counter()
        retriever.retrieve(q)
        single_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = dict(fe.LAUNCHES)
    n_batches = -(-N_DOCS // embedder.batch_size) + 2 * -(-N_QUERIES // embedder.batch_size) + 5
    print(f"launches {launches}; encode batches {n_batches}; layers {cfg.num_layers}")
    for name in ("fused_attention_block", "fused_ffn_block"):
        launched[name] += launches[name]
        if launches[name] != cfg.num_layers * n_batches:
            raise RuntimeError(f"{name} launched {launches[name]} times, expected "
                               f"{cfg.num_layers * n_batches}: the main path bypassed it")
    doc_emb = np.concatenate(record.embeddings_index)
    if doc_emb.shape != (N_DOCS, hid) or not np.isfinite(doc_emb).all():
        raise RuntimeError(f"bad document embeddings: shape {doc_emb.shape}")
    norms = np.linalg.norm(doc_emb, axis=1)
    if not np.allclose(norms, 1.0, atol=1e-3):
        raise RuntimeError(f"embeddings are not unit norm: {norms.min()}..{norms.max()}")
    if any(len(h) != 1 for h in hits):
        raise RuntimeError("a query returned no hit")
    print(f"index build: {N_DOCS} chunks, {tokens} tokens in {t_build:.3f} s: "
          f"{N_DOCS / t_build:.1f} chunks/s, {tokens / t_build:.0f} tokens/s; host tokenization of "
          f"the same texts alone {t_tok:.3f} s {card}")
    print(f"query: {N_QUERIES} queries in one batch {t_batch * 1e3:.2f} ms; single query median "
          f"{sorted(single_ms)[2]:.2f} ms {card}")
    print(f"WordPiece texts of the index build and queries: C++ core {wordpiece.PATHS['native']}, "
          f"Python path {wordpiece.PATHS['python']}")
    # against the host clock above: how far the host paces a single query
    device_profile(torch, lambda: retriever.retrieve(queries[0]), "one single query", card, top=4)
    print(f"peak memory (index build + queries): {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB {card}",
          flush=True)

    # the same path through the plain versions, on the card
    plain_embedder = BgeEmbedder(
        tokenizer=embedder.tokenizer,
        encoder=BertEncoder(cfg, compute_dtype=torch.bfloat16, attention_impl="fused_plain",
                            pooling=embedder.encoder.pooling),
        params=embedder.params, device="cuda", query_instruction=embedder.query_instruction,
        model_id=embedder.model_id,
    )
    plain_doc = plain_embedder.embed_documents(texts)
    print(f"document embeddings, kernel path vs plain path: max abs diff "
          f"{np.abs(doc_emb - plain_doc).max():.3g}")
    q_kernel = embedder.embed_queries(queries[:N_TOP1])
    q_plain = plain_embedder.embed_queries(queries[:N_TOP1])
    kernel_top = retriever.index.find_batch(q_kernel)
    plain_index = SemanticRetriever.from_doc_records(
        plain_embedder, [type("R", (), {"embeddings_index": [e[None] for e in plain_doc]})()], k=1
    ).index
    plain_top = plain_index.find_batch(q_plain)
    ties = top1_agree([h[0].chunk_id for h in kernel_top], [h[0].chunk_id for h in plain_top], doc_emb, q_kernel,
                      "bf16 main path")
    print(f"top-1 of {N_TOP1} queries: kernel path = plain path ({ties} near-ties below {TIE_GAP})")

    # f32 reference on a few real chunks: the path the CPU tests pin to JAX
    f32_embedder = BgeEmbedder.from_hf_checkpoint(str(CHECKPOINT), compute_dtype=torch.float32, device="cuda")
    ref = f32_embedder.embed_documents(oracle[:8])
    cos = (ref * doc_emb[:8]).sum(axis=1)
    print(f"bf16 kernel path vs f32 path on 8 chunks: cosine min {cos.min():.5f}")
    if not cos.min() > 0.99:
        raise RuntimeError(f"bf16 kernel path disagrees with the f32 path: cosine {cos.min()}")
    del f32_embedder, plain_embedder, plain_index

    # where one encode batch spends the card's time (profiler, one batch)
    ids_b, mask_b = embedder.tokenizer.encode_batch(texts[len(oracle) : len(oracle) + b])
    ids_b = torch.from_numpy(ids_b).to(dev, dtype=torch.long)
    mask_b = torch.from_numpy(mask_b).to(dev)
    device_profile(torch, lambda: embedder.encoder.encode(embedder.params, ids_b, mask_b),
                   f"one encode batch (B={b}, S={s})", card)

    # seeded 1M x 384 f32 dense index on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    mat = torch.randn((1_000_000, hid), generator=gen, device=dev)
    mat /= mat.norm(dim=1, keepdim=True)
    big = DenseIndex.from_device_matrix(RetrievalType.TEXT, mat, limit=5)
    qs = torch.from_numpy(embedder.embed_queries(queries))
    big_hits = big.find_batch(qs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big_hits = big.find_batch(qs)
    t_big = time.perf_counter() - t0
    t0 = time.perf_counter()
    big.find(qs[0])
    t_big1 = time.perf_counter() - t0
    qd = qs[:4].to(dev, torch.float64)
    d64 = (mat.double() ** 2).sum(1)[None, :] - 2 * qd @ mat.double().T + (qd**2).sum(1)[:, None]
    top2 = torch.topk(d64, 2, largest=False)
    for qi in range(4):
        best, second = top2.indices[qi].tolist(), top2.values[qi].tolist()
        if big_hits[qi][0].chunk_id != best[0] and second[1] - second[0] >= 1e-5:
            raise RuntimeError(f"1M index top-1 of query {qi} is {big_hits[qi][0].chunk_id}, f64 says {best[0]}")
    print(f"dense index 1M x {hid} f32 ({big.nbytes / 1e9:.2f} GB): find_batch of {N_QUERIES} "
          f"{t_big * 1e3:.2f} ms, find {t_big1 * 1e3:.2f} ms; top-1 = f64 scan on 4 queries {card}")
    print(f"peak memory (bf16 main path and 1M index): {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"{card}")
    del big, mat, d64, qd

    phase("document indexing")
    for name, n in document_indexing_phase(torch, card, embedder, texts, queries).items():
        launched[name] += n

    phase("hybrid retrieval")
    for name, n in hybrid_retrieval_phase(torch, card, embedder, record.embeddings_index, chunks, queries).items():
        launched[name] += n

    phase("BM25 1M")
    bm25_1m_phase(torch, card)

    phase("dense layouts")
    dense_layouts_phase(torch, card, dev, qs)

    phase("late interaction")
    li_emb = BgeEmbedder.from_hf_checkpoint(str(LI_CHECKPOINT), compute_dtype=torch.bfloat16, device="cuda")
    li_launches, li_tokens = late_interaction_phase(torch, card, li_emb, texts, chunks, queries)
    for name, n in li_launches.items():
        launched[name] += n

    phase("local arms ensemble")
    local_launches, local_record = local_arms_phase(torch, card, embedder, li_emb, record.embeddings_index, li_tokens,
                                                    chunks, queries)
    for name, n in local_launches.items():
        launched[name] += n

    phase("concurrent serving")
    for name, n in concurrent_serving_phase(torch, card, embedder, li_emb, local_record, queries).items():
        launched[name] += n
    del li_emb, li_tokens, local_record
    torch.cuda.empty_cache()

    phase("service")
    for name, n in service_phase(torch, card, texts).items():
        launched[name] += n

    phase("whole-layer serve")
    launched["fused_layer_block"] += whole_layer_phase(torch, card, embedder, texts, queries)
    embedder_tokenizer = embedder.tokenizer
    del embedder, retriever

    phase("attention kernels")
    base = BgeEmbedder.from_hf_checkpoint(str(CHECKPOINT), compute_dtype=torch.float32, device="cuda")
    train_cfg, stream = training_setup(base)
    path_shapes = main_path_shapes(base, train_cfg, stream)
    print(f"attention shapes of the training and f32 serve phases (use, B, S): {path_shapes}", flush=True)
    rows.update(attention_rows(torch, dev, card, cfg.num_heads, hid // cfg.num_heads, path_shapes, torch.float32))
    # the other instantiations, at the shapes their phases below give them:
    # the "auto" repair (S = 64, 520 and PAST_LIMIT_S) and the bge-base
    # fine-tune (its training batches)
    repair_shapes = [("auto repair", 2, 64), ("auto repair", 2, 520), ("auto repair", 2, PAST_LIMIT_S)]
    base_shapes = sorted({("bge-base training", *batch["q_ids"].shape)
                          for batch in pairs_to_batches(base.tokenizer, stream[: 32 * BASE_TRAIN_STEPS], train_cfg)})
    for dtype, dh, shapes in ((torch.bfloat16, 32, repair_shapes), (torch.float32, 64, repair_shapes + base_shapes),
                              (torch.bfloat16, 64, repair_shapes)):
        rows.update(attention_rows(torch, dev, card, 12, dh, shapes, dtype))
    tensor_core_gates(torch, dev, cfg.num_heads)
    tensor_core_waves(torch, dev, card, cfg.num_heads)

    def count(name, dtype, dh, n):
        """Adds ``n`` main-path launches to the kernels JSON row of ``name``
        in (dtype, head_dim ``dh``)."""
        launched[instantiation(name, dtype, f"head_dim {dh}")] += n

    phase("auto repair")
    launched.update(auto_repair_phase(torch, dev, cfg.vocab_size))

    phase("f32 tanh-GELU encode")
    launched.update(f32_encode_phase(
        torch, card, dev,
        [("bge-small", base.params, cfg, base.encoder.pooling),
         ("bge-base", prepare_params(base_params, dev, torch.float32), base_cfg, "cls")],
        base.tokenizer, base.query_instruction, texts[len(oracle) : len(oracle) + b], queries))

    phase("bf16 gradient")
    bf16_gradient_phase(torch, base, train_cfg, stream)

    phase("bf16 short-context gradient")
    # the first batch of the training phase's stream, which the bge-base
    # fine-tune takes first too, through both widths' encoders
    first = next(pairs_to_batches(base.tokenizer, stream, train_cfg))
    for what, model, params in (("bge-small", cfg, base.params), ("bge-base", base_cfg, base_params)):
        short = bf16_short_gradient_phase(torch, card, dev, model, params, first, train_cfg.temperature, what)
        dh = model.hidden_size // model.num_heads
        count("qkv_native_attention", torch.bfloat16, dh, short["attention_tc"])
        count("flash_attention_bwd", torch.bfloat16, dh, short["flash_attention_bwd"])
    del first
    torch.cuda.empty_cache()

    phase("training")
    trained, train_launches = training_phase(torch, card, base, cfg.num_layers, train_cfg, stream)
    for name in ("qkv_native_attention", "flash_attention_fwd", "flash_attention_bwd"):
        count(name, torch.float32, 32, train_launches[name])

    phase("f32 serve")
    serve_launches = f32_serve_phase(torch, card, base, trained)
    count("qkv_native_attention", torch.float32, 32, serve_launches)
    print(f"qkv_native_attention launches: training {train_launches['qkv_native_attention']}, "
          f"f32 serve {serve_launches}; flash_attention_fwd (the head-major wrapper of the same CUDA "
          f"kernel) is off both paths at S <= 512", flush=True)
    del base, trained

    phase("bge-base serve")
    base_launches = base_serve_phase(torch, card, bge_base, texts, queries, tokens)
    for name in ("fused_attention_block", "fused_ffn_block"):
        launched[instantiation(name, torch.bfloat16, "H 768")] += base_launches[name]
    launched[instantiation("fused_layer_block", torch.bfloat16, "H 768")] += whole_layer_phase(
        torch, card, bge_base, texts, queries)
    del bge_base

    phase("bge-base training")
    base_train = base_training_phase(torch, card, dev, base_cfg, base_params, embedder_tokenizer, stream)
    for name in ("qkv_native_attention", "flash_attention_bwd"):
        count(name, torch.float32, 64, base_train[name])
    del base_params

    from dial_rag_tpu_torch.models.tokenizer import DEFAULT_BUCKETS, WordPieceTokenizer
    from dial_rag_tpu_torch.training.loop import TrainConfig

    long_tokenizer = WordPieceTokenizer.from_vocab_file(str(CHECKPOINT / "vocab.txt"),
                                                        buckets=DEFAULT_BUCKETS + LONG_BUCKETS)
    long_docs = long_texts(long_tokenizer, LONG_TARGETS)
    path = long_path(long_tokenizer, long_docs, LONG_BUCKETS[-1])
    print(f"long-document encode batches (S, row lengths): {path}", flush=True)
    # the seeded long-context encoders: bge-small's widths and BAAI/bge-base-en-v1.5's,
    # each with 8192 positions
    long_cfgs = {
        32: BertConfig(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
                       num_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
                       max_position_embeddings=LONG_MAX_POSITIONS, type_vocab_size=cfg.type_vocab_size),
        64: BertConfig(vocab_size=cfg.vocab_size, type_vocab_size=cfg.type_vocab_size,
                       **{**BASE_WIDTHS, "max_position_embeddings": LONG_MAX_POSITIONS}),
    }
    train_seqs = sorted(set(LONG_TRAIN_SEQS)) + [4352]  # 4352: query-blocked above 4096 (S % 512 != 0)
    timed = {"attention_bwd_q_blocked": (LONG_TRAIN_BATCH, 4096), "bwd_dq_kv_blocked": (LONG_TRAIN_BATCH, 8192),
             "bwd_dkv_kv_blocked": (LONG_TRAIN_BATCH, 8192)}
    for dh, what, cycles, lr in ((32, "bge-small", LONG_TRAIN_CYCLES, LONG_TRAIN_LR),
                                 (64, "bge-base", BASE_LONG_TRAIN_CYCLES, BASE_LONG_TRAIN_LR)):
        long_cfg = long_cfgs[dh]
        heads = long_cfg.num_heads

        phase("long-document serve" if dh == 32 else f"{what} long-document serve")
        rows.update(long_attention_rows(torch, dev, card, heads, dh, path))
        long_params = init_params(long_cfg, torch.Generator().manual_seed(0))
        long_launches = long_document_phase(torch, card, dev, long_cfg, long_params, long_tokenizer, long_docs,
                                            max_len=LONG_BUCKETS[-1], what=what)
        count("attention_q_blocked", torch.float32, dh, long_launches["float32"]["attention_q_blocked"])
        count("attention_q_blocked", torch.bfloat16, dh, long_launches["bfloat16"]["attention_tc"])
        for dtype in (torch.float32, torch.bfloat16):
            count("attention_kv_blocked_fwd", dtype, dh, long_launches[str(dtype)[6:]]["attention_kv_blocked_fwd"])

        phase("long-context backward kernels" if dh == 32 else f"{what} long-context backward kernels")
        rows.update(long_backward_rows(torch, dev, card, heads, dh, LONG_TRAIN_BATCH, train_seqs, timed))
        torch.cuda.empty_cache()

        long_train_cfg = TrainConfig(batch_size=LONG_TRAIN_BATCH, seq_len=LONG_BUCKETS[-1],
                                     learning_rate=lr, warmup_steps=2,
                                     total_steps=len(LONG_TRAIN_SEQS) * cycles)
        long_stream = long_training_pairs(long_tokenizer, cycles)

        phase("bf16 long-context gradient" if dh == 32 else f"{what} bf16 long-context gradient")
        bf16_long = bf16_long_gradient_phase(torch, card, dev, long_cfg, long_params, long_tokenizer, long_train_cfg,
                                             long_stream, what)
        for name in ("attention_kv_blocked_fwd", "bwd_dq_kv_blocked", "bwd_dkv_kv_blocked"):
            count(name, torch.bfloat16, dh, bf16_long[name])

        phase("long-context training" if dh == 32 else f"{what} long-context training")
        long_train_launches = long_training_phase(torch, card, dev, long_cfg, long_params, long_tokenizer,
                                                  long_train_cfg, long_stream, cycles, what)
        for name in ("attention_q_blocked", "attention_kv_blocked_fwd", "attention_bwd_q_blocked",
                     "bwd_dq_kv_blocked", "bwd_dkv_kv_blocked"):
            count(name, torch.float32, dh, long_train_launches[name])
        del long_params
        torch.cuda.empty_cache()

    phase(None)
    unmeasured = set(launched) - set(rows)
    if unmeasured:
        raise RuntimeError(f"launches counted for kernels no phase measured: {sorted(unmeasured)}")
    for name, row in rows.items():
        row["launches"] = launched[name]
    # kernels 1-3 at H 1024: no phase runs an encoder that wide. So they
    # are gated and timed but off the main path
    off_path = {instantiation(name, dtype, "H 1024") for dtype in (torch.bfloat16, torch.float32)
                for name in ("fused_attention_block", "fused_ffn_block", "fused_layer_block")}
    idle = [name for name, row in rows.items() if row["launches"] == 0 and name not in off_path]
    if idle:
        raise RuntimeError(f"the main path never launched {idle}")
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
