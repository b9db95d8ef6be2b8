"""The port's contrastive training (``dial_rag_tpu_torch.training``) against
the JAX package's, on the CPU, with the same numpy-seeded inputs and the
JAX parameters carried across by ``params_from_jax_numpy``.

Tolerances: losses rel 1e-5 and gradients atol 1e-5, rtol 1e-4 (f32
through a 2-layer encoder, summed in another order); the optimizer's
updates rtol 1e-4, atol 5e-7 (optax's f32 bias correction, f32 rounding
of the params); remat atol 1e-6, the
reference's own (tests/test_training_loop.py); data streams exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dial_rag_tpu.models.bert import BertConfig as JaxConfig
from dial_rag_tpu.models.bert import init_params as jax_init_params
from dial_rag_tpu.training import contrastive as jc
from dial_rag_tpu.training import data as jdata
from dial_rag_tpu.training import loop as jloop
from dial_rag_tpu_torch.models.bert import BertConfig
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer, build_test_vocab
from dial_rag_tpu_torch.training import contrastive as tc
from dial_rag_tpu_torch.training import data as tdata
from dial_rag_tpu_torch.training import loop as tloop
from dial_rag_tpu_torch.weights import param_leaves, params_from_jax_numpy, params_to_numpy

WORDS = [chr(c) for c in range(97, 123)]


@pytest.fixture(scope="module")
def tokenizer():
    return WordPieceTokenizer(vocab=build_test_vocab(WORDS))


def _pairs(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = rng.choice(WORDS, size=4)
        out.append((" ".join(w[:2]), " ".join(w)))
    return out


def _jax_params(seed=0):
    return jax_init_params(jax.random.PRNGKey(seed), JaxConfig.tiny())


def _port_params(jparams, requires_grad=True):
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    for t in param_leaves(params):
        t.requires_grad_(requires_grad)
    return params


def _batch(seed=1, b=4, s=16, hid=64):
    rng = np.random.default_rng(seed)
    mask = np.ones((2, b, s), np.int32)
    mask[0, 1, 9:] = 0
    mask[1, 2, 5:] = 0
    batch = {
        "q_ids": rng.integers(1, 50, size=(b, s)).astype(np.int32),
        "q_mask": mask[0],
        "p_ids": rng.integers(1, 50, size=(b, s)).astype(np.int32),
        "p_mask": mask[1],
    }
    bank = rng.standard_normal((7, hid)).astype(np.float32)
    extras = {
        "teacher_scores": rng.standard_normal((b, b)).astype(np.float32),
        "bank_emb": bank / np.linalg.norm(bank, axis=-1, keepdims=True),
        "teacher_corpus": rng.standard_normal((b, 7)).astype(np.float32),
        "bank_cols": np.array([5, 0, 2, 6], np.int32),
    }
    return batch, extras


CASES = {
    "cls": ({}, (), {"temperature": 0.05}),
    "maxsim": ({"objective": "maxsim"}, (), {"temperature": 1.0}),
    "teacher_scores": ({}, ("teacher_scores",), {"temperature": 0.05, "kd_weight": 0.3}),
    "teacher_corpus": (
        {},
        ("bank_emb", "teacher_corpus", "bank_cols"),
        {"temperature": 0.05, "corpus_kd_weight": 0.6, "teacher_temperature": 2.0},
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_contrastive_loss_matches_jax(case):
    """Value and gradients of every loss branch against jax.value_and_grad."""
    objective, keys, kw = CASES[case]
    batch, extras = _batch()
    batch.update({k: extras[k] for k in keys})
    config = JaxConfig.tiny()
    jparams = _jax_params()
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jc.contrastive_loss(p, batch, num_heads=config.num_heads, **objective, **kw)
    )(jparams)
    params = _port_params(jparams)
    loss = tc.contrastive_loss(params, batch, num_heads=config.num_heads, **objective, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    grads = jax.tree.leaves(j_grads)
    for t, g in zip(param_leaves(params), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-4)
    if case == "teacher_corpus":
        # the live bank columns give the passage side a gradient
        assert float(np.abs(params["layers"][0]["qkv"]["kernel"].grad.numpy()).max()) > 0


def test_maxsim_zero_token_passage_is_finite():
    """A passage with no real token scores -1e9, never -inf."""
    q_tok = torch.ones((2, 3, 4), requires_grad=True)
    p_mask = torch.tensor([[1, 1, 0], [0, 0, 0]], dtype=torch.int32)
    scores = tc.maxsim_scores_pairwise(q_tok, torch.ones((2, 3), dtype=torch.int32), torch.ones((2, 3, 4)), p_mask)
    assert torch.isfinite(scores).all() and (scores[:, 1] < scores[:, 0]).all()
    scores.sum().backward()
    assert torch.isfinite(q_tok.grad).all()


def test_schedule_matches_optax():
    cfg = tloop.TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=12)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 12)
    got = [tloop.warmup_cosine_lr(cfg, c) for c in range(16)]
    np.testing.assert_allclose(got, [float(sched(c)) for c in range(16)], rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got[:4], [0.0, 5e-4, 1e-3, 9.755283e-4], rtol=1e-6)


def test_optimizer_matches_optax():
    """AdamW + LambdaLR against optax.adamw(warmup_cosine_decay_schedule),
    fed the same numpy gradients for 6 steps from params ~N(0, 1) at lr
    1e-2, biases nonzero so that weight decay on them (optax masks none)
    shows. The first step runs at lr 0 and leaves the params exactly as
    they were. Each later step's update (new params minus old) agrees
    within rtol 1e-4: optax forms Adam's bias correction 1 - 0.999**t in
    f32, where the cancellation costs ~1e-5 of each update (torch forms it
    in double), while an unmasked decay term is lr * 0.01 * |p|, ~1e-2 of
    an update. atol 5e-7 is four f32 roundings of a param below 4."""
    rng = np.random.default_rng(0)
    tree = {
        "embeddings": {"word": rng.standard_normal((6, 4)).astype(np.float32)},
        "layers": [{"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                    "bias": rng.standard_normal(3).astype(np.float32),
                    "scale": (1 + 0.1 * rng.standard_normal(3)).astype(np.float32)}],
    }
    cfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6)
    j_opt = jloop.make_optimizer(jloop.TrainConfig(**cfg))
    j_update = jax.jit(j_opt.update)
    j_params = jax.tree.map(jnp.asarray, tree)
    j_state = j_opt.init(j_params)
    params = tloop.trainable_params(params_from_jax_numpy(tree), "cpu")
    optimizer, scheduler = tloop.make_optimizer(tloop.TrainConfig(**cfg), params)
    before, j_before = tree, tree
    for step in range(6):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        updates, j_state = j_update(jax.tree.map(jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for t, g in zip(param_leaves(params), param_leaves(params_from_jax_numpy(grads))):
            t.grad = g
        optimizer.step()
        scheduler.step()
        got, j_got = params_to_numpy(params), jax.tree.map(np.asarray, j_params)
        if step == 0:
            jax.tree.map(np.testing.assert_array_equal, got, tree)
            jax.tree.map(np.testing.assert_array_equal, j_got, tree)
        jax.tree.map(
            lambda a, a0, b, b0: np.testing.assert_allclose(
                a.astype(np.float64) - a0, b.astype(np.float64) - b0, rtol=1e-4, atol=5e-7
            ),
            got, before, j_got, j_before,
        )
        before, j_before = got, j_got


def test_train_steps_match_jax(tokenizer):
    """Three make_train_step steps (optimizer and schedule included)
    against JAX's, from the same weights on the same batches."""
    cfg = dict(batch_size=4, seq_len=32, learning_rate=1e-3, warmup_steps=1, total_steps=10)
    batches = list(tloop.pairs_to_batches(tokenizer, _pairs(12, seed=2), tloop.TrainConfig(**cfg)))
    config = JaxConfig.tiny()
    j_opt = jloop.make_optimizer(jloop.TrainConfig(**cfg))
    j_step = jc.make_train_step(config, j_opt, temperature=0.05)
    j_params = _jax_params(3)
    params = tloop.trainable_params(params_from_jax_numpy(jax.tree.map(np.asarray, j_params)), "cpu")
    state = tc.create_train_state(params, *tloop.make_optimizer(tloop.TrainConfig(**cfg), params))
    step = tc.make_train_step(BertConfig.tiny(), temperature=0.05)
    j_state = j_opt.init(j_params)
    for batch in batches:
        j_params, j_state, j_loss = j_step(j_params, j_state, batch)
        loss = step(state, batch)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert state.step == 3


def test_training_reduces_loss(tokenizer):
    cfg = tloop.TrainConfig(batch_size=8, seq_len=32, learning_rate=1e-3, warmup_steps=2, total_steps=12,
                            checkpoint_every=100)
    params, losses = tloop.train(BertConfig.tiny(), cfg, _pairs(cfg.batch_size * 12), tokenizer, device="cpu")
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert not any(t.requires_grad for t in param_leaves(params))


def test_checkpoint_roundtrip_and_resume(tokenizer, tmp_path):
    """A restore is exact; a resumed run skips the consumed batches and
    continues the uninterrupted run; the last 3 checkpoints are kept; a
    final step on a checkpoint boundary saves once."""
    config = BertConfig.tiny()

    def cfg(total, every=2):
        return tloop.TrainConfig(batch_size=4, seq_len=32, learning_rate=1e-3, total_steps=total,
                                 checkpoint_every=every, warmup_steps=1)

    pairs = _pairs(4 * 8, seed=1)
    _, straight = tloop.train(config, cfg(6), pairs, tokenizer, device="cpu")
    # the same run cut after 4 steps by the end of its data
    params, first = tloop.train(config, cfg(6), pairs[:16], tokenizer, checkpoint_dir=str(tmp_path / "c"),
                                device="cpu")
    ckpt = tloop.Checkpointer(str(tmp_path / "c"))
    assert ckpt.steps() == [2, 4]
    like = tloop.trainable_params(params, "cpu")
    with torch.no_grad():
        for t in param_leaves(like):
            t.zero_()
    state = tc.create_train_state(like, *tloop.make_optimizer(cfg(6), like))
    assert ckpt.restore(state) == 4 and state.step == 4
    for a, b in zip(param_leaves(state.params), param_leaves(params)):
        assert torch.equal(a, b)
    assert state.optimizer.state_dict()["state"][0]["step"].item() == 4
    assert state.scheduler.last_epoch == 4

    _, resumed = tloop.train(config, cfg(6), pairs, tokenizer, checkpoint_dir=str(tmp_path / "c"), device="cpu")
    assert len(resumed) == 2  # only steps 5 and 6 ran, on batches 5 and 6
    np.testing.assert_allclose(first + resumed, straight, rtol=1e-4)
    assert tloop.Checkpointer(str(tmp_path / "c")).steps() == [2, 4, 6]
    tloop.train(config, cfg(8), pairs, tokenizer, checkpoint_dir=str(tmp_path / "c"), device="cpu")
    # steps 7 and 8 ran; the last step, on a checkpoint boundary, saved once
    assert tloop.Checkpointer(str(tmp_path / "c")).steps() == [4, 6, 8]


def test_remat_gradients_equal():
    """torch.utils.checkpoint changes when activations are computed, not
    the gradients; through the "pallas" route's autograd function too."""
    batch, _ = _batch(seed=4)
    grads = {}
    for remat in (False, True):
        params = _port_params(_jax_params(5))
        tc.contrastive_loss(params, batch, num_heads=4, remat=remat, attention_impl="pallas").backward()
        grads[remat] = [t.grad for t in param_leaves(params)]
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_bank_encoder_matches_jax():
    """Blocks of 4 rows with a ragged last block, against JAX's scan."""
    config = JaxConfig.tiny()
    jparams = _jax_params(0)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 50, size=(11, 16)).astype(np.int32)
    mask = (rng.random((11, 16)) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    want = jc.make_bank_encoder(config, block=4)(jparams, ids, mask)
    got = tc.make_bank_encoder(BertConfig.tiny(), block=4)(_port_params(jparams, False), ids, mask)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_train_with_corpus_teacher_refreshes_bank(tokenizer):
    pairs = _pairs(4 * 6, seed=5)
    corpus = sorted({p for _, p in pairs})
    col = {p: i for i, p in enumerate(corpus)}
    ids, mask = tokenizer.encode_batch(corpus, max_len=32)

    def corpus_teacher(buf):
        rows = np.full((len(buf), len(corpus)), -5.0, np.float32)
        for i, (_, p) in enumerate(buf):
            rows[i, col[p]] = 5.0
        return rows

    cfg = tloop.TrainConfig(batch_size=4, seq_len=32, learning_rate=1e-3, warmup_steps=1, total_steps=6,
                            checkpoint_every=100, bank_refresh_every=2)
    _, losses = tloop.train(BertConfig.tiny(), cfg, pairs, tokenizer, corpus_teacher=corpus_teacher,
                            bank_tokens=(ids, mask), device="cpu")
    assert len(losses) == 6 and all(np.isfinite(losses))
    with pytest.raises(ValueError, match="BOTH"):
        tloop.train(BertConfig.tiny(), cfg, pairs, tokenizer, corpus_teacher=corpus_teacher, device="cpu")


def test_mesh_is_not_ported():
    with pytest.raises(NotImplementedError):
        tc.make_train_step(BertConfig.tiny(), mesh=object())


def test_params_to_numpy_inverts_params_from_jax_numpy():
    tree = jax.tree.map(np.asarray, _jax_params(1))
    back = params_to_numpy(params_from_jax_numpy(tree))
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def _clustered_pairs(n_clusters=6, per_cluster=4, queries_per=3):
    pairs, neighbors = [], {}
    for c in range(n_clusters):
        members = [c * per_cluster + m for m in range(per_cluster)]
        for s in members:
            neighbors[s] = [o for o in members if o != s]
            pairs.extend((f"q{s}_{qi}", f"passage{s}") for qi in range(queries_per))
    return pairs, neighbors


def _jsonl(tmp_path):
    for shard in range(3):
        with open(tmp_path / f"pairs-{shard}.jsonl", "w") as f:
            for i in range(10):
                f.write(json.dumps({"query": f"q{shard}-{i}", "passage": f"p{shard}-{i}"}) + "\n")
            f.write("not json\n")
    return str(tmp_path / "pairs-*.jsonl")


STREAMS = {
    "jsonl_pairs": lambda mod, tmp: list(mod.jsonl_pairs(_jsonl(tmp), seed=7, shuffle_buffer=8, repeat=2)),
    "hard_negative_stream": lambda mod, tmp: mod.hard_negative_stream(
        *_clustered_pairs()[:1], 4, 12, _clustered_pairs()[1], seed=3,
        pos_key=lambda p: int(p.removeprefix("passage")),
    ),
    "positive_disjoint_stream": lambda mod, tmp: mod.positive_disjoint_stream(
        _clustered_pairs()[0], 4, 12, seed=3, pos_key=lambda p: int(p.removeprefix("passage")),
    ),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_data_streams_identical_to_jax(name, tmp_path):
    got = STREAMS[name](tdata, tmp_path)
    assert got == STREAMS[name](jdata, tmp_path)
    assert len(got) == (60 if name == "jsonl_pairs" else 48)
