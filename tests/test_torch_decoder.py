"""The port's decoder LM and Generator against the JAX package's, on the
CPU.

The JAX package's parameters (a random Flax init, a few JAX training steps,
or the repo's decoder checkpoint) go through ``models/convert`` into the
port. In float32 the logits agree within F32_TOL and greedy text is equal.
In bfloat16 (the checkpoint) the two sum in other orders and round at the
same cast points, so logits agree within BF16_TOL, and greedy text is equal
up to the first step whose top two logits lie within BF16_TOL (a near-tie,
counted; the rest of that row is not compared). Sampling cannot follow
``jax.random``; it is held by properties: tokens inside the top-k / top-p
set, one seed one text, batched output equal to single-prompt output.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.models import decoder as jd
from optimized_rag_tpu.models import pretrain as j_pretrain
from optimized_rag_tpu.models.loader import _flatten
from optimized_rag_tpu.models.training import DecoderTrainer
from optimized_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from optimized_rag_tpu_torch.models import convert, pretrain
from optimized_rag_tpu_torch.models import decoder as pd

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "pretrained")
F32_TOL = 1e-5        # float32 products in two summation orders
# bf16 trunk: a one-ulp rounding flip in one layer's product (the two
# packages sum in other orders) grows through the layers; on the
# checkpoint the logits differ by 0.77 at most and 0.036 on average.
BF16_TOL = 1.0
BF16_MEAN_TOL = 0.1
J_TINY = jd.DecoderConfig(hidden_dim=64, num_layers=2, num_heads=4,
                          mlp_dim=128, max_seq_len=128, dtype=jnp.float32)
P_TINY = pd.DecoderConfig(hidden_dim=64, num_layers=2, num_heads=4,
                          mlp_dim=128, max_seq_len=128, dtype=torch.float32)
PROMPTS = ["short", "a somewhat longer prompt here", "mid size one",
           "hello world"]


def _pair(max_prompt_len=32, max_new_tokens=8, seed=0):
    ref = jd.Generator(J_TINY, max_prompt_len=max_prompt_len,
                       max_new_tokens=max_new_tokens, seed=seed)
    port = pd.Generator(P_TINY, params=convert.decoder_flax_to_torch(
        _flatten(ref.params), P_TINY), max_prompt_len=max_prompt_len,
        max_new_tokens=max_new_tokens, device="cpu")
    return port, ref


def _ids(rng, b, n):
    return rng.integers(3, 259, (b, n)).astype(np.int32)


def test_byte_tokenizer_matches_jax():
    for s in ("Hello, TPU! 123 — unicode ✓", "", "x" * 40):
        ids = pd.encode_bytes(s)
        np.testing.assert_array_equal(ids, jd.encode_bytes(s))
        assert ids[0] == pd.BOS and pd.decode_bytes(ids.tolist()) == s
        for n, trunc in ((8, "left"), (8, "right"), (200, "left")):
            np.testing.assert_array_equal(pd.encode_bytes(s, n, trunc),
                                          jd.encode_bytes(s, n, trunc))
    assert pd.decode_bytes([1, 0, 2, 200, 258]) == jd.decode_bytes(
        [1, 0, 2, 200, 258])


def test_causal_forward_matches_jax(rng):
    port, ref = _pair()
    ids = _ids(rng, 2, 16)
    j_logits, j_caches = ref.model.apply(ref.params, jnp.asarray(ids))
    logits, caches, hidden = port.model(torch.from_numpy(ids).long())
    assert logits.shape == (2, 16, P_TINY.vocab_size)
    assert len(caches) == P_TINY.num_layers and hidden.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               atol=F32_TOL, rtol=0)
    for (k, v), (jk, jv) in zip(caches, j_caches):
        np.testing.assert_allclose(k.detach().numpy(), np.asarray(jk),
                                   atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv),
                                   atol=F32_TOL, rtol=0)


def test_left_padded_forward_matches_jax(rng):
    """key_valid and per-row pos_ids of a left-padded batch."""
    port, ref = _pair()
    ids = _ids(rng, 3, 12)
    pad_len = np.array([0, 5, 11])
    for r, n in enumerate(pad_len):
        ids[r, :n] = pd.PAD
    col = np.arange(12)[None]
    valid = col >= pad_len[:, None]
    pos_ids = np.maximum(col - pad_len[:, None], 0)
    j_logits, _ = ref.model.apply(ref.params, jnp.asarray(ids),
                                  key_valid=jnp.asarray(valid),
                                  pos_ids=jnp.asarray(pos_ids))
    logits, _, _ = port.model(torch.from_numpy(ids).long(),
                              key_valid=torch.from_numpy(valid),
                              pos_ids=torch.from_numpy(pos_ids))
    np.testing.assert_allclose(logits.detach().numpy()[valid],
                               np.asarray(j_logits)[valid], atol=F32_TOL,
                               rtol=0)


def test_causality(rng):
    """Changing a future token must not change earlier logits."""
    port, _ = _pair()
    ids = torch.from_numpy(_ids(rng, 1, 12)).long()
    ids2 = ids.clone()
    ids2[0, -1] = (ids[0, -1] + 5) % 256 + 3
    a = port.model(ids)[0].detach()
    b = port.model(ids2)[0].detach()
    torch.testing.assert_close(a[0, :-1], b[0, :-1], atol=F32_TOL, rtol=0)


def test_cached_decode_matches_full_forward_and_jax(rng):
    """One cached step at pos 9 reproduces the full forward's logits and
    the JAX package's step."""
    port, ref = _pair()
    seq = _ids(rng, 1, 10)
    full, _, _ = port.model(torch.from_numpy(seq).long())
    _, caches, _ = port.model(torch.from_numpy(seq[:, :9]).long())
    caches = pd.cache_buffers(caches, 16)
    step, _, _ = port.model(torch.from_numpy(seq[:, 9:10]).long(), caches, 9)
    torch.testing.assert_close(step[0, 0], full[0, 9], atol=2e-4, rtol=0)
    _, j_caches = ref.model.apply(ref.params, jnp.asarray(seq[:, :9]))
    j_caches = [(jnp.zeros((1, 16, 4, 16)).at[:, :9].set(k),
                 jnp.zeros((1, 16, 4, 16)).at[:, :9].set(v))
                for k, v in j_caches]
    j_step, _ = ref.model.apply(ref.params, jnp.asarray(seq[:, 9:10]),
                                kv_caches=j_caches, pos=jnp.asarray(9))
    np.testing.assert_allclose(step[0, 0].detach().numpy(),
                               np.asarray(j_step[0, 0]), atol=F32_TOL,
                               rtol=0)


def test_greedy_generation_matches_jax():
    port, ref = _pair(max_new_tokens=12)
    for p in PROMPTS:
        assert port.generate(p) == ref.generate(p, temperature=0.0)
    assert port.generate_batch(PROMPTS) == ref.generate_batch(PROMPTS)


def test_generator_greedy_deterministic_and_respects_max_new():
    port, _ = _pair(max_new_tokens=4)
    a, b = port.generate("hello"), port.generate("hello")
    assert a == b and isinstance(a, str)
    out = port.generate("abc", max_new_tokens=4)
    assert len(out.encode("utf-8", errors="replace")) <= 4 * 4
    with pytest.raises(ValueError, match="max_seq_len"):
        port.generate("abc", max_new_tokens=200)
    with pytest.raises(ValueError, match="max_seq_len"):
        pd.Generator(P_TINY, max_prompt_len=100, max_new_tokens=64,
                     device="cpu")


def test_batched_generation_matches_single():
    port, _ = _pair()
    batched = port.generate_batch(PROMPTS[:3], temperature=0.0)
    assert batched == [port.generate(p, temperature=0.0)
                       for p in PROMPTS[:3]]


def test_decode_stops_early_with_the_same_tokens(monkeypatch):
    """Once every row has emitted EOS the loop stops; the tokens equal a
    loop that runs every step (the reference's fixed scan)."""
    port, _ = _pair(max_new_tokens=40)
    eos_bias = torch.zeros(P_TINY.vocab_size)
    eos_bias[pd.EOS] = 3.0
    with torch.no_grad():
        port.model.head.bias += eos_bias
    ids, pad = pd.left_pad(PROMPTS, 32)
    args = (torch.from_numpy(ids), torch.from_numpy(pad), 0.0, 0, 1.0, 0,
            40)
    early = port._generate(*args)
    steps = []
    loop = pd.decode_loop
    monkeypatch.setattr(pd, "decode_loop", lambda first, step, pick, n: loop(
        first, lambda t, i: (steps.append(i), step(t, i))[1], pick, n,
        check_every=10 ** 9))
    full = port._generate(*args)
    assert len(steps) == 39
    torch.testing.assert_close(early, full, rtol=0, atol=0)
    assert (full == pd.EOS).any(dim=0).all()


def _teacher_logits(port, prompt, toks):
    """The port's full-forward logits before each generated token."""
    ids = np.concatenate([pd.encode_bytes(prompt), np.asarray(toks)])
    return port.model(torch.from_numpy(ids[None]).long())[0][0].detach()[
        len(ids) - len(toks) - 1:-1]


def test_sampling_filters_and_properties():
    port, _ = _pair(max_new_tokens=10)
    greedy = port.generate("hello world", temperature=0.0)
    assert port.generate("hello world", temperature=0.7, top_k=1,
                         seed=3) == greedy
    assert port.generate("hello world", temperature=0.7, top_p=1e-6,
                         seed=3) == greedy
    kw = dict(temperature=0.9, top_k=40, top_p=0.9, seed=5)
    assert port.generate("hello world", **kw) == port.generate(
        "hello world", **kw)
    samples = {port.generate("hello world", temperature=1.5, seed=s)
               for s in range(6)}
    assert len(samples) > 1
    # batched sampled output equals each prompt's own
    batched = port.generate_batch(PROMPTS, **kw)
    assert batched == [port.generate(p, **kw) for p in PROMPTS]
    # every sampled token lies in the top-k set of its step
    ids, pad = pd.left_pad(["hello world"], 32)
    for top_k, top_p in ((5, 1.0), (0, 0.5)):
        toks = port._generate(torch.from_numpy(ids), torch.from_numpy(pad),
                              1.0, top_k, top_p, 11, 10)[:, 0].tolist()
        toks = toks[:toks.index(pd.EOS) + 1] if pd.EOS in toks else toks
        toks = [t for t in toks if t != pd.PAD]
        lg = _teacher_logits(port, "hello world", toks)
        for t, row in zip(toks, lg):
            order = torch.argsort(row, descending=True, stable=True)
            if top_k:
                assert t in order[:top_k].tolist()
            else:
                probs = torch.softmax(row, -1)[order]
                nucleus = int((torch.cumsum(probs, 0) - probs < top_p).sum())
                assert t in order[:nucleus + 1].tolist()


def test_score_matches_jax():
    port, ref = _pair()
    for text in ("aaaa bbbb aaaa bbbb", "zzzz qqqq"):
        assert abs(port.score(text) - ref.score(text)) < F32_TOL


def test_jax_trained_params_score_seen_text_higher():
    """tests/test_decoder.py's trained model: the JAX trainer's parameters
    in the port score as in the JAX package, seen text above unseen."""
    tr = DecoderTrainer(J_TINY, jax_make_mesh(data=8, model=1),
                        learning_rate=5e-3)
    text = "aaaa bbbb aaaa bbbb "
    batch = np.tile(jd.encode_bytes(text * 4, 96), (8, 1)).astype(np.int32)
    for _ in range(12):
        tr.train_step(batch)
    params = jax.device_get(tr.params)
    ref = jd.Generator(J_TINY, params=params, max_prompt_len=32,
                       max_new_tokens=8)
    port = pd.Generator(P_TINY, params=convert.decoder_flax_to_torch(
        _flatten(params), P_TINY), max_prompt_len=32, max_new_tokens=8,
        device="cpu")
    for t in (text * 2, "zzzz qqqq xxxx wwww"):
        assert abs(port.score(t) - ref.score(t)) < F32_TOL
    assert port.score(text * 2) > port.score("zzzz qqqq xxxx wwww")
    assert port.generate("aaaa ") == ref.generate("aaaa ")


def test_local_lm_provider_matches_jax():
    port, ref = _pair()
    prov, j_prov = pd.LocalLMProvider(port), jd.LocalLMProvider(ref)
    q = "Query: what is x\nIntent:"
    assert prov.structured(q, ["intent"], task="intent") == \
        j_prov.structured(q, ["intent"], task="intent")
    ctx = "[1] context doc\nQuestion: what\nAnswer:"
    ans = prov.complete(ctx, task="generate")
    assert isinstance(ans, str) and ans
    assert ans == j_prov.complete(ctx, task="generate")
    assert prov.structured(ctx, ["answer", "citations"], task="generate") \
        == j_prov.structured(ctx, ["answer", "citations"], task="generate")


# ------------------------------------------------ the repo's checkpoint

def _first_divergence(port, ref_model, ref_params, prompts, got, want):
    """Rows equal, or equal up to a step whose top two logits (the JAX
    full forward) lie within BF16_TOL, with the port's token one of
    them. Returns the near-ties met."""
    ties = 0
    for prompt, a, b in zip(prompts, got, want):
        ta = list(pd.encode_bytes(a)[1:])
        tb = list(pd.encode_bytes(b)[1:])
        if ta == tb:
            continue
        t = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                 min(len(ta), len(tb)))
        ids = np.concatenate([jd.encode_bytes(prompt, 64, "left"),
                              np.asarray(tb[:t], np.int32)])[None]
        lg = np.asarray(ref_model.apply(ref_params, jnp.asarray(ids))[0])[
            0, -1]
        order = np.argsort(-lg, kind="stable")
        assert lg[order[0]] - lg[order[1]] <= BF16_TOL, (prompt, a, b)
        mine = ta[t] if t < len(ta) else pd.EOS
        assert mine in order[:2], (prompt, a, b)
        ties += 1
    return ties


def test_checkpoint_logits_and_greedy_text_match_jax():
    cfg, state = pretrain.load_pretrained(CKPT, "decoder")
    j_cfg, params = j_pretrain.load_pretrained(CKPT, "decoder")
    assert (cfg.hidden_dim, cfg.num_layers, cfg.dtype) == (
        j_cfg.hidden_dim, j_cfg.num_layers, torch.bfloat16)
    port = pd.Generator(cfg, params=state, max_prompt_len=64,
                        max_new_tokens=24, device="cpu")
    ref = jd.Generator(j_cfg, params=params, max_prompt_len=64,
                       max_new_tokens=24)
    ids = pd.encode_bytes("The tensor core multiplies matrices in bf16.")
    logits = port.model(torch.from_numpy(ids[None]).long())[0]
    j_logits = np.asarray(ref.model.apply(params, jnp.asarray(ids[None]))[0])
    err = np.abs(logits.float().detach().numpy() - j_logits)
    assert err.max() <= BF16_TOL and err.mean() <= BF16_MEAN_TOL, (
        err.max(), err.mean())
    prompts = ["The capital of", "question: what is a tile?\nanswer:",
               "Retrieval augmented generation"]
    got, want = port.generate_batch(prompts), ref.generate_batch(prompts)
    ties = _first_divergence(port, ref.model, params, prompts, got, want)
    assert ties <= 1, (got, want)
