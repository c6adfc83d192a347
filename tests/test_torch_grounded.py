"""The port's grounded pointer-generator (serving half) against the JAX
package's, on the CPU.

The mixture math is held within MIX_TOL (float32 einsums and softmaxes in
two summation orders), prompt rendering byte for byte, and generation with
the JAX package's parameters (a random Flax init, a few JAX training steps,
or the repo's ``checkpoints/grounded_r5``) through ``models/convert``:
greedy text equal in float32; in bfloat16 (the checkpoint) log-probs within
BF16_TOL and text equal up to a step whose top two log-probs lie within
BF16_TOL (a near-tie, counted). The provider routes ``generate`` to the
model and everything else to the deterministic fallback, as the JAX one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.models import grounded as jg
from optimized_rag_tpu.models import pretrain as j_pretrain
from optimized_rag_tpu.models.loader import _flatten
from optimized_rag_tpu_torch.models import convert, pretrain
from optimized_rag_tpu_torch.models import decoder as pd
from optimized_rag_tpu_torch.models import grounded as pg

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "grounded_r5")
MIX_TOL = 1e-6
F32_TOL = 1e-5
# bf16 trunk of 6 layers: one-ulp rounding flips grow through the layers
# (tests/test_torch_decoder.py); the mixed log-probs of the checkpoint's
# likely tokens differ by much less than the logits.
BF16_TOL = 1.0
J_TINY = jg.GroundedConfig(hidden_dim=64, num_layers=2, num_heads=2,
                           mlp_dim=128, max_seq_len=320, copy_dim=32,
                           dtype=jnp.float32)
P_TINY = pg.GroundedConfig(hidden_dim=64, num_layers=2, num_heads=2,
                           mlp_dim=128, max_seq_len=320, copy_dim=32,
                           dtype=torch.float32)
AGENT_PROMPT = ("Context:\n[1] The matrix unit is a 128 by 128 array.\n"
                "[2] Vector memory holds sixteen megabytes per core.\n\n"
                "Question: What size is the matrix unit?\nAnswer:")


def _texts():
    return [
        "The matrix unit is a 128 by 128 systolic array. It performs one "
        "dense multiply per cycle. Accumulation always happens in float32 "
        "registers. The compiler tiles large contractions onto it.",
        "Vector memory holds sixteen megabytes per core. Loads from high "
        "bandwidth memory stream through it [3]. Double buffering hides the "
        "transfer latency behind compute.",
        "Reciprocal rank fusion scores an item by one over sixty plus its "
        "rank. The constant softens the head of each ranking. Items found "
        "by both channels gain the most.",
        "An inverted file index partitions the corpus into clusters. Each "
        "query probes only the closest centroids. Recall depends on the "
        "probe count and the cluster balance.",
        "Chunks overlap by one hundred fifty characters by default. The "
        "overlap preserves sentence context across boundaries. Larger "
        "overlap raises storage cost linearly.",
        "Temporal decay halves a document weight per half life. Recent "
        "documents therefore outrank stale duplicates. The half life is "
        "a tunable retrieval parameter.",
        "The cross encoder scores query document pairs jointly. It reads "
        "both texts in one sequence. Scores calibrate better than dual "
        "encoder dot products.",
        "Greedy decoding picks the argmax byte each step. Sampling "
        "introduces controlled randomness instead. Temperature scales "
        "the logit sharpness before the softmax.",
    ]


QUESTIONS = ["what size is the matrix unit?", "How much vector memory?",
             "what does the constant soften in rank fusion", "zebra?",
             "the a an", "Recall of an inverted file index depends on what "
             "and what else, in detail, per query?"]


def _pair(max_prompt_len=288, max_new_tokens=16, params=None):
    ref = jg.GroundedGenerator(J_TINY, params=params,
                               max_prompt_len=max_prompt_len,
                               max_new_tokens=max_new_tokens)
    port = pg.GroundedGenerator(
        P_TINY, params=convert.grounded_flax_to_torch(_flatten(ref.params),
                                                      P_TINY),
        max_prompt_len=max_prompt_len, max_new_tokens=max_new_tokens,
        device="cpu")
    return port, ref


# ------------------------------------------------------- prompt rendering

def test_render_prompt_matches_jax_byte_for_byte():
    long_doc = ("Filler sentence about nothing relevant here. " * 12
                + "The matrix unit is a 128 by 128 array. "
                + "More filler prose follows this important fact. " * 12)
    for docs, q, mb in ((["alpha beta gamma.", "delta epsilon."],
                         "what is alpha?", 400),
                        ([long_doc], "what size is the matrix unit?", 500),
                        (_texts(), QUESTIONS[0], 2500),
                        (_texts() + [long_doc], QUESTIONS[5], 300),
                        ([], "empty?", 100)):
        got = pg.render_prompt(docs, q, max_bytes=mb)
        assert got == jg.render_prompt(docs, q, max_bytes=mb)
    p = pg.render_prompt([long_doc], "what size is the matrix unit?",
                         max_bytes=500)
    assert len(p.encode()) <= 520 and "128 by 128" in p
    assert p.startswith("context:\n[1] ") and p.endswith(
        "question: what size is the matrix unit?\nanswer:")


@pytest.mark.parametrize("budget", [20, 60, 120, 10_000])
def test_compress_doc_matches_jax(budget):
    for doc in _texts() + ["no sentence boundary here at all " * 10]:
        assert pg.compress_doc(doc, QUESTIONS[0], budget) == \
            jg.compress_doc(doc, QUESTIONS[0], budget)


def test_select_and_render_candidates_match_jax():
    docs = _texts() + [_texts()[0]]            # a duplicate doc
    for q in QUESTIONS:
        for m in (1, 4, 8):
            cands = pg.select_candidates(q, docs, m=m)
            assert cands == jg.select_candidates(q, docs, m=m)
            for mb in (80, 400, 1700):
                assert pg.render_candidates(cands, q, max_bytes=mb) == \
                    jg.render_candidates(cands, q, max_bytes=mb)
    assert pg.select_candidates("the a an", docs) == []
    assert all("[3]" not in s for _, s in pg.select_candidates(
        QUESTIONS[1], docs))


# --------------------------------------------------------- mixture math

def test_copy_attention_and_mixed_log_probs_match_jax(rng):
    b, t, p, h, v = 2, 3, 11, 8, 259
    q = rng.standard_normal((b, t, h)).astype(np.float32)
    k = rng.standard_normal((b, p, h)).astype(np.float32)
    valid = np.ones((b, p), bool)
    valid[1, :4] = False
    att = pg.copy_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(valid))
    j_att = jg.copy_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(valid))
    np.testing.assert_allclose(att.numpy(), np.asarray(j_att), atol=MIX_TOL,
                               rtol=0)
    assert float(att[1, :, :4].abs().max()) == 0.0
    ids = rng.integers(0, v, (b, p))
    onehot = np.eye(v, dtype=np.float32)[ids]
    lm = 3 * rng.standard_normal((b, t, v)).astype(np.float32)
    gate = rng.standard_normal((b, t)).astype(np.float32)
    lp = pg.mixed_log_probs(torch.from_numpy(lm), att,
                            torch.from_numpy(onehot), torch.from_numpy(gate))
    j_lp = jg.mixed_log_probs(jnp.asarray(lm), j_att, jnp.asarray(onehot),
                              jnp.asarray(gate))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=MIX_TOL,
                               rtol=MIX_TOL)
    np.testing.assert_allclose(np.exp(lp.numpy()).sum(-1), 1.0, atol=1e-4)


def test_copy_heads_match_jax(rng):
    _, ref = _pair()
    heads = pg.CopyHeads(64, 32)
    heads.load_state_dict({k[len("heads."):]: v for k, v in
                           convert.grounded_flax_to_torch(
                               _flatten(ref.params), P_TINY).items()
                           if k.startswith("heads.")})
    h = rng.standard_normal((2, 5, 64)).astype(np.float32)
    got = heads(torch.from_numpy(h))
    want = jg.CopyHeads(32).apply(ref.params["heads"], jnp.asarray(h))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=F32_TOL, rtol=0)


# ------------------------------------------------------------ generator

def test_generator_greedy_matches_jax_and_is_deterministic():
    port, ref = _pair()
    prompts = [pg.render_prompt(["alpha beta gamma."], "what is alpha?",
                                max_bytes=200)]
    prompts += [pg.render_prompt(_texts()[:2], q, max_bytes=260)
                for q in QUESTIONS[:3]]
    a = port.generate(prompts[0])
    assert a == port.generate(prompts[0]) == ref.generate(prompts[0])
    outs = port.generate_batch(prompts)
    assert outs == ref.generate_batch(prompts)
    assert outs[0] == a
    assert port.generate_batch([prompts[0], prompts[0] + " "])[0] == a


def test_generator_sampling_properties():
    port, _ = _pair(max_new_tokens=12)
    p = pg.render_prompt(_texts()[:1], QUESTIONS[0], max_bytes=260)
    kw = dict(temperature=0.8, seed=4)
    assert port.generate(p, **kw) == port.generate(p, **kw)
    assert port.generate_batch([p, "x"], **kw)[0] == port.generate(p, **kw)
    assert port.generate(p, temperature=1e-5) == port.generate(p)
    with pytest.raises(ValueError, match="max_seq_len"):
        pg.GroundedGenerator(P_TINY, max_prompt_len=300, max_new_tokens=32,
                             device="cpu")


def test_jax_trained_params_generate_as_in_jax():
    """tests/test_grounded.py's trainer, a few steps: the trained
    parameters in the port give the JAX package's greedy text."""
    from optimized_rag_tpu.models.grounded_data import GroundedSampler
    from optimized_rag_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(3)
    sampler = GroundedSampler(_texts(), prompt_len=288, target_len=32,
                              doc_bytes=160)
    tr = jg.GroundedTrainer(J_TINY, make_mesh(data=1, model=1),
                            prompt_len=288, target_len=32,
                            learning_rate=3e-3, seed=0)
    for _ in range(6):
        tr.train_step(*sampler.batch(rng, 8))
    port, ref = _pair(max_new_tokens=24,
                      params=jax.device_get(tr.params))
    prompts = [sampler.sample(np.random.default_rng(s))[0] for s in (5, 6)]
    assert port.generate_batch(prompts) == ref.generate_batch(prompts)


# ------------------------------------------------------------- provider

def test_provider_routes_generate_and_falls_back_as_jax():
    port, ref = _pair(max_new_tokens=8)
    prov, j_prov = pg.GroundedProvider(port), jg.GroundedProvider(ref)
    keys = ("answer", "citations")
    out = prov.structured(AGENT_PROMPT, keys, task="generate")
    assert set(out) == set(keys) and out["answer"]
    assert out == j_prov.structured(AGENT_PROMPT, keys, task="generate")
    assert prov.complete(AGENT_PROMPT, task="generate") == \
        j_prov.complete(AGENT_PROMPT, task="generate")
    assert prov._native_prompt(AGENT_PROMPT) == \
        j_prov._native_prompt(AGENT_PROMPT)
    # no shared content word, or too little evidence: refusal, no model call
    for bad in ("Context:\n[1] Bananas are yellow.\n\nQuestion: What size "
                "is the matrix unit?\nAnswer:",
                "Context:\n[1] The unit exists.\n\nQuestion: matrix unit "
                "systolic array dimensions tile size?\nAnswer:"):
        assert prov._native_prompt(bad) is None
        assert prov.complete(bad, task="generate") == pg.REFUSAL == \
            j_prov.complete(bad, task="generate")
    assert prov.complete("Question: hi\n", task="intent") == \
        j_prov.complete("Question: hi\n", task="intent")


# --------------------------------------------------- the repo's checkpoint

def test_checkpoint_generates_the_jax_text():
    """checkpoints/grounded_r5 (6 layers, 384 wide, bf16) at a short prompt
    budget: the same config, first-step log-probs within BF16_TOL, and the
    JAX package's greedy answers up to a counted near-tie."""
    cfg, state = pretrain.load_pretrained(CKPT, "grounded")
    j_cfg, params = j_pretrain.load_pretrained(CKPT, "grounded")
    for f in ("hidden_dim", "num_layers", "num_heads", "copy_dim",
              "max_seq_len", "prompt_len", "target_len"):
        assert getattr(cfg, f) == getattr(j_cfg, f)
    port = pg.GroundedGenerator(cfg, params=state, max_prompt_len=384,
                                max_new_tokens=48, device="cpu")
    ref = jg.GroundedGenerator(j_cfg, params=params, max_prompt_len=384,
                               max_new_tokens=48)
    prov, j_prov = pg.GroundedProvider(port), jg.GroundedProvider(ref)
    agent = ("Context:\n" + "".join(f"[{i + 1}] {d}\n"
                                    for i, d in enumerate(_texts()))
             + "\nQuestion: {}\nAnswer:")
    prompts = [prov._native_prompt(agent.format(q)) for q in QUESTIONS[:3]]
    assert prompts == [j_prov._native_prompt(agent.format(q))
                       for q in QUESTIONS[:3]]
    # First-step mixed log-probs of the batch (measured 0.23 at most).
    ids, pad = pd.left_pad(prompts, 384)
    mask, pos, _ = pd.prefill_masks(torch.from_numpy(pad), 384, 1)
    with torch.no_grad():
        lg, _, h = port.model.backbone(torch.from_numpy(ids), key_valid=mask,
                                       pos_ids=pos)
        qc, kc, gate = port.model.heads(h)
        lp = pg.mixed_log_probs(
            lg[:, -1:], pg.copy_attention(qc[:, -1:], kc, mask),
            torch.nn.functional.one_hot(torch.from_numpy(ids), 259).float(),
            gate[:, -1:])[:, 0]
    j_lg, _, j_qc, j_kc, j_gate = ref._forward(
        ref.params, jnp.asarray(ids, jnp.int32), key_valid=jnp.asarray(
            mask.numpy()), pos_ids=jnp.asarray(pos.numpy()))
    j_lp = jg.mixed_log_probs(
        j_lg[:, -1:], jg.copy_attention(j_qc[:, -1:], j_kc,
                                        jnp.asarray(mask.numpy())),
        jax.nn.one_hot(jnp.asarray(ids), 259), j_gate[:, -1:])[:, 0]
    assert np.abs(lp.numpy() - np.asarray(j_lp)).max() <= BF16_TOL
    got, want = port.generate_batch(prompts), ref.generate_batch(prompts)
    ties = 0
    for prompt, a, b in zip(prompts, got, want):
        ta, tb = list(pd.encode_bytes(a)[1:]), list(pd.encode_bytes(b)[1:])
        if ta == tb:
            continue
        t = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                 min(len(ta), len(tb)))
        # The port's log-probs before the first differing token.
        ids, pad = pd.left_pad([prompt], 384)
        toks = torch.tensor([tb[:t]], dtype=torch.long)
        full = torch.cat([torch.from_numpy(ids), toks], dim=1)
        valid = torch.ones_like(full, dtype=torch.bool)
        valid[0, :int(pad[0])] = False
        pos_ids = torch.clamp_min(torch.arange(full.shape[1]) - int(pad[0]),
                                  0)[None]
        with torch.no_grad():
            lg, _, h = port.model.backbone(full, key_valid=valid,
                                           pos_ids=pos_ids)
            qc, kc, gate = port.model.heads(h)
            att = pg.copy_attention(qc[:, -1:], kc[:, :384], valid[:, :384])
            lp = pg.mixed_log_probs(lg[:, -1:], att, torch.nn.functional
                                    .one_hot(full[:, :384], 259).float(),
                                    gate[:, -1:])[0, 0]
        top = torch.topk(lp, 2)
        assert float(top.values[0] - top.values[1]) <= BF16_TOL, (a, b)
        assert int(top.indices[0]) in (ta + [pd.EOS])[t:t + 1] + \
            (tb + [pd.EOS])[t:t + 1], (a, b)
        ties += 1
    assert ties <= 1, (got, want)
    assert any(g.strip() for g in got)
