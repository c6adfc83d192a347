"""The plain reference: its top-k against a brute-force float64 top-k, its
encoder at float32 against itself at float64, its tokenizer against the
program's."""

import os

import numpy as np
import torch

from portbench import system, texts
from portbench.reference import encoder as ref_encoder
from portbench.reference.topk import RunningTopK, scores_of, store

CFG = {"vocab_size": 32768, "num_hidden_layers": 6,
       "num_attention_heads": 12,
       "encoder": {"checkpoint": "checkpoints/pretrained",
                   "params": "biencoder.params.npz", "max_len": 128}}


def test_running_topk_is_the_brute_force_topk():
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(3000, 24, generator=g, dtype=torch.float64)
    q = torch.randn(7, 24, generator=g, dtype=torch.float64)
    top = RunningTopK(q, 10, sub=256)
    for lo in range(0, 3000, 1000):
        top.feed(rows[lo:lo + 1000], lo)
    want_s, want_i = torch.topk(q @ rows.T, 10, dim=1)
    assert torch.allclose(top.scores, want_s, rtol=0, atol=1e-12)
    assert torch.equal(top.ids, want_i)


def test_scores_of_picks_each_answer_in_its_block():
    g = torch.Generator().manual_seed(1)
    rows = torch.randn(100, 8, generator=g, dtype=torch.float64)
    q = torch.randn(3, 8, generator=g, dtype=torch.float64)
    qidx = torch.tensor([0, 1, 2, 2])
    ids = torch.tensor([5, 99, 0, 50])
    out = torch.zeros(4, dtype=torch.float64)
    scores_of(q, qidx, ids, rows[:50], 0, out)
    scores_of(q, qidx, ids, rows[50:], 50, out)
    want = (q[qidx] * rows[ids]).sum(dim=1)
    assert torch.allclose(out, want, atol=0, rtol=0)


def test_store_rounds_to_the_stated_dtype():
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(2))
    u = x / torch.sqrt((x * x).sum(dim=1, keepdim=True))
    assert torch.equal(store(x, "float32"), u.double())
    assert torch.equal(store(x, "bfloat16"), u.to(torch.bfloat16).double())
    q8 = store(x, "int8")
    assert (q8 - u.double()).abs().max() < 1.0 / 127


def test_plain_encoder_float32_against_float64():
    npz = ref_encoder.load_npz(os.path.join(
        system.checkpoint_dir(CFG), "biencoder.params.npz"))
    tok = system.tokenizer(CFG)
    sample = texts.sentences()[:12]
    e32 = ref_encoder.Encoder(npz, 6, 12, "cpu").encode(tok, sample, 128)
    e64 = ref_encoder.Encoder(npz, 6, 12, "cpu", dtype=torch.float64
                              ).encode(tok, sample, 128)
    assert e32.dtype == torch.float32 and e64.dtype == torch.float64
    assert (e32.double() - e64).abs().max() < 1e-5


def test_frozen_tokenizer_gives_the_programs_ids():
    from optimized_rag_tpu_torch.models.convert import load_tokenizer
    prog = load_tokenizer(system.checkpoint_dir(CFG), 32768, 128)
    ref = system.tokenizer(CFG)
    sample = texts.sentences()[:40] + [
        "Supercalifragilisticexpialidocious retrievalaugmentation 42!",
        "tell me about explain what does the doc say on"]
    for t in sample:
        assert ref.tokenize(t) == prog.tokenize(t), t
    ids, mask = ref.encode_batch(sample, 128)
    pids, pmask = prog.encode_batch(sample, 128)
    n = ids.shape[1]
    assert np.array_equal(ids, pids[:, :n]) and not pids[:, n:].any()
    assert np.array_equal(mask, pmask[:, :n])


def test_kept_qa_docs_rows_are_the_plain_encoders():
    from portbench.corpus import qa_docs_rows
    kept = np.load(qa_docs_rows.PATH)
    rows = qa_docs_rows.encode(CFG)
    assert kept.dtype == np.float32 and kept.shape == (len(texts.chunks()),
                                                       384)
    assert np.abs(kept - rows).max() < 1e-5
