"""The port's C++ analyzer bridge (``optimized_rag_tpu_torch/native.py``)
against the JAX package's Python analyzer, which is authoritative.

The library is built by g++ from ``native/analyzer.cpp`` into ``build/``;
the port never loads the JAX package's ``native/liborag_native.so``. Every
id must equal the Python path's exactly: term ids, per-document term counts
and lengths, model-tokenizer ids (hash and learned vocabulary), and a
``LexicalIndex``'s built arrays and search results (scores within 1e-6
relative, as ``tests/test_torch_lexical.py`` holds the two packages'
float32 idf). The JAX package's ``LexicalIndex`` is held on its Python
path (its own native library is switched off here).
"""

import gc
import glob
import os
import re
import subprocess
import sys
import threading
from collections import Counter

import numpy as np
import pytest

import optimized_rag_tpu.native as jax_native
from optimized_rag_tpu.index.lexical import LexicalIndex as JaxLexical
from optimized_rag_tpu.index.lexical import lexical_tokens as jax_tokens
from optimized_rag_tpu.models.tokenizer import HashTokenizer as JaxHash
from optimized_rag_tpu.models.tokenizer import VocabTokenizer as JaxVocab
from optimized_rag_tpu_torch import native
from optimized_rag_tpu_torch.index.lexical import LexicalIndex
from optimized_rag_tpu_torch.models.tokenizer import (
    HashTokenizer, VocabTokenizer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
EDGE = [
    "",
    "The quick brown fox jumps over the lazy dog!",
    "a the and of in is",                                   # stopwords only
    "punctuation: (parens) [brackets] {braces} ... !!! ###",
    "Supercalifragilisticexpialidocious antidisestablishmentarianism",
    "abcdefghijkl abcdefghijklm abcdefghijklmn",            # 12, 13, 14
    "digits 12345 3.14159 v5e bfloat16 x86_64 2021-06-30",
    "mixed CASE Text With   Multiple   spaces\nand\tnewlines",
    "word\x7fother a\x01b\x1cc d\x00e \x08tail\x1f",          # control bytes
    "scanning scans scanned storing stored stores",
]
NON_ASCII = ["café résumé naïve", "日本語テキスト", "ünïcode — dash"]


def _chunks():
    out = []
    for path in sorted(glob.glob(os.path.join(
            REPO, "optimized_rag_tpu", "eval", "qa_docs", "*.md"))):
        with open(path, encoding="utf-8") as f:
            out += [p.strip() for p in f.read().split("\n\n") if p.strip()]
    return out


def _texts(n_filler=200, seed=0):
    chunks = _chunks()
    words = [w for c in chunks for w in c.split()]
    rng = np.random.default_rng(seed)
    return chunks + [" ".join(rng.choice(words, size=int(rng.integers(
        5, 41)))) for _ in range(n_filler)] + EDGE


@pytest.fixture
def jax_python_path(monkeypatch):
    """The JAX package's analyzer on its Python path."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_load_attempted", True)


def test_parallel_builds_give_one_loadable_library(tmp_path):
    code = ("import sys; from optimized_rag_tpu_torch import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "native.build()\n"
            "print(native.library_path())\n"
            "print(native.model_tokenize('hello world', 4096))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    paths = {o.splitlines()[0] for o, _ in outs}
    assert len(paths) == 1
    libs = glob.glob(os.path.join(tmp_path, "*.so"))
    assert libs == [paths.pop()]
    want = [JaxHash(4096)._tid("hello"), JaxHash(4096)._tid("world")]
    assert {o.splitlines()[1] for o, _ in outs} == {str(want)}


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "analyzer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="(?s)building the native analyzer "
                                           "failed.*error"):
        native._compile(native.find_compiler(), native.library_path())
    assert not glob.glob(str(tmp_path / "out" / "*.so"))


def test_tokenize_hash_and_term_counts_match_python():
    ref = JaxLexical(vocab_hash_bits=15)
    for text in _texts():
        toks = jax_tokens(text)
        want = [ref._term_id(t) for t in toks]
        assert native.tokenize_hash(text, ref.vocab_size).tolist() == want
        terms, tfs, dlen = native.term_counts(text, ref.vocab_size)
        assert dlen == len(toks)
        assert dict(zip(terms.tolist(), tfs.tolist())) == dict(Counter(want))


@pytest.mark.parametrize("vocab_size", [4096, 32768])
def test_model_tokenize_matches_python(vocab_size):
    ref = JaxHash(vocab_size)
    for text in _texts():
        want = []
        for w in re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower()):
            want.append(ref._tid(w))
            if len(w) > 12:
                want += [ref._tid("##" + w[i:i + 3])
                         for i in range(0, len(w) - 2, 3)]
        assert native.model_tokenize(text, vocab_size) == want
        assert HashTokenizer(vocab_size).tokenize(text) == want


def test_non_ascii_text_takes_the_python_path(jax_python_path):
    for text in NON_ASCII:
        assert native.tokenize_hash(text, 1024) is None
        assert native.term_counts(text, 1024) is None
        assert native.model_tokenize(text, 1024) is None
        assert HashTokenizer(4096).tokenize(text) == \
            JaxHash(4096).tokenize(text)
    ref, port = JaxLexical(vocab_hash_bits=12), LexicalIndex(
        vocab_hash_bits=12, device="cpu")
    ref.add(NON_ASCII + EDGE)
    port.add(NON_ASCII + EDGE)
    assert port._doc_len == ref._doc_len
    assert {t: dict(p) for t, p in port._postings.items()} == \
        {t: dict(p) for t, p in ref._postings.items()}


def test_vocab_tokenizer_native_matches_python_and_releases():
    chunks = _chunks()
    ref = JaxVocab.train(chunks, vocab_size=4096)
    vt = VocabTokenizer(ref.words, vocab_size=4096)
    texts = _texts() + ["unknown extraordinarilylongword anotherlongoovword",
                        "The matrix unit is a 128x128 systolic array?"]
    for text in texts:
        fast = vt.tokenize(text)
        handle = vt._native_handle
        assert handle is not None
        vt._native_handle = None
        try:
            slow = vt.tokenize(text)
        finally:
            vt._native_handle = handle
        assert fast == slow == _jax_vocab_python(ref, text), text
    assert vt.tokenize(NON_ASCII[0]) == _jax_vocab_python(ref, NON_ASCII[0])
    assert native.vocab_tokenize(handle, NON_ASCII[0]) is None
    # __del__ frees the C++ map: the handle is unknown afterwards.
    del vt
    gc.collect()
    assert native.vocab_tokenize(handle, "hello") is None


def _jax_vocab_python(tok, text):
    """The JAX package's VocabTokenizer on its Python path."""
    saved, tok._native_handle = tok._native_handle, None
    tried, tok._native_tried = tok._native_tried, True
    try:
        return tok.tokenize(text)
    finally:
        tok._native_handle, tok._native_tried = saved, tried


def test_vocab_tokenizer_builds_one_handle_under_threads():
    vt = VocabTokenizer(["alpha", "beta"], vocab_size=4096)
    barrier = threading.Barrier(8)
    out = []

    def work():
        barrier.wait(timeout=10)
        out.append(vt.tokenize("alpha beta gamma"))

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(out) == 8 and all(o == out[0] for o in out)
    assert out[0][:2] == [4, 5]


@pytest.mark.parametrize("cap", [1024, 8])
def test_native_lexical_index_matches_jax_python_path(jax_python_path, cap):
    texts = _texts()
    ref = JaxLexical(vocab_hash_bits=17, cap=cap)
    port = LexicalIndex(vocab_hash_bits=17, cap=cap, device="cpu")
    ref.add(texts)
    port.add(texts)
    ref.build()
    port.build()
    assert port._row_of == ref._row_of
    for key in ("champ_docs", "champ_tf", "champ_valid", "doc_len",
                "avg_len"):
        np.testing.assert_array_equal(port._device[key].numpy(),
                                      np.asarray(ref._device[key]), key)
    np.testing.assert_allclose(port._device["idf"].numpy(),
                               np.asarray(ref._device["idf"]), rtol=RTOL)
    for query in ("dense index deletes", "memory tier budget owners",
                  "scanning stored bfloat16", "zzzqqq"):
        s_ref, i_ref = ref.search(query, k=20)
        s, i = port.search(query, k=20)
        np.testing.assert_array_equal(i, i_ref)
        np.testing.assert_allclose(s, s_ref, rtol=RTOL)


def test_colliding_stems_follow_each_reference_path(jax_python_path,
                                                     monkeypatch):
    """'lay' and 'test' share a term id at 2^17 buckets. The C++ analyzer
    counts a document's tf per term id (their sum); the Python path, in
    both packages, keeps the count of the stem seen last. The reference's
    two paths disagree on such a document, and the port's follow them."""
    ref = JaxLexical()
    assert ref._term_id("lay") == ref._term_id("test")
    tid = ref._term_id("test")
    texts = ["lay the test test out", "test lay lay lay", "test only"]
    native_idx = LexicalIndex(device="cpu")
    native_idx.add(texts)
    assert dict(native_idx._postings[tid]) == {0: 3, 1: 4, 2: 1}
    monkeypatch.setattr(native, "term_counts", lambda *a: None)
    python_idx = LexicalIndex(device="cpu")
    python_idx.add(texts)
    ref.add(texts)
    assert dict(ref._postings[tid]) == {0: 2, 1: 3, 2: 1}
    assert dict(python_idx._postings[tid]) == dict(ref._postings[tid])


def test_colliding_stems_in_non_ascii_text_match_the_reference():
    """Non-ASCII text takes the Python path in both packages, with its
    colliding stems too: the port's index equals the JAX package's, with
    or without the JAX package's own native library."""
    texts = ["café: lay the test test out", "test lay lay lay — naïve",
             "résumé test only", "ünïcode lay lay test"]
    ref = JaxLexical()
    port = LexicalIndex(device="cpu")
    ref.add(texts)
    port.add(texts)
    tid = ref._term_id("test")
    assert dict(port._postings[tid]) == {0: 2, 1: 3, 2: 1, 3: 1}
    assert port._postings == ref._postings
    ref.build()
    port.build()
    for key in ("champ_docs", "champ_tf", "champ_valid", "doc_len"):
        np.testing.assert_array_equal(port._device[key].numpy(),
                                      np.asarray(ref._device[key]), key)
    for query in ("test", "lay out naïve", "résumé only"):
        s_ref, i_ref = ref.search(query, k=4)
        s, i = port.search(query, k=4)
        np.testing.assert_array_equal(i, i_ref)
        np.testing.assert_allclose(s, s_ref, rtol=RTOL)


def test_python_path_lexical_index_equals_native(monkeypatch):
    texts = _texts()
    a = LexicalIndex(device="cpu")
    a.add(texts)
    monkeypatch.setattr(native, "term_counts", lambda *args: None)
    b = LexicalIndex(device="cpu")
    b.add(texts)
    a.build()
    b.build()
    for key in ("champ_docs", "champ_tf", "champ_valid", "doc_len", "idf"):
        np.testing.assert_array_equal(a._device[key].numpy(),
                                      b._device[key].numpy(), key)
