"""The chat turn's engine components in the PyTorch port against the JAX
package's, on the same inputs on the CPU.

Consistency checking and semantic dedup compute a pairwise cosine on the
port's device (the CPU here): the similarity matrices agree within 1e-6,
and the contradiction lists and kept indices must be equal. Pairs whose
float64 cosine lies within 1e-6 of a threshold could cross it between the
two packages; each case counts them and requires none in its data, so an
equality here is not an accident of rounding. The other components are
host code copied from the JAX package: their outputs must be identical.
The embedder is ``tests/fakes.py``'s deterministic ``FakeEmbedder``,
shared by both sides.
"""

import dataclasses
import enum
import zipfile

import numpy as np
import pytest
import torch

from optimized_rag_tpu.engine import adaptive as jax_adaptive
from optimized_rag_tpu.engine import chunking as jax_chunking
from optimized_rag_tpu.engine import compressor as jax_compressor
from optimized_rag_tpu.engine import consistency as jax_consistency
from optimized_rag_tpu.engine import documents as jax_documents
from optimized_rag_tpu.engine import hierarchical as jax_hier
from optimized_rag_tpu.engine import pdf as jax_pdf
from optimized_rag_tpu.engine import types as jax_types
from optimized_rag_tpu.engine import wrangler as jax_wrangler
from optimized_rag_tpu_torch.engine import adaptive, chunking, compressor
from optimized_rag_tpu_torch.engine import consistency, documents
from optimized_rag_tpu_torch.engine import hierarchical, pdf, types
from optimized_rag_tpu_torch.engine import wrangler

from fakes import FakeEmbedder
from test_pdf import _minimal_pdf

SIM_TOL = 1e-6      # float32 cosine of unit rows, two summation orders
TIE_GAP = 1e-6      # float64 distance from a threshold that counts a tie

SENTENCES = [
    "the tower is 300 meters tall and made of iron",
    "the tower is 450 meters tall and made of iron",
    "the tower is not made of iron and is 300 meters tall",
    "tpus accelerate matrix multiplication with systolic arrays",
    "tpus do not accelerate matrix multiplication with systolic arrays",
    "the cat sat on the warm windowsill in the sun",
    "bananas are rich in potassium and grow in tropical climates",
    "the sky is blue today",
    "the sky is not blue today",
    "it was never cold in the valley",
    "it was always cold in the valley",
    "the report is correct and complete",
]


@pytest.fixture
def embed():
    return FakeEmbedder(dim=64)


def _plain(x):
    """A comparable form of either package's outputs."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _docs(mod, scores, texts=None):
    texts = texts or [f"doc {i}" for i in range(len(scores))]
    return [mod.RetrievedDoc(doc_id=i, score=s, text=t, created_at=0.0)
            for i, (s, t) in enumerate(zip(scores, texts))]


def _same_check(got, want):
    """Equal consistency reports: the same pairs, in order, and verdict;
    each pair's cosine within SIM_TOL (float32, two summation orders)."""
    assert got.keys() == want.keys()
    assert got["consistent"] == want["consistent"]
    assert got["confidence_multiplier"] == want["confidence_multiplier"]
    assert [c[:2] for c in got["contradictions"]] == \
        [c[:2] for c in want["contradictions"]]
    np.testing.assert_allclose([c[2] for c in got["contradictions"]],
                               [c[2] for c in want["contradictions"]],
                               atol=SIM_TOL)


def _threshold_ties(sim, threshold):
    """Pairs (i < j) whose cosine lies within TIE_GAP of ``threshold``."""
    iu = np.triu_indices(sim.shape[0], k=1)
    return int((np.abs(sim[iu] - threshold) <= TIE_GAP).sum())


# --------------------------------------------------------------- consistency

@pytest.mark.parametrize("threshold", [0.5, 0.7, 0.85])
def test_consistency_checker_matches_jax(embed, threshold):
    ref = jax_consistency.ConsistencyChecker(embed, sim_threshold=threshold)
    port = consistency.ConsistencyChecker(embed, sim_threshold=threshold,
                                          device="cpu")
    emb = embed(SENTENCES).astype(np.float64)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    assert _threshold_ties(emb @ emb.T, threshold) == 0
    want = ref.check_consistency(_docs(jax_types, [0.9] * 12, SENTENCES))
    got = port.check_consistency(_docs(types, [0.9] * 12, SENTENCES))
    _same_check(got, want)
    assert want["contradictions"] or threshold == 0.85


def test_consistency_checker_precomputed_sim_and_shape_error(embed):
    ref = jax_consistency.ConsistencyChecker(embed, sim_threshold=0.6)
    port = consistency.ConsistencyChecker(embed, sim_threshold=0.6,
                                          device="cpu")
    docs_j = _docs(jax_types, [0.9] * 5, SENTENCES[:5])
    docs_p = _docs(types, [0.9] * 5, SENTENCES[:5])
    sim = np.asarray(embed(SENTENCES[:5]) @ embed(SENTENCES[:5]).T)
    assert port.check_consistency(docs_p, sim=sim) == \
        ref.check_consistency(docs_j, sim=sim)
    for checker, docs in ((ref, docs_j), (port, docs_p)):
        with pytest.raises(ValueError, match="sim matrix shape"):
            checker.check_consistency(docs, sim=sim[:4, :4])
    one = port.check_consistency(docs_p[:1])
    assert one == ref.check_consistency(docs_j[:1])
    assert one["consistent"] and one["confidence_multiplier"] == 1.0


def test_consistency_pairwise_cosine_matches_jax(embed):
    from optimized_rag_tpu.ops.similarity import pairwise_cosine as jax_pc
    from optimized_rag_tpu_torch.ops.similarity import pairwise_cosine
    emb = embed(SENTENCES)
    got = pairwise_cosine(torch.from_numpy(emb)).numpy()
    want = np.asarray(jax_pc(emb))
    np.testing.assert_allclose(got, want, atol=SIM_TOL)


@pytest.mark.parametrize("a,b", [
    ("the sky is not blue", "the sky is blue"),
    ("it costs 5 dollars", "it costs 7 dollars"),
    ("the sky is blue", "the sky is blue"),
    ("this cannot fail", "this can fail"),
    ("the answer is false", "the answer is true"),
    ("version 2.5 shipped", "version 2.5 shipped on time"),
    ("no numbers here", "still no numbers"),
])
def test_is_contradiction_matches_jax(a, b):
    assert consistency.is_contradiction(a, b) == \
        jax_consistency.is_contradiction(a, b)


# -------------------------------------------------------------- wrangling

MESSY = ["  Some   text\n\n\n\nwith   mess \x00control ",
         "visit https://example.com/x or mail a@b.co now\t\tplease",
         "# Title\n\n| a | b |\n|---|---|\n- item one\n1. item two\n"
         "```code block```\n## Sub heading",
         "você não sabe que isso é muito bom para mim",
         "los gatos son muy bonitos pero este perro",
         ""]


@pytest.mark.parametrize("urls,emails", [(False, False), (True, True)])
def test_text_cleaner_and_structure_match_jax(urls, emails):
    for text in MESSY:
        assert wrangler.TextCleaner().clean(text, urls, emails) == \
            jax_wrangler.TextCleaner().clean(text, urls, emails)
        assert wrangler.StructureExtractor().extract(text) == \
            jax_wrangler.StructureExtractor().extract(text)


def test_quality_scorer_and_language_match_jax():
    for text in MESSY + SENTENCES:
        assert wrangler.QualityScorer().score(text) == \
            jax_wrangler.QualityScorer().score(text)
        assert wrangler.detect_language(text) == \
            jax_wrangler.detect_language(text)


def test_data_wrangler_matches_jax():
    for text in MESSY:
        got = wrangler.DataWrangler(min_quality=0.5).process(
            text, {"source": "t"})
        assert got == jax_wrangler.DataWrangler(min_quality=0.5).process(
            text, {"source": "t"})


DEDUP_TEXTS = [
    "the quick brown fox jumps over a lazy dog",
    "The quick brown fox jumps over a lazy dog",       # exact (case)
    "the quick brown fox jumps over a lazy dot",       # fuzzy
    "completely different content about tpus",
    "tpus content about completely different",         # same words
    "bananas are rich in potassium",
    "potassium rich bananas are",                      # same words
    "an unrelated sentence on weather in spring",
]


@pytest.mark.parametrize("semantic", [False, True])
@pytest.mark.parametrize("threshold", [0.95, 0.8])
def test_deduplicator_matches_jax(embed, semantic, threshold):
    ref = jax_wrangler.Deduplicator(semantic_threshold=threshold,
                                    embed_fn=embed)
    port = wrangler.Deduplicator(semantic_threshold=threshold,
                                 embed_fn=embed, device="cpu")
    emb = embed(DEDUP_TEXTS).astype(np.float64)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    assert _threshold_ties(emb @ emb.T, threshold) == 0
    keep = port.dedup(DEDUP_TEXTS, semantic=semantic)
    assert keep == ref.dedup(DEDUP_TEXTS, semantic=semantic)
    assert keep[:2] == [0, 3]
    if semantic:      # a word-order twin embeds alike and is dropped
        assert 4 not in keep


def test_semantic_dedup_compares_kept_rows_as_jax():
    vecs = {"alpha": [1.0, 0.0], "beta": [1.0, 0.0],
            "gamma": [0.0, 1.0], "delta": [0.0, 1.0]}
    texts = ["alpha stands entirely alone here",
             "beta text shares nothing lexically with the first one",
             "gamma covers an unrelated topic in other words",
             "delta also written with no overlapping words at all"]

    def embed(batch):
        return np.asarray([vecs[t.split()[0]] for t in batch], np.float32)

    port = wrangler.Deduplicator(embed_fn=embed, semantic_threshold=0.9,
                                 device="cpu")
    ref = jax_wrangler.Deduplicator(embed_fn=embed, semantic_threshold=0.9)
    assert port.dedup(texts, semantic=True) == \
        ref.dedup(texts, semantic=True) == [0, 2]


def test_text_only_wrangling_needs_no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert wrangler.Deduplicator().device is None
    assert wrangler.DataWrangler().dedup.device is None
    assert documents.DocumentProcessor().wrangler.dedup.device is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wrangler.Deduplicator(embed_fn=FakeEmbedder())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wrangler.DataWrangler(embed_fn=FakeEmbedder())


# ------------------------------------------------------------- compression

COMPRESS_TEXT = ("tpus multiply matrices quickly. bananas are yellow fruit. "
                 "the matrix unit is a systolic array! why do arrays pump "
                 "data? memory bandwidth bounds the scan.\nnew line here.")


@pytest.mark.parametrize("confidence,n_docs,max_tokens", [
    (0.95, 3, 400), (0.95, 9, 400), (0.7, 9, 60), (0.3, 9, 40),
    (0.95, 9, 10)])
def test_context_compressor_matches_jax(embed, confidence, n_docs,
                                        max_tokens):
    kw = dict(max_tokens=max_tokens, sentences_per_doc=1,
              conservative_mode=False, skip_doc_count=2)
    texts = [COMPRESS_TEXT if i % 2 else COMPRESS_TEXT.upper()
             for i in range(n_docs)]
    got = compressor.ContextCompressor(embed, **kw).compress(
        "matrix multiplication systolic", _docs(types, [0.9] * n_docs, texts),
        confidence=confidence)
    want = jax_compressor.ContextCompressor(embed, **kw).compress(
        "matrix multiplication systolic",
        _docs(jax_types, [0.9] * n_docs, texts), confidence=confidence)
    assert _plain(got) == _plain(want)


def test_split_sentences_and_tokens_match_jax():
    for text in [COMPRESS_TEXT, "", "one. two! three?"] + MESSY:
        assert compressor.split_sentences(text) == \
            jax_compressor.split_sentences(text)
        assert compressor.approx_tokens(text) == \
            jax_compressor.approx_tokens(text)


# ---------------------------------------------------------------- chunking

LONG_TEXT = ("para one. " * 30 + "\n\n" + "para two is here. " * 20
             + "\n\n" + "x" * 700 + "\n" + COMPRESS_TEXT * 3)


@pytest.mark.parametrize("size,overlap", [(100, 20), (333, 0), (64, 63)])
def test_fixed_and_recursive_chunkers_match_jax(size, overlap):
    for mod_p, mod_j in ((chunking, jax_chunking),):
        for cls in ("FixedSizeChunker", "RecursiveChunker"):
            got = getattr(mod_p, cls)(size, overlap).chunk(LONG_TEXT,
                                                           {"d": 1})
            want = getattr(mod_j, cls)(size, overlap).chunk(LONG_TEXT,
                                                            {"d": 1})
            assert got == want


@pytest.mark.parametrize("threshold,max_chars", [(0.3, 500), (0.6, 120)])
def test_semantic_chunker_matches_jax(embed, threshold, max_chars):
    text = ("tpus multiply matrices. tpus have systolic arrays. "
            "tpus use high bandwidth memory. bananas are yellow. "
            "bananas grow on trees. bananas have potassium. " + COMPRESS_TEXT)
    got = chunking.SemanticChunker(embed, threshold=threshold,
                                   max_chars=max_chars).chunk(text)
    want = jax_chunking.SemanticChunker(embed, threshold=threshold,
                                        max_chars=max_chars).chunk(text)
    assert got == want and len(got) >= 2


# --------------------------------------------------------------- documents

def _write_docs(tmp_path):
    paths = {}
    (tmp_path / "a.txt").write_text("Plain   text\n\n\n\nfile body.")
    (tmp_path / "b.md").write_text("# Heading\n\n- item\n\n```x = 1```\n")
    (tmp_path / "c.html").write_text(
        "<html><head><style>p{}</style><script>var x;</script></head><body>"
        "<h1>Title</h1><p>Para &amp; more</p><br/>tail</body></html>")
    doc_xml = (
        '<?xml version="1.0"?><w:document '
        'xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/'
        'main"><w:body><w:p><w:r><w:t>Hello docx</w:t></w:r></w:p>'
        '<w:p><w:r><w:t>Second paragraph.</w:t></w:r></w:p>'
        '</w:body></w:document>')
    with zipfile.ZipFile(tmp_path / "d.docx", "w") as z:
        z.writestr("word/document.xml", doc_xml)
    (tmp_path / "e.pdf").write_bytes(_minimal_pdf(
        b"BT /F1 12 Tf (Retrieval augmented generation uses fused "
        b"kernels.) Tj ET"))
    for name in ("a.txt", "b.md", "c.html", "d.docx", "e.pdf"):
        paths[name] = str(tmp_path / name)
    return paths


def test_document_processor_matches_jax(tmp_path):
    for name, path in _write_docs(tmp_path).items():
        got = documents.DocumentProcessor().process_file(path, {"k": name})
        want = jax_documents.DocumentProcessor().process_file(
            path, {"k": name})
        assert got == want, name
        assert got["content"], name
    with pytest.raises(ValueError, match="unsupported"):
        documents.DocumentProcessor().extract_text(str(tmp_path / "x.bin"))


PDF_CONTENTS = [
    (b"BT /F1 12 Tf 72 700 Td (Hello RAG world) Tj ET", True),
    (b"BT /F1 12 Tf 72 700 Td [(Hyb)-7(rid)-280(retrieval)] TJ ET", False),
    (rb"BT /F1 12 Tf (line \(one\)) Tj 0 -14 Td (line two \\ done) Tj ET",
     True),
    (b"BT /F1 12 Tf 1 0 0 1 72 700 Tm (hyphen-) Tj 1 0 0 1 72 686 Tm "
     b"(ated words) Tj T* (next) Tj ET", True),
]


@pytest.mark.parametrize("case", range(len(PDF_CONTENTS)))
def test_extract_pdf_text_matches_jax(tmp_path, case):
    content, compress = PDF_CONTENTS[case]
    p = tmp_path / "t.pdf"
    p.write_bytes(_minimal_pdf(content, compress=compress))
    assert pdf.extract_pdf_text(str(p)) == jax_pdf.extract_pdf_text(str(p))


def test_extract_pdf_tounicode_and_no_text_match_jax(tmp_path):
    import zlib
    cmap = (b"1 begincodespacerange <0000> <FFFF> endcodespacerange\n"
            b"3 beginbfchar\n<0001> <0054>\n<0002> <0050>\n<0003> <0055>\n"
            b"endbfchar\n1 beginbfrange\n<0010> <0012> <0041>\nendbfrange\n")
    cdata = zlib.compress(cmap)
    extra = (b"\n6 0 obj << /Filter /FlateDecode /Length "
             + str(len(cdata)).encode() + b" >> stream\n" + cdata
             + b"\nendstream endobj"
             b"\n7 0 obj << /Type /Font /Subtype /Type0 "
             b"/ToUnicode 6 0 R >> endobj")
    pdf_bytes = _minimal_pdf(b"BT /F2 10 Tf <000100020003> Tj "
                             b"<001000110012> Tj ET", extra_objects=extra)
    p = tmp_path / "t.pdf"
    p.write_bytes(pdf_bytes.replace(b"/Font << /F1 5 0 R >>",
                                    b"/Font << /F1 5 0 R /F2 7 0 R >>"))
    got = pdf.extract_pdf_text(str(p))
    assert got == jax_pdf.extract_pdf_text(str(p)) and "TPU" in got
    p.write_bytes(b"%PDF-1.4\nnothing here\n%%EOF")
    for mod in (pdf, jax_pdf):
        with pytest.raises(ValueError):
            mod.extract_pdf_text(str(p))


# ---------------------------------------------------------------- adaptive

QUERIES = ["compare x and y", "what is a tpu", "the weather there",
           "latest recent news today", "explain why the code in python "
           "fails and how to fix the function", "medical diagnosis of "
           "the patient symptoms", "something neutral here", ""]


def test_feature_extractor_matches_jax():
    port, ref = adaptive.QueryFeatureExtractor(), \
        jax_adaptive.QueryFeatureExtractor()
    for q in QUERIES:
        for intent in (None, "search", "comparison"):
            assert port.extract_complexity(q, intent).value == \
                ref.extract_complexity(q, intent).value
        assert _plain(port.extract_domain_indicators(q)) == \
            _plain(ref.extract_domain_indicators(q))


class _RecordingDB:
    def __init__(self):
        self.calls = []

    def load_learned_weights(self, *a):
        return None

    def save_performance(self, rec):
        self.calls.append(("perf", _plain(rec)))

    def save_learned_weights(self, *a):
        self.calls.append(("weights", _plain(a)))


@pytest.mark.parametrize("lr,rounds", [(0.1, 3), (0.5, 7)])
def test_dynamic_weight_manager_matches_jax(lr, rounds):
    dbs = _RecordingDB(), _RecordingDB()
    port = adaptive.DynamicWeightManager(learning_rate=lr, db=dbs[0],
                                         persist_every=2)
    ref = jax_adaptive.DynamicWeightManager(learning_rate=lr, db=dbs[1],
                                            persist_every=2)
    for r in range(rounds):
        fb = {"semantic": 1.0 - 0.1 * r, "keyword": 0.1 * r,
              "temporal": 0.05, "knowledge_graph": 0.0}
        for mgr, mod in ((port, adaptive), (ref, jax_adaptive)):
            mgr.record_feedback(fb, quality=0.5 + 0.05 * r, intent="search",
                                complexity=mod.QueryComplexity.MODERATE)
    for q in QUERIES:
        for intent in ("search", "question_answering", "comparison"):
            assert port.calculate_optimal_weights(q, intent) == \
                ref.calculate_optimal_weights(q, intent)
    assert dbs[0].calls == dbs[1].calls and dbs[0].calls


# ------------------------------------------------------------------- tiers

@pytest.mark.parametrize("scores,intent,semantic", [
    ([0.9, 0.88, 0.87, 0.9, 0.89], "search", None),
    ([0.2, 0.1], "search", 0.0),
    ([0.95], "question_answering", 0.7),
    ([0.5, 0.4], "multi_hop_reasoning", None),
    ([], "search", None)])
def test_confidence_evaluator_matches_jax(scores, intent, semantic):
    port = hierarchical.ConfidenceEvaluator().evaluate_confidence(
        _docs(types, scores), intent, semantic)
    ref = jax_hier.ConfidenceEvaluator().evaluate_confidence(
        _docs(jax_types, scores), intent, semantic)
    assert port == ref


class _FakeTier2:
    """A tier-2 retriever answering from a fixed list of scores."""

    def __init__(self, mod, scores):
        self.mod, self.scores = mod, scores

    def retrieve(self, query, top_k, intent=None, weights=None):
        return _docs(self.mod, self.scores,
                     [f"{query} result {i}" for i in range(len(self.scores))]
                     )[:top_k]


def _tier3(mod, fail=False):
    def tier3(query, intent, context_docs):
        if fail:
            raise RuntimeError("boom")
        return [mod.RetrievedDoc(doc_id=999, score=0.9, text="web result",
                                 source=mod.Source.WEB, created_at=0.0)]
    return tier3


@pytest.mark.parametrize("case", [
    dict(core={"facts": "the user name is alice and alice likes tensor "
                        "processing units"}, threshold=0.2,
         query="what is the user name alice likes", t2=[0.5]),
    dict(core={}, threshold=0.99, query="systolic arrays",
         t2=[0.4, 0.3], t3=True),
    dict(core={}, threshold=0.99, query="systolic arrays", t2=[0.4],
         t3=True, fail=True),
    dict(core={"facts": "project meeting notes overall"}, threshold=0.55,
         query="what is the project about", t2=[0.9, 0.85, 0.8], t3=True,
         semantic=0.0),
    dict(core={"facts": "this is about what the user said"}, threshold=0.5,
         query="what is this about", t2=[0.9, 0.9, 0.9, 0.9, 0.9])])
def test_hierarchical_retriever_matches_jax(monkeypatch, case):
    out = {}
    for name, mod, hmod in (("port", types, hierarchical),
                            ("jax", jax_types, jax_hier)):
        # time.time pinned for the latencies. The tier-1 docs' created_at
        # (RetrievedDoc's default, the clock at creation) is left out.
        clock = iter(np.arange(0.0, 1000.0, 0.25))
        monkeypatch.setattr(hmod.time, "time", lambda: next(clock))
        hr = hmod.HierarchicalRetriever(
            _FakeTier2(mod, case["t2"]), core_memory_fn=lambda: case["core"],
            tier3_fn=(_tier3(mod, case.get("fail", False))
                      if case.get("t3") else None),
            escalation_threshold=case["threshold"])
        docs, info = hr.retrieve(case["query"], top_k=4,
                                 intent=mod.Intent.SEARCH,
                                 semantic_confidence=case.get("semantic"))
        docs = _plain(docs)
        for d in docs:
            if d["tier"] == 1:
                d.pop("created_at")
        out[name] = (docs, info, hr.get_statistics())
    assert out["port"] == out["jax"]
    assert out["port"][0]
