"""The port's QA sheets and holdout probes against the JAX package's
``eval/qa_sheet.py`` and ``eval/holdout_probes.py``, on the CPU.

The sheets, the grader (``_citation_validity``, ``run_sheet``'s rows and
summary, its per-question isolation of memory ids and weight managers) and
``main``'s summaries are held for equality, with stub agents and seeded
answers. Then a small sheet (answerable and unanswerable English items and
three language items over each package's loopback endpoint) runs through both
packages' ``build_agent`` with the in-repo checkpoints: the rows' answers,
grades and citations are equal, and their scores within 0.35 / 4 (a
reranked score blends the sigmoid of the bf16 cross-encoder's logit, which
the two packages compute within 0.35: ``tests/test_torch_rerank.py``).
``time.time`` is pinned and both analyzers run their Python paths
(``tests/test_torch_agent.py``).
"""

import dataclasses
import filecmp
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from optimized_rag_tpu.engine.adaptive import (
    DynamicWeightManager as JaxWeights)
from optimized_rag_tpu.eval import holdout_probes as jho
from optimized_rag_tpu.eval import llm_endpoint as jle
from optimized_rag_tpu.eval import qa_sheet as jqs
from optimized_rag_tpu_torch.engine.adaptive import DynamicWeightManager
from optimized_rag_tpu_torch.eval import holdout_probes as pho
from optimized_rag_tpu_torch.eval import llm_endpoint as ple
from optimized_rag_tpu_torch.eval import qa_sheet as pqs

from test_torch_agent import _pin

SHEETS = ("QA_SHEET", "PDF_SHEET", "HARD_PDF_SHEET", "PT_SHEET", "ES_SHEET",
          "FR_SHEET", "DE_SHEET")
SCORE_TOL = 0.35 / 4
SMALL = ("hw-mxu-shape", "hw-bottleneck", "un-capital", "un-author")
PACKAGES = {"jax": (jqs, jho, JaxWeights), "port": (pqs, pho,
                                                    DynamicWeightManager)}


def _asdicts(items):
    return [dataclasses.asdict(i) for i in items]


@pytest.mark.parametrize("name", SHEETS)
def test_sheets_equal_jax_item_for_item(name):
    ours, ref = getattr(pqs, name), getattr(jqs, name)
    assert len(ours) == len(ref) > 0
    assert _asdicts(ours) == _asdicts(ref)
    assert all(isinstance(i, pqs.QAItem) for i in ours)


def test_holdout_sheet_equals_jax_and_is_fresh():
    assert _asdicts(pho.HOLDOUT_SHEET) == _asdicts(jho.HOLDOUT_SHEET)
    tuned = {i.question.lower() for i in pqs.QA_SHEET + pqs.PDF_SHEET}
    assert not any(i.question.lower() in tuned for i in pho.HOLDOUT_SHEET)
    assert pho.QAItem is pqs.QAItem and pho.run_sheet is pqs.run_sheet


def test_qa_docs_copy_is_byte_equal():
    ref_dir = os.path.dirname(jqs.QA_DOCS_DIR + os.sep)
    ours = sorted(os.listdir(pqs.QA_DOCS_DIR))
    assert pqs.QA_DOCS_DIR.startswith(os.path.dirname(pqs.__file__))
    assert ours == sorted(os.listdir(ref_dir)) and len(ours) == 8
    match, mismatch, errors = filecmp.cmpfiles(ref_dir, pqs.QA_DOCS_DIR,
                                               ours, shallow=False)
    assert match == ours and not mismatch and not errors


def _sentences():
    out = []
    for name in sorted(os.listdir(pqs.QA_DOCS_DIR)):
        with open(os.path.join(pqs.QA_DOCS_DIR, name),
                  encoding="utf-8") as f:
            out += [s for s in re.split(r"(?<=[.!?])\s+", f.read())
                    if len(s.split()) > 3]
    return out


def test_citation_validity_matches_jax_on_seeded_answers(rng):
    """Answers of 1-4 corpus sentences with citations inside, after the
    period and leading the first sentence; sources of cited and uncited
    corpus text; numbers in and out of range."""
    sents = _sentences()
    seen = set()
    for _ in range(400):
        picked = [sents[int(rng.integers(len(sents)))]
                  for _ in range(int(rng.integers(1, 5)))]
        sources = [{"text": t} for t in picked[:int(rng.integers(0, 4))]]
        parts = []
        for j, s in enumerate(picked):
            n = (j + 1 if j < len(sources) and rng.random() < 0.7
                 else int(rng.integers(0, len(sources) + 2)))
            cite, where = f"[{n}]", rng.integers(0, 4)
            if where == 0:
                s = f"{s[:-1]} {cite}{s[-1]}"
            elif where == 1:
                s = f"{s} {cite}"
            elif where == 2:
                s = f"{cite} {s}"
            parts.append(s)
        answer = " ".join(parts)
        got = pqs._citation_validity(answer, sources)
        assert got == jqs._citation_validity(answer, sources), answer
        seen.add(got)
    assert seen == {None, True, False}


def test_citation_validity_leading_citation_rules():
    srcs = [{"text": "the quick brown fox jumps over the lazy dog"}]
    cases = {
        "The quick brown fox jumps high [1].": True,
        "Fact [3].": False,
        "Completely unrelated assertion about pallas kernels [1].": False,
        "No citations here.": None,
        "[1] Unrelated assertion about pallas kernels.": False,
        "[1] The quick brown fox jumps over the dog.": True,
        "The quick brown fox jumps over the dog. [1] It lands.": True,
        "Unrelated pallas kernels. [1] [1] The quick brown fox.": False,
    }
    for answer, want in cases.items():
        assert pqs._citation_validity(answer, srcs) is want, answer
        assert jqs._citation_validity(answer, srcs) is want, answer


class _StubAgent:
    """The chat surface ``run_sheet`` touches, with canned responses; it
    records the memory id and weight manager each question saw."""

    def __init__(self, responses, weights, fail_on=None):
        self._responses = responses
        self.memory = SimpleNamespace(agent_id="stub")
        self.weight_manager = weights
        self.seen = []
        self._fail_on = fail_on

    def chat(self, question):
        wm = self.weight_manager
        self.seen.append((self.memory.agent_id, wm.agent_id,
                          wm.learning_rate, wm.tracker.window_size,
                          wm.persist_every, wm.enable_learning, wm.db,
                          wm is self._base))
        if question == self._fail_on:
            raise RuntimeError("turn failed")
        return self._responses[question]


def _canned(rng, sheet):
    """A seeded response for each question: its expected key, a miss, a
    refusal or a no-information answer, with or without citations."""
    sents = _sentences()
    out = {}
    for item in sheet:
        kind = int(rng.integers(0, 4))
        key = item.expect_any[0] if item.expect_any else "nothing"
        answer = [f"It is {key} here [1].", "Something unrelated.",
                  "", "I don't have enough information to answer."][kind]
        cited = f"{key} {sents[int(rng.integers(len(sents)))]}"
        out[item.question] = SimpleNamespace(
            answer=answer, refused=kind == 2, sources=[{"text": cited}],
            support_ratio=float(rng.random()),
            factuality_score=float(rng.random()),
            confidence=float(rng.random()))
    return out


def _stub_run(pkg, responses, fail_on=None):
    qs, _, Weights = PACKAGES[pkg]
    base = Weights(agent_id="base", learning_rate=0.05, window_size=7,
                   persist_every=3, enable_learning=False, db=object())
    agent = _StubAgent(responses, base, fail_on)
    agent._base = base
    sheet = qs.QA_SHEET + qs.PT_SHEET
    try:
        out = qs.run_sheet(agent, sheet=sheet, verbose=False)
    except RuntimeError:
        out = None
    assert agent.memory.agent_id == "stub" and agent.weight_manager is base
    return out, [s[:6] + (s[6] is None, s[7]) for s in agent.seen]


def test_run_sheet_with_a_stub_agent_matches_jax(rng):
    responses = _canned(rng, pqs.QA_SHEET + pqs.PT_SHEET)
    (ours, seen), (ref, jseen) = (_stub_run("port", responses),
                                  _stub_run("jax", responses))
    assert ours == ref
    assert seen == jseen and len(seen) == len(ours["rows"])
    assert len({s[0] for s in seen}) == len(seen)       # a fresh id each
    assert all(s[6] and not s[7] for s in seen)         # fresh, no db
    assert seen[0][1:6] == ("stub-qa-hw-mxu-shape", 0.05, 7, 3, False)
    s = ours["summary"]
    assert set(s) == {"n", "answer_accuracy", "refusal_rate_answerable",
                      "unanswerable_refused", "citation_validity",
                      "citation_presence", "support_ratio_mean",
                      "support_ratio_p50", "support_ratio_min"}
    assert 0 < s["answer_accuracy"] < 1 and 0 < s["citation_validity"] < 1


def test_run_sheet_restores_the_agent_after_a_failed_turn(rng):
    responses = _canned(rng, pqs.QA_SHEET + pqs.PT_SHEET)
    fail = pqs.QA_SHEET[5].question
    (ours, seen), (ref, jseen) = (_stub_run("port", responses, fail),
                                  _stub_run("jax", responses, fail))
    assert ours is None and ref is None and seen == jseen
    assert len(seen) == 6


def _small_sheet(qs):
    """SMALL, then two language items and es-dr-ivf (which both packages
    refuse here at factuality 0.11; the reference's TPU run answered it:
    docs/results_r5/qa_full.json)."""
    by_id = {i.id: i for i in qs.QA_SHEET}
    es = {i.id: i for i in qs.ES_SHEET}
    return [by_id[i] for i in SMALL] + [qs.PT_SHEET[0], es["es-hw-mxu"],
                                        es["es-dr-ivf"]]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Each package's ``build_agent`` over the qa_docs with the in-repo
    checkpoints, online to its own loopback endpoint (the port's on the
    CPU)."""
    mp = pytest.MonkeyPatch()
    _pin(mp)
    torch.set_num_threads(4)
    out = {}
    for pkg, endpoint, kw in (("jax", jle, {}), ("port", ple,
                                                 {"device": "cpu"})):
        srv = endpoint.MockOpenAIServer().start()
        mp.setenv("ORAG_LLM_API_BASE", srv.api_base)
        data = str(tmp_path_factory.mktemp(f"qa_{pkg}"))
        out[pkg] = (PACKAGES[pkg][0].build_agent(data_dir=data, online=True,
                                                 **kw), srv)
    yield out
    for _, srv in out.values():
        srv.stop()
    mp.undo()


def _hold_rows(got, want):
    assert [r["id"] for r in got] == [r["id"] for r in want]
    for g, w in zip(got, want):
        for f in ("question", "answer", "correct", "refused",
                  "unanswerable", "citations_valid"):
            assert g[f] == w[f], (g["id"], f, g[f], w[f])
        for f in ("support_ratio", "factuality", "confidence"):
            np.testing.assert_allclose(g[f], w[f], atol=SCORE_TOL,
                                       err_msg=f"{g['id']} {f}")


def test_small_sheet_through_both_build_agents_gives_equal_rows(built):
    (ja, jsrv), (pa, psrv) = built["jax"], built["port"]
    assert pa.device.type == "cpu"
    want = jqs.run_sheet(ja, sheet=_small_sheet(jqs), verbose=False)
    got = pqs.run_sheet(pa, sheet=_small_sheet(pqs), verbose=False)
    _hold_rows(got["rows"], want["rows"])
    for k, v in want["summary"].items():
        np.testing.assert_allclose(got["summary"][k], v, atol=SCORE_TOL)
    assert got["summary"]["unanswerable_refused"] == 1.0
    assert got["summary"]["answer_accuracy"] > 0
    assert got["rows"][-1]["refused"] and not got["rows"][-1]["correct"]
    assert "translate" in psrv.model.calls and psrv.model.calls == \
        jsrv.model.calls


def test_main_summaries_equal_jax(built, monkeypatch, tmp_path):
    """``main --no-pt`` and the holdout's ``main`` over the built agents
    (their sheets cut to the small English items): the same JSON, and the
    port passes ``--device`` on."""
    outs = {}
    for pkg in ("jax", "port"):
        qs, ho, _ = PACKAGES[pkg]
        agent = built[pkg][0]
        devices = []

        def build(*a, device=None, **kw):
            devices.append(device)
            return agent
        small = [i for i in _small_sheet(qs) if i.id in SMALL]
        monkeypatch.setattr(qs, "QA_SHEET", small)
        monkeypatch.setattr(qs, "build_agent", build)
        monkeypatch.setattr(ho, "HOLDOUT_SHEET", small[2:])
        monkeypatch.setattr(ho, "build_agent", build)
        path = str(tmp_path / f"{pkg}.json")
        args = ["--no-pt", "--pdf-docs", "none", "--json", path]
        args += ["--device", "cpu"] if pkg == "port" else []
        assert qs.main(args) == 0
        hpath = str(tmp_path / f"{pkg}_holdout.json")
        code = ho.main(["--json", hpath] + args[-2:] if pkg == "port"
                       else ["--json", hpath])
        with open(path) as f, open(hpath) as g:
            outs[pkg] = (code, json.load(f), json.load(g))
        assert devices == ([None, None] if pkg == "jax" else ["cpu", "cpu"])
    (jcode, jmain, jhold), (pcode, pmain, phold) = outs["jax"], outs["port"]
    assert pcode == jcode == 0 and phold["summary"]["gate_pass"]
    for got, want in ((pmain, jmain), (phold, jhold)):
        _hold_rows(got["rows"], want["rows"])
        assert set(got["summary"]) == set(want["summary"])
    assert pmain["summary"]["n"] == len(SMALL)


def test_main_without_a_card_needs_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (lambda: pqs.main(["--no-pt", "--pdf-docs", "none"]),
                 lambda: pho.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main()
    assert pqs.REF_PDF_DIR == "none"
