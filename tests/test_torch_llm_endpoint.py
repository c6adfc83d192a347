"""The port's loopback OpenAI-compatible endpoint against the JAX
package's ``eval/llm_endpoint.py``, on the CPU.

Host code only, so everything is held for equality: the task inferred from
every prompt template of both packages, the translation of every question
of the four language sheets, the scripted model's replies to seeded
prompts, the server's replies on the wire (and its refusal of a bad API
key), and the full agent graph over HTTP (the hermetic fakes of
``tests/test_llm_endpoint.py``) answering English, off-topic, Portuguese
and Spanish questions as the JAX package's does. ``time.time`` is pinned
and both analyzers run their Python paths (``tests/test_torch_agent.py``).
"""

import collections
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from optimized_rag_tpu.agent import prompts as j_prompts
from optimized_rag_tpu.agent.agent import RAGAgent as JaxAgent
from optimized_rag_tpu.agent.llm import OpenAICompatibleLLM as JaxClient
from optimized_rag_tpu.config import Settings as JaxSettings
from optimized_rag_tpu.eval import llm_endpoint as jle
from optimized_rag_tpu.eval import qa_sheet as jqs
from optimized_rag_tpu.store import kg as j_kg
from optimized_rag_tpu.store.cost import CostTracker as JaxCost
from optimized_rag_tpu_torch.agent import prompts as p_prompts
from optimized_rag_tpu_torch.agent.agent import RAGAgent
from optimized_rag_tpu_torch.agent.llm import OpenAICompatibleLLM
from optimized_rag_tpu_torch.config import Settings
from optimized_rag_tpu_torch.eval import llm_endpoint as ple
from optimized_rag_tpu_torch.eval import qa_sheet as pqs
from optimized_rag_tpu_torch.store import kg as p_kg
from optimized_rag_tpu_torch.store.cost import CostTracker

from fakes import FakeCrossEncoder, FakeEmbedder
from test_torch_agent import _pin

LANG_SHEETS = ("PT_SHEET", "ES_SHEET", "FR_SHEET", "DE_SHEET")
DOC = ("The TPU matrix unit is a 128 by 128 systolic array. Embeddings are "
       "stored in bfloat16 because it halves the bytes per row and doubles "
       "the achievable scan rate.")
QUESTIONS = ("What is the size of the TPU matrix unit?",
             "What is the capital of the Eldoria kingdom?",
             "Qual é o tamanho da unidade de matriz da TPU?",
             "¿Cuál es el tamaño de la unidad de matriz de la TPU?")


def _templates(prompts) -> dict:
    """Every ``*_PROMPT`` template of a prompts module, formatted with a
    placeholder word for each field, and the KG module's own prompt."""
    blank = collections.defaultdict(lambda: "x")
    return {name: getattr(prompts, name).format_map(blank)
            for name in dir(prompts) if name.endswith("_PROMPT")}


def test_infer_task_over_every_prompt_template():
    jt, pt = _templates(j_prompts), _templates(p_prompts)
    assert set(jt) == set(pt) and len(pt) >= 15
    tasks = set()
    for name in pt:
        assert jt[name] == pt[name], name
        task = ple.infer_task(pt[name])
        assert task == jle.infer_task(pt[name]) == jle.infer_task(jt[name])
        tasks.add(task)
    assert {"intent", "translate", "generate", "verify_claim",
            "extract_triples"} <= tasks
    kg = p_kg._EXTRACT_PROMPT.format(text="t")
    assert kg == j_kg._EXTRACT_PROMPT.format(text="t")
    assert ple.infer_task(kg) == jle.infer_task(kg) == "extract_triples"
    assert ple.infer_task("tell me a joke") == "" == jle.infer_task(
        "tell me a joke")
    assert ple._marker(p_prompts.INTENT_PROMPT) == jle._marker(
        j_prompts.INTENT_PROMPT)
    assert ple._TASK_MARKERS == jle._TASK_MARKERS


@pytest.mark.parametrize("sheet", LANG_SHEETS)
def test_translate_to_english_over_the_language_sheets(sheet):
    items = getattr(pqs, sheet)
    assert [i.question for i in items] == [
        i.question for i in getattr(jqs, sheet)]
    for item in items:
        got = ple.translate_to_english(item.question)
        assert got == jle.translate_to_english(item.question), item.id
        assert got != item.question, item.id
    for item in pqs.QA_SHEET:          # English passes through
        assert ple.translate_to_english(item.question) == \
            jle.translate_to_english(item.question) == item.question


def test_translation_tables_equal_the_reference():
    for name in ("_PT_EN", "_ES_EN", "_FR_EN", "_DE_EN", "_MULTI",
                 "_FR_ELISIONS", "_ADJ", "_FUNCTION_EN"):
        assert getattr(ple, name) == getattr(jle, name), name


def test_scripted_model_respond_matches_jax(rng):
    """Seeded prompts of every template, with and without a JSON schema
    suffix, over sentences of the fixture corpus: the same replies and the
    same inferred calls."""
    with open(os.path.join(pqs.QA_DOCS_DIR, "tpu_hardware.md"),
              encoding="utf-8") as f:
        words = f.read().split()
    pt = _templates(p_prompts)
    ours, ref = ple.ScriptedInstructLLM(), jle.ScriptedInstructLLM()
    for name in sorted(pt):
        for _ in range(3):
            fill = collections.defaultdict(lambda: " ".join(
                words[int(rng.integers(0, len(words) - 30)):][
                    :int(rng.integers(3, 30))]))
            prompt = getattr(p_prompts, name).format_map(fill)
            if rng.random() < 0.5:
                prompt += ("\n\nRespond with ONLY a JSON object with keys: "
                           "answer, citations")
            assert ours.respond(prompt) == ref.respond(prompt), name
    assert ours.calls == ref.calls and len(ours.calls) == 3 * len(pt)


def _post(api_base, body, key=None):
    req = urllib.request.Request(
        api_base + "/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 **({"Authorization": f"Bearer {key}"} if key else {})})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_server_replies_and_rejects_a_bad_key_as_jax_does():
    body = {"model": "m", "messages": [
        {"role": "system", "content": "s"},
        {"role": "user", "content": p_prompts.TRANSLATE_PROMPT.format(
            query="Qual é o tamanho da unidade de matriz da TPU?")}]}
    with ple.MockOpenAIServer(require_key="sk-right") as ours, \
            jle.MockOpenAIServer(require_key="sk-right") as ref:
        assert ours.api_base.startswith("http://127.0.0.1:")
        assert _post(ours.api_base, body, "sk-right") == _post(
            ref.api_base, body, "sk-right")
        for srv in (ours, ref):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(srv.api_base, body, "sk-no")
            assert err.value.code == 401
        bad = OpenAICompatibleLLM(ours.api_base, model="m", api_key="sk-no")
        with pytest.raises(urllib.error.HTTPError):
            bad.complete("hello", task="generate")
        good = OpenAICompatibleLLM(ours.api_base, model="m",
                                   api_key="sk-right")
        jgood = JaxClient(ref.api_base, model="m", api_key="sk-right")
        p = "Translate to English, preserving technical terms.\n\n" \
            "Query: ok\nEnglish:"
        assert good.complete(p) == jgood.complete(p)
        assert len(ours.requests) == len(ref.requests) == 2
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                ours.api_base + "/embeddings", data=b"{}"), timeout=30)
        assert err.value.code == 404
    with pytest.raises(AssertionError, match="not started"):
        ple.MockOpenAIServer().api_base


@pytest.fixture(scope="module")
def http_agents(tmp_path_factory):
    """Both packages' agents over their own loopback servers, the fakes as
    encoders, one document ingested."""
    mp = pytest.MonkeyPatch()
    _pin(mp)
    out = []
    for name, Agent, Client, Cost, Sets, server, kw in (
            ("jax", JaxAgent, JaxClient, JaxCost, JaxSettings, jle, {}),
            ("port", RAGAgent, OpenAICompatibleLLM, CostTracker, Settings,
             ple, {"device": "cpu"})):
        srv = server.MockOpenAIServer().start()
        s = Sets()
        s.data_dir = str(tmp_path_factory.mktemp(f"http_{name}"))
        tracker = Cost(os.path.join(s.data_dir, "cost.json"))
        agent = Agent(s, llm=Client(srv.api_base, model="scripted-1",
                                    cost_tracker=tracker),
                      embed_service=FakeEmbedder(dim=32),
                      cross_encoder=FakeCrossEncoder(), **kw)
        agent.ingestor.ingest_text(DOC, filename="doc.txt", title="TPU")
        out.append((agent, srv, tracker))
    yield out
    for _, srv, _ in out:
        srv.stop()
    mp.undo()


@pytest.mark.parametrize("question", QUESTIONS)
def test_full_graph_over_http_answers_as_jax(http_agents, question):
    (ja, jsrv, jcost), (pa, psrv, pcost) = http_agents
    jsrv.model.calls.clear()
    psrv.model.calls.clear()
    rj, rp = ja.chat(question), pa.chat(question)
    for f in ("answer", "citations", "refused", "intent", "support_ratio"):
        assert getattr(rp, f) == getattr(rj, f), f
    assert [s["text"] for s in rp.sources] == [s["text"] for s in rj.sources]
    np.testing.assert_allclose(rp.confidence, rj.confidence, atol=1e-5)
    assert psrv.model.calls == jsrv.model.calls
    assert pcost.get_summary()["llm_input_tokens"] == \
        jcost.get_summary()["llm_input_tokens"] > 0
    if question == QUESTIONS[1]:
        assert rp.refused and not rp.citations
    else:
        assert not rp.refused and "128 by 128" in rp.answer
    if question in QUESTIONS[2:]:
        assert "translate" in psrv.model.calls
