"""Graded end-to-end answer-quality evaluation.

Held against ``optimized_rag_tpu/eval/qa_sheet.py`` (:1-718), of which it is
a copy over the port's agent: the seven sheets, ``_citation_validity``,
``run_sheet`` and the summaries are the JAX package's. Two things differ.
``build_agent`` and ``main`` take a device (``--device``: "cuda" by
default, or "cpu"), as every computing subcommand of the port's CLI does.
The pdf sections read the directory of ``--pdf-docs``, which has no
default here (the reference's default is a directory outside its
repository); without one they are skipped, as the reference skips them
when its directory is missing.

The reference system's only quality instrument is a bilingual manual QA
sheet plus an annotated run log (2 of 3 hard queries refused with
support_ratio 0.0). This module is the runnable equivalent: a fixed
question sheet with expected-answer keys over a committed fixture corpus
(eval/qa_docs/*.md, the port's own copy), run through the FULL agent
(ingest -> chat -> verification), scoring:

  * answer accuracy      — any expected substring appears in the answer
  * citation validity    — every [N] resolves to a source AND the cited
                           source textually supports the answer sentence
  * refusal rate         — and refusal correctness on the unanswerable
                           probes (refusing those is the RIGHT outcome)
  * support_ratio        — distribution over answered questions

Run:  python -m optimized_rag_tpu_torch.eval.qa_sheet [--device cpu]
      [--local-lm] [--json F] [--docs DIR]   (extra corpus, e.g. PDFs)
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

QA_DOCS_DIR = os.path.join(os.path.dirname(__file__), "qa_docs")


@dataclass
class QAItem:
    id: str
    question: str
    expect_any: List[str] = field(default_factory=list)
    unanswerable: bool = False
    source_hint: str = ""


# Expected keys are distinctive fragments of the fixture articles
# (eval/qa_docs). Unanswerable probes have no support in the corpus —
# the correct behavior is refusal (reference validacao.md's hard rows).
QA_SHEET: List[QAItem] = [
    # --- tpu_hardware.md
    QAItem("hw-mxu-shape", "What is the size of the TPU matrix unit?",
           ["128 by 128", "128x128", "128 × 128"], source_hint="tpu_hardware"),
    QAItem("hw-vmem", "How much vector memory does a TPU core have?",
           ["16 megabytes", "16 mb"], source_hint="tpu_hardware"),
    QAItem("hw-vpu", "What shape is the vector processing unit?",
           ["8 by 128", "8x128"], source_hint="tpu_hardware"),
    QAItem("hw-bottleneck",
           "What limits dense retrieval throughput on a TPU?",
           ["high bandwidth memory", "memory throughput", "stream the"],
           source_hint="tpu_hardware"),
    QAItem("hw-bf16",
           "Why store embeddings in bfloat16 for scanning?",
           ["halves the bytes", "doubles the achievable scan"],
           source_hint="tpu_hardware"),
    QAItem("hw-tile",
           "What is the minimum efficient tile for bfloat16 arrays?",
           ["16 sublanes by 128"], source_hint="tpu_hardware"),
    # --- dense_retrieval.md
    QAItem("dr-cosine",
           "When does cosine similarity equal the dot product?",
           ["normalized to unit length", "unit length"],
           source_hint="dense_retrieval"),
    QAItem("dr-bruteforce",
           "Why is brute-force search the recall gold standard?",
           ["scores every row", "exact"], source_hint="dense_retrieval"),
    QAItem("dr-ivf", "How does an IVF index reduce search cost?",
           ["nprobe closest clusters", "k-means centroids",
            "partitions the corpus into clusters"],
           source_hint="dense_retrieval"),
    QAItem("dr-hnsw-params",
           "What HNSW parameters does pgvector use by default?",
           ["m set to 16", "ef_construction set to 64"],
           source_hint="dense_retrieval"),
    QAItem("dr-fused",
           "What does a fused top-k kernel avoid materializing?",
           ["full score matrix"], source_hint="dense_retrieval"),
    # --- hybrid_search.md
    QAItem("hs-channels",
           "Which score channels does hybrid retrieval blend?",
           ["semantic similarity from", "keyword relevance from bm25",
            "temporal recency"], source_hint="hybrid_search"),
    QAItem("hs-bm25-params", "What are the common BM25 defaults for k1 "
           "and b?", ["1.2", "0.75"], source_hint="hybrid_search"),
    QAItem("hs-rrf", "How does reciprocal rank fusion score an item?",
           ["sixty plus its rank", "one over the quantity sixty"],
           source_hint="hybrid_search"),
    QAItem("hs-mmr-lambda",
           "What does a lambda of zero mean in MMR?",
           ["purely by diversity"], source_hint="hybrid_search"),
    QAItem("hs-decay", "How does temporal decay weight a document that "
           "is one half-life old?",
           ["exactly half", "one half raised"], source_hint="hybrid_search"),
    # --- verification.md
    QAItem("vf-ensemble",
           "Which methods does the ensemble verifier combine?",
           ["language model judgment", "jaccard", "embedding similarity"],
           source_hint="verification"),
    QAItem("vf-support", "What support ratio must an answer reach to be "
           "accepted?", ["0.70"], source_hint="verification"),
    QAItem("vf-factuality",
           "When is an answer refused based on factuality?",
           ["below 0.50"], source_hint="verification"),
    QAItem("vf-contradiction", "How much does each detected "
           "contradiction reduce confidence?",
           ["fifteen percent"], source_hint="verification"),
    # --- memory_tiers.md
    QAItem("mt-kinds", "What are the three kinds of agent memory?",
           ["core memory", "archival", "recall"],
           source_hint="memory_tiers"),
    QAItem("mt-tier3", "What happens in tier three retrieval?",
           ["agentic", "web search with a reformulated",
            "decides whether the gathered evidence"],
           source_hint="memory_tiers"),
    QAItem("mt-confidence", "What weight does the average score carry in "
           "result confidence?", ["0.35"], source_hint="memory_tiers"),
    QAItem("mt-learning-rate", "What learning rate does the adaptive "
           "weight learner use?", ["0.01"], source_hint="memory_tiers"),
    # --- ingestion.md
    QAItem("ing-stages", "What are the five stages of ingestion?",
           ["extraction, cleaning, chunking, embedding, and indexing"],
           source_hint="ingestion"),
    QAItem("ing-chunk-size", "What is the default chunk size and overlap?",
           ["1200 characters", "overlap of 150"], source_hint="ingestion"),
    QAItem("ing-dedup", "What are the three levels of deduplication?",
           ["exact hashes", "edit distance", "embedding similarity"],
           source_hint="ingestion"),
    # --- 2-hop KG question (project_meridian.md + staff_notes.md): the
    # leader fact and the lab fact live in DIFFERENT documents; only the
    # knowledge graph's composed chain can support the answer
    # (kg.query_chains; tests/test_agent.py proves it fails with
    # enable_kg off).
    QAItem("kg-2hop",
           "Where did the head of the Meridian project come from?",
           ["basel"], source_hint="project_meridian+staff_notes"),
    # --- unanswerable probes (correct outcome: refusal / no-info answer)
    QAItem("un-capital", "What is the capital city of Australia?",
           unanswerable=True),
    QAItem("un-price", "What did the framework's cloud bill cost in "
           "March?", unanswerable=True),
    QAItem("un-author", "Who won the Nobel Prize in Physics in 1921?",
           unanswerable=True),
]

# Questions over the reference system's OWN fixture corpus (the sample
# PDFs its QA sheet probes), ingested through the stdlib PDF extractor
# (engine/pdf.py).
# Expected keys quote the extracted text; words containing fi/fl
# ligatures are avoided because the extractor preserves them verbatim.
# Run only when the PDF directory is present (--pdf-docs).
REF_PDF_DIR = "none"

PDF_SHEET: List[QAItem] = [
    QAItem("pdf-dwgrpo-objectives",
           "Which three objectives does DW-GRPO balance?",
           ["relevance, faithfulness", "faithfulness,and conciseness",
            "faithfulness, and conciseness"], source_hint="dw-grpo.pdf"),
    QAItem("pdf-dwgrpo-stages",
           "What are the stages of Deep GraphRAG's hierarchical "
           "retrieval strategy?",
           ["inter-community", "entity-level"], source_hint="dw-grpo.pdf"),
    QAItem("pdf-dwgrpo-beam",
           "What guides Deep GraphRAG's three-stage retrieval process?",
           ["beam search"], source_hint="dw-grpo.pdf"),
    QAItem("pdf-dwgrpo-compact",
           "How close does the compact 1.5B model trained with DW-GRPO "
           "get to the 72B model's Natural Questions performance?",
           ["94%", "94 percent"], source_hint="dw-grpo.pdf"),
    QAItem("pdf-dwgrpo-datasets",
           "Which benchmark datasets were used to evaluate Deep "
           "GraphRAG?",
           ["natural questions", "hotpotqa"], source_hint="dw-grpo.pdf"),
    QAItem("pdf-sys1",
           "What kind of thinking does predetermined modular reasoning "
           "resemble in the agentic RAG survey?",
           ["system 1", "fast, structured"],
           source_hint="system1-system2.pdf"),
    QAItem("pdf-sys2",
           "Which cognitive mode does agentic reasoning align with?",
           ["system 2", "slow, deliberative"],
           source_hint="system1-system2.pdf"),
    QAItem("pdf-rezero",
           "How does ReZero incentivize persistence in search agents?",
           ["retry", "trying one more time", "positive reward"],
           source_hint="system1-system2.pdf"),
    # Off-topic probes mirroring the reference instrument's closing
    # "Nada a ver com o assunto" section (validacao.md:80-89): plausible
    # technical questions none of the ingested documents answer — the
    # system must refuse rather than stitch together topical-sounding
    # fragments.
    QAItem("pdf-offtopic-diskann",
           "What is the specific search-latency impact of using the "
           "DiskANN indexing engine instead of HNSW for vector datasets "
           "that exceed available RAM?",
           unanswerable=True),
    QAItem("pdf-offtopic-ring",
           "How does Ring Attention let infinite-context models process "
           "sequences of millions of tokens on GPU clusters?",
           unanswerable=True),
]

# HARD reference-PDF section: facts from PDF pages
# no earlier sheet ever asked about, phrased to MINIMIZE lexical overlap
# with the source sentences — an instrument designed to be able to fail,
# published as the round-5 baseline rather than tuned to saturation.
HARD_PDF_SHEET: List[QAItem] = [
    QAItem("hard-chunk-window",
           "What sliding-window settings segment the corpus before "
           "graph construction?",
           ["600 tokens", "overlap"], source_hint="dw-grpo.pdf"),
    QAItem("hard-extract-model",
           "Which instruction model pulls entities and relationships "
           "out of each chunk?",
           ["qwen2.5-72b"], source_hint="dw-grpo.pdf"),
    QAItem("hard-entity-merge",
           "How are candidate entity pairs confirmed before merging?",
           ["discriminator", "0.95", "same real-world concept"],
           source_hint="dw-grpo.pdf"),
    QAItem("hard-embed-model",
           "Which embedding model measures entity description "
           "similarity during resolution?",
           ["bge-m3"], source_hint="dw-grpo.pdf"),
    QAItem("hard-louvain",
           "Which community detection algorithm builds the hierarchy?",
           ["louvain"], source_hint="dw-grpo.pdf"),
    QAItem("hard-seesaw",
           "What failure mode of static multi-reward weighting does the "
           "paper name?",
           ["seesaw"], source_hint="dw-grpo.pdf"),
    QAItem("hard-weight-rule",
           "Which reward components receive larger weights under the "
           "adaptive scheme?",
           ["slower growth", "rate of change"],
           source_hint="dw-grpo.pdf"),
    QAItem("hard-latency-cut",
           "By how much is latency reduced relative to DRIFT search?",
           ["86", "81.6"], source_hint="dw-grpo.pdf"),
    QAItem("hard-question-cats",
           "Into which categories were test questions divided?",
           ["comprehensive", "local questions", "global questions"],
           source_hint="dw-grpo.pdf"),
    QAItem("hard-em-nq",
           "What exact-match total does the best configuration reach "
           "on Natural Questions?",
           ["44.69"], source_hint="dw-grpo.pdf"),
    QAItem("hard-baselines",
           "Against which baseline retrieval strategies is the "
           "hierarchical method compared?",
           ["local search", "global search", "drift"],
           source_hint="dw-grpo.pdf"),
    QAItem("hard-predef-variants",
           "Which architectural variants make up structured reasoning "
           "pipelines in the survey?",
           ["route-based", "loop-based", "tree-based"],
           source_hint="system1-system2.pdf"),
    QAItem("hard-agentic-role",
           "What role does the language model take in autonomous "
           "retrieval orchestration?",
           ["active decision maker", "decision maker",
            "when and how to retrieve"],
           source_hint="system1-system2.pdf"),
    # Hard unanswerable probes in the same register.
    QAItem("hard-un-colbert",
           "What late-interaction scoring function does ColBERT use "
           "for passage ranking?", unanswerable=True),
    QAItem("hard-un-pq",
           "How much recall does product quantization lose at 64x "
           "compression on the BEIR benchmark?", unanswerable=True),
]

# Cross-lingual section: Portuguese questions over
# the same ENGLISH fixture corpus — the reference instrument validacao.md
# is bilingual for exactly this flow. Runs through the ONLINE provider
# path (OpenAICompatibleLLM against eval/llm_endpoint.MockOpenAIServer,
# whose scripted instruction follower actually translates), so it
# measures the full translate -> retrieve -> generate -> verify pipeline
# over real loopback HTTP. Expected keys stay English: answers are
# extracted from the English docs.
PT_SHEET: List[QAItem] = [
    QAItem("pt-hw-mxu", "Qual é o tamanho da unidade de matriz da TPU?",
           ["128 by 128", "128x128", "128 × 128"],
           source_hint="tpu_hardware"),
    QAItem("pt-hw-vmem", "Quanta memória vetorial tem um núcleo da TPU?",
           ["16 megabytes", "16 mb"], source_hint="tpu_hardware"),
    QAItem("pt-hw-bf16",
           "Por que armazenar incorporações em bfloat16 para varredura?",
           ["halves the bytes", "doubles the achievable scan"],
           source_hint="tpu_hardware"),
    QAItem("pt-dr-cosine",
           "Quando a similaridade de cosseno é igual ao produto escalar?",
           ["normalized to unit length", "unit length"],
           source_hint="dense_retrieval"),
    QAItem("pt-dr-ivf", "Como o índice IVF reduz o custo de busca?",
           ["nprobe closest clusters", "k-means centroids",
            "partitions the corpus into clusters"],
           source_hint="dense_retrieval"),
    QAItem("pt-mt-kinds", "Quais são os três tipos de memória do agente?",
           ["core memory", "archival", "recall"],
           source_hint="memory_tiers"),
    QAItem("pt-ing-chunk",
           "Qual é o tamanho padrão do fragmento e a sobreposição?",
           ["1200 characters", "overlap of 150"], source_hint="ingestion"),
    QAItem("pt-vf-support",
           "Qual razão de suporte uma resposta deve atingir para ser "
           "aceita?", ["0.70"], source_hint="verification"),
    # Unanswerable PT probes — refusal is the correct outcome.
    QAItem("pt-un-capital", "Qual é a capital da Austrália?",
           unanswerable=True),
    QAItem("pt-un-nobel",
           "Quem ganhou o Prêmio Nobel de Física em 1921?",
           unanswerable=True),
]

# Spanish cross-lingual section, same design as PT_SHEET: ASCII-light
# Spanish questions over the ENGLISH fixture corpus through the online
# provider path — exercises utils/lang.py's es identification plus the
# translate -> retrieve -> generate -> verify pipeline on a second
# source language (the reference leans on langdetect + GPT for this,
# rag/nodes/helpers.py:605-616).
ES_SHEET: List[QAItem] = [
    QAItem("es-hw-mxu", "¿Cuál es el tamaño de la unidad de matriz "
           "de la TPU?",
           ["128 by 128", "128x128", "128 × 128"],
           source_hint="tpu_hardware"),
    QAItem("es-hw-vmem", "¿Cuánta memoria vectorial tiene un núcleo "
           "de la TPU?",
           ["16 megabytes", "16 mb"], source_hint="tpu_hardware"),
    QAItem("es-dr-cosine",
           "¿Cuándo la similitud de coseno es igual al producto "
           "escalar?",
           ["normalized to unit length", "unit length"],
           source_hint="dense_retrieval"),
    QAItem("es-dr-ivf", "¿Cómo reduce el índice IVF el costo de "
           "búsqueda?",
           ["nprobe closest clusters", "k-means centroids",
            "partitions the corpus into clusters"],
           source_hint="dense_retrieval"),
    QAItem("es-mt-kinds", "¿Cuáles son los tres tipos de memoria del "
           "agente?",
           ["core memory", "archival", "recall"],
           source_hint="memory_tiers"),
    QAItem("es-vf-support",
           "¿Qué razón de soporte debe alcanzar una respuesta para "
           "ser aceptada?", ["0.70"], source_hint="verification"),
    # Unanswerable ES probes — refusal is the correct outcome.
    QAItem("es-un-capital", "¿Cuál es la capital de Australia?",
           unanswerable=True),
    QAItem("es-un-nobel",
           "¿Quién ganó el Premio Nobel de Física en 1921?",
           unanswerable=True),
]

# French cross-lingual section, same design as PT/ES: the third source
# language through utils/lang.py identification + the online provider's
# scripted translation (elisions like "l'unité" and noun-adjective
# inversion are French-specific grammar the translator handles).
FR_SHEET: List[QAItem] = [
    QAItem("fr-hw-mxu", "Quelle est la taille de l'unité de matrice "
           "du TPU ?",
           ["128 by 128", "128x128", "128 × 128"],
           source_hint="tpu_hardware"),
    QAItem("fr-hw-vmem", "Combien de mémoire vectorielle possède un "
           "cœur du TPU ?",
           ["16 megabytes", "16 mb"], source_hint="tpu_hardware"),
    QAItem("fr-dr-cosine",
           "Quand la similarité de cosinus est-elle égale au produit "
           "scalaire ?",
           ["normalized to unit length", "unit length"],
           source_hint="dense_retrieval"),
    QAItem("fr-dr-ivf", "Comment l'index IVF réduit-il le coût de "
           "recherche ?",
           ["nprobe closest clusters", "k-means centroids",
            "partitions the corpus into clusters"],
           source_hint="dense_retrieval"),
    QAItem("fr-mt-kinds", "Quels sont les trois types de mémoire de "
           "l'agent ?",
           ["core memory", "archival", "recall"],
           source_hint="memory_tiers"),
    QAItem("fr-vf-support",
           "Quel ratio de support une réponse doit-elle atteindre pour "
           "être acceptée ?", ["0.70"], source_hint="verification"),
    # Unanswerable FR probes — refusal is the correct outcome.
    QAItem("fr-un-capital", "Quelle est la capitale de l'Australie ?",
           unanswerable=True),
    QAItem("fr-un-nobel",
           "Qui a gagné le prix Nobel de physique en 1921 ?",
           unanswerable=True),
]

# German cross-lingual section: a NON-Romance source language — German
# word order is already head-last and its technical terms are single-
# word compounds ("Matrixeinheit", "Skalarprodukt"), so it exercises a
# different translation path (table-mapped compounds, no inversion).
DE_SHEET: List[QAItem] = [
    QAItem("de-hw-mxu", "Welche Größe hat die Matrixeinheit der TPU?",
           ["128 by 128", "128x128", "128 × 128"],
           source_hint="tpu_hardware"),
    QAItem("de-hw-vmem", "Wie viel Vektorspeicher hat ein Kern der TPU?",
           ["16 megabytes", "16 mb"], source_hint="tpu_hardware"),
    QAItem("de-dr-cosine",
           "Wann ist die Kosinus-Ähnlichkeit gleich dem Skalarprodukt?",
           ["normalized to unit length", "unit length"],
           source_hint="dense_retrieval"),
    QAItem("de-dr-ivf", "Wie reduziert der IVF-Index die Suchkosten?",
           ["nprobe closest clusters", "k-means centroids",
            "partitions the corpus into clusters"],
           source_hint="dense_retrieval"),
    QAItem("de-mt-kinds", "Was sind die drei Arten von Speicher des "
           "Agenten?",
           ["core memory", "archival", "recall"],
           source_hint="memory_tiers"),
    QAItem("de-vf-support",
           "Welches Unterstützungsverhältnis muss eine Antwort "
           "erreichen, um akzeptiert zu werden?",
           ["0.70"], source_hint="verification"),
    # Unanswerable DE probes — refusal is the correct outcome.
    QAItem("de-un-capital", "Was ist die Hauptstadt von Australien?",
           unanswerable=True),
    QAItem("de-un-nobel",
           "Wer hat 1921 den Nobelpreis für Physik gewonnen?",
           unanswerable=True),
]

_NO_INFO = re.compile(
    r"(don't|do not|does not) have (enough|sufficient) information"
    r"|cannot answer|no relevant", re.IGNORECASE)
_CIT = re.compile(r"\[(\d+)\]")
_WORD = re.compile(r"[a-z0-9.]+")


def _content_words(text: str) -> set:
    stop = {"the", "a", "an", "is", "are", "of", "to", "and", "in", "on",
            "by", "for", "with", "that", "its", "as", "at", "or", "it"}
    return {w for w in _WORD.findall(text.lower()) if w not in stop}


def _citation_validity(answer: str, sources: List[Dict]) -> Optional[bool]:
    """Every [N] resolves to a source AND the cited source shares content
    with the sentence it cites. None = no citations present.

    Both generators emit citations AFTER the sentence period
    ("... fifteen percent. [5] Next sentence ..."), so the sentence
    split leaves each citation at the START of the following fragment —
    leading citation tokens therefore attach to the PRECEDING sentence
    (without this, an answer whose consecutive sentences cite different
    docs fails falsely; observed on es-dr-ivf)."""
    cits = [int(m) for m in _CIT.findall(answer)]
    if not cits:
        return None
    sents = re.split(r"(?<=[.!?])\s+", answer)
    lead = re.compile(r"^\s*(?:\[\d+\]\s*)+")
    checks = []                     # (citation number, owning body text)
    prev_body = ""
    for sent in sents:
        m = lead.match(sent)
        rest = sent[m.end():] if m else sent
        if m:
            # A leading citation belongs to the preceding sentence —
            # except on the FIRST sentence, where there is none: own it
            # to the sentence it heads, otherwise '[3] Unrelated.' would
            # grade valid against any source (empty body skips the
            # overlap check).
            owner = prev_body if prev_body.strip() else rest
            checks += [(int(n), owner)
                       for n in _CIT.findall(m.group(0))]
        checks += [(int(g.group(1)), rest) for g in _CIT.finditer(rest)]
        if rest.strip():
            prev_body = rest
    for n, owner in checks:
        if not (1 <= n <= len(sources)):
            return False
        src_text = str(sources[n - 1].get("text", ""))
        body = _content_words(_CIT.sub(" ", owner))
        if body and len(body & _content_words(src_text)) < min(
                3, len(body)):
            return False
    return True


def build_agent(local_lm: bool = False, data_dir: Optional[str] = None,
                extra_docs: Optional[str] = None, settings=None,
                online: bool = False, device="cuda"):
    """Fresh agent on ``device`` over the fixture corpus (plus an optional
    extra dir). ``online=True`` lets the CLI wiring pick up
    ORAG_LLM_API_BASE and build the OpenAICompatibleLLM provider."""
    import tempfile
    from optimized_rag_tpu_torch.config import Settings
    if settings is None:
        settings = Settings.from_env()
        settings.data_dir = data_dir or tempfile.mkdtemp(prefix="qa_sheet_")
    from optimized_rag_tpu_torch.cli import build_agent as _build
    agent = _build(settings, offline=not online, local_lm=local_lm,
                   device=device)
    ing = agent.ingestor
    for d in filter(None, [QA_DOCS_DIR, extra_docs]):
        ing.upload_directory(d)
    return agent


def run_sheet(agent, sheet: Optional[List[QAItem]] = None,
              verbose: bool = True, isolate_turns: bool = True) -> Dict:
    """``isolate_turns`` rotates the memory agent_id per question so one
    question's stored answer cannot surface in the next one's recall
    retrieval (the validacao.md sheet is likewise independent probes),
    and gives each question a fresh DW-GRPO weight manager so the
    retrieval blend one question learned cannot shift the next one's
    retrieved context — without this the sheet's result depends on
    question order (observed: an off-topic probe refused in isolation
    but answered mid-run under drifted weights)."""
    sheet = sheet or QA_SHEET
    base_id = getattr(agent.memory, "agent_id", "default")
    base_wm = getattr(agent, "weight_manager", None)
    rows = []
    try:
        for item in sheet:
            if isolate_turns:
                agent.memory.agent_id = f"{base_id}-qa-{item.id}"
                if base_wm is not None:
                    from optimized_rag_tpu_torch.engine.adaptive import (
                        DynamicWeightManager)
                    agent.weight_manager = DynamicWeightManager(
                        agent_id=f"{base_id}-qa-{item.id}",
                        learning_rate=base_wm.learning_rate,
                        window_size=base_wm.tracker.window_size,
                        persist_every=base_wm.persist_every,
                        enable_learning=base_wm.enable_learning, db=None)
            resp = agent.chat(item.question)
            ans = resp.answer or ""
            refused = bool(resp.refused) or bool(_NO_INFO.search(ans))
            if item.unanswerable:
                correct = refused
            else:
                correct = (not refused) and any(
                    e.lower() in ans.lower() for e in item.expect_any)
            cit_ok = _citation_validity(ans, resp.sources or [])
            rows.append({
                "id": item.id, "question": item.question,
                "answer": ans[:400], "correct": bool(correct),
                "refused": bool(refused),
                "unanswerable": item.unanswerable,
                "citations_valid": cit_ok,
                "support_ratio": float(resp.support_ratio),
                "factuality": float(resp.factuality_score),
                "confidence": float(resp.confidence),
            })
            if verbose:
                mark = "ok " if correct else "MISS"
                print(f"  [{mark}] {item.id}: refused={refused} "
                      f"support={resp.support_ratio:.2f} cit={cit_ok}",
                      file=sys.stderr, flush=True)
    finally:
        # A mid-sheet exception must not leave the caller's agent on a
        # throwaway per-question memory id / weight manager.
        if isolate_turns:
            agent.memory.agent_id = base_id
            if base_wm is not None:
                agent.weight_manager = base_wm
    answerable = [r for r in rows if not r["unanswerable"]]
    unanswerable = [r for r in rows if r["unanswerable"]]
    with_cits = [r for r in rows if r["citations_valid"] is not None]
    srs = sorted(r["support_ratio"] for r in answerable
                 if not r["refused"])
    summary = {
        "n": len(rows),
        "answer_accuracy": (sum(r["correct"] for r in answerable)
                            / max(len(answerable), 1)),
        "refusal_rate_answerable": (sum(r["refused"] for r in answerable)
                                    / max(len(answerable), 1)),
        "unanswerable_refused": (sum(r["correct"] for r in unanswerable)
                                 / max(len(unanswerable), 1)),
        "citation_validity": (sum(bool(r["citations_valid"])
                                  for r in with_cits)
                              / max(len(with_cits), 1)),
        "citation_presence": len(with_cits) / max(len(rows), 1),
        "support_ratio_mean": (sum(srs) / len(srs)) if srs else 0.0,
        "support_ratio_p50": srs[len(srs) // 2] if srs else 0.0,
        "support_ratio_min": srs[0] if srs else 0.0,
    }
    return {"summary": summary, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--local-lm", action="store_true",
                    help="use the trained on-device decoder as generator")
    ap.add_argument("--docs", default=None,
                    help="extra corpus directory to ingest (e.g. PDFs)")
    ap.add_argument("--pdf-docs", default=REF_PDF_DIR,
                    help="reference sample-PDF dir enabling the pdf-* "
                         "section ('none' to disable)")
    ap.add_argument("--json", dest="json_out", default=None)
    ap.add_argument("--no-pt", action="store_true",
                    help="skip the cross-lingual sections (pt/es/fr/de)")
    ap.add_argument("--no-translation-xl", action="store_true",
                    help="ALSO run the cross-lingual sections with "
                         "enable_translation=0 (offline extractor + "
                         "embedding rescue channel): proves multilingual "
                         "RETRIEVAL, not translation plumbing")
    ap.add_argument("--device", default="cuda",
                    help="device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)
    sheet = list(QA_SHEET)
    pdf_dir = None if args.pdf_docs in (None, "none") else args.pdf_docs
    if pdf_dir and os.path.isdir(pdf_dir):
        sheet += PDF_SHEET + HARD_PDF_SHEET
    else:
        pdf_dir = None
        print("pdf-* section skipped (no PDF dir)", file=sys.stderr)
    agent = build_agent(local_lm=args.local_lm, extra_docs=args.docs,
                        device=args.device)
    if pdf_dir:
        agent.ingestor.upload_directory(pdf_dir)
    result = run_sheet(agent, sheet=sheet)
    hard_rows = [r for r in result["rows"] if r["id"].startswith("hard-")]
    if hard_rows:
        # Round-5 baseline section — reported as-is, never tuned to
        # saturation (an instrument that can fail).
        hard_ans = [r for r in hard_rows if not r["unanswerable"]]
        hard_probes = [r for r in hard_rows if r["unanswerable"]]
        result["summary"]["hardpdf_accuracy"] = (
            sum(r["correct"] for r in hard_ans) / max(len(hard_ans), 1))
        result["summary"]["hardpdf_probes_refused"] = (
            sum(r["correct"] for r in hard_probes)
            / max(len(hard_probes), 1))
        result["summary"]["hardpdf_n"] = len(hard_rows)
    pdf_rows = [r for r in result["rows"]
                if r["id"].startswith("pdf-")]
    if pdf_rows:
        # Split like the main summary: answer accuracy on answerable
        # questions, refusal correctness on the off-topic probes —
        # one blended number can't distinguish a wrong answer from a
        # wrongly-answered probe.
        pdf_ans = [r for r in pdf_rows if not r["unanswerable"]]
        pdf_probes = [r for r in pdf_rows if r["unanswerable"]]
        result["summary"]["pdf_accuracy"] = (
            sum(r["correct"] for r in pdf_ans) / max(len(pdf_ans), 1))
        result["summary"]["pdf_probes_refused"] = (
            sum(r["correct"] for r in pdf_probes)
            / max(len(pdf_probes), 1))
        result["summary"]["pdf_n"] = len(pdf_rows)
    if not args.no_pt and not args.local_lm:
        # Cross-lingual sections over the ONLINE provider path: a real
        # loopback chat-completions endpoint whose scripted model
        # translates; measures the translate->retrieve->generate->verify
        # pipeline, not a hosted LLM's translation quality. Four source
        # languages (pt/es/fr/de) — every language utils/lang.py
        # identifies gets a graded end-to-end section.
        from optimized_rag_tpu_torch.eval.llm_endpoint import MockOpenAIServer
        lang_sheets = [("pt", PT_SHEET), ("es", ES_SHEET),
                       ("fr", FR_SHEET), ("de", DE_SHEET)]
        with MockOpenAIServer() as srv:
            prev = os.environ.get("ORAG_LLM_API_BASE")
            os.environ["ORAG_LLM_API_BASE"] = srv.api_base
            try:
                xl_agent = build_agent(extra_docs=args.docs, online=True,
                                       device=args.device)
                for tag, lang_sheet in lang_sheets:
                    print(f"{tag}-* section (online provider path):",
                          file=sys.stderr)
                    xl_result = run_sheet(xl_agent, sheet=lang_sheet)
                    result["rows"] += xl_result["rows"]
                    ans = [r for r in xl_result["rows"]
                           if not r["unanswerable"]]
                    probes = [r for r in xl_result["rows"]
                              if r["unanswerable"]]
                    result["summary"][f"{tag}_accuracy"] = (
                        sum(r["correct"] for r in ans) / max(len(ans), 1))
                    result["summary"][f"{tag}_probes_refused"] = (
                        sum(r["correct"] for r in probes)
                        / max(len(probes), 1))
                    result["summary"][f"{tag}_n"] = len(xl_result["rows"])
            finally:
                if prev is None:
                    os.environ.pop("ORAG_LLM_API_BASE", None)
                else:
                    os.environ["ORAG_LLM_API_BASE"] = prev
        result["summary"]["xlingual_provider"] = (
            "openai-compatible loopback")
    if args.no_translation_xl:
        # The cross-lingual sections with the translate hop DISABLED.
        # Retrieval embeds the
        # raw pt/es/fr/de query via the cross-lingually trained encoder;
        # the extractive generator's embedding rescue channel selects
        # the EN answer sentence in the same space.
        from optimized_rag_tpu_torch.config import Settings
        nt_settings = Settings.from_env(
            {"ORAG_FLAGS_ENABLE_TRANSLATION": "0"})
        import tempfile
        nt_settings.data_dir = tempfile.mkdtemp(prefix="qa_sheet_nt_")
        nt_agent = build_agent(extra_docs=args.docs,
                               settings=nt_settings, device=args.device)
        for tag, lang_sheet in [("pt", PT_SHEET), ("es", ES_SHEET),
                                ("fr", FR_SHEET), ("de", DE_SHEET)]:
            print(f"{tag}-* section (translation DISABLED):",
                  file=sys.stderr)
            nt_result = run_sheet(nt_agent, sheet=lang_sheet)
            for r in nt_result["rows"]:
                r["id"] = f"nt-{r['id']}"
            result["rows"] += nt_result["rows"]
            ans = [r for r in nt_result["rows"]
                   if not r["unanswerable"]]
            probes = [r for r in nt_result["rows"] if r["unanswerable"]]
            result["summary"][f"{tag}_accuracy_notranslation"] = (
                sum(r["correct"] for r in ans) / max(len(ans), 1))
            result["summary"][f"{tag}_probes_refused_notranslation"] = (
                sum(r["correct"] for r in probes) / max(len(probes), 1))
    s = result["summary"]
    print(json.dumps(s, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
