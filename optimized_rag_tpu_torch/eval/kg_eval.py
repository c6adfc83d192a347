"""Triple-extraction quality evaluation.

Held against ``optimized_rag_tpu/eval/kg_eval.py`` (:1-311), of which it is
a copy over the port's ``store/kg.KnowledgeGraphExtractor``,
``agent/llm`` and ``eval/llm_endpoint.MockOpenAIServer``. It is host code
only: its numbers are the JAX package's (docs/results_r5/kg_eval.json).

The reference system ships an LLM extractor with no measurement of triple
quality, and a heuristic fallback was equally unmeasured. This module is
the instrument: a gold fixture of passages in the fixture-corpus register
with hand-labeled (subject, relation, object) triples, scored for
precision and recall under tolerant normalization (case/articles/relation
synonyms), for BOTH extraction paths:

  * heuristic — ``KnowledgeGraphExtractor`` with no ``llm_fn``
  * llm       — extraction through a provider (the deterministic task
                behavior, or the loopback HTTP endpoint with --loopback)

A predicted triple counts as correct when its normalized subject and
object match a gold pair and the relations share a content word
(relation phrasing varies legitimately: "was led by" vs "led by").

Run:  python -m optimized_rag_tpu_torch.eval.kg_eval [--loopback] [--json F]
"""

from __future__ import annotations

import argparse
import json
import re
from typing import Dict, List, Sequence, Tuple

Triple = Tuple[str, str, str]

# Gold cases: passage -> labeled triples. Register matches the QA
# fixture corpus (technical prose with named entities).
GOLD_CASES: List[Dict] = [
    {"id": "mxu", "text": "The MXU is a systolic array. It multiplies "
                          "dense matrices every cycle.",
     "gold": [("MXU", "is", "systolic array")]},
    {"id": "vmem", "text": "Vector memory holds about 16 megabytes per "
                           "core. Scalar memory stores loop counters.",
     "gold": [("Vector memory", "holds", "16 megabytes per core"),
              ("Scalar memory", "stores", "loop counters")]},
    {"id": "ivf", "text": "An IVF index partitions the corpus into "
                          "clusters. The index scans the nprobe closest "
                          "clusters at query time.",
     "gold": [("IVF index", "partitions", "corpus into clusters"),
              ("index", "scans", "nprobe closest clusters")]},
    {"id": "led-by", "text": "The Meridian project was led by Dr. "
                             "Alvarez. The project built the retrieval "
                             "engine.",
     "gold": [("Meridian project", "was led by", "Dr. Alvarez"),
              ("project", "built", "retrieval engine")]},
    {"id": "joined", "text": "Dr. Alvarez joined from the Basel lab in "
                             "2021.",
     "gold": [("Dr. Alvarez", "joined from", "Basel lab")]},
    {"id": "bm25", "text": "BM25 uses inverse document frequency. The "
                           "parameter k1 controls saturation.",
     "gold": [("BM25", "uses", "inverse document frequency"),
              ("parameter k1", "controls", "saturation")]},
    {"id": "hnsw", "text": "HNSW links each vector to neighbors across "
                           "several layers. Pgvector builds HNSW indexes "
                           "by default.",
     "gold": [("HNSW", "links", "each vector to neighbors"),
              ("Pgvector", "builds", "HNSW indexes")]},
    {"id": "tiers", "text": "Core memory is an always-in-context store. "
                            "Archival memory is a long-term store of "
                            "embedded passages.",
     "gold": [("Core memory", "is", "always-in-context store"),
              ("Archival memory", "is", "long-term store")]},
    {"id": "decay", "text": "Temporal decay multiplies a document score "
                            "by a half-life factor.",
     "gold": [("Temporal decay", "multiplies", "document score")]},
    {"id": "rrf", "text": "Reciprocal rank fusion merges several ranked "
                          "lists. The constant sixty dampens outliers.",
     "gold": [("Reciprocal rank fusion", "merges",
               "several ranked lists"),
              ("constant sixty", "dampens", "outliers")]},
    {"id": "ensemble", "text": "The ensemble verifier combines three "
                               "independent methods. It accepts a claim "
                               "when two methods agree.",
     "gold": [("ensemble verifier", "combines",
               "three independent methods")]},
    {"id": "chunking", "text": "Semantic chunking embeds each sentence. "
                               "Fixed-size chunking cuts every N "
                               "characters with overlap.",
     "gold": [("Semantic chunking", "embeds", "each sentence"),
              ("Fixed-size chunking", "cuts", "every N characters")]},
]

# Out-of-register gold: text the heuristic's verb lexicon was NOT
# curated on. Two sub-registers:
#   * verbatim sentences from the reference system's own sample PDFs
#     (dw-grpo.pdf, system1-system2.pdf via engine/pdf.extract_pdf_text)
#     — academic prose;
#   * news-style sentences (event reporting, past tense, proper nouns).
# Numbers here are expected WELL below the in-register fixture's: that
# is the honest generalization measurement, not a regression.
GOLD_OOR_CASES: List[Dict] = [
    # -- reference-PDF academic prose (verbatim spans)
    {"id": "pdf-outperforms",
     "text": "Deep GraphRAG significantly outperforms baseline graph "
             "retrieval methods in both accuracy and efficiency.",
     "gold": [("Deep GraphRAG", "outperforms",
               "baseline graph retrieval methods")]},
    {"id": "pdf-mitigates",
     "text": "Retrieval-Augmented Generation effectively mitigates "
             "common LLM challenges such as hallucination and knowledge "
             "cutoff.",
     "gold": [("Retrieval-Augmented Generation", "mitigates",
               "common LLM challenges")]},
    {"id": "pdf-sacrifices",
     "text": "Coarse-grained community summarization often sacrifices "
             "fine-grained contextual relevance.",
     "gold": [("Coarse-grained community summarization", "sacrifices",
               "fine-grained contextual relevance")]},
    {"id": "pdf-rely",
     "text": "LLMs rely on static training data, making them prone to "
             "hallucinations.",
     "gold": [("LLMs", "rely on", "static training data")]},
    {"id": "pdf-enhances",
     "text": "RAG enhances factual accuracy and broadens the model's "
             "temporal and domain coverage.",
     "gold": [("RAG", "enhances", "factual accuracy")]},
    {"id": "pdf-attracted",
     "text": "Retrieval-Augmented Generation has attracted significant "
             "attention as a promising approach to overcome the "
             "knowledge limitations of LLMs.",
     "gold": [("Retrieval-Augmented Generation", "has attracted",
               "significant attention")]},
    # -- news-style event reporting
    {"id": "news-rates",
     "text": "The central bank raised interest rates by half a "
             "percentage point on Tuesday.",
     "gold": [("central bank", "raised", "interest rates")]},
    {"id": "news-landfall",
     "text": "Hurricane Milton made landfall near Tampa late Wednesday "
             "night.",
     "gold": [("Hurricane Milton", "made landfall near", "Tampa")]},
    {"id": "news-budget",
     "text": "The city council approved the new transit budget after a "
             "heated debate.",
     "gold": [("city council", "approved", "transit budget")]},
    {"id": "news-antibiotic",
     "text": "Researchers at the university discovered a new antibiotic "
             "compound in soil samples.",
     "gold": [("Researchers", "discovered", "antibiotic compound")]},
    {"id": "news-flights",
     "text": "The airline canceled hundreds of flights because of the "
             "storm.",
     "gold": [("airline", "canceled", "hundreds of flights")]},
    {"id": "news-fine",
     "text": "Regulators fined the company eleven million dollars for "
             "safety violations.",
     "gold": [("Regulators", "fined", "company")]},
    {"id": "news-acquired",
     "text": "Northwind Logistics acquired its largest regional rival "
             "for an undisclosed sum.",
     "gold": [("Northwind Logistics", "acquired",
               "largest regional rival")]},
]

# Held-out gold: authored AFTER the round-5 morphological fallback was
# frozen, never used to develop any pattern. The number on this section
# is reported as-is (tuning on it would re-circularize the instrument).
# Registers: encyclopedia, sports, weather, legal.
GOLD_HELDOUT_CASES: List[Dict] = [
    {"id": "ho-curie",
     "text": "Marie Curie won the Nobel Prize in Physics in 1903.",
     "gold": [("Marie Curie", "won", "Nobel Prize in Physics")]},
    {"id": "ho-amazon",
     "text": "The Amazon river carries more water than any other river.",
     "gold": [("Amazon river", "carries", "more water")]},
    {"id": "ho-everest",
     "text": "Mount Everest stands 8,849 meters above sea level.",
     "gold": [("Mount Everest", "stands", "8,849 meters above sea "
                                          "level")]},
    {"id": "ho-plea",
     "text": "The defendant pleaded guilty to two counts of fraud.",
     "gold": [("defendant", "pleaded", "guilty")]},
    {"id": "ho-match",
     "text": "The home team defeated the visitors three to one.",
     "gold": [("home team", "defeated", "visitors")]},
    {"id": "ho-storm",
     "text": "A severe thunderstorm swept through the valley overnight.",
     "gold": [("severe thunderstorm", "swept through", "valley")]},
    {"id": "ho-vote",
     "text": "The committee postponed the vote until next month.",
     "gold": [("committee", "postponed", "vote")]},
    {"id": "ho-ev",
     "text": "Interest in electric vehicles grew sharply last year.",
     "gold": [("Interest in electric vehicles", "grew", "sharply")]},
]

_ARTICLES = re.compile(r"\b(the|a|an)\b", re.IGNORECASE)
_STOP_REL = {"was", "were", "is", "are", "by", "from", "to", "of", "the",
             "a", "an"}


def _norm(s: str) -> str:
    s = _ARTICLES.sub(" ", s.lower())
    return " ".join(re.findall(r"[\w\-]+", s))


def _rel_words(rel: str) -> set:
    return set(_norm(rel).split())


def triple_matches(pred: Triple, gold: Triple) -> bool:
    """Subjects/objects match up to normalization and containment;
    relations must share at least one word (content word when the gold
    relation has one)."""
    ps, pr, po = map(_norm, pred)
    gs, gr, go = map(_norm, gold)
    if not (ps == gs or ps in gs or gs in ps):
        return False
    if not (po == go or po in go or go in po):
        return False
    pw, gw = _rel_words(pr), _rel_words(gr)
    content = gw - _STOP_REL
    return bool((pw & content) if content else (pw & gw))


def score_extractor(extract_fn, cases: Sequence[Dict] = GOLD_CASES
                    ) -> Dict:
    """precision/recall of ``extract_fn(text) -> List[Triple]``."""
    tp = fp = fn = 0
    per_case = []
    for case in cases:
        preds = list(extract_fn(case["text"]))
        gold = [tuple(g) for g in case["gold"]]
        matched_gold = set()
        case_tp = 0
        for p in preds:
            hit = next((gi for gi, g in enumerate(gold)
                        if gi not in matched_gold and triple_matches(p, g)),
                       None)
            if hit is None:
                fp += 1
            else:
                matched_gold.add(hit)
                case_tp += 1
        tp += case_tp
        fn += len(gold) - len(matched_gold)
        per_case.append({"id": case["id"], "pred": len(preds),
                         "tp": case_tp, "gold": len(gold)})
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return {"precision": round(precision, 3), "recall": round(recall, 3),
            "tp": tp, "fp": fp, "fn": fn, "cases": per_case}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", dest="json_out", default=None)
    ap.add_argument("--loopback", action="store_true",
                    help="also measure extraction through a real HTTP "
                         "chat-completions loopback endpoint")
    args = ap.parse_args(argv)
    from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
    from optimized_rag_tpu_torch.store.kg import KnowledgeGraphExtractor

    heur = KnowledgeGraphExtractor(store=None)
    det = DeterministicLLM()
    llm = KnowledgeGraphExtractor(
        store=None, llm_fn=lambda p: det.complete(p, task="extract_triples"))
    # "in_register" = the fixture-register gold the heuristic's verb
    # lexicon WAS curated on (an in-register instrument, not a general
    # benchmark); "out_of_register" is the honest generalization number.
    out = {
        "in_register": {
            "heuristic": score_extractor(heur.extract_triples),
            "llm": score_extractor(llm.extract_triples),
        },
        "out_of_register": {
            "heuristic": score_extractor(heur.extract_triples,
                                         GOLD_OOR_CASES),
            "llm": score_extractor(llm.extract_triples, GOLD_OOR_CASES),
        },
        # never used for rule development — report as-is
        "held_out": {
            "heuristic": score_extractor(heur.extract_triples,
                                         GOLD_HELDOUT_CASES),
        },
    }
    if args.loopback:
        from optimized_rag_tpu_torch.agent.llm import OpenAICompatibleLLM
        from optimized_rag_tpu_torch.eval.llm_endpoint import MockOpenAIServer
        with MockOpenAIServer() as srv:
            client = OpenAICompatibleLLM(srv.api_base, model="scripted")
            lb = KnowledgeGraphExtractor(
                store=None,
                llm_fn=lambda p: client.complete(p,
                                                 task="extract_triples"))
            out["loopback"] = {
                "in_register": score_extractor(lb.extract_triples),
                "out_of_register": score_extractor(lb.extract_triples,
                                                   GOLD_OOR_CASES),
            }

    def strip(v):
        if "cases" in v:
            return {kk: vv for kk, vv in v.items() if kk != "cases"}
        return {kk: strip(vv) for kk, vv in v.items()}

    print(json.dumps({k: strip(v) for k, v in out.items()}, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
