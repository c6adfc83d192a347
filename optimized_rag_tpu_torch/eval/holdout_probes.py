"""Held-out validation of the extractive-generator relevance bar.

Held against ``optimized_rag_tpu/eval/holdout_probes.py`` (:1-125), of
which it is a copy over the port's ``qa_sheet``; ``main`` also takes
``--device`` ("cuda" by default, or "cpu").

The bar's thresholds (config.VerificationConfig.extractive_min_weighted
= 2.6, extractive_min_coverage = 0.7; enforced in
agent/llm.py DeterministicLLM._generate) were CALIBRATED by reading
scores off the round-3 QA sheet — which the sheet then graded, making
the 10/10 off-topic refusal number partly circular. This module is the
fresh instrument: 12 answerable and 12
off-topic questions over the same fixture corpus that were written
AFTER the thresholds were frozen and have never been used for tuning.

Gate: zero false answers on the off-topic probes and at most one
wrongful refusal on the answerable set. If a future threshold change is
tuned on THESE probes, write a new held-out set first — the instrument
only works while it is fresh.

Run:  python -m optimized_rag_tpu_torch.eval.holdout_probes [--device cpu]
      [--json F]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from optimized_rag_tpu_torch.eval.qa_sheet import (QAItem, build_agent,
                                                   run_sheet)

# Answerable: facts present in eval/qa_docs/*.md that no QA_SHEET
# question ever asked about.
HOLDOUT_SHEET: List[QAItem] = [
    QAItem("ho-scalar-memory", "What is scalar memory used for on a TPU?",
           ["loop indices", "control flow"], source_hint="tpu_hardware"),
    QAItem("ho-f32-tile", "What tile shape do float32 arrays use?",
           ["8 sublanes by 128"], source_hint="tpu_hardware"),
    QAItem("ho-ivf-restore",
           "How can recall lost to cluster pruning be restored?",
           ["oversampling candidates", "rescoring them exactly"],
           source_hint="dense_retrieval"),
    QAItem("ho-hnsw-structure", "How does HNSW link vectors together?",
           ["small number of neighbors", "several layers"],
           source_hint="dense_retrieval"),
    QAItem("ho-semantic-chunking",
           "When does semantic chunking start a new chunk?",
           ["drops below a threshold"], source_hint="ingestion"),
    QAItem("ho-kg-traversal",
           "How does triple retrieval walk the knowledge graph?",
           ["breadth-first", "maximum hop count"], source_hint="ingestion"),
    QAItem("ho-pdf-extraction",
           "How is PDF text recovered during extraction?",
           ["compressed content streams"], source_hint="ingestion"),
    QAItem("ho-dedup-paraphrase",
           "Which deduplication level catches paraphrases?",
           ["embedding similarity"], source_hint="ingestion"),
    QAItem("ho-recall-memory",
           "How is recall memory searched when the user refers back to "
           "the conversation?", ["keyword"], source_hint="memory_tiers"),
    QAItem("ho-compression-blend",
           "Which similarity blend selects sentences during context "
           "compression?", ["0.7 semantic", "0.3 lexical"],
           source_hint="memory_tiers"),
    QAItem("ho-ensemble-accept",
           "When does the ensemble verifier accept a claim?",
           ["at least two", "two of the three"],
           source_hint="verification"),
    QAItem("ho-temporal-kinds",
           "What impossible dates does temporal validation look for?",
           ["ranges that run backwards", "future dates"],
           source_hint="verification"),
    # Off-topic: plausible technical questions that deliberately share
    # generic vocabulary (block, node, score, default, matrix) with the
    # corpus — the bar must refuse all of them.
    QAItem("ho-off-flash", "What block size does FlashAttention use for "
           "its softmax tiling on an A100?", unanswerable=True),
    QAItem("ho-off-raft", "How does the Raft consensus protocol handle "
           "leader election timeouts?", unanswerable=True),
    QAItem("ho-off-gptq", "What perplexity degradation does 4-bit GPTQ "
           "quantization cause on Llama models?", unanswerable=True),
    QAItem("ho-off-kafka", "What is the default retention period for "
           "messages in a Kafka topic?", unanswerable=True),
    QAItem("ho-off-bleu", "What BLEU score did the original Transformer "
           "achieve on WMT14 English to German?", unanswerable=True),
    QAItem("ho-off-pagerank", "What damping factor does the PageRank "
           "algorithm conventionally use?", unanswerable=True),
    QAItem("ho-off-tls", "Which cipher suites does TLS 1.3 mandate for "
           "compliant implementations?", unanswerable=True),
    QAItem("ho-off-btree", "What is the typical fan-out of a B-tree node "
           "under PostgreSQL's default page size?", unanswerable=True),
    QAItem("ho-off-mi300", "How does matrix core occupancy on the MI300 "
           "compare with tensor cores?", unanswerable=True),
    QAItem("ho-off-cap", "What does the CAP theorem say about "
           "availability during network partitions?", unanswerable=True),
    QAItem("ho-off-hadoop", "How many reduce tasks does Hadoop schedule "
           "per node by default?", unanswerable=True),
    QAItem("ho-off-sprint", "How long should a sprint retrospective last "
           "for a team of ten people?", unanswerable=True),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", dest="json_out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)
    agent = build_agent(device=args.device)
    result = run_sheet(agent, sheet=HOLDOUT_SHEET)
    s = result["summary"]
    answerable = [r for r in result["rows"] if not r["unanswerable"]]
    probes = [r for r in result["rows"] if r["unanswerable"]]
    false_answers = sum(not r["correct"] for r in probes)
    wrongful_refusals = sum(r["refused"] for r in answerable)
    s["false_answers"] = false_answers
    s["wrongful_refusals"] = wrongful_refusals
    s["gate_pass"] = bool(false_answers == 0 and wrongful_refusals <= 1)
    print(json.dumps(s, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=2)
    if not s["gate_pass"]:
        print("HELD-OUT GATE FAIL", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
