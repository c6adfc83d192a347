"""Centralized prompt text.

The reference keeps 13 prompt modules (~450 LoC) under prompts/
(prompts/__init__.py); the same surface lives here as constants, one per
pipeline stage, with the citation rules of prompts/generate_response.py
preserved in spirit (write [N] markers tied to the numbered context).

Held against ``optimized_rag_tpu/agent/prompts.py``, a copy whose imports
name the port's modules.
"""

INTENT_PROMPT = """Classify the intent of this query into exactly one of:
question_answering, summarization, comparison, fact_checking,
multi_hop_reasoning, clarification, conversational, instruction, search.

Query: {query}
Intent:"""

REWRITE_PROMPT = """Rewrite the query for retrieval. Apply only what helps:
simplify verbose phrasing, resolve pronouns from the conversation, fix
spelling. Preserve the language and the meaning.

Conversation:
{history}

Query: {query}
Rewritten query:"""

TRANSLATE_PROMPT = """Translate to English, preserving technical terms.

Query: {query}
English:"""

DECOMPOSE_PROMPT = """Break this complex question into 2-4 simpler
sub-questions, one per line.

Question: {query}
Sub-questions:"""

EXPAND_PROMPT = """Give 2 alternative phrasings of the query using
synonyms, one per line.

Query: {query}
Alternatives:"""

# Worked citation examples (capability parity with the reference's few-shot
# block, prompts/generate_response.py:1-96 — re-written). Example context
# lines are indented so they can never be mistaken for the real numbered
# context below.
GENERATE_FEW_SHOT = """Citation rules:
1. Every factual sentence MUST carry a [N] marker tied to the numbered
   context item that supports it.
2. Use ONLY the provided context — never answer from prior knowledge.
3. If the context does not contain the answer, say so instead of guessing.

Worked examples (GOOD and BAD):

  GOOD — every claim cited:
    Q: What is a TPU?
    Ctx: [1] A TPU is an accelerator built around a systolic matmul array.
    A: A TPU is an accelerator built around a systolic matmul array [1].

  BAD — uncited claim (never do this):
    A: A TPU is a chip made by a large cloud vendor.
    Problem: no [N] marker, and the vendor claim is not in the context.

  GOOD — insufficient context acknowledged:
    Q: What will TPUs look like in ten years?
    Ctx: [1] Current TPUs focus on dense matmul throughput.
    A: Current TPUs focus on dense matmul throughput [1]. The provided
       context does not say anything about future designs, so I can't
       answer that part.

  BAD — answering from training knowledge instead of the context:
    Ctx: [1] The report contrasts fast and analytical processing.
    A: This refers to Kahneman's System 1 / System 2 research...
    Problem: the context never mentions Kahneman; cite [1] and stop there.
"""

GENERATE_PROMPT = """You are a careful assistant. Answer the question using
ONLY the numbered context. Every factual sentence MUST end with a citation
marker [N] pointing at the context item that supports it. If the context
does not contain the answer, say you don't know.

""" + GENERATE_FEW_SHOT + """
Core memory:
{core_memory}

Context:
{context}

Question: {query}
Answer:"""

TIER3_AGENTIC_PROMPT = """You are a research assistant deciding whether
external tools are needed (be conservative — tools cost money).

User query: {query}

Local context from tiers 1-2 (top results with scores):
{context}

Decide:
- If the local context covers the query well, it is SUFFICIENT.
- If the query asks for latest/recent/current information, or the local
  scores are low (<0.5) or the context is missing, a web search helps;
  reformulate the search query if a different phrasing would match better.

Respond with: sufficient (true/false), use_web_search (true/false),
search_query (the reformulated web query, or the original)."""

COT_PROMPT = """Think step by step about how the context answers the
question. List the reasoning steps, then state what evidence supports each.

Context:
{context}

Question: {query}
Reasoning:"""

SYNTHESIZE_PROMPT = """Synthesize the numbered documents into one coherent
summary that covers points relevant to the question. Keep [N] markers.

Context:
{context}

Question: {query}
Synthesis:"""

EXTRACT_CLAIMS_PROMPT = """List the factual claims in this answer as a
numbered list, one claim per line.

Question: {query}
ANSWER: {answer}
Claims:"""

VERIFY_CLAIM_PROMPT = """Does the evidence support the claim? Reply
SUPPORTED or NOT_SUPPORTED with a confidence, e.g. "SUPPORTED
(confidence: 0.9)".

CLAIM: {claim}
EVIDENCE: {evidence}
Verdict:"""

FAITHFULNESS_PROMPT = """Rate 0.0-1.0 how faithful the answer is to the
context (1.0 = fully grounded). Reply with only the number.

Context:
{context}

ANSWER: {answer}
Score:"""

RELEVANCE_PROMPT = """Rate 0.0-1.0 how relevant this document is to the
query. Reply with only the number.

Query: {query}
Document: {document}
Score:"""

FACT_EXTRACTION_PROMPT = """Extract at most 3 durable personal facts about
the user from this exchange (preferences, names, goals), one per line
prefixed with "- ". Reply NONE if there are none. Skip chit-chat.

User: {user}
Assistant: {assistant}
Facts:"""

KG_EXTRACT_PROMPT = """Extract factual (subject, relation, object) triples
from the text. Output ONE per line as: subject|relation|object

Text: {text}
Triples:"""

CONVERSATION_REFERENCE_PROMPT = """Does the user's query refer to this
conversation itself (an earlier question, answer, or topic of the
dialogue) rather than asking for new information?

Recent conversation:
{history}

Query: {query}

Reply IS_REFERENCE or NOT_REFERENCE followed by a confidence 0.0-1.0."""

REFINE_PROMPT = """The previous retrieval missed. Rewrite the query with
different words to find the answer.

Original query: {query}
Previous answer problems: {problems}
Refined query:"""
