"""Knowledge graph: triple extraction + multi-hop retrieval.

Re-implements rag/knowledge_graph.py:
  * ``KnowledgeGraphExtractor.extract_triples`` (:40) — LLM prompt
    returning "subject|relation|object" lines, parsed tolerantly, with a
    dependency-free heuristic fallback when no LLM is configured
  * ``KnowledgeGraphRetriever.find_related_entities`` (:180) — BFS up to
    max_hops; each hop is a LIKE scan over the triples table (:219-226)
  * ``query_knowledge_graph`` (:260) — entity extraction + traversal to a
    context string

Held against ``optimized_rag_tpu/store/kg.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Set, Tuple

from optimized_rag_tpu_torch.store.db import MetadataStore

Triple = Tuple[str, str, str]

_EXTRACT_PROMPT = """Extract factual (subject, relation, object) triples \
from the text. Output ONE triple per line as: subject|relation|object
Only include facts stated in the text. Text:
{text}
Triples:"""

# Heuristic fallback patterns (measured on eval/kg_eval.py's gold
# fixture — the round-3 single is/has/uses regex scored recall 0.25).
# P1: passive/prepositional — "X was led by Y", "X joined from Y".
# Objects/subjects may contain abbreviation dots ("Dr. Alvarez"):
# sentences are pre-split and stripped of their final punctuation, so
# the in-pattern terminators are only [,;:] / "and" / end-of-sentence.
_HEUR_PASSIVE = re.compile(
    r"(?:The |An? )?([A-Z][\w\.\- ]{1,45}?)\s+"
    r"(?:(is|are|was|were)\s+)?(\w+(?:ed|wn|ilt))\s+"
    r"(by|from|into|to)\s+(?:a |an |the )?"
    r"([\w\.\- ]{2,60}?)(?:[,;:]|\s+and\s+|$)", re.MULTILINE)
# P2: active SVO with a curated verb lexicon (precision guard: a bare
# \w+s verb slot would triple every sentence).
_HEUR_VERBS = (
    "is|are|was|were|has|have|uses|use|contains|holds|stores|runs|"
    "delivers|supports|requires|provides|performs|feeds|joins|leads|"
    "links|builds|merges|combines|blends|embeds|cuts|multiplies|"
    "partitions|scans|accepts|scores|ranks|selects|extracts|persists|"
    "adjusts|escalates|reduces|trades|dampens|maintains|represents|"
    "splits|catches|measures|tracks|records|checks")
_HEUR_ACTIVE = re.compile(
    r"(?:The |An? )?([A-Z][\w\.\- ]{1,45}?)\s+(%s)\s+"
    r"(?:a |an |the |about )?([\w\.\- ]{2,60}?)(?:[,;:]|$)"
    % _HEUR_VERBS, re.MULTILINE)
_PRONOUNS = {"it", "they", "this", "that", "these", "those", "he", "she",
             "its", "there"}
# P3 (round 5): general-register morphological fallback — fires ONLY
# when P1/P2 miss a sentence. The verb slot is morphology, not a
# lexicon: an inflected form (-s/-es/-ed), an aux+participle, a common
# irregular past, or a base verb + preposition ("rely on"). Anchored to
# the sentence start (subject must open the sentence) for precision.
# Developed against eval/kg_eval.py's OUT-OF-REGISTER gold (reference-
# PDF prose + news sentences the curated lexicon scored 0.0 on); the
# in-register fixture still grades 1.0 because P1/P2 shadow this rule.
_IRREGULAR_PAST = (
    "made|took|gave|went|won|lost|built|led|found|kept|held|rose|fell|"
    "began|brought|came|ran|saw|sent|set|sold|told|thought|drew|grew|"
    "knew|left|meant|met|paid|put|read|said|spent|stood|taught|wore|"
    "wrote|broke|chose|drove|spoke|became|got|gained|showed")
_HEUR_MORPH = re.compile(
    r"^(?:The |An? )?([A-Za-z][\w\.\- ]{1,45}?)\s+"
    r"(?:\w+ly\s+|often\s+|also\s+|still\s+|now\s+|then\s+)*"
    r"((?:has |have |had )?(?:%s)\b(?:\s+(?:on|upon|onto|into|with|"
    r"from|for|near|at)\b)?)\s+"
    r"(?:a |an |the |its |their |about )?([\w\.\-' ]{2,70}?)"
    r"(?:[,;:]|\s+(?:and|as|because|after|while|which|who|that|when|"
    r"where|so|but)\s+|$)"
    % (_IRREGULAR_PAST
       # lowercase-initial guard: a capitalized "verb" is a name part
       # ("Northwind Logistics acquired ..."), not an inflected verb
       + r"|[a-z]\w{2,}(?:s|es|ed)|[a-z]\w{2,}(?=\s+(?:on|upon|"
       r"onto|into|with|from|for|near)\b)"))
_ABBREV_TAIL = re.compile(
    r"\b(?:Dr|Mr|Mrs|Ms|Prof|St|vs|etc|e\.g|i\.e|No)\.$")


def _sentences(text: str) -> List[str]:
    """Sentence split that does not break after title abbreviations
    ("Dr. Alvarez") — a naive split truncated subjects to "Dr" and sent
    the BFS frontier chasing the substring "dr" (matched "draft")."""
    parts = re.split(r"(?<=[.!?])\s+", text or "")
    out: List[str] = []
    for p in parts:
        if out and _ABBREV_TAIL.search(out[-1]):
            out[-1] = out[-1] + " " + p
        else:
            out.append(p)
    return [s.rstrip().rstrip(".!?") for s in out]


def heuristic_triples(text: str) -> List[Triple]:
    """Dependency-free extraction: passive pattern first per sentence,
    active SVO otherwise; pronoun subjects dropped (no coreference)."""
    out: List[Triple] = []
    for sent in _sentences(text):
        m = _HEUR_PASSIVE.search(sent)
        if m:
            subj, aux, verb, prep, obj = m.groups()
            if subj.strip().lower() not in _PRONOUNS:
                rel = " ".join(filter(None, (aux, verb, prep)))
                out.append((subj.strip(), rel, obj.strip()))
                continue
        m = _HEUR_ACTIVE.search(sent)
        if m:
            subj, verb, obj = m.groups()
            if subj.strip().lower() not in _PRONOUNS:
                out.append((subj.strip(), verb, obj.strip()))
                continue
        m = _HEUR_MORPH.match(sent)
        if m:
            subj, verb, obj = m.groups()
            if subj.strip().lower() not in _PRONOUNS:
                out.append((subj.strip(), verb.strip(), obj.strip()))
    return out


def parse_triple_lines(raw: str) -> List[Triple]:
    out = []
    for line in raw.splitlines():
        parts = [p.strip() for p in line.split("|")]
        if len(parts) == 3 and all(parts) and len(parts[0]) < 128:
            out.append((parts[0], parts[1], parts[2]))
    return out


class KnowledgeGraphExtractor:
    """``llm_fn(prompt) -> str`` is any text-in/text-out provider."""

    def __init__(self, store: MetadataStore, agent_id: str = "default",
                 llm_fn: Optional[Callable[[str], str]] = None,
                 max_triples_per_doc: int = 50):
        self.store = store
        self.agent_id = agent_id
        self.llm_fn = llm_fn
        self.max_triples = max_triples_per_doc

    def extract_triples(self, text: str) -> List[Triple]:
        if self.llm_fn is not None:
            try:
                raw = self.llm_fn(_EXTRACT_PROMPT.format(text=text[:4000]))
                triples = parse_triple_lines(raw)
                if triples:
                    return triples[: self.max_triples]
            except Exception:
                pass  # fall through to heuristics (fail-open like reference)
        return heuristic_triples(text)[: self.max_triples]

    def store_triples(self, triples: List[Triple],
                      source_doc: Optional[int] = None) -> int:
        if not triples:
            return 0
        return self.store.insert_triples(self.agent_id, triples, source_doc)

    def extract_and_store(self, text: str,
                          source_doc: Optional[int] = None) -> int:
        return self.store_triples(self.extract_triples(text), source_doc)


class KnowledgeGraphRetriever:
    def __init__(self, store: MetadataStore, agent_id: str = "default",
                 max_hops: int = 2, max_entities: int = 20):
        self.store = store
        self.agent_id = agent_id
        self.max_hops = max_hops
        self.max_entities = max_entities

    def find_related_entities(self, entity: str,
                              max_hops: Optional[int] = None
                              ) -> List[Triple]:
        """BFS traversal; per hop, a LIKE scan (reference :219-226)."""
        hops = max_hops or self.max_hops
        seen_triples: Set[Triple] = set()
        frontier: Set[str] = {entity.lower()}
        visited: Set[str] = set()
        out: List[Triple] = []
        for _ in range(hops):
            next_frontier: Set[str] = set()
            for ent in frontier:
                if ent in visited or len(visited) >= self.max_entities:
                    continue
                # Short fragments make LIKE '%x%' match everything
                # ("dr" matched "draft"); they cannot be real entities.
                if len(ent) < 3:
                    continue
                visited.add(ent)
                for t in self.store.find_triples(self.agent_id, ent):
                    if t in seen_triples:
                        continue
                    seen_triples.add(t)
                    out.append(t)
                    next_frontier.add(t[0].lower())
                    next_frontier.add(t[2].lower())
            frontier = next_frontier - visited
            if not frontier:
                break
        return out

    _QUESTION_WORDS = frozenset(
        "what which who whom whose when where why how did does do is are "
        "was were the can could would should tell give list".split())

    @classmethod
    def extract_query_entities(cls, query: str) -> List[str]:
        """Capitalized spans + long words (the reference prompts an LLM;
        this keeps the hot path LLM-free). Sentence-initial question
        words capitalize without being entities — filtered."""
        caps = re.findall(r"\b[A-Z][\w\-]+(?:\s+[A-Z][\w\-]+)*", query)
        longw = [w for w in re.findall(r"[a-zA-Z]{5,}", query)]
        seen, out = set(), []
        for e in caps + longw:
            k = e.lower()
            if k in cls._QUESTION_WORDS or k in seen:
                continue
            seen.add(k)
            out.append(e)
        return out[:5]

    def query_knowledge_graph(self, query: str) -> str:
        """Entity extraction + traversal -> context block (reference :260)."""
        lines = []
        for ent in self.extract_query_entities(query):
            for s, r, o in self.find_related_entities(ent, 1):
                lines.append(f"{s} {r} {o}")
        seen, uniq = set(), []
        for ln in lines:
            if ln not in seen:
                seen.add(ln)
                uniq.append(ln)
        return "\n".join(uniq[:30])

    def query_chains(self, query: str, max_chains: int = 8) -> List[str]:
        """Composed multi-hop paths for the query's entities.

        A 2-hop fact ("Meridian was led by Alvarez" + "Alvarez joined
        from Basel") lives in two documents; no single retrieved chunk
        can support the composed answer. This walks max_hops out from
        each query entity and joins adjacent triples (object of one ~
        subject of the next) into one evidence sentence, giving the
        generator and the claim verifier a citable surface for
        multi-hop questions. The reference's KG retriever returns flat
        triple lines only (knowledge_graph.py:260-305); chains are what
        make them usable by extraction.
        """
        def norm(s: str) -> str:
            return " ".join(re.findall(r"[\w\-]+", s.lower()))

        chains: List[str] = []
        seen: Set[str] = set()
        for ent in self.extract_query_entities(query):
            triples = self.find_related_entities(ent)
            for t1 in triples:
                for t2 in triples:
                    if t1 is t2:
                        continue
                    o1, s2 = norm(t1[2]), norm(t2[0])
                    if not o1 or not s2 or \
                            not (o1 == s2 or s2 in o1 or o1 in s2):
                        continue
                    line = (f"{t1[0]} {t1[1]} {t1[2]}, and "
                            f"{t2[0]} {t2[1]} {t2[2]}")
                    if line not in seen:
                        seen.add(line)
                        chains.append(line)
                        if len(chains) >= max_chains:
                            return chains
        return chains
