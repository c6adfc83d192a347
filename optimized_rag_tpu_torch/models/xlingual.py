"""Cross-lingual ICT augmentation: pt/es/fr/de queries over EN chunks.

Held against ``optimized_rag_tpu/models/xlingual.py`` (:1-200), of which it
is a copy: ``translate_en``, ``pick_lang`` and ``augment_queries`` give the
JAX package's strings exactly.

During ICT pretraining a fraction of query spans is rendered into
pt/es/fr/de while the positive stays the ENGLISH chunk, so non-English
queries embed directly into the EN chunk space and the translation hop
disappears (agent flag ``enable_translation=0``).

The renderer is a scripted en->xx word mapper built from three layers:
  * the inverted xx->en lexicons of eval/llm_endpoint.py (the QA
    sections' function words + technical vocabulary);
  * COGNATE SUFFIX rules (en "-ity" -> pt "-idade" / es "-idad" /
    fr "-ité", "-tion" -> "-ção/-ción/-tion", ...), which cover
    open-class vocabulary no finite table can;
  * Romance head-inversion: an EN noun compound is head-LAST
    ("matrix unit size"), Romance is head-FIRST: content-word runs are
    reversed and joined with "de" ("tamanho de unidade de matriz").

Words no layer covers pass through unchanged. The choice of language per
query is a DETERMINISTIC hash of the query text, so the trainer's
snapshot/resume replay realigns without a second RNG stream.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Sequence

LANGS = ("pt", "es", "fr", "de")

# EN function words kept in place (never treated as compound members).
_EN_FUNCTION = {
    "the", "a", "an", "of", "in", "on", "at", "to", "for", "with",
    "and", "or", "is", "are", "was", "were", "be", "been", "by",
    "that", "this", "it", "as", "from", "not", "no", "but", "if",
    "what", "which", "how", "why", "when", "where", "who", "does",
    "do", "did", "can", "could", "has", "have", "had", "its", "their",
    "each", "every", "per", "than", "then", "so", "such", "into",
    "about", "over", "under", "between", "both", "all", "any", "one",
    "two", "three", "much", "many", "more", "most", "some", "other",
    "same", "there", "they", "we", "you", "will", "would", "should",
}

# Function-word translations (en -> xx) for the words the inverted
# lexicons may miss; identity when absent.
_FUNC = {
    "pt": {"the": "o", "of": "de", "in": "em", "and": "e", "is": "é",
           "are": "são", "a": "um", "with": "com", "for": "para",
           "what": "qual", "how": "como", "why": "por que",
           "which": "quais", "not": "não", "by": "por", "to": "para"},
    "es": {"the": "el", "of": "de", "in": "en", "and": "y", "is": "es",
           "are": "son", "a": "un", "with": "con", "for": "para",
           "what": "cuál", "how": "cómo", "why": "por qué",
           "which": "cuáles", "not": "no", "by": "por", "to": "a"},
    "fr": {"the": "le", "of": "de", "in": "dans", "and": "et",
           "is": "est", "are": "sont", "a": "un", "with": "avec",
           "for": "pour", "what": "quelle", "how": "comment",
           "why": "pourquoi", "which": "quels", "not": "pas",
           "by": "par", "to": "à"},
    "de": {"the": "die", "of": "der", "in": "in", "and": "und",
           "is": "ist", "are": "sind", "a": "ein", "with": "mit",
           "for": "für", "what": "was", "how": "wie", "why": "warum",
           "which": "welche", "not": "nicht", "by": "von", "to": "zu"},
}

# Cognate suffix rules, longest-suffix-first per language. Applied to
# content words >=6 chars that the lexicon does not cover.
_SUFFIX: Dict[str, List] = {
    "pt": [("ization", "ização"), ("ation", "ação"), ("tion", "ção"),
           ("sion", "são"), ("ity", "idade"), ("ency", "ência"),
           ("ancy", "ância"), ("ence", "ência"), ("ance", "ância"),
           ("ment", "mento"), ("ive", "ivo"), ("ous", "oso"),
           ("ary", "ário"), ("ical", "ico"), ("ic", "ico"),
           ("able", "ável"), ("ible", "ível"), ("ly", "mente"),
           ("al", "al")],
    "es": [("ization", "ización"), ("ation", "ación"), ("tion", "ción"),
           ("sion", "sión"), ("ity", "idad"), ("ency", "encia"),
           ("ancy", "ancia"), ("ence", "encia"), ("ance", "ancia"),
           ("ment", "mento"), ("ive", "ivo"), ("ous", "oso"),
           ("ary", "ario"), ("ical", "ico"), ("ic", "ico"),
           ("able", "able"), ("ible", "ible"), ("ly", "mente"),
           ("al", "al")],
    "fr": [("ization", "isation"), ("ation", "ation"), ("tion", "tion"),
           ("sion", "sion"), ("ity", "ité"), ("ency", "ence"),
           ("ancy", "ance"), ("ence", "ence"), ("ance", "ance"),
           ("ment", "ment"), ("ive", "ive"), ("ous", "eux"),
           ("ary", "aire"), ("ical", "ique"), ("ic", "ique"),
           ("able", "able"), ("ible", "ible"), ("ly", "ment"),
           ("al", "al")],
    # German shares Latinate suffixes for much technical vocabulary.
    "de": [("ization", "isierung"), ("ation", "ation"), ("tion", "tion"),
           ("ity", "ität"), ("ence", "enz"), ("ance", "anz"),
           ("ical", "isch"), ("ic", "isch")],
}

_WORD = re.compile(r"[A-Za-z][\w\-]*|\d+\S*|\S")

_inverted: Dict[str, Dict[str, str]] = {}


def _lexicon(lang: str) -> Dict[str, str]:
    """Inverted en->xx lexicon from eval/llm_endpoint's xx->en tables.
    Multi-word EN values are inverted too ("how much" -> "quanta")."""
    if lang in _inverted:
        return _inverted[lang]
    from optimized_rag_tpu_torch.eval import llm_endpoint as L
    table = {"pt": L._PT_EN, "es": L._ES_EN, "fr": L._FR_EN,
             "de": L._DE_EN}[lang]
    inv: Dict[str, str] = {}
    for src, dst in table.items():
        # prefer the shortest (most canonical) source for each EN word
        if dst not in inv or len(src) < len(inv[dst]):
            inv[dst] = src
    inv.update(_FUNC[lang])
    _inverted[lang] = inv
    return inv


def _suffix_map(word: str, lang: str) -> str:
    if len(word) < 6:
        return word
    for en_suf, xx_suf in _SUFFIX[lang]:
        if word.endswith(en_suf) and len(word) - len(en_suf) >= 3:
            return word[: -len(en_suf)] + xx_suf
    return word


def translate_en(text: str, lang: str) -> str:
    """Scripted en -> ``lang`` rendering of a query/span: lexicon,
    cognate suffixes, Romance head-inversion; pass-through otherwise."""
    assert lang in LANGS, lang
    lex = _lexicon(lang)
    toks = _WORD.findall(text)
    romance = lang != "de"

    def xx(word: str) -> str:
        low = word.lower()
        hit = lex.get(low)
        if hit is not None:
            return hit
        return _suffix_map(low, lang)

    out: List[str] = []
    i = 0
    while i < len(toks):
        w = toks[i]
        low = w.lower()
        if not w[0].isalpha() or low in _EN_FUNCTION:
            out.append(lex.get(low, w) if w[0].isalpha() else w)
            i += 1
            continue
        # collect a content-word run (EN noun compound)
        run = [w]
        j = i + 1
        while j < len(toks) and toks[j][0].isalpha() \
                and toks[j].lower() not in _EN_FUNCTION:
            run.append(toks[j])
            j += 1
        if romance and 1 < len(run) <= 3:
            # Noun-compound heuristic: short content runs are noun
            # phrases; head-last -> head-first, joined with "de".
            # Longer runs cross clause boundaries (they contain the
            # verb) — translate those in place.
            out.append(" de ".join(xx(r) for r in reversed(run)))
        else:
            out.extend(xx(r) for r in run)
        i = j
    return " ".join(out)


def pick_lang(text: str, en_keep: float = 0.55) -> str | None:
    """Deterministic language choice for one training query: CRC of the
    text — no RNG stream, so trainer snapshot/resume replay realigns
    for free. ``en_keep`` of queries stay English."""
    h = zlib.crc32(text.encode("utf-8"))
    if (h % 1000) < en_keep * 1000:
        return None
    return LANGS[(h // 1000) % len(LANGS)]


def augment_queries(queries: Sequence[str],
                    en_keep: float = 0.55) -> List[str]:
    """ICT query-side augmentation hook for pretrain.train_biencoder:
    renders a deterministic fraction of spans into pt/es/fr/de."""
    out = []
    for q in queries:
        lang = pick_lang(q, en_keep)
        out.append(q if lang is None else translate_en(q, lang))
    return out
