"""Loopback OpenAI-compatible chat-completions endpoint.

Held against ``optimized_rag_tpu/eval/llm_endpoint.py`` (:1-502), of which
it is a copy over the port's ``agent/prompts``, ``agent/llm`` and
``utils/lang``: ``infer_task``, ``translate_to_english``,
``ScriptedInstructLLM.respond`` and ``MockOpenAIServer``'s replies give the
JAX package's strings exactly. The four xx->en lexicons are also what
``models/xlingual.py`` inverts. It is host code only.

The reference's generation quality rides on a hosted instruction
follower. This build environment has zero egress, so
``OpenAICompatibleLLM`` (agent/llm.py) — the escape hatch a production
deployment points at a real endpoint — would otherwise stay dead code.
This module stands up a real HTTP server on 127.0.0.1 speaking the
chat-completions protocol, backed by a scripted instruction follower, so
the FULL agent graph (structured citations, claim verification, refusal,
cost accounting) runs through the online provider path end to end.

The scripted model:
  * infers the pipeline stage from the prompt text (a real LLM reads
    the same instructions; the ``task=`` tag is client-side only and
    never crosses the HTTP boundary),
  * answers via the same extractive logic as ``DeterministicLLM``,
  * actually translates pt/es/fr/de queries word-by-word with a
    small dictionary — enough for the cross-lingual QA section to
    exercise translate -> retrieve -> generate -> verify over English
    documents.

Usage:
    with MockOpenAIServer() as srv:
        llm = OpenAICompatibleLLM(srv.api_base, model="scripted-1")
        ...
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from optimized_rag_tpu_torch.agent import prompts
from optimized_rag_tpu_torch.agent.llm import DeterministicLLM

# ---------------------------------------------------------------------------
# Task inference: distinctive instruction prefixes, longest first.
# ---------------------------------------------------------------------------


def _marker(template: str) -> str:
    """Literal instruction prefix of a prompt template (up to the first
    format placeholder), normalized to single-space."""
    head = template.split("{", 1)[0]
    return " ".join(head.split())


_TASK_MARKERS: List[Tuple[str, str]] = sorted(
    [
        ("intent", _marker(prompts.INTENT_PROMPT)),
        ("rewrite", _marker(prompts.REWRITE_PROMPT)),
        ("translate", _marker(prompts.TRANSLATE_PROMPT)),
        ("decompose", _marker(prompts.DECOMPOSE_PROMPT)),
        ("expand", _marker(prompts.EXPAND_PROMPT)),
        ("generate", _marker(prompts.GENERATE_PROMPT)),
        ("cot", _marker(prompts.COT_PROMPT)),
        ("synthesize", _marker(prompts.SYNTHESIZE_PROMPT)),
        ("extract_claims", _marker(prompts.EXTRACT_CLAIMS_PROMPT)),
        ("verify_claim", _marker(prompts.VERIFY_CLAIM_PROMPT)),
        ("faithfulness", _marker(prompts.FAITHFULNESS_PROMPT)),
        ("relevance", _marker(prompts.RELEVANCE_PROMPT)),
        ("extract_facts", _marker(prompts.FACT_EXTRACTION_PROMPT)),
        ("extract_triples", _marker(prompts.KG_EXTRACT_PROMPT)),
        # store/kg.py carries its own triple prompt variant.
        ("extract_triples",
         "Extract factual (subject, relation, object) triples from the "
         "text. Output ONE triple per line"),
        ("conversation_reference",
         _marker(prompts.CONVERSATION_REFERENCE_PROMPT)),
        ("refine", _marker(prompts.REFINE_PROMPT)),
    ],
    key=lambda kv: -len(kv[1]),
)


def infer_task(prompt: str) -> str:
    """Infer the pipeline stage from the instruction text alone."""
    flat = " ".join(prompt.split())
    for task, marker in _TASK_MARKERS:
        if marker and marker in flat:
            return task
    return ""


# ---------------------------------------------------------------------------
# Word-level translation for the cross-lingual QA section.
# ---------------------------------------------------------------------------

# Function words + the technical/question vocabulary of the QA sheet.
# Word-by-word output is not fluent English; it preserves exactly the
# content terms retrieval and extraction key on — which is the honest
# lower bound of what a real translator would provide.
_PT_EN = {
    "qual": "what", "quais": "which", "é": "is", "e": "and", "o": "the",
    "a": "the", "os": "the", "as": "the", "um": "a", "uma": "a",
    "de": "of", "do": "of the", "da": "of the", "dos": "of the",
    "das": "of the", "em": "in", "no": "in the", "na": "in the",
    "por": "by", "porque": "why", "que": "that", "como": "how",
    "quando": "when", "onde": "where", "quanto": "how much",
    "quanta": "how much", "para": "for", "com": "with", "sem": "without",
    "não": "not", "são": "are", "tem": "has", "há": "there is",
    "ser": "be", "foi": "was", "se": "if", "tamanho": "size",
    "unidade": "unit", "matriz": "matrix", "matrizes": "matrices",
    "memória": "memory", "memoria": "memory", "vetorial": "vector",
    "vetor": "vector", "busca": "search", "custo": "cost",
    "reduz": "reduce", "índice": "index", "indice": "index",
    "limita": "limits", "armazenar": "store", "armazena": "stores",
    "incorporações": "embeddings", "incorporacoes": "embeddings",
    "núcleo": "core", "nucleo": "core", "forma": "shape",
    "processamento": "processing", "taxa": "rate",
    "aprendizado": "learning", "aprendizagem": "learning",
    "recuperação": "retrieval", "recuperacao": "retrieval",
    "densa": "dense", "denso": "dense", "exata": "exact",
    "exato": "exact", "força": "force", "forca": "force",
    "bruta": "brute", "padrão": "default", "padrao": "default",
    "ouro": "gold", "igual": "equal", "iguala": "equals",
    "produto": "product", "escalar": "dot", "similaridade": "similarity",
    "cosseno": "cosine", "quantos": "how many", "quantas": "how many",
    "bytes": "bytes", "usa": "uses", "usam": "use", "utiliza": "uses",
    "você": "you", "voce": "you", "pode": "can", "mínimo": "minimum",
    "minimo": "minimum", "eficiente": "efficient", "pesos": "weights",
    "adaptativos": "adaptive", "consulta": "query", "intenção": "intent",
    "intencao": "intent", "documentos": "documents",
    "documento": "document", "limite": "limit", "limiar": "threshold",
    "confiança": "confidence", "confianca": "confidence",
    "escalonamento": "escalation", "camada": "tier", "camadas": "tiers",
    "nível": "tier", "nivel": "tier", "níveis": "tiers",
    "niveis": "tiers", "verificação": "verification",
    "verificacao": "verification", "alucinação": "hallucination",
    "alucinacao": "hallucination", "resposta": "answer",
    "respostas": "answers", "pergunta": "question",
    "perguntas": "questions", "fragmento": "chunk",
    "fragmentos": "chunks", "pedaço": "chunk", "pedaços": "chunks",
    "sobreposição": "overlap", "sobreposicao": "overlap",
    "divisão": "chunking", "divisao": "chunking",
    "semântica": "semantic", "semantica": "semantic",
    "agrupamento": "clustering", "grupos": "clusters",
    "aglomerados": "clusters", "centroides": "centroids",
    "centróides": "centroids", "fusão": "fusion", "fusao": "fusion",
    "pontuação": "score", "pontuacao": "score",
    "recência": "recency", "recencia": "recency",
    "decaimento": "decay", "meia-vida": "half-life",
    "léxica": "lexical", "lexica": "lexical", "tempo": "time",
    "largura": "width", "banda": "bandwidth", "limitam": "limit",
    "rendimento": "throughput", "vazão": "throughput",
    "vazao": "throughput", "ao": "to the", "à": "to the",
    "varredura": "scanning", "tipos": "kinds", "tipo": "kind",
    "três": "three", "tres": "three", "agente": "agent",
    "suporte": "support", "razão": "ratio", "razao": "ratio",
    "deve": "must", "atingir": "reach", "aceita": "accepted",
    "quem": "who", "ganhou": "won", "prêmio": "prize",
    "premio": "prize", "física": "physics", "fisica": "physics",
}

_ES_EN = {
    "cuál": "what", "cual": "what", "cuáles": "which", "cuales": "which",
    "es": "is", "y": "and", "el": "the", "la": "the", "los": "the",
    "las": "the", "un": "a", "una": "a", "de": "of", "del": "of the",
    "en": "in", "por": "by", "qué": "what", "que": "that",
    "cómo": "how", "como": "how", "cuándo": "when", "cuando": "when",
    "dónde": "where", "donde": "where", "cuánto": "how much",
    "cuanto": "how much", "para": "for", "con": "with", "sin": "without",
    "no": "not", "son": "are", "tiene": "has", "hay": "there is",
    "ser": "be", "fue": "was", "si": "if", "tamaño": "size",
    "tamano": "size", "unidad": "unit", "matriz": "matrix",
    "memoria": "memory", "vectorial": "vector", "búsqueda": "search",
    "busqueda": "search", "costo": "cost", "coste": "cost",
    "reduce": "reduces", "índice": "index", "indice": "index",
    "almacenar": "store", "incrustaciones": "embeddings",
    "núcleo": "core", "nucleo": "core", "forma": "shape",
    "recuperación": "retrieval", "recuperacion": "retrieval",
    "densa": "dense", "exacta": "exact", "fuerza": "force",
    "bruta": "brute", "producto": "product", "escalar": "dot",
    "similitud": "similarity", "coseno": "cosine", "usa": "uses",
    "utiliza": "uses", "mínimo": "minimum", "minimo": "minimum",
    "eficiente": "efficient", "respuesta": "answer",
    "pregunta": "question", "al": "to the", "cuánta": "how much",
    "cuanta": "how much",
    "igual": "equal", "tres": "three", "tipos": "kinds", "tipo": "kind",
    "agente": "agent", "soporte": "support", "razón": "ratio",
    "razon": "ratio", "debe": "must", "alcanzar": "reach",
    "aceptada": "accepted", "capital": "capital", "quién": "who",
    "quien": "who", "ganó": "won", "gano": "won", "premio": "prize",
    "física": "physics", "fisica": "physics",
}


_FR_EN = {
    "quel": "what", "quelle": "what", "quels": "which",
    "quelles": "which", "est": "is", "sont": "are", "le": "the",
    "la": "the", "les": "the", "un": "a", "une": "a", "de": "of",
    "du": "of the", "des": "of the", "au": "to the", "aux": "to the",
    "taille": "size", "unité": "unit", "unite": "unit",
    "matrice": "matrix", "combien": "how much", "quantité": "amount",
    "quantite": "amount", "mémoire": "memory", "memoire": "memory",
    "vectorielle": "vector", "possède": "has", "possede": "has",
    "cœur": "core", "coeur": "core", "quand": "when",
    "similarité": "similarity", "similarite": "similarity",
    "cosinus": "cosine", "égale": "equal", "egale": "equal",
    "produit": "product", "scalaire": "dot", "comment": "how",
    "réduit": "reduces", "reduit": "reduces", "coût": "cost",
    "cout": "cost", "recherche": "search", "trois": "three",
    "types": "kinds", "type": "kind", "agent": "agent",
    "ratio": "ratio", "support": "support", "réponse": "answer",
    "reponse": "answer", "doit": "must", "atteindre": "reach",
    "pour": "for", "être": "be", "etre": "be", "acceptée": "accepted",
    "acceptee": "accepted", "capitale": "capital",
    "australie": "australia", "qui": "who", "a": "has",
    "gagné": "won", "gagne": "won", "prix": "prize",
    "physique": "physics", "en": "in", "et": "and", "dans": "in",
    "avec": "with", "sans": "without", "ne": "not", "pas": "not",
    "il": "it", "elle": "it", "stocke": "stores", "indice": "index",
    # Hyphenated interrogative inversions arrive as single tokens.
    "est-elle": "is", "est-il": "is", "réduit-il": "reduces",
    "reduit-il": "reduces", "doit-elle": "must", "doit-il": "must",
    "a-t-il": "has", "a-t-elle": "has", "possède-t-il": "has",
}

# German question vocabulary. German compounds are single words a
# word-by-word pass cannot decompose (a hosted translator handles them
# lexically too), so the technical compounds map to their English
# noun phrases directly; word order is already head-last like English,
# so no inversion rule applies (romance-only below).
_DE_EN = {
    "welche": "which", "welcher": "which", "welches": "which",
    "was": "what", "wie": "how", "ist": "is", "sind": "are",
    "die": "the", "das": "the", "den": "the", "dem": "the",
    "der": "the", "des": "of the", "ein": "a", "eine": "a",
    "einen": "a", "einem": "a", "einer": "a", "größe": "size",
    "groesse": "size", "hat": "has", "haben": "have",
    "matrixeinheit": "matrix unit", "vektorspeicher": "vector memory",
    "kern": "core", "wann": "when", "gleich": "equal to",
    "kosinus-ähnlichkeit": "cosine similarity",
    "kosinusähnlichkeit": "cosine similarity",
    "skalarprodukt": "dot product", "reduziert": "reduces",
    "ivf-index": "IVF index", "suchkosten": "search cost",
    "kosten": "cost", "suche": "search", "drei": "three",
    "arten": "kinds", "art": "kind", "von": "of",
    "speicher": "memory", "agenten": "agent", "agent": "agent",
    "unterstützungsverhältnis": "support ratio", "muss": "must",
    "antwort": "answer", "erreichen": "reach", "um": "to", "zu": "to",
    "akzeptiert": "accepted", "werden": "be", "hauptstadt": "capital",
    "australien": "australia", "wer": "who",
    "nobelpreis": "Nobel prize", "für": "for", "fuer": "for",
    "physik": "physics", "gewonnen": "won", "viel": "much",
    "nicht": "not", "und": "and", "mit": "with", "ohne": "without",
    "im": "in the", "in": "in", "zur": "to the", "zum": "to the",
    "es": "it", "man": "one", "wieviel": "how much", "bei": "at",
    "auf": "on", "standard-fragmentgröße": "default chunk size",
    "fragmentgröße": "chunk size", "überlappung": "overlap",
}

# Multiword units that word-by-word translation would mangle.
_MULTI = [("por que", "why"), ("por quê", "why"), ("o que", "what"),
          ("por qué", "why"), ("qué es", "what is"),
          ("meia vida", "half-life"), ("produto escalar", "dot product"),
          ("producto escalar", "dot product"),
          ("força bruta", "brute force"), ("fuerza bruta", "brute force"),
          ("produit scalaire", "dot product"),
          ("force brute", "brute force"),
          ("qu'est-ce que", "what"), ("est-ce que", ""),
          ("wie viel", "how much"), ("wie groß", "how large")]

# French elisions: "l'unité" -> "the unité" before word-by-word lookup.
_FR_ELISIONS = [("l'", "the "), ("d'", "of "), ("qu'", "that "),
                ("n'", "not "), ("c'", "it "), ("s'", ""), ("j'", "I ")]

# Adjective forms (source-language): Romance adjectives FOLLOW the noun,
# English ones precede — "memória vetorial" -> "vector memory".
_ADJ = {"vetorial", "semântica", "semantica", "densa", "denso", "exata",
        "exato", "léxica", "lexica", "bruta", "adaptativos", "adaptativa",
        "eficiente", "mínimo", "minimo", "hierárquica", "hierarquica",
        "vectorial", "semántica", "exacta", "adaptativa", "jerárquica",
        "vectorielle", "sémantique", "semantique", "exacte", "lexicale",
        "hiérarchique", "hierarchique", "adaptatifs", "adaptative"}

# Function-word translations (articles/prepositions/copulas): nouns are
# everything NOT in this set — used by the noun-phrase inversion below.
_FUNCTION_EN = {"the", "a", "an", "of", "of the", "in", "in the", "is",
                "are", "and", "that", "what", "which", "how", "why",
                "when", "where", "by", "for", "with", "without", "not",
                "to", "to the", "be", "was", "has", "if", "how much",
                "how many", "there is", "you", "can", "who", "must"}


def translate_to_english(query: str) -> str:
    """Scripted pt/es/fr/de -> en translation preserving unknown terms
    (technical tokens like "bfloat16" or "TPU" pass through).

    Word-by-word plus one real grammar rule: Romance noun compounds are
    head-first ("unidade de matriz", "similarité de cosinus") while
    English is head-last — "N1 de N2" inverts to "N2 N1" ("matrix
    unit", "cosine similarity") so retrieval sees the English bigram.
    German word order is already head-last; its technical compounds
    (single words) map to English noun phrases in the table instead.
    """
    from optimized_rag_tpu_torch.utils.lang import detect_language
    lang = detect_language(query)
    table = {"pt": _PT_EN, "es": _ES_EN, "fr": _FR_EN,
             "de": _DE_EN}.get(lang)
    if table is None:
        return query
    romance = lang != "de"
    low = query
    for src, dst in _MULTI:
        low = re.sub(re.escape(src), dst, low, flags=re.IGNORECASE)
    if lang == "fr":
        for src, dst in _FR_ELISIONS:
            low = re.sub(re.escape(src), dst, low, flags=re.IGNORECASE)
    toks = []                              # (pre, word, post) or raw
    for raw in low.split():
        m = re.match(r"^([^\wÀ-ÿ]*)([\wÀ-ÿ-]+)([^\wÀ-ÿ]*)$", raw)
        toks.append(m.groups() if m else raw)

    def tr(word: str) -> str:
        return table.get(word.lower(), word)

    def is_noun(word: str) -> bool:
        rep = tr(word)
        return rep not in _FUNCTION_EN and " " not in rep

    out = []
    i = 0
    while i < len(toks):
        t = toks[i]
        if isinstance(t, str):
            out.append(t)
            i += 1
            continue
        pre, word, post = t
        # Noun + following adjective swap: "memória vetorial" ->
        # "vector memory".
        nxt = toks[i + 1] if i + 1 < len(toks) else None
        if (romance and not post and is_noun(word) and isinstance(nxt, tuple)
                and not nxt[0] and nxt[1].lower() in _ADJ):
            out.append(pre + tr(nxt[1]) + " " + tr(word) + nxt[2])
            i += 2
            continue
        # Collect a maximal "N (de N)+" compound chain and reverse it:
        # "tamanho da unidade de matriz da TPU" -> "TPU matrix unit size".
        if romance and not post and is_noun(word):
            chain = [word]
            j = i + 1
            while j + 1 < len(toks):
                link, noun = toks[j], toks[j + 1]
                if not (isinstance(link, tuple) and isinstance(noun, tuple)
                        and link[1].lower() in ("de", "do", "da", "du")
                        and not link[0] and not link[2] and not noun[0]
                        and is_noun(noun[1])):
                    break
                chain.append(noun[1])
                if noun[2]:        # punctuation ends the compound
                    j += 2
                    break
                j += 2
            if len(chain) > 1:
                tail_post = toks[j - 1][2] if isinstance(toks[j - 1],
                                                         tuple) else ""
                out.append(pre + " ".join(tr(wd)
                                          for wd in reversed(chain))
                           + tail_post)
                i = j
                continue
        out.append(pre + tr(word) + post)
        i += 1
    return " ".join(out)


# ---------------------------------------------------------------------------
# The scripted instruction follower.
# ---------------------------------------------------------------------------

class ScriptedInstructLLM:
    """Instruction follower used behind the HTTP endpoint.

    Reuses ``DeterministicLLM``'s task behaviors (they are exactly the
    contracts the agent graph needs) but drives them from INFERRED
    tasks, and implements real translation. Mirrors what the hosted
    model does for the reference: read instructions, follow them.
    """

    def __init__(self):
        self._det = DeterministicLLM()
        self.calls: List[str] = []

    _SCHEMA_RE = re.compile(
        r"\s*Respond with ONLY a JSON object with keys:\s*(.+)\s*$",
        re.DOTALL)

    def respond(self, prompt: str) -> str:
        m = self._SCHEMA_RE.search(prompt)
        keys: Optional[Sequence[str]] = None
        if m:
            keys = [k.strip() for k in m.group(1).split(",") if k.strip()]
            prompt = prompt[: m.start()]
        task = infer_task(prompt)
        self.calls.append(task or "?")
        if task == "translate":
            q = self._det._query_of(prompt)
            return translate_to_english(q)
        if keys is not None:
            return json.dumps(self._det.structured(prompt, keys, task=task))
        return self._det.complete(prompt, task=task)


# ---------------------------------------------------------------------------
# HTTP server.
# ---------------------------------------------------------------------------

class MockOpenAIServer:
    """127.0.0.1 chat-completions endpoint over ``ScriptedInstructLLM``.

    Context-manager; ``api_base`` gives the URL for
    ``OpenAICompatibleLLM(api_base, model=...)``. Counts usage tokens
    (whitespace approximation) so the client's cost tracker exercises
    its accounting path.
    """

    def __init__(self, model: Optional[ScriptedInstructLLM] = None,
                 require_key: str = ""):
        self.model = model or ScriptedInstructLLM()
        self.require_key = require_key
        self.requests: List[Dict] = []
        self._httpd: Optional[ThreadingHTTPServer] = None

    @property
    def api_base(self) -> str:
        assert self._httpd is not None, "server not started"
        return "http://127.0.0.1:%d/v1" % self._httpd.server_address[1]

    def start(self) -> "MockOpenAIServer":
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                if not self.path.endswith("/chat/completions"):
                    self.send_error(404)
                    return
                if srv.require_key:
                    auth = self.headers.get("Authorization", "")
                    if auth != f"Bearer {srv.require_key}":
                        self.send_error(401, "bad api key")
                        return
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                srv.requests.append(body)
                messages = body.get("messages", [])
                prompt = next((m.get("content", "")
                               for m in reversed(messages)
                               if m.get("role") == "user"), "")
                try:
                    content = srv.model.respond(prompt)
                except Exception as exc:  # scripted-model bug -> 500
                    self.send_error(500, str(exc))
                    return
                out = json.dumps({
                    "id": "chatcmpl-scripted",
                    "object": "chat.completion",
                    "model": body.get("model", "scripted-1"),
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant",
                                    "content": content},
                        "finish_reason": "stop",
                    }],
                    "usage": {
                        "prompt_tokens": len(prompt.split()),
                        "completion_tokens": len(content.split()),
                        "total_tokens": (len(prompt.split())
                                         + len(content.split())),
                    },
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def __enter__(self) -> "MockOpenAIServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
