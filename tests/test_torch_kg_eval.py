"""The port's triple-extraction eval against the JAX package's
``eval/kg_eval.py``, on the CPU.

Host code only, so everything is held for equality: the gold cases,
``triple_matches`` over seeded pairs of triples, ``score_extractor`` over
both packages' extractors (heuristic, the deterministic LLM, and the
loopback HTTP endpoint), and ``main --loopback``'s JSON, which is also the
committed reference result ``docs/results_r5/kg_eval.json``.
"""

import json
import os

import pytest

from optimized_rag_tpu.agent.llm import DeterministicLLM as JaxLLM
from optimized_rag_tpu.eval import kg_eval as jkg
from optimized_rag_tpu.store.kg import (
    KnowledgeGraphExtractor as JaxExtractor)
from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
from optimized_rag_tpu_torch.eval import kg_eval as pkg
from optimized_rag_tpu_torch.store.kg import KnowledgeGraphExtractor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = ("GOLD_CASES", "GOLD_OOR_CASES", "GOLD_HELDOUT_CASES")
EXTRACTORS = {
    "heuristic": (lambda: KnowledgeGraphExtractor(store=None),
                  lambda: JaxExtractor(store=None)),
    "llm": (lambda: KnowledgeGraphExtractor(
        store=None, llm_fn=lambda p: DeterministicLLM().complete(
            p, task="extract_triples")),
            lambda: JaxExtractor(store=None, llm_fn=lambda p: JaxLLM(
            ).complete(p, task="extract_triples"))),
}


@pytest.mark.parametrize("name", GOLD)
def test_gold_cases_equal_jax(name):
    ours, ref = getattr(pkg, name), getattr(jkg, name)
    assert ours == ref and len(ours) > 0


def test_triple_matches_and_norm_match_jax(rng):
    """Every gold triple against seeded predictions: the gold itself, its
    parts swapped between cases, with articles, case and containment
    changes."""
    triples = [tuple(g) for c in pkg.GOLD_CASES + pkg.GOLD_OOR_CASES
               for g in c["gold"]]
    hits = 0
    for gold in triples:
        for _ in range(20):
            a, b = (triples[int(rng.integers(len(triples)))]
                    for _ in range(2))
            pick = [gold, a, b]
            pred = tuple(pick[int(rng.integers(3))][i] for i in range(3))
            if rng.random() < 0.3:
                pred = ("The " + pred[0].upper(), pred[1],
                        pred[2].split()[-1])
            got = pkg.triple_matches(pred, gold)
            assert got == jkg.triple_matches(pred, gold), (pred, gold)
            hits += got
        for part in gold:
            assert pkg._norm(part) == jkg._norm(part)
            assert pkg._rel_words(part) == jkg._rel_words(part)
    assert 0 < hits < 20 * len(triples)


@pytest.mark.parametrize("extractor", sorted(EXTRACTORS))
@pytest.mark.parametrize("name", GOLD)
def test_score_extractor_matches_jax(extractor, name):
    ours, ref = (make() for make in EXTRACTORS[extractor])
    cases = getattr(pkg, name)
    got = pkg.score_extractor(ours.extract_triples, cases)
    assert got == jkg.score_extractor(ref.extract_triples, cases)
    assert got["tp"] + got["fn"] == sum(len(c["gold"]) for c in cases)


def test_main_with_loopback_equals_jax_and_the_reference(tmp_path,
                                                         capsys):
    ours, ref = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert pkg.main(["--loopback", "--json", ours]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert jkg.main(["--loopback", "--json", ref]) == 0
    with open(ours) as f, open(ref) as g:
        got, want = json.load(f), json.load(g)
    assert got == want
    with open(os.path.join(REPO, "docs", "results_r5", "kg_eval.json")) as f:
        assert got == json.load(f)
    assert set(got["loopback"]) == {"in_register", "out_of_register"}
    assert "cases" not in printed["in_register"]["heuristic"]
