"""The traffic generators: the same inputs for the same seed, others for
another, and the same sizes for every seed."""

import torch

from portbench import harness
from portbench.corpus.clustered import Corpus
from portbench.traffic import served

MIX = harness.load_json(harness.HERE, "traffic", "search-saturated.json")


def texts(seed, n=300, label=10):
    stream = served.TextStream(MIX, seed, label, set())
    return [next(stream) for _ in range(n)]


def test_texts_follow_the_seed():
    big = 2 ** 31 + 977
    assert texts(big) == texts(big)
    assert texts(big) != texts(big + 1)


def test_texts_never_repeat_and_lengths_do_not_depend_on_the_seed():
    a = served.TextStream(MIX, 5, 10, set())
    b = served.TextStream(MIX, 6, 10, set())
    assert sorted(a.lengths) == sorted(b.lengths)
    assert a.lengths != b.lengths
    w = MIX["words"]
    assert min(a.lengths) == w["min"] and max(a.lengths) <= w["max"]
    assert sorted(a.lengths)[len(a.lengths) // 2] == w["median"]
    got = [next(a) for _ in range(5000)]
    assert len(set(got)) == len(got)


def test_warmup_and_window_texts_are_apart():
    used = set()
    win = served.TextStream(MIX, 9, 10, used)
    warm = served.TextStream(MIX, 9, 11, used)
    w1 = [next(warm) for _ in range(500)]
    w2 = [next(win) for _ in range(500)]
    assert not set(w1) & set(w2)


def test_arrival_gaps_are_the_same_set_for_every_seed():
    g1, g2 = served._gaps(880.0, 1), served._gaps(880.0, 2)
    assert g1 != g2 and sorted(g1) == sorted(g2)
    assert abs(sum(g1) / len(g1) - 1 / 880.0) < 0.02 / 880.0


def corpus(seed, runs=8):
    spec = {"rows": 8192, "dim": 32, "clusters": 16, "runs": runs,
            "run_len": [8, 32], "base": None}
    return Corpus(spec, seed, "cpu")


def test_corpus_and_queries_follow_the_seed():
    a = torch.cat([x for _, x in corpus(2 ** 31 + 3).blocks()])
    again = torch.cat([x for _, x in corpus(2 ** 31 + 3).blocks()])
    other = torch.cat([x for _, x in corpus(2 ** 31 + 4).blocks()])
    assert torch.equal(a, again) and not torch.equal(a, other)
    assert a.shape == (8192, 32)
    assert torch.allclose(a.norm(dim=1), torch.ones(8192), atol=1e-5)
    c = corpus(11)
    assert torch.equal(c.queries(64, 0), corpus(11).queries(64, 0))
    assert not torch.equal(c.queries(64, 0), c.queries(64, 1))


def test_blocks_walk_the_same_rows_twice():
    c = corpus(21)
    first = torch.cat([x for _, x in c.blocks()])
    second = torch.cat([x for _, x in c.blocks()])
    assert torch.equal(first, second)


def test_near_duplicate_runs_sit_near_their_base():
    c = corpus(31)
    rows = torch.cat([x for _, x in c.blocks()])
    start, length = c.runs[0]
    run = rows[start:start + length]
    sims = run @ run.T
    assert sims.min() > 0.9
