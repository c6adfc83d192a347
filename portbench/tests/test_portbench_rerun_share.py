"""The readers of how often a failed certificate reran the whole tiled
search (``rerun_share.*``) on hand-made records of the program's spans:
the share of ``search.fallback`` spans whose ``rerun`` is true, only from
searches that start in the window; None where no ``search.fallback``
carries the attribute (a program without the repair) and without records.
"""

from types import SimpleNamespace

import pytest

from optimized_rag_tpu_torch.utils import profiling
from portbench import harness

T0, T1 = 100.0, 110.0
NAMES = ["rerun_share.batch", "rerun_share.qps"]


def rec(name, id_, parent, start_s, **attrs):
    start = round(start_s * 1e9)
    return SimpleNamespace(name=name, id=id_, parent=parent, start_ns=start,
                           end_ns=start + 1_000_000, cpu_ns=None, thread=1,
                           attrs=attrs)


def search(i, t, route, **fallback):
    out = [rec("search", 10 * i, None, t, B=64, k=10, cc=10, route=route)]
    if route == "fallback":
        out.append(rec("search.fallback", 10 * i + 1, 10 * i, t + 0.0001,
                       **fallback))
    return out


class Recorder:
    def __init__(self, recs):
        self.recs = recs

    def records(self, t0, t1):
        return [r for r in self.recs if t0 * 1e9 <= r.start_ns < t1 * 1e9]


RUN = SimpleNamespace(t0=T0, t1=T1)
RECORDS = (search(0, 99.0, "fallback", pairs=9, rerun=True)      # before
           + search(1, 101.0, "fallback", pairs=3, rerun=False)
           + search(2, 102.0, "fallback", pairs=900, rerun=True)
           + search(3, 103.0, "certified")
           + search(4, 104.0, "fallback", pairs=2, rerun=False)
           + search(5, 105.0, "fallback", pairs=4, rerun=False)
           + search(6, 110.5, "fallback", pairs=1, rerun=True))  # after


def test_entries_name_their_cells():
    names = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    assert names["rerun_share.batch"]["workloads"] == [
        "mrl128.bf16-10m.batch-b4096"]
    assert names["rerun_share.qps"]["workloads"] == [
        "minilm-l6.f32-4m.search-saturated"]
    for name in NAMES:
        assert names[name]["source"] == "program_counter"
        assert names[name]["better"] == "lower"


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_hand_made_records(monkeypatch, name):
    monkeypatch.setattr(profiling, "RECORDER", Recorder(RECORDS))
    assert harness.reader(name)(RUN) == pytest.approx(25.0)


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_the_attribute(monkeypatch, name):
    """The parent's spans: search.fallback without ``rerun``."""
    monkeypatch.setattr(profiling, "RECORDER", Recorder(
        search(1, 101.0, "fallback") + search(2, 102.0, "certified")))
    assert harness.reader(name)(RUN) is None
    monkeypatch.setattr(profiling, "RECORDER", Recorder([]))
    assert harness.reader(name)(RUN) is None
    monkeypatch.delattr(profiling, "RECORDER")
    assert harness.reader(name)(RUN) is None
