"""The readers of the program's own spans (``program_spans.py`` and the
metrics that use it) on hand-made records: each reads what its entry says,
only from spans that start in the window, and gives None without records
and with a program that has no recorder."""

from types import SimpleNamespace

import pytest

from optimized_rag_tpu_torch.utils import profiling
from portbench import harness

T0, T1 = 100.0, 110.0            # the window, perf_counter seconds
NEW = ["queue_wait_ms.qps", "tokenize_ms.qps", "encode_launch_ms.qps",
       "encode_upload_ms.qps", "encode_fetch_ms.qps",
       "encode_offcpu_ms.qps", "search_wait_ms.qps", "search_wait_ms.batch",
       "fallback_ms.qps", "fallback_ms.batch", "uncovered.qps",
       "uncovered.batch"]


def rec(name, id_, parent, start_s, ms, cpu_ms=None, **attrs):
    start = round(start_s * 1e9)
    return SimpleNamespace(
        name=name, id=id_, parent=parent, start_ns=start,
        end_ns=start + round(ms * 1e6),
        cpu_ns=None if cpu_ms is None else round(cpu_ms * 1e6), thread=1,
        attrs=attrs)


def batch(i, t, n, wait_sum, route, uncovered, fallback_ms):
    """One served batch's spans, ids from 100 * i."""
    b = 100 * i
    out = [rec("serve.collect", b, None, t - 0.004, 2.0, batch=i, n=n),
           rec("serve.dispatch", b + 1, None, t, 60.0, batch=i, n=n,
               bucket=64, k_eff=16, wait_ms_sum=wait_sum,
               wait_ms_max=wait_sum / n),
           rec("encode", b + 2, b + 1, t + 0.001, 40.0, cpu_ms=10.0,
               texts=64, misses=n, bucket=64),
           rec("encode.tokenize", b + 3, b + 2, t + 0.0015, 1.0),
           rec("encode.upload", b + 4, b + 2, t + 0.003, 3.0),
           rec("encode.forward", b + 5, b + 2, t + 0.007, 20.0),
           rec("encode.fetch", b + 6, b + 2, t + 0.028, 12.0),
           rec("search", b + 7, b + 1, t + 0.042, 15.0, B=64, k=16, cc=16,
               route=route, **({} if uncovered is None
                               else {"uncovered": uncovered})),
           rec("search.wait", b + 8, b + 7, t + 0.043, 4.0)]
    if fallback_ms:
        out.append(rec("search.fallback", b + 9, b + 7, t + 0.048,
                       fallback_ms))
    return out


RECORDS = (batch(0, 99.0, 64, 640.0, "fallback", 7, 9.0)   # before: out
           + batch(1, 101.0, 64, 320.0, "fallback", 3, 8.0)
           + batch(2, 102.0, 32, 96.0, "certified", 0, 0.0)
           + batch(3, 103.0, 64, 64.0, "direct", None, 0.0)
           + batch(4, 110.5, 64, 640.0, "fallback", 9, 9.0))  # after: out
WANT = {"queue_wait_ms.qps": (320 + 96 + 64) / (64 + 32 + 64),
        "tokenize_ms.qps": 1.0, "encode_launch_ms.qps": 20.0,
        "encode_upload_ms.qps": 3.0, "encode_fetch_ms.qps": 12.0,
        "encode_offcpu_ms.qps": 30.0, "search_wait_ms.qps": 4.0,
        "search_wait_ms.batch": 4.0, "fallback_ms.qps": 8.0 / 3,
        "fallback_ms.batch": 8.0 / 3, "uncovered.qps": 1.5,
        "uncovered.batch": 1.5}


class Recorder:
    def __init__(self, recs):
        self.recs = recs

    def records(self, t0, t1):
        return [r for r in self.recs if t0 * 1e9 <= r.start_ns < t1 * 1e9]


RUN = SimpleNamespace(t0=T0, t1=T1)


def test_every_new_metric_has_an_entry_and_a_reader():
    names = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name in NEW:
        assert names[name]["workloads"] and names[name]["source"] == (
            "program_counter" if name.startswith("uncovered")
            else "host_clock")


@pytest.mark.parametrize("name", NEW)
def test_reader_on_hand_made_records(monkeypatch, name):
    monkeypatch.setattr(profiling, "RECORDER", Recorder(RECORDS))
    assert harness.reader(name)(RUN) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_reader_without_records(monkeypatch, name):
    monkeypatch.setattr(profiling, "RECORDER", Recorder([]))
    assert harness.reader(name)(RUN) is None
    monkeypatch.setattr(profiling, "RECORDER", Recorder(
        batch(0, 99.0, 64, 640.0, "fallback", 7, 9.0)))
    assert harness.reader(name)(RUN) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_of_a_program_without_the_recorder(monkeypatch, name):
    monkeypatch.delattr(profiling, "RECORDER")
    assert harness.reader(name)(RUN) is None


def test_uncovered_needs_a_certified_scan(monkeypatch):
    direct = [r for r in batch(1, 101.0, 64, 64.0, "direct", None, 0.0)]
    monkeypatch.setattr(profiling, "RECORDER", Recorder(direct))
    assert harness.reader("uncovered.qps")(RUN) is None
    assert harness.reader("fallback_ms.qps")(RUN) == 0.0
