"""The store layer and index snapshots of the PyTorch port against the JAX
package's, on the CPU.

``MetadataStore``, the knowledge graph and ``CostTracker`` are host code
copied from the JAX package: the same operations, with the stores' clock
(``store/db.py``'s ``time.time``) pinned to the same sequence in both, must
give identical rows. Archival memory searches a ``DenseIndex`` on the
manager's device: its ids must equal the JAX package's and its scores
agree within 1e-6 (float32 dot products, two summation orders), also after
the index grows past its 4,096-row block. Snapshots go both ways for dense (float32 and bfloat16),
lexical and archival indexes, and the searches after a load must equal
those of the index that was saved (ids equal, scores within 1e-6).
"""

import json
import sqlite3
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from optimized_rag_tpu.index import snapshot as jax_snapshot
from optimized_rag_tpu.index.dense import DenseIndex as JaxDense
from optimized_rag_tpu.index.lexical import LexicalIndex as JaxLexical
from optimized_rag_tpu.store import cost as jax_cost
from optimized_rag_tpu.store import db as jax_db
from optimized_rag_tpu.store import kg as jax_kg
from optimized_rag_tpu.store import memory as jax_memory
from optimized_rag_tpu_torch.index import snapshot
from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.index.lexical import LexicalIndex
from optimized_rag_tpu_torch.store import cost, db, kg, memory

SCORE_TOL = 1e-6
DIM = 32


@pytest.fixture
def clock(monkeypatch):
    """The stores' ``time`` module with ``time()`` pinned (the rest is the
    real module's); ``restart()`` replays the same clock. Only the two
    ``store/db.py`` modules see it: JAX reads the real clock itself."""
    class Clock:
        def restart(self):
            self.t = 1.7e9

        def time(self):
            self.t += 0.5
            return self.t

        def __getattr__(self, name):
            return getattr(time, name)
    c = Clock()
    c.restart()
    for mod in (db, jax_db):
        monkeypatch.setattr(mod, "time", c)
    return c


def _both(clock, fn):
    """``fn(package modules)`` for the port and the JAX package, each from
    the same clock."""
    out = []
    for mods in ((db, kg, memory), (jax_db, jax_kg, jax_memory)):
        clock.restart()
        out.append(fn(*mods))
    return out


# ------------------------------------------------------------- metadata

def _metadata_script(dbm, path=":memory:"):
    s = dbm.MetadataStore(path)
    rec = {}
    doc = s.insert_document("a1", filename="f.txt", title="T")
    s.insert_chunks("a1", doc, ids=[0, 1], texts=["chunk a", "chunk b"])
    rec["chunk"] = [s.get_chunk(i) for i in (0, 1, 7)]
    rec["text"] = [s.chunk_text(0), s.chunk_created_at(1)]
    rec["docs"] = s.list_documents("a1")
    s.set_core_memory("a1", "facts", "alpha")
    s.set_core_memory("a2", "facts", "beta")
    rec["core"] = [s.get_core_memory("a1"), s.get_core_memory("a2")]
    w = {"semantic": 0.6, "keyword": 0.3, "temporal": 0.1}
    s.save_learned_weights("a1", "search", "simple", w)
    rec["weights"] = [s.load_learned_weights("a1", "search", "simple"),
                      s.load_learned_weights("a1", "search", "complex")]
    s.save_performance(dict(agent_id="a1", intent="search",
                            complexity="simple", weights=w, quality=0.9))
    s.update_daily_metric("a1", "tier1_hits", 3)
    s.update_daily_metric("a1", "tier1_hits", 2)
    rec["daily"] = s.get_daily_metrics("a1")
    for role, text in (("user", "hello there"), ("assistant", "hi!"),
                       ("user", "tell me about gpus")):
        s.save_message("a1", role, text)
    rec["recent"] = s.get_recent_messages("a1", 2)
    rec["search"] = s.conversation_search("a1", "gpus")
    s.insert_archival("a1", 0, "archived note", {"k": 1})
    rec["archival"] = [s.archival_text(0), s.archival_created_at(0),
                       s.archival_text(9)]
    s.log_memory_operation("a1", "op", "detail")
    rec["ops"] = s.execute("SELECT * FROM memory_operations")
    i1 = s.hitl_enqueue("a", "q1", "ans1", 0.55, 0.6)
    i2 = s.hitl_enqueue("a", "q2", "ans2", 0.45, 0.5)
    rec["hitl"] = [s.hitl_list("a"), s.hitl_review(i1, "approved", "fine"),
                   s.hitl_review(i1, "rejected"), s.hitl_list("a"),
                   s.hitl_list("a", status="approved"), i2]
    rec["version"] = s.schema_version()
    rec["migrations"] = s.execute("SELECT * FROM schema_migrations")
    s.close()
    return rec


def test_metadata_store_matches_jax(clock):
    got, want = _both(clock, lambda dbm, *_: _metadata_script(dbm))
    assert got == want
    assert got["version"] == db._MIGRATIONS[-1][0] == \
        jax_db._MIGRATIONS[-1][0]


def test_migrations_and_persistence_match_jax(clock, tmp_path):
    def script(dbm, *_):
        path = str(tmp_path / f"{dbm.__name__}.db")
        conn = sqlite3.connect(path)
        conn.executescript(dbm._SCHEMA)       # an unversioned data dir
        conn.execute("INSERT INTO core_memory VALUES ('a', 'facts', "
                     "'kept', 1)")
        conn.commit()
        conn.close()
        s1 = dbm.MetadataStore(path)
        s1.set_core_memory("a1", "persona", "persistent persona")
        rows = [s1.schema_version(),
                s1.execute("SELECT content FROM core_memory "
                           "WHERE agent_id='a'")]
        s1.close()
        s2 = dbm.MetadataStore(path)
        rows += [s2.get_core_memory("a1"), s2.schema_version(),
                 s2.execute("SELECT COUNT(*) FROM schema_migrations")]
        s2.close()
        return rows
    got, want = _both(clock, script)
    assert got == want
    assert got[1] == [("kept",)] and got[-1] == [(len(db._MIGRATIONS),)]


def test_reads_run_while_writer_holds_lock(tmp_path):
    store = db.MetadataStore(str(tmp_path / "c.db"))
    doc = store.insert_document("a", filename="f.txt")
    store.insert_chunks("a", doc, [0], ["chunk body"])
    got = {}
    with store._lock:                       # an in-flight writer
        t = threading.Thread(target=lambda: got.update(
            row=store.get_chunk(0)), daemon=True)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "reader blocked behind the write lock"
    assert got["row"]["content"] == "chunk body"
    store.close()


def test_close_closes_every_thread_connection(tmp_path):
    store = db.MetadataStore(str(tmp_path / "d.db"))
    doc = store.insert_document("a", filename="f.txt")
    store.insert_chunks("a", doc, [0], ["body"])
    conns = {}

    def worker():
        store.get_chunk(0)
        conns["c"] = store._local.conn

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(store._conns) >= 2
    store.close()
    with pytest.raises(sqlite3.ProgrammingError):
        conns["c"].execute("SELECT 1")
    assert store.get_chunk(0)["content"] == "body"
    store.close()


# ------------------------------------------------------------------- KG

KG_TEXTS = [
    "The Meridian project was led by Dr. Alvarez.",
    "Dr. Alvarez joined from the Basel lab in 2021.",
    "Semantic chunking embeds each sentence.",
    "It multiplies matrices.",
    "The central bank raised interest rates by half a percentage point.",
    "LLMs rely on static training data, making them prone to errors.",
    "Northwind Logistics acquired its largest regional rival.",
]


def test_heuristic_triples_and_parsing_match_jax():
    for text in KG_TEXTS:
        assert kg.heuristic_triples(text) == jax_kg.heuristic_triples(text)
    raw = "a|rel|b\nmalformed line\nc | has | d\n||\n"
    assert kg.parse_triple_lines(raw) == jax_kg.parse_triple_lines(raw) \
        == [("a", "rel", "b"), ("c", "has", "d")]


def test_knowledge_graph_matches_jax(clock):
    def script(dbm, kgm, _):
        store = dbm.MetadataStore(":memory:")
        ex = kgm.KnowledgeGraphExtractor(store, agent_id="t")
        for text in KG_TEXTS:
            ex.extract_and_store(text)
        ex.store_triples([("tpu", "made_by", "google"),
                          ("google", "located_in", "california"),
                          ("california", "part_of", "usa"),
                          ("X", "made by", "Dr"),
                          ("Claim", "splits", "draft answer")])
        llm = kgm.KnowledgeGraphExtractor(store, llm_fn=lambda p:
                                          "GPU|is|accelerator\nbad")
        failing = kgm.KnowledgeGraphExtractor(
            store, llm_fn=lambda p: (_ for _ in ()).throw(RuntimeError()))
        ret = kgm.KnowledgeGraphRetriever(store, agent_id="t", max_hops=2)
        out = [llm.extract_triples("whatever"),
               failing.extract_triples("The GPU is a matrix accelerator."),
               ret.find_related_entities("tpu", max_hops=2),
               ret.find_related_entities("tpu", max_hops=1),
               ret.find_related_entities("X"),
               ret.query_knowledge_graph("Meridian project"),
               ret.query_chains("Where did the head of the Meridian "
                                "project come from?"),
               kgm.KnowledgeGraphRetriever.extract_query_entities(
                   "What is the capital of Paris region?")]
        store.close()
        return out
    got, want = _both(clock, script)
    assert got == want
    assert got[6] and "Basel lab" in got[6][0]


def test_cost_tracker_matches_jax(tmp_path):
    out = []
    for mod in (cost, jax_cost):
        path = str(tmp_path / f"{mod.__name__}.json")
        t = mod.CostTracker(path)
        t.track_llm(8000, 500, "gpt-4o-mini")
        t.track_llm(1000, 100)
        t.track_embedding(10000, "on-device", device_seconds=0.01)
        t.track_search(2)
        t.track_device_time(0.25, "rerank")
        t.save()
        out.append([t.get_summary(), t.get_cost_savings_report(),
                    t.get_daily_report(), t.get_total_cost(),
                    mod.CostTracker(path).totals])
    assert out[0] == out[1]
    assert out[0][0]["search_calls"] == 2


# --------------------------------------------------------------- memory

def _embedder(n=8192, seed=3):
    """Text ``"note i ..."`` -> row i of a seeded Gaussian matrix; other
    texts -> a vector seeded by their length. The same function for both
    packages."""
    table = np.random.default_rng(seed).standard_normal(
        (n, DIM)).astype(np.float32)

    def embed(texts):
        return np.stack([table[int(t.split()[1])] if t.startswith("note ")
                         else np.random.default_rng(len(t)).standard_normal(
                             DIM).astype(np.float32) for t in texts])
    return embed


def test_core_and_recall_memory_match_jax(clock):
    embed = _embedder()

    def script(dbm, _, mm):
        m = mm.MemoryManager(dbm.MetadataStore(":memory:"), embed,
                             embed_dim=DIM, persona="I am a test agent.",
                             core_limit_chars=60,
                             **({"device": "cpu"} if mm is memory else {}))
        out = [m.get_core_memory(),
               m.core_memory_append("human", "name: alice"),
               m.core_memory_replace("human", "alice", "bob"),
               m.core_memory_replace("human", "nonexistent", "x"),
               m.add_core_fact("the sky is blue"),
               m.core_memory_append("facts", "x" * 100),
               m.get_core_memory(), m.format_core_memory()]
        for role, text in (("user", "hello there"),
                           ("assistant", "hi! how can I help?"),
                           ("user", "tell me about gpus")):
            out.append(m.save_message(role, text))
        out += [m.get_recent_messages(2), m.conversation_search("gpus"),
                m.archival_memory_search("empty archive", 5)]
        return out
    got, want = _both(clock, script)
    assert got == want
    assert got[5].startswith("Error") and got[3].startswith("Error")


def _hits(docs):
    return ([d.doc_id for d in docs], [d.score for d in docs],
            [d.text for d in docs], [d.created_at for d in docs])


def test_archival_memory_matches_jax_past_the_block(clock):
    embed = _embedder()
    queries = [f"note {i} query" for i in (5, 4095, 4096, 17)] + [
        "an unrelated question", "what pet does the user have"]
    runs = {}
    for name, mods in (("port", (db, memory)), ("jax", (jax_db, jax_memory))):
        clock.restart()
        dbm, mm = mods
        m = mm.MemoryManager(dbm.MetadataStore(":memory:"), embed,
                             embed_dim=DIM,
                             **({"device": "cpu"} if mm is memory else {}))
        ids = m.bulk_insert_archival([f"note {i} bulk" for i in range(4000)])
        ids += m.bulk_insert_archival([f"note {i} more" for i in
                                       range(4000, 4096)])
        out = [ids, [_hits(m.archival_memory_search(q, 5))
                     for q in queries]]
        ids.append(m.archival_memory_insert("note 4096 single", {"k": 1}))
        out.append(m.archival.capacity)
        out.append([_hits(m.archival_memory_search(q, k))
                    for q in queries for k in (1, 5)])
        runs[name] = out
    port, ref = runs["port"], runs["jax"]
    assert port[0] == ref[0] == list(range(4097))
    assert port[2] == ref[2] == 8192
    for got, want in zip(port[1] + port[3], ref[1] + ref[3]):
        assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
        np.testing.assert_allclose(got[1], want[1], atol=SCORE_TOL)
    # The new entry answers its own text first.
    assert port[3][5][0][0] == 4096


def test_memory_manager_uses_a_passed_archival_index():
    idx = DenseIndex(DIM, capacity_block=256, tile=256, device="cpu")
    m = memory.MemoryManager(db.MetadataStore(":memory:"), _embedder(),
                             embed_dim=DIM, archival_index=idx,
                             device="cpu")
    assert m.archival is idx
    m.archival_memory_insert("note 3 x")
    assert idx.size == 1


# ------------------------------------------------------------ snapshots

def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _dense_pair(dtype, rng):
    """The same rows in a JAX and a port DenseIndex (3 tombstones)."""
    rows = _unit(rng, 700, DIM)
    ref = JaxDense(DIM, capacity_block=256, dtype={
        "float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype], tile=256)
    port = DenseIndex(DIM, capacity_block=256, dtype=dtype, tile=256,
                      device="cpu")
    for idx in (ref, port):
        idx.add(rows)
        idx.delete([3, 40, 511])
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_dense_snapshot_across_packages(tmp_path, rng, dtype, direction):
    ref, port = _dense_pair(dtype, rng)
    q = _unit(rng, 6, DIM)
    if direction == "jax_to_port":
        jax_snapshot.save_state(str(tmp_path), "dense", ref.state_dict())
        saved, loaded = ref, DenseIndex.from_state_dict(
            snapshot.load_state(str(tmp_path), "dense"), device="cpu")
        assert str(loaded.dtype) == f"torch.{dtype}"
    else:
        snapshot.save_state(str(tmp_path), "dense", port.state_dict())
        saved, loaded = port, JaxDense.from_state_dict(
            jax_snapshot.load_state(str(tmp_path), "dense"))
    assert loaded.size == saved.size == 700
    assert loaded._tombstones == {3, 40, 511}
    for k in (1, 5, 12):
        r1, r2 = saved.search(q, k), loaded.search(q, k)
        np.testing.assert_array_equal(r1.ids, r2.ids)
        np.testing.assert_allclose(r1.scores, r2.scores, atol=SCORE_TOL)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_lexical_snapshot_across_packages(tmp_path, direction, monkeypatch):
    import optimized_rag_tpu.native as jax_native
    monkeypatch.setattr(jax_native, "_lib", None)     # its Python path
    monkeypatch.setattr(jax_native, "_load_attempted", True)
    corpus = ["the quick brown fox jumps over the lazy dog",
              "machine learning on tensor processing units",
              "quick sort and merge sort algorithms",
              "deep learning models require massive compute",
              "the fox hunted rabbits in the brown forest"] * 3
    ref, port = JaxLexical(vocab_hash_bits=12, cap=16), LexicalIndex(
        vocab_hash_bits=12, cap=16, device="cpu")
    ref.add(corpus)
    port.add(corpus)
    if direction == "jax_to_port":
        jax_snapshot.save_state(str(tmp_path), "lexical", ref.state_dict())
        saved, loaded = ref, LexicalIndex.from_state_dict(
            snapshot.load_state(str(tmp_path), "lexical"), device="cpu")
    else:
        snapshot.save_state(str(tmp_path), "lexical", port.state_dict())
        saved, loaded = port, JaxLexical.from_state_dict(
            jax_snapshot.load_state(str(tmp_path), "lexical"))
    for query in ("brown fox", "learning compute", "sort", "nothing"):
        s1, i1 = saved.search(query, 4)
        s2, i2 = loaded.search(query, 4)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(s1, s2, rtol=SCORE_TOL)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_archival_snapshot_across_packages(tmp_path, clock, direction):
    embed = _embedder()
    managers = {}
    for name, dbm, mm in (("port", db, memory), ("jax", jax_db, jax_memory)):
        clock.restart()
        m = mm.MemoryManager(dbm.MetadataStore(":memory:"), embed,
                             embed_dim=DIM,
                             **({"device": "cpu"} if mm is memory else {}))
        m.bulk_insert_archival([f"note {i} x" for i in range(300)])
        managers[name] = m
    src, dst = (("jax", "port") if direction == "jax_to_port"
                else ("port", "jax"))
    save = {"jax": jax_snapshot, "port": snapshot}
    save[src].save_state(str(tmp_path), "archival",
                         managers[src].archival.state_dict())
    state = save[dst].load_state(str(tmp_path), "archival")
    managers[dst].archival = (
        DenseIndex.from_state_dict(state, device="cpu") if dst == "port"
        else JaxDense.from_state_dict(state))
    for q in ("note 7 q", "note 299 q", "what pet"):
        got = _hits(managers[dst].archival_memory_search(q, 5))
        want = _hits(managers[src].archival_memory_search(q, 5))
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_allclose(got[1], want[1], atol=SCORE_TOL)


def test_snapshot_version_stamp_and_refusal(tmp_path):
    for mod, other in ((snapshot, jax_snapshot), (jax_snapshot, snapshot)):
        d = str(tmp_path / mod.__name__)
        mod.save_state(d, "x", {"a": np.ones(3), "k": 5})
        meta = json.load(open(f"{d}/x.json"))
        assert meta["__format_version__"] == \
            snapshot.SNAPSHOT_FORMAT_VERSION == \
            jax_snapshot.SNAPSHOT_FORMAT_VERSION
        state = other.load_state(d, "x")
        assert state["k"] == 5 and "__format_version__" not in state
        assert other.exists(d, "x") and not other.exists(d, "y")
        meta.pop("__format_version__")          # unstamped: version 0
        json.dump(meta, open(f"{d}/x.json", "w"))
        assert other.load_state(d, "x")["k"] == 5
        meta["__format_version__"] = 99         # newer: refused
        json.dump(meta, open(f"{d}/x.json", "w"))
        with pytest.raises(ValueError, match="newer"):
            other.load_state(d, "x")
