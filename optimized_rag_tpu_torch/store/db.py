"""SQLite metadata store.

Schema concepts carried over from the reference (SURVEY.md §2.1 rows 22-23,
46): agent_id multi-tenancy, JSON metadata columns, created_at for the
temporal boost, a memory-operations audit log, and the three DW-GRPO
tables (performance records, learned weights, daily metrics). The
embedding columns are gone — vectors live on-device (index/dense.py);
rows store the engine's doc ids instead.

Thread safety: one connection per thread (SQLite's check_same_thread) via
threading.local, WAL mode for concurrent readers.

Held against ``optimized_rag_tpu/store/db.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    agent_id TEXT NOT NULL,
    filename TEXT,
    title TEXT,
    metadata TEXT DEFAULT '{}',
    quality REAL DEFAULT 0.0,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS chunks (
    id INTEGER PRIMARY KEY,              -- engine doc id (dense index row)
    document_id INTEGER REFERENCES documents(id),
    agent_id TEXT NOT NULL,
    content TEXT NOT NULL,
    chunk_index INTEGER DEFAULT 0,
    metadata TEXT DEFAULT '{}',
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_chunks_agent ON chunks(agent_id);
CREATE INDEX IF NOT EXISTS idx_chunks_doc ON chunks(document_id);

CREATE TABLE IF NOT EXISTS core_memory (
    agent_id TEXT NOT NULL,
    block TEXT NOT NULL,
    content TEXT NOT NULL DEFAULT '',
    updated_at REAL NOT NULL,
    PRIMARY KEY (agent_id, block)
);
CREATE TABLE IF NOT EXISTS archival_memory (
    id INTEGER PRIMARY KEY,              -- engine doc id in archival index
    agent_id TEXT NOT NULL,
    content TEXT NOT NULL,
    metadata TEXT DEFAULT '{}',
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_archival_agent ON archival_memory(agent_id);
CREATE TABLE IF NOT EXISTS recall_memory (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    agent_id TEXT NOT NULL,
    role TEXT NOT NULL,
    content TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_recall_agent
    ON recall_memory(agent_id, created_at);
CREATE TABLE IF NOT EXISTS memory_operations (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    agent_id TEXT NOT NULL,
    operation TEXT NOT NULL,
    detail TEXT DEFAULT '',
    created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS kg_triples (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    agent_id TEXT NOT NULL,
    subject TEXT NOT NULL,
    relation TEXT NOT NULL,
    object TEXT NOT NULL,
    source_doc INTEGER,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_kg_subject ON kg_triples(agent_id, subject);
CREATE INDEX IF NOT EXISTS idx_kg_object ON kg_triples(agent_id, object);

CREATE TABLE IF NOT EXISTS dw_grpo_performance (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    agent_id TEXT NOT NULL,
    intent TEXT NOT NULL,
    complexity TEXT NOT NULL,
    weights TEXT NOT NULL,
    quality REAL NOT NULL,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS dw_grpo_weights (
    agent_id TEXT NOT NULL,
    intent TEXT NOT NULL,
    complexity TEXT NOT NULL,
    weights TEXT NOT NULL,
    updated_at REAL NOT NULL,
    PRIMARY KEY (agent_id, intent, complexity)
);
CREATE TABLE IF NOT EXISTS daily_metrics (
    day TEXT NOT NULL,
    agent_id TEXT NOT NULL,
    metric TEXT NOT NULL,
    value REAL NOT NULL,
    PRIMARY KEY (day, agent_id, metric)
);
"""

# Versioned migration chain (reference run_migration.py:33-41 tracks
# applied migrations in a schema_migrations table). Append new entries —
# never edit an applied one; every statement must be safe on a database
# created by any earlier version (hence IF NOT EXISTS in migration 1,
# which also adopts round-1 databases that predate version tracking).
_MIGRATIONS: List[tuple] = [
    (1, _SCHEMA),
    # Round 2: human-in-the-loop review queue (the reference only FLAGS
    # gray-zone answers, generate_response.py:390-424; the queue gives
    # the flags somewhere to go).
    (2, """
CREATE TABLE IF NOT EXISTS hitl_queue (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    agent_id TEXT NOT NULL,
    query TEXT NOT NULL,
    answer TEXT NOT NULL,
    factuality REAL NOT NULL,
    support_ratio REAL NOT NULL,
    status TEXT NOT NULL DEFAULT 'pending',
    reviewer_note TEXT NOT NULL DEFAULT '',
    created_at REAL NOT NULL,
    reviewed_at REAL
);
CREATE INDEX IF NOT EXISTS idx_hitl_status
    ON hitl_queue(agent_id, status, created_at);
"""),
]


class MetadataStore:
    def __init__(self, path: str = ":memory:"):
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._local = threading.local()
        # :memory: must share one connection or each thread sees an
        # empty database.
        self._shared = sqlite3.connect(":memory:",
                                       check_same_thread=False) \
            if path == ":memory:" else None
        self._lock = threading.Lock()
        self._conns: list[sqlite3.Connection] = []   # every thread's conn
        self._conns_lock = threading.Lock()
        self._migrate()

    def _migrate(self) -> None:
        """Apply unapplied migrations in order, recording each."""
        c = self._conn()
        c.execute("CREATE TABLE IF NOT EXISTS schema_migrations ("
                  "version INTEGER PRIMARY KEY, applied_at REAL NOT NULL)")
        applied = {r[0] for r in c.execute(
            "SELECT version FROM schema_migrations").fetchall()}
        for version, sql in _MIGRATIONS:
            if version in applied:
                continue
            c.executescript(sql)
            c.execute("INSERT INTO schema_migrations (version, applied_at)"
                      " VALUES (?, ?)", (version, time.time()))
            c.commit()

    def schema_version(self) -> int:
        rows = self.execute("SELECT MAX(version) FROM schema_migrations")
        return int(rows[0][0] or 0)

    def _conn(self) -> sqlite3.Connection:
        if self._shared is not None:
            return self._shared
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # check_same_thread=False only so close() can shut down
            # EVERY thread's connection from the closing thread; each
            # connection is still used by exactly one thread otherwise.
            conn = sqlite3.connect(self.path, check_same_thread=False)
            conn.execute("PRAGMA journal_mode=WAL")
            self._local.conn = conn
            with self._conns_lock:
                self._conns.append(conn)
        return conn

    def execute(self, sql: str, params: tuple = ()) -> list:
        # Reads on per-thread file connections run lock-free: WAL gives
        # each reader its own snapshot, and Python's legacy isolation
        # mode opens no transaction for SELECT — so the global lock
        # (needed to serialize writers and ALL access to the shared
        # :memory: connection) would otherwise cap read throughput at
        # single-connection rate, defeating the per-thread-conn design.
        if self._shared is None and sql.lstrip()[:6].upper() == "SELECT":
            return self._conn().execute(sql, params).fetchall()
        with self._lock:
            cur = self._conn().execute(sql, params)
            rows = cur.fetchall()
            self._conn().commit()
            return rows

    # ------------------------------------------------------------ documents

    def insert_document(self, agent_id: str, filename: str = "",
                        title: str = "", metadata: Optional[Dict] = None,
                        quality: float = 0.0) -> int:
        with self._lock:
            cur = self._conn().execute(
                "INSERT INTO documents (agent_id, filename, title, metadata,"
                " quality, created_at) VALUES (?,?,?,?,?,?)",
                (agent_id, filename, title, json.dumps(metadata or {}),
                 quality, time.time()))
            self._conn().commit()
            return int(cur.lastrowid)

    def insert_chunks(self, agent_id: str, document_id: int,
                      ids: List[int], texts: List[str],
                      metadata: Optional[List[Dict]] = None) -> None:
        now = time.time()
        rows = [(int(i), document_id, agent_id, t, n,
                 json.dumps((metadata or [{}] * len(ids))[n]), now)
                for n, (i, t) in enumerate(zip(ids, texts))]
        with self._lock:
            self._conn().executemany(
                "INSERT INTO chunks (id, document_id, agent_id, content,"
                " chunk_index, metadata, created_at) VALUES (?,?,?,?,?,?,?)",
                rows)
            self._conn().commit()

    def get_chunk(self, chunk_id: int) -> Optional[Dict]:
        rows = self.execute(
            "SELECT id, content, metadata, created_at, document_id"
            " FROM chunks WHERE id=?", (int(chunk_id),))
        if not rows:
            return None
        i, content, meta, created, doc = rows[0]
        return {"id": i, "content": content, "metadata": json.loads(meta),
                "created_at": created, "document_id": doc}

    def chunk_text(self, chunk_id: int) -> str:
        row = self.get_chunk(chunk_id)
        return row["content"] if row else ""

    def chunk_created_at(self, chunk_id: int) -> float:
        row = self.get_chunk(chunk_id)
        return row["created_at"] if row else time.time()

    def list_documents(self, agent_id: str) -> List[Dict]:
        rows = self.execute(
            "SELECT d.id, d.filename, d.title, d.created_at,"
            " (SELECT COUNT(*) FROM chunks c WHERE c.document_id = d.id)"
            " FROM documents d WHERE d.agent_id=? ORDER BY d.id",
            (agent_id,))
        return [{"id": r[0], "filename": r[1], "title": r[2],
                 "created_at": r[3], "num_chunks": r[4]} for r in rows]

    # ---------------------------------------------------------- core memory

    def get_core_memory(self, agent_id: str) -> Dict[str, str]:
        rows = self.execute(
            "SELECT block, content FROM core_memory WHERE agent_id=?",
            (agent_id,))
        return dict(rows)

    def set_core_memory(self, agent_id: str, block: str, content: str
                        ) -> None:
        self.execute(
            "INSERT INTO core_memory (agent_id, block, content, updated_at)"
            " VALUES (?,?,?,?) ON CONFLICT(agent_id, block)"
            " DO UPDATE SET content=excluded.content,"
            " updated_at=excluded.updated_at",
            (agent_id, block, content, time.time()))

    def log_memory_operation(self, agent_id: str, operation: str,
                             detail: str = "") -> None:
        self.execute(
            "INSERT INTO memory_operations (agent_id, operation, detail,"
            " created_at) VALUES (?,?,?,?)",
            (agent_id, operation, detail, time.time()))

    # ------------------------------------------------------------- archival

    def insert_archival(self, agent_id: str, doc_id: int, content: str,
                        metadata: Optional[Dict] = None) -> None:
        self.execute(
            "INSERT INTO archival_memory (id, agent_id, content, metadata,"
            " created_at) VALUES (?,?,?,?,?)",
            (int(doc_id), agent_id, content, json.dumps(metadata or {}),
             time.time()))

    def archival_text(self, doc_id: int) -> str:
        rows = self.execute(
            "SELECT content FROM archival_memory WHERE id=?", (int(doc_id),))
        return rows[0][0] if rows else ""

    def archival_created_at(self, doc_id: int) -> float:
        rows = self.execute(
            "SELECT created_at FROM archival_memory WHERE id=?",
            (int(doc_id),))
        return rows[0][0] if rows else time.time()

    # --------------------------------------------------------------- recall

    def save_message(self, agent_id: str, role: str, content: str) -> int:
        with self._lock:
            cur = self._conn().execute(
                "INSERT INTO recall_memory (agent_id, role, content,"
                " created_at) VALUES (?,?,?,?)",
                (agent_id, role, content, time.time()))
            self._conn().commit()
            return int(cur.lastrowid)

    def get_recent_messages(self, agent_id: str, limit: int = 10
                            ) -> List[Dict]:
        rows = self.execute(
            "SELECT role, content, created_at FROM recall_memory"
            " WHERE agent_id=? ORDER BY id DESC LIMIT ?",
            (agent_id, limit))
        return [{"role": r, "content": c, "created_at": t}
                for r, c, t in reversed(rows)]

    def conversation_search(self, agent_id: str, query: str,
                            limit: int = 10) -> List[Dict]:
        """Substring search, the reference's ILIKE recall search
        (memory/manager.py:353)."""
        rows = self.execute(
            "SELECT role, content, created_at FROM recall_memory"
            " WHERE agent_id=? AND content LIKE ? ORDER BY id DESC LIMIT ?",
            (agent_id, f"%{query}%", limit))
        return [{"role": r, "content": c, "created_at": t}
                for r, c, t in rows]

    # ------------------------------------------------------------------- KG

    def insert_triples(self, agent_id: str,
                       triples: List[tuple], source_doc: Optional[int] = None
                       ) -> int:
        now = time.time()
        with self._lock:
            self._conn().executemany(
                "INSERT INTO kg_triples (agent_id, subject, relation, object,"
                " source_doc, created_at) VALUES (?,?,?,?,?,?)",
                [(agent_id, s, r, o, source_doc, now) for s, r, o in triples])
            self._conn().commit()
        return len(triples)

    def find_triples(self, agent_id: str, entity: str, limit: int = 50
                     ) -> List[tuple]:
        pat = f"%{entity}%"
        rows = self.execute(
            "SELECT subject, relation, object FROM kg_triples"
            " WHERE agent_id=? AND (subject LIKE ? OR object LIKE ?)"
            " LIMIT ?", (agent_id, pat, pat, limit))
        return [tuple(r) for r in rows]

    # -------------------------------------------------------------- DW-GRPO

    def save_performance(self, record: Dict[str, Any]) -> None:
        self.execute(
            "INSERT INTO dw_grpo_performance (agent_id, intent, complexity,"
            " weights, quality, created_at) VALUES (?,?,?,?,?,?)",
            (record["agent_id"], record["intent"], record["complexity"],
             json.dumps(record["weights"]), record["quality"], time.time()))

    def save_learned_weights(self, agent_id: str, intent: str,
                             complexity: str, weights: Dict[str, float]
                             ) -> None:
        self.execute(
            "INSERT INTO dw_grpo_weights (agent_id, intent, complexity,"
            " weights, updated_at) VALUES (?,?,?,?,?)"
            " ON CONFLICT(agent_id, intent, complexity)"
            " DO UPDATE SET weights=excluded.weights,"
            " updated_at=excluded.updated_at",
            (agent_id, intent, complexity, json.dumps(weights), time.time()))

    def load_learned_weights(self, agent_id: str, intent: str,
                             complexity: str) -> Optional[Dict[str, float]]:
        rows = self.execute(
            "SELECT weights FROM dw_grpo_weights WHERE agent_id=? AND"
            " intent=? AND complexity=?", (agent_id, intent, complexity))
        return json.loads(rows[0][0]) if rows else None

    # ----------------------------------------------------------- HITL queue

    def hitl_enqueue(self, agent_id: str, query: str, answer: str,
                     factuality: float, support_ratio: float) -> int:
        with self._lock:
            cur = self._conn().execute(
                "INSERT INTO hitl_queue (agent_id, query, answer,"
                " factuality, support_ratio, created_at)"
                " VALUES (?,?,?,?,?,?)",
                (agent_id, query, answer, factuality, support_ratio,
                 time.time()))
            self._conn().commit()
            return int(cur.lastrowid)

    def hitl_list(self, agent_id: str, status: str = "pending",
                  limit: int = 50) -> List[Dict[str, Any]]:
        rows = self.execute(
            "SELECT id, query, answer, factuality, support_ratio, status,"
            " reviewer_note, created_at FROM hitl_queue WHERE agent_id=?"
            " AND status=? ORDER BY created_at LIMIT ?",
            (agent_id, status, limit))
        keys = ("id", "query", "answer", "factuality", "support_ratio",
                "status", "reviewer_note", "created_at")
        return [dict(zip(keys, r)) for r in rows]

    def hitl_review(self, item_id: int, status: str,
                    note: str = "") -> bool:
        assert status in ("approved", "rejected"), status
        rows = self.execute(
            "UPDATE hitl_queue SET status=?, reviewer_note=?, reviewed_at=?"
            " WHERE id=? AND status='pending' RETURNING id",
            (status, note, time.time(), item_id))
        return bool(rows)

    def update_daily_metric(self, agent_id: str, metric: str, value: float,
                            day: Optional[str] = None) -> None:
        day = day or time.strftime("%Y-%m-%d")
        self.execute(
            "INSERT INTO daily_metrics (day, agent_id, metric, value)"
            " VALUES (?,?,?,?) ON CONFLICT(day, agent_id, metric)"
            " DO UPDATE SET value = daily_metrics.value + excluded.value",
            (day, agent_id, metric, value))

    def get_daily_metrics(self, agent_id: str, day: Optional[str] = None
                          ) -> Dict[str, float]:
        day = day or time.strftime("%Y-%m-%d")
        rows = self.execute(
            "SELECT metric, value FROM daily_metrics WHERE agent_id=? AND"
            " day=?", (agent_id, day))
        return dict(rows)

    def close(self) -> None:
        if self._shared is not None:
            self._shared.close()
        # Close EVERY thread's connection, not just the caller's —
        # worker-thread connections otherwise leak until process exit.
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.close()
            except sqlite3.Error:
                pass
        self._local = threading.local()
