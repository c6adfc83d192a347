"""Document ingestion: wrangle -> chunk -> embed -> index -> KG.

Re-implements the reference's two-piece ingestion surface:
  * DocumentStore.upload_and_index (rag/document_store.py:238-405):
    clean, chunk, batch-embed, insert chunks, extract KG triples
  * DocumentUploader.upload_file / upload_directory
    (services/document_uploader.py:59-124)

The embedding batch runs on the device (one forward for all chunks); the
NaN/Inf validation the reference performs per row before SQL insert
(document_store.py:354-364) happens on the whole batch at once.

Held against ``optimized_rag_tpu/services/ingest.py``, a copy whose imports
name the port's modules. ``DataWrangler()`` takes no ``embed_fn`` here, as
in the reference, so it needs no device.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from optimized_rag_tpu_torch.engine.chunking import (
    FixedSizeChunker, RecursiveChunker, SemanticChunker)
from optimized_rag_tpu_torch.engine.documents import DocumentProcessor
from optimized_rag_tpu_torch.engine.wrangler import DataWrangler


class DocumentIngestor:
    def __init__(self, agent, chunker=None):
        """``agent`` supplies settings, embed_fn, dense/lexical indexes,
        metadata store, and the KG extractor."""
        self.agent = agent
        s = agent.settings
        if chunker is None:
            if s.chunking.strategy == "semantic":
                chunker = SemanticChunker(
                    agent.embed_fn, threshold=s.chunking.semantic_threshold,
                    max_chars=s.chunking.max_semantic_chunk_chars)
            elif s.chunking.strategy == "fixed":
                chunker = FixedSizeChunker(s.chunking.chunk_size,
                                           s.chunking.chunk_overlap)
            else:
                chunker = RecursiveChunker(s.chunking.chunk_size,
                                           s.chunking.chunk_overlap)
        self.chunker = chunker
        self.wrangler = DataWrangler()
        self.processor = DocumentProcessor(self.wrangler)

    # ------------------------------------------------------------------ text

    def ingest_text(self, text: str, filename: str = "", title: str = "",
                    metadata: Optional[Dict] = None) -> Dict:
        a = self.agent
        t0 = time.time()
        wrangled = self.wrangler.process(text, metadata)
        clean = wrangled["content"]
        if not clean.strip():
            return {"ok": False, "error": "empty document"}
        doc_id = a.store.insert_document(
            a.settings.agent_id, filename=filename, title=title,
            metadata=wrangled["metadata"], quality=wrangled["quality_score"])
        chunks = self.chunker.chunk(clean, {"document_id": doc_id})
        texts = [c["content"] for c in chunks
                 if len(c["content"].strip())
                 >= self.agent.settings.chunking.min_chunk_chars] \
            or [clean[: a.settings.chunking.chunk_size]]
        emb = np.atleast_2d(a.embed_fn(texts))
        if not np.isfinite(emb).all():  # reference :354-364
            bad = ~np.isfinite(emb).all(axis=1)
            emb = emb[~bad]
            texts = [t for t, b in zip(texts, bad) if not b]
            if not texts:
                return {"ok": False, "error": "all embeddings invalid"}
        ids = a.dense.add(emb)
        a.lexical.add(texts)
        a.store.insert_chunks(a.settings.agent_id, doc_id,
                              [int(i) for i in ids], texts)
        triples = 0
        if a.settings.flags.enable_kg and a.kg_extractor is not None:
            triples = a.kg_extractor.extract_and_store(clean, doc_id)
        if a.cost_tracker is not None:
            a.cost_tracker.track_embedding(
                sum(len(t) // 4 for t in texts),
                device_seconds=time.time() - t0)
        a.maybe_upgrade_index()  # index policy check (index/policy.py)
        return {"ok": True, "document_id": doc_id, "chunks": len(texts),
                "kg_triples": triples,
                "quality": wrangled["quality_score"],
                "seconds": time.time() - t0}

    # ----------------------------------------------------------------- files

    def upload_file(self, path: str, metadata: Optional[Dict] = None) -> Dict:
        try:
            text = self.processor.extract_text(path)
        except Exception as exc:  # fail-open per file: one corrupt file
            # must not abort a directory upload (reference behavior)
            return {"ok": False, "error": str(exc), "path": path}
        return self.ingest_text(text, filename=os.path.basename(path),
                                title=os.path.splitext(
                                    os.path.basename(path))[0],
                                metadata=metadata)

    def upload_directory(self, directory: str,
                         extensions: Optional[tuple] = None) -> List[Dict]:
        exts = extensions or DocumentProcessor.SUPPORTED
        results = []
        for root, _dirs, files in os.walk(directory):
            for name in sorted(files):
                if os.path.splitext(name)[1].lower() in exts:
                    results.append(self.upload_file(os.path.join(root, name)))
        return results

    def list_documents(self) -> List[Dict]:
        return self.agent.store.list_documents(self.agent.settings.agent_id)
