"""Host services: document ingestion pipeline.

Held against ``optimized_rag_tpu/services/__init__.py``, a copy whose
imports name the port's modules.
"""

from optimized_rag_tpu_torch.services.ingest import DocumentIngestor
