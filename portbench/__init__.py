"""The benchmark of the PyTorch and CUDA port, ``optimized_rag_tpu_torch``.

See ``portbench/README.md``."""
