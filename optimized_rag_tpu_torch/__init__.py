"""PyTorch/CUDA port of ``optimized_rag_tpu``, beside the JAX package.

The module tree mirrors the JAX package's, and each module names the file it
is held against. The port imports neither JAX nor the JAX package. Entry
points (``DenseIndex``, ``EmbeddingService``, ``load_biencoder``) run on
``device="cuda"`` unless the caller passes ``device="cpu"``. Importing the
package turns TF32 off (see ``device.configure_numerics``).
"""

from optimized_rag_tpu_torch.device import configure_numerics, resolve_device

configure_numerics()

__version__ = "0.1.0"

__all__ = ["configure_numerics", "resolve_device"]
