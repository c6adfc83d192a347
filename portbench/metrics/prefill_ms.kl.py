"""prefill_ms.kl: ``prefill_ms.gen`` in the Kimi Linear cell: mean device
ms of a call's prefill (the program's ``generate.prefill`` span: a CUDA
event pair read after the call)."""

from portbench.harness import reader

read = reader("prefill_ms.gen")
