"""decode_step_ms.kl: ``decode_step_ms.gen`` in the Kimi Linear cell:
device ms of one decode step, the window's decode device time (the
program's ``generate.decode`` spans) over its steps."""

from portbench.harness import reader

read = reader("decode_step_ms.gen")
