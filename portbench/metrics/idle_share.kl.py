"""idle_share.kl: ``idle_share.gen`` in the Kimi Linear cell: share of
the window with no kernel, copy or fill on the device, from the raw
trace, in %."""

from portbench.harness import reader

read = reader("idle_share.gen")
