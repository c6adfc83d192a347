"""expert_load_max.kl: ``expert_load_max.gen`` in the Kimi Linear cell:
the prefill's most-loaded held expert over the mean per held expert
(tokens routed to it, from the program's routing counter, which counts
the held experts alone), averaged over the MoE layers and the window's
calls."""

from portbench.harness import reader

read = reader("expert_load_max.gen")
