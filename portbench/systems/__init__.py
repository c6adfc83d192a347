"""Kinds of system the benchmark builds and checks, one module a kind.

A configuration file (``configs/<config>.json``) names its kind under the
key ``"system"``, and the harness and the control import
``portbench.systems.<kind>``. A kind module provides:

* ``System(cfg, seed, device, spans)``: the system under test, built from
  the configuration and the seed, with ``phases`` (seconds of each step of
  its set-up, by name) and ``close()`` (stops what it started and frees the
  program's device state). It may have ``server``, anything with
  ``get_stats()``, which the harness reads at the window's edges into
  ``run.marks``. A metric reader finds whatever else the system keeps on
  ``run`` (``run.<name>`` is the system's where the run has no such
  attribute). Host spans go to ``spans.add(layer, span)``, each span
  starting (t0, t1) on ``time.perf_counter``, under layer names of the
  kind's own; the trace's idle gaps are named after them.
* ``compare(cfg, system, answers, seed, device) -> dict[str, float]``: the
  numbers that decide ``correct``, by name, each held to its limit in
  ``limits/<cell>.json``. The harness calls it once the window has closed
  and ``close()`` has run, with the answers of the traffic generator's
  ``answers()``.
* ``control_answers(c, seed, device, n_answers) -> (system_inputs,
  answers)``: for ``control.py``, the control's answers (the plain
  reference one step below the precision the configuration states, in the
  program's place) to the first ``n_answers`` that a run of cell ``c``
  would ask, and what ``compare`` reads of a system to judge them.

The only thing the harness itself reads from the answers is ``missing``,
the requests of the window that got no answer. The traffic generators that
a kind's cells name (``traffic/<generator>.py``) drive its system. A kind's
operation and byte counts go in a file of their own beside it, taking
``PEAK``, ``PEAK_BW`` and ``bound_ms`` from ``work.py``.
"""
