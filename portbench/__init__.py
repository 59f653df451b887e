"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``portbench/run.py`` runs one cell of ``BENCHMARK.json`` once and prints
one JSON line. Everything that belongs to one configuration, one cell or
one per-layer metric is a file of its own that the harness finds by the
name ``BENCHMARK.json`` gives it:

  * ``configs/<config>.json``     a model configuration as it is run;
  * ``workloads/<cell>.json``     a cell's traffic, its settings and the
                                  limits of its correctness check;
  * ``metrics/<metric>.py``       a per-layer metric's reader.

``lib/`` holds the yardstick (traffic generation, weights from the seed,
percentiles, FLOP and byte counts, the card's peaks, kernel classes, the
trace reduction and the comparison that decides ``correct``);
``reference/`` holds the plain float32 model and algorithm that the
comparison runs. Nothing here imports ``jax`` or the JAX package.
"""
