"""The yardstick of the benchmark of ``optimaltextures_tpu_torch``.

Everything here is frozen with the benchmark: the traffic generator, the
pass and width schedule, the FLOP model, the kernels' operation and byte
counts, the profiler reading and the plain reference that decides
``correct``. From the program the harness takes only the system under test
(``core.Synthesizer``), its launch counters and its kernel names.
Nothing here imports ``jax`` or the JAX package; ``reference.py`` imports
nothing of the port either.
"""
