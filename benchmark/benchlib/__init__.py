"""The harness of the benchmark: files found by name, the run record, the
profiler window and its reading, and the pieces frozen from the program's
drivers (the world generator, the one-chunk mosaic sink, the timed engine).
Nothing here imports ``jax`` or the JAX package ``topotpu``."""
