"""Plain references of what the program computes, in torch and numpy alone.
Nothing here imports ``topotpu_torch``, ``topotpu`` or ``jax``: every input
is what the benchmark generated, and everything the program derives from it
(pools, neighbourhoods, trends, gains, pack scales) is worked out again."""
