"""The yardstick: inputs from the seed, the trace's reduction, the peaks and
the result line.  Nothing here imports ``jax`` or the JAX package."""
