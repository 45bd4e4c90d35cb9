"""Experiments of the port, off every default path (counterpart of the
JAX package's `experiments/`)."""
