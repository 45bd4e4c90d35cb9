"""Command-line apps of the port (counterpart of the JAX package's `apps/`)."""
