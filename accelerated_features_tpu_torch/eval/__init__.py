"""Relative-pose evaluation for the port (counterpart of the JAX package's
`eval/`)."""
