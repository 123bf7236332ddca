"""Core pieces of the port (counterparts of the JAX package's ``core``)."""
