"""LLM serving of the port (counterparts of the JAX package's ``llm``)."""
