"""The dense causal LM: layers, model assembly, and weights from JAX."""
