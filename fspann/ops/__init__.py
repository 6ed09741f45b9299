"""Device-side compute primitives (JAX/XLA)."""
