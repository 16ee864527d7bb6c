"""Device (JAX/XLA) compute engines for sz_tpu."""
