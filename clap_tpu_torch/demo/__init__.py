"""See the JAX package's counterpart demos (demo/)."""
