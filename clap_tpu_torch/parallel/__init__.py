"""See the JAX package's counterpart subpackage (clap_tpu.parallel)."""
