"""Device resolution and weight carry-over from the JAX package's checkpoints."""
