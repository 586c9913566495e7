"""Model configurations: copies of the JAX package's, as data."""
