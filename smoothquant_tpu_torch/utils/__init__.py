"""Parameter conversion from the JAX package and H100 roofline accounting."""
