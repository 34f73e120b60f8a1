"""Dense linear algebra of the port: kernel K2 (batched Cholesky)."""
