"""Dense linear algebra of the port: kernel K2 (batched Cholesky) and
the vector norms of linalg/dense.py."""
