"""Solver loops of the port: kernel K1 (the fused P-ALM iteration) and
the nonconvex gamma pins (LOBPCG)."""
