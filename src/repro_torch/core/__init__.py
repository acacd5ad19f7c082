"""Solver core of the port: tridiagonal numerics, stream models, autotune."""
