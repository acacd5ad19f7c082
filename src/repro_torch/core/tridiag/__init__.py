"""Tridiagonal solvers of the port: Thomas, the partition method, batch and
ragged fusion, plans and the session front door (see :mod:`.api`)."""
