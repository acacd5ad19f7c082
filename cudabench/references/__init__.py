"""The plain references the benchmark holds the port's answers against:
plain PyTorch and NumPy, importing nothing of the port and taking nothing
it has made."""
