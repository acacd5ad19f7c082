"""setup_s (s, host clock): from the harness's first line to the first
timed call: imports, the kernels' build or load, inputs and weights, and
the warm-up of the cell's shapes (CUDA graph captures included)."""


def read(rec):
    return rec.setup_s
