"""One driver a kind of system: ``run(cell, seed, seconds, trace, device,
variant, t0) -> harness.Record`` sets the program up from the cell's
configuration, drives the window with the cell's traffic, and compares what
the window produced with the configuration's plain reference."""
