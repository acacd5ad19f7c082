"""solve.kernel_roofline_pct (%, device trace): the least device time of the
window's solves, their bytes (each operand read once, the solution written
once) over the HBM bandwidth, over the summed device time of every kernel
in the window (the stages, the reduced solve, the layout's gathers)."""

from cudabench import formulas, peaks


def read(rec):
    tl = rec.timeline
    if tl is None:
        return None
    kernel_s = tl.time_of(kinds=("kernel",))
    if kernel_s <= 0:
        return None
    nbytes = formulas.solve_bytes(rec.counters["unknowns"], rec.counters["itemsize"])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / kernel_s
