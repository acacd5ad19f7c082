"""solve.copy_gbps (GB/s, device trace): the bytes the verbs must move (four
operands in, the solution out, from the shapes) over the device time of
the window's host-device copies."""

from cudabench import formulas


def read(rec):
    tl = rec.timeline
    if tl is None:
        return None
    copy_s = tl.time_of(kinds=("gpu_memcpy",))
    if copy_s <= 0:
        return None
    nbytes = formulas.solve_bytes(rec.counters["unknowns"], rec.counters["itemsize"])
    return nbytes / copy_s / 1e9
