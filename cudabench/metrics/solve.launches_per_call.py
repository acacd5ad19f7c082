"""solve.launches_per_call (launches, program counter): the port's kernel
launches in the window, made by its wrappers and by CUDA graph replays
(``repro_torch.kernels.LAUNCH_COUNTERS``' totals), per call. The chunk
count the plan's heuristic picks sets it. None where nothing launched (the
CPU)."""


def read(rec):
    launches = rec.counters.get("launches", 0.0)
    if launches <= 0 or not rec.counters.get("calls"):
        return None
    return launches / rec.counters["calls"]
