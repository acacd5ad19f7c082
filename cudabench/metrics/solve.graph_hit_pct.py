"""solve.graph_hit_pct (%, program counter): the share of the window's
calls served by a CUDA graph replay (calls in which the kernels' replayed
counts rose). None where nothing launched (the CPU)."""


def read(rec):
    if rec.counters.get("launches", 0.0) <= 0 or not rec.counters.get("calls"):
        return None
    return 100.0 * rec.counters["replayed_calls"] / rec.counters["calls"]
