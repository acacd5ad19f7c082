"""train.peak_gb (GB, allocator counter): ``torch.cuda.max_memory_allocated``
over the window, after ``reset_peak_memory_stats`` at its start."""


def read(rec):
    peak = rec.counters.get("window_peak_bytes")
    return None if not peak else peak / 1e9
