"""train.optimizer_ms (ms, CUDA events): the mean time a step of the traced
window spends in ``apply_gradients`` (AdamW's update and the in-place add),
from events recorded before and after the harness's call of it."""


def read(rec):
    return rec.counters.get("optimizer_ms")
