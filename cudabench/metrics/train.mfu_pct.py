"""train.mfu_pct (%, host clock): the window's model FLOPs by the
benchmark's fixed formula (6 × parameters × tokens plus the SSD chunked
scan's products, ``formulas.mamba2_step_flops``) over the window's seconds,
over the bf16 dense peak (989.4 TFLOP/s)."""

from cudabench import peaks


def read(rec):
    if rec.window_s <= 0 or not rec.counters.get("model_flops"):
        return None
    return 100.0 * rec.counters["model_flops"] / rec.window_s / peaks.BF16_FLOPS
