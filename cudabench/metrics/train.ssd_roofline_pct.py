"""train.ssd_roofline_pct (%, device trace): the least time of the window's
SSD Stage 1 forward and backward launches (``formulas.ssd_bound_s``: per
launch the larger of its operations over the TF32 peak and its bytes over
the HBM bandwidth) over those kernels' device time in the trace."""

#: The kernels of csrc/ssd_stage1.cu and csrc/ssd_stage1_bwd.cu.
KERNELS = ("ssd_scores_kernel", "ssd_y_kernel", "ssd_state_kernel",
           "bwd_scores_kernel", "bwd_mid_kernel", "bwd_out_kernel")


def read(rec):
    tl = rec.timeline
    if tl is None or not rec.counters.get("ssd_bound_s"):
        return None
    ssd_s = tl.time_of(kinds=("kernel",), names=KERNELS)
    if ssd_s <= 0:
        return None
    return 100.0 * rec.counters["ssd_bound_s"] / ssd_s
