"""solve_unknowns_per_s (unknowns/s, host clock): every unknown of the
calls completed in the window, over the window's seconds."""


def read(rec):
    if not rec.calls or rec.window_s <= 0:
        return None
    return sum(u for _, _, u in rec.calls) / rec.window_s
