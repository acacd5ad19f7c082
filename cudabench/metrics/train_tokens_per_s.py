"""train_tokens_per_s (tokens/s, host clock): the tokens of every train
step completed in the window, over the window's seconds (the window ends
when the card has finished its last step)."""


def read(rec):
    if not rec.calls or rec.window_s <= 0:
        return None
    return sum(u for _, _, u in rec.calls) / rec.window_s
