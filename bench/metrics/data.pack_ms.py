"""Mean host milliseconds a batch in the program's ``loader.pack`` spans
(``core/loader.py``: decode the records and pack the slot buffer) during
the window. Moves ``train_tokens_per_s`` once packing holds the card back."""


def read(ctx):
    packs = [ev[3] for ev in ctx.spans if ev[0] == "loader.pack" and ev[3] >= 0]
    return 1e3 * sum(packs) / len(packs) if packs else None
