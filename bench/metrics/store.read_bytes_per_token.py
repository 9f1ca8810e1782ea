"""Bytes the chunk store's backend read in the window
(``BackendStats.bytes_read``, ``core/storage``) over the loss-bearing
tokens trained: 4 bytes a token times the records' untrained tails and
every chunk read again within an epoch, a count of the storage work a
trained token costs."""


def read(ctx):
    if not ctx.loss_tokens:
        return None
    return ctx.win["bytes_read"] / ctx.loss_tokens
