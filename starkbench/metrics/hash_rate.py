"""hash_rate: digests per second, every batch dispatched in the window over
the time to the synchronise that ends it."""


def read(run):
    return run.rate()
