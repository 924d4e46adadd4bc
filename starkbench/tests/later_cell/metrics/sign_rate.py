"""sign_rate: signatures completed per second of the window (the closed
loop's answers over its span, which ends with the answer that passed the
window's end)."""


def read(run):
    return run.rate()
