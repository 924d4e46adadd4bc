"""sign_p95_ms: the 95th percentile of every request's latency in the
window, from the call to the answer's bytes in hand."""

from starkbench import yardstick


def read(run):
    if not run.latencies:
        return None
    return yardstick.percentile(run.latencies, 95) * 1e3
