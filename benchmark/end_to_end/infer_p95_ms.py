"""``infer_p95_ms``: the 95th percentile of the latency of every request
of the window, from the call to the output complete (on the card,
synchronized, or copied to the host)."""

from harness.window import percentile


def read(m):
    return percentile(m.window.latencies_s(), 95) * 1e3
