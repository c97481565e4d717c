"""p95 over the traced run's timing pass of the host time from an image's
submission to its formatted result (the profiler recording the device's
activity alone). The untraced window's p95 spread 11-18% between runs
of one call (host-paced at batch 1), too wide for a bound, so the tail
is read here, beside the rate it moves."""
from harness.train import p_quantile


def read(rec):
    lat = rec.get('latency_s') or []
    if not lat:
        return None
    return 1e3 * p_quantile(lat, 0.95)
