"""Host ms a train step in the traced run's timing pass: the harness's
clock around the batch's copy (``batch_to_device``) and the step call,
the profiler recording the device's activity alone."""


def read(rec):
    host = (rec.get('host_s') or {}).get('step') or []
    if not host:
        return None
    return 1e3 * sum(host) / len(host)
