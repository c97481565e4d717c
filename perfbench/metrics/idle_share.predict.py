"""The share of the traced run's timing pass in which no device activity
ran, in %: 1 - the union of the kernel, copy and set intervals / the
window (the profiler recording the device's activity alone, so that its
host work does not widen the gaps)."""


def read(rec):
    if rec['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - rec['busy_s'] / rec['window_s'])
