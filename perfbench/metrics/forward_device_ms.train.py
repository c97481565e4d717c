"""Device ms a train step launched inside the detector's top-level
children's forwards (``pb:forward.<child>``: backbone, neck, heads)."""


def read(rec):
    n = rec['span_count'].get('step', 0)
    dev = sum(v for k, v in rec['span_device_s'].items()
              if k.startswith('forward.'))
    if not n or dev <= 0:
        return None
    return 1e3 * dev / n
