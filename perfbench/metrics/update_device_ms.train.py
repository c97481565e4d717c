"""Device ms a train step launched inside the step call and outside
``model.loss``: the backward, the gradient norm and clip, the optimizer."""


def read(rec):
    n = rec['span_count'].get('step', 0)
    dev = rec['span_device_s'].get('step', 0.0)
    if not n or dev <= 0:
        return None
    return 1e3 * dev / n
