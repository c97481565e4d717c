"""Device ms a train step launched inside ``model.loss`` and outside the
forward spans: targets, the loss heads, the losses and their kernels."""


def read(rec):
    n = rec['span_count'].get('step', 0)
    dev = rec['span_device_s'].get('loss', 0.0)
    if not n or dev <= 0:
        return None
    return 1e3 * dev / n
