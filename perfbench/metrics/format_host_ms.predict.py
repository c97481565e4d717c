"""Host ms an image of ``format_detection`` in the traced run's timing
pass (the harness's clock around the call): the masks' resize on the
device, the binarising and their copy to the host."""


def read(rec):
    host = (rec.get('host_s') or {}).get('format') or []
    if not host:
        return None
    return 1e3 * sum(host) / len(host)
