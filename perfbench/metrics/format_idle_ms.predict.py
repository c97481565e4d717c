"""Idle device ms an image in the gaps that began under the port's
``format`` span (``format_detection``: the masks' resize on the device and
the copies out; the program pass, ``harness/program.py``)."""


def read(rec):
    prog = rec.get('program') or {}
    if 'idle_under_s' not in prog or not prog['steps']:
        return None
    return 1e3 * prog['idle_under_s'].get('format', 0.0) / prog['steps']
