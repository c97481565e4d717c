"""Idle device ms an image in the gaps that began under the port's
``predict`` span (``predict_batch``: the copy in, the forwards and the
post-processing; the program pass, ``harness/program.py``)."""


def read(rec):
    prog = rec.get('program') or {}
    if 'idle_under_s' not in prog or not prog['steps']:
        return None
    return 1e3 * prog['idle_under_s'].get('predict', 0.0) / prog['steps']
