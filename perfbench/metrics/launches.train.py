"""Kernels a train step on the device in the program pass
(``harness/program.py``): every kernel, copies and sets left out."""


def read(rec):
    prog = rec.get('program') or {}
    if 'kernels' not in prog or not prog['steps']:
        return None
    return prog['kernels'] / prog['steps']
