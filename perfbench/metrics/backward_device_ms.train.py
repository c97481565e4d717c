"""Device ms a train step launched while the port's ``backward`` span was
open (the program pass, ``harness/program.py``): the autograd backward
and the zeroing of the old gradients."""


def read(rec):
    prog = rec.get('program') or {}
    if 'device_under_s' not in prog or not prog['steps']:
        return None
    return 1e3 * prog['device_under_s'].get('backward', 0.0) / prog['steps']
