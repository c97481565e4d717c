"""Idle device ms a train step in the gaps that began while one of the
port's ``forward.<child>`` spans was open (the program pass,
``harness/program.py``): the host's work inside the detector's top-level
children."""


def read(rec):
    prog = rec.get('program') or {}
    if 'idle_under_s' not in prog or not prog['steps']:
        return None
    return 1e3 * sum(v for k, v in prog['idle_under_s'].items()
                     if k.startswith('forward.')) / prog['steps']
