"""Idle device ms a train step in the gaps that began under the port's
``loss`` span or its phases (``loss.targets`` ... ``loss.levelset``), the
forwards left out (the program pass, ``harness/program.py``): the loss's
host work."""


def read(rec):
    prog = rec.get('program') or {}
    if 'idle_under_s' not in prog or not prog['steps']:
        return None
    return 1e3 * prog['idle_under_s'].get('loss', 0.0) / prog['steps']
