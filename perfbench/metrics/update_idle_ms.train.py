"""Idle device ms a train step in the gaps that began under the port's
``backward``, ``grad_norm`` or ``optimizer`` spans (the program pass,
``harness/program.py``): the update's host work and launches."""


def read(rec):
    prog = rec.get('program') or {}
    if 'idle_under_s' not in prog or not prog['steps']:
        return None
    under = prog['idle_under_s']
    return 1e3 * sum(under.get(k, 0.0) for k in (
        'backward', 'grad_norm', 'optimizer')) / prog['steps']
