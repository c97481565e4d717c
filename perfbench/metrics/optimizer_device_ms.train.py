"""Device ms a train step launched under the port's ``grad_norm`` (the
zero-fill, the gradients' mean over ranks, the global norm and the clip)
and ``optimizer`` (the LR set and ``optimizer.step``) spans (the program
pass, ``harness/program.py``)."""


def read(rec):
    prog = rec.get('program') or {}
    if 'device_under_s' not in prog or not prog['steps']:
        return None
    under = prog['device_under_s']
    return 1e3 * (under.get('grad_norm', 0.0)
                  + under.get('optimizer', 0.0)) / prog['steps']
