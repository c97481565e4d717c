"""Host syncs a train step: the port's ``host_sync`` count, one for each
synchronizing CUDA call that the sync debug mode reported in the program
pass (``harness/program.py``)."""


def read(rec):
    prog = rec.get('program') or {}
    if not prog.get('syncs_watched') or not prog['steps']:
        return None
    return prog['counts'].get('host_sync', 0) / prog['steps']
