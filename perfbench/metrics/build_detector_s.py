"""Host seconds of the port's ``build_detector`` span in the traced run's
set-up: the detector's modules built and randomly initialised on the
device, before the seeded weights overwrite them."""


def read(rec):
    setup = rec.get('setup') or {}
    if not setup.get('build_detector_s'):
        return None
    return setup['build_detector_s']
