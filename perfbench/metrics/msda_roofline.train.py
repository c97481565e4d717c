"""The MSDA kernels' share of their bound in a train step, in %:
``boxinstseg::msda_forward`` and ``msda_backward`` (``harness.kernels``)."""
from harness.kernels import roofline_percent


def read(rec):
    return roofline_percent(rec, ['boxinstseg::msda_forward',
                                  'boxinstseg::msda_backward'])
