"""The MSDA forward kernel's share of its bound in predict, in %
(``harness.kernels``)."""
from harness.kernels import roofline_percent


def read(rec):
    return roofline_percent(rec, ['boxinstseg::msda_forward'])
