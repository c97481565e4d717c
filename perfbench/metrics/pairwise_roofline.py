"""K1 and K2's share of their bound, in %: the summed bound time of
every ``boxinstseg::pairwise_forward`` / ``pairwise_backward`` call in the
traced window over their device time (``harness.kernels``)."""
from harness.kernels import roofline_percent


def read(rec):
    return roofline_percent(rec, ['boxinstseg::pairwise_forward',
                                  'boxinstseg::pairwise_backward'])
