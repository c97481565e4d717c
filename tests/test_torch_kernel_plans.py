"""How the LCM ring kernel (K3) and the CRF kernel (K7) cut a call into
blocks, on the CPU: the pure-Python plans that the wrappers hand to the
kernels (``ops.lcm.ring_plan``, ``ops.crf.crf_plan``), with the card's
cluster occupancy given as a function. A plan covers every row exactly
once, fits shared memory, keeps to the cluster size, and fills one wave
of clusters where it can; shapes beyond the kernels' limits get no plan.
The kernels themselves run in ``tests/test_torch_cuda.py`` on the card.
"""
import pytest

from boxinstseg_tpu_torch.ops import crf, lcm
from boxinstseg_tpu_torch.ops.color import neighbor_offsets

# max active clusters by cluster size on an H100 SXM at the kernels'
# shared memory (cudaOccupancyMaxActiveClusters, the card's answer)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 16, 8: 15}


def ring(d):
    return neighbor_offsets(3, d)


@pytest.mark.parametrize('d', [1, 2, 3])
def test_ring_dilation_takes_the_module_ring_only(d):
    assert lcm.ring_dilation(ring(d)) == d
    assert lcm.ring_dilation(ring(d)[::-1]) is None
    assert lcm.ring_dilation(ring(1) + ring(2)) is None
    assert lcm.ring_dilation(ring(d)[:7]) is None


def check_ring(plan, b, c, h, w, transpose):
    d, g, rows, bands = plan['d'], plan['G'], plan['band_rows'], \
        plan['bands']
    assert (bands - 1) * rows < h <= bands * rows
    assert bands <= lcm.RING_MAX_BANDS and (bands == 1 or rows >= d)
    assert rows * w <= lcm.RING_THREADS * lcm.RING_PPT
    plane = (rows + 2 * d) * w * 4
    assert (2 * g + (8 if transpose else 0)) * plane \
        <= lcm.MAX_SHARED_BYTES
    assert 1 <= g <= c


@pytest.mark.parametrize('transpose', [False, True])
@pytest.mark.parametrize('shape', [(2, 80, 96, 96), (2, 83, 96, 96),
                                   (1, 3, 130, 100), (1, 2, 208, 96),
                                   (1, 3, 37, 53), (2, 5, 3, 5)])
def test_ring_plan_covers_the_map_within_the_limits(shape, transpose):
    plan = lcm.ring_plan(*shape, ring(2), transpose,
                         lambda d, g, rows, bands: H100_CLUSTERS[bands])
    check_ring(plan, *shape, transpose)


def test_ring_plan_fills_one_wave_at_the_box2mask_shape():
    # 30 clusters of 4 bands run at once: 14 groups of 6 channels an image
    plan = lcm.ring_plan(2, 80, 96, 96, ring(2), True,
                         lambda d, g, rows, bands: H100_CLUSTERS[bands])
    assert plan == dict(d=2, G=6, band_rows=24, bands=4)
    assert 2 * -(-80 // plan['G']) <= H100_CLUSTERS[4]


@pytest.mark.parametrize('shape, offsets', [
    ((1, 2, 209, 96), ring(2)),          # nine bands of 96 columns
    ((1, 1, 8, 2561), ring(2)),          # a row over a band's pixels
    ((1, 3, 37, 53), ring(1) + ring(2)),
    ((1, 3, 37, 53), ring(2)[::-1])])
def test_ring_plan_leaves_the_rest_to_the_generic_kernel(shape, offsets):
    assert lcm.ring_plan(*shape, offsets, False, lambda *a: 30) is None


@pytest.mark.parametrize('shape', [(2, 128, 200, 336), (2, 128, 336, 200),
                                   (1, 5, 37, 53), (3, 5, 37, 53),
                                   (2, 13, 37, 53), (1, 1, 1, 4)])
def test_crf_plan_covers_the_map_within_the_limits(shape):
    b, k, h, w = shape
    plan = crf.crf_plan(b, k, h, w, lambda rows, bands: H100_CLUSTERS[bands])
    rows, bands = plan['band_rows'], plan['bands']
    assert (bands - 1) * rows < h <= bands * rows
    assert bands <= crf.CRF_MAX_BANDS
    assert crf.band_bytes(rows, w) <= crf.MAX_SHARED_BYTES


def test_crf_plan_takes_the_most_bands_that_make_one_wave():
    # 32 plane groups: 3 bands (39 clusters at once) is the most that fit
    # one wave; with room for only 8 clusters, the fewest bands that fit
    plan = crf.crf_plan(2, 128, 200, 336,
                        lambda rows, bands: H100_CLUSTERS[bands])
    assert plan == dict(band_rows=67, bands=3)
    plan = crf.crf_plan(2, 128, 200, 336, lambda rows, bands: 8)
    assert plan == dict(band_rows=100, bands=2)


def test_crf_plan_refuses_more_than_eight_bands():
    assert crf.crf_plan(1, 1, 1200, 1200, lambda *a: 132) is None
