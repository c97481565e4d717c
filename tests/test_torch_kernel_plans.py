"""How the LCM ring kernel (K3) and the CRF kernel (K7) cut a call into
blocks, on the CPU: the pure-Python plans that the wrappers hand to the
kernels (``ops.lcm.ring_plan``, ``ops.crf.crf_plan``), with the card's
cluster occupancy given as a function. A plan covers every row exactly
once, fits shared memory, keeps to the cluster size, and fills one wave
of clusters where it can; shapes beyond the kernels' limits get no plan.
The window attention pair's shared-memory plans (``ops.swin_attention.
smem_plan``): the backward (K6) takes every window the forward (K5) takes,
and ``plan_bytes`` equals the source's own ``plan_floats``, compiled here
with the host compiler from its ``<plan>`` block.
The kernels themselves run in ``tests/test_torch_cuda.py`` on the card.
"""
import os
import re
import shutil
import subprocess

import pytest

from boxinstseg_tpu_torch.ops import crf, lcm
from boxinstseg_tpu_torch.ops import swin_attention as swa
from boxinstseg_tpu_torch.ops._native import CSRC_DIR
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


# ------------------------------------------------ window attention (K5/K6)

@pytest.mark.parametrize('d', [32, 64])
def test_swin_backward_has_a_plan_for_every_window_the_forward_takes(d):
    for n in range(1, swa.MAX_N + 1):
        fwd, bwd = swa.smem_plan(n, d, False), swa.smem_plan(n, d, True)
        assert fwd is not None and bwd is not None, n
        assert max(fwd[1], bwd[1]) <= swa.SMEM_LIMIT
        if d == 32:
            # up to window 12 the plan of before: bias and dbias in shared
            # memory (N <= 64), dbias only (up to 144); past it the dbias
            # goes to the partial, every operand still staged
            want = swa.BIAS_SMEM if n <= 64 else 0 if n <= 144 \
                else swa.DBIAS_GLOBAL
            assert bwd[0] == want, n
        elif n > 144:
            assert bwd[0] == swa.DBIAS_GLOBAL | swa.G_GLOBAL, n


def test_swin_plans_refuse_the_same_shapes_in_both_directions():
    for d in (6, 8, 16, 32, 48, 64, 96, 128):
        for n in range(1, swa.MAX_N + 1):
            assert (swa.smem_plan(n, d, False) is None) \
                == (swa.smem_plan(n, d, True) is None), (n, d)
    assert swa.smem_plan(256, 128, True) is None
    assert swa.smem_plan(144, 128, True)[0] == \
        swa.DBIAS_GLOBAL | swa.G_GLOBAL


def _plan_block():
    """The source's ``<plan>`` block as plain C++."""
    with open(os.path.join(CSRC_DIR, 'swin_attention.cu')) as f:
        src = f.read()
    block = re.search(r'// <plan>.*?// </plan>', src, re.S)
    assert block, 'csrc/swin_attention.cu lost its <plan> block'
    return ('#include <cstddef>\n#include <cstdio>\n'
            '#define __host__\n#define __device__\n' + block.group(0))


def test_swin_plan_bytes_equal_the_sources_plan_floats(tmp_path):
    cxx = shutil.which('g++') or shutil.which('c++')
    assert cxx, 'a host C++ compiler is needed to read the source\'s sizes'
    ds, plans = (6, 8, 16, 32, 48, 64, 96, 128), range(8)
    main = ('int main() {\n'
            f'  const int ds[] = {{{", ".join(map(str, ds))}}};\n'
            '  for (int n = 1; n <= MAX_N; ++n) for (int d : ds)\n'
            '    for (int b = 0; b < 2; ++b) for (int p = 0; p < 8; ++p)\n'
            '      printf("%zu\\n", 4 * plan_floats(8 * key_tiles(n), d, '
            'b, p));\n}\n')
    source = tmp_path / 'plan.cc'
    source.write_text(_plan_block() + f'\nconstexpr int MAX_N = '
                      f'{swa.MAX_N};\n' + main)
    exe = tmp_path / 'plan'
    subprocess.run([cxx, '-std=c++17', '-o', str(exe), str(source)],
                   check=True, capture_output=True, text=True)
    got = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout.split()
    want = [swa.plan_bytes(n, d, bool(b), p)
            for n in range(1, swa.MAX_N + 1) for d in ds for b in (0, 1)
            for p in plans]
    assert list(map(int, got)) == want


def test_every_backward_plan_has_its_kernel_instance():
    """Each (key tiles, DBIAS_GLOBAL, G_GLOBAL) the wrapper's plans give
    is among the backward's template instances (``SWIN_BWD`` in the
    source); the shapes no plan takes instantiate nothing."""
    with open(os.path.join(CSRC_DIR, 'swin_attention.cu')) as f:
        src = f.read()
    made = {(int(kt), dg == 'true', gg == 'true') for kt, dg, gg in
            re.findall(r'SWIN_BWD\((\d+), (true|false), (true|false)\)',
                       src)}
    used = set()
    for n in range(1, swa.MAX_N + 1):
        for d in range(1, swa.MAX_D + 1):
            plan = swa.smem_plan(n, d, True)
            if plan is not None:
                used.add((swa.key_tiles(n), bool(plan[0] & swa.DBIAS_GLOBAL),
                          bool(plan[0] & swa.G_GLOBAL)))
    assert used == made
