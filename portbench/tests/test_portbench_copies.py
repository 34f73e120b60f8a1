"""The benchmark's frozen copy of the roofline arithmetic gives what
chip_smoke.py's original gives, number for number."""

import pytest

from portbench.reference import roofline


@pytest.mark.parametrize("nb,n,m,iters", [(512, 64, 96, 40000),
                                          (128, 352, 528, 30), (1, 8, 8, 0)])
def test_roofline_is_chip_smokes(nb, n, m, iters):
    import chip_smoke

    assert roofline.k1_bound(nb, n, m, iters) == \
        chip_smoke.k1_bound(nb, n, m, iters)
    assert roofline.bound(1e9, 1e8, roofline.F64_PEAK) == \
        chip_smoke.bound(1e9, 1e8, chip_smoke.F64_PEAK)
    assert (roofline.F32_PEAK, roofline.F64_PEAK, roofline.HBM_RATE) == \
        (chip_smoke.F32_PEAK, chip_smoke.F64_PEAK, chip_smoke.HBM_RATE)
