"""arp_tpu_torch.ops.k2_ablate: the pure-Python part, the means taken from a launch's time notes."""

import numpy as np
import pytest

from arp_tpu_torch.ops import k2_ablate


def make_notes(tiles_by_block, products_ns, epilogue_ns, pause_ns, t0=10_000):
    notes = np.zeros(k2_ablate.TRACE_SHAPE, dtype=np.uint64)
    for block, tiles in enumerate(tiles_by_block):
        for wg in range(2):
            t = t0 + 7 * block + wg
            for tile in range(tiles):
                notes[block, wg, tile] = (t, t + products_ns, t + products_ns + epilogue_ns)
                t += products_ns + epilogue_ns + pause_ns
    return notes


@pytest.mark.parametrize("tiles_by_block,products_ns,epilogue_ns,pause_ns", [
    ([3, 3, 2], 3600, 2000, 100),
    ([1], 30000, 2500, 0),
    ([9] * 132, 3700, 4200, 80),
])
def test_phases_are_the_means_of_the_notes(tiles_by_block, products_ns, epilogue_ns, pause_ns):
    got = k2_ablate.phases(make_notes(tiles_by_block, products_ns, epilogue_ns, pause_ns))
    assert got["tiles_of_block_0"] == tiles_by_block[0]
    assert got["products_us"] == pytest.approx(products_ns / 1e3)
    assert got["epilogue_us"] == pytest.approx(epilogue_ns / 1e3)
    assert got["pause_us"] == pytest.approx(pause_ns / 1e3 if max(tiles_by_block) > 1 else 0.0)
    assert got["products_us_block_0"] == [products_ns / 1e3] * tiles_by_block[0]
    n = tiles_by_block[0]
    assert got["kernel_us_block_0"] == pytest.approx((n * (products_ns + epilogue_ns) + (n - 1) * pause_ns) / 1e3)


def test_variants_sum_the_flags_the_kernel_reads():
    assert k2_ablate.VARIANTS["whole"] == 0
    assert all(0 <= v < 16 for v in k2_ablate.VARIANTS.values())
    assert k2_ablate.VARIANTS["loads_only"] == 1 | 2 | 4
