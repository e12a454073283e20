"""Checks that need a GPU: the approximate-count kernel compiled for the
card against the plain scan at real widths, and against the oracle on a
slice.  They skip elsewhere; ``chip_smoke.py`` runs the same checks (and
the CLI end to end) in one process on the card."""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("k", chip_smoke.KERNEL_KS)
@pytest.mark.parametrize("maxerr", chip_smoke.KERNEL_MAXERRS)
def test_kernel_matches_scan_at_real_width(gpu, k, maxerr):
    chip_smoke.check_kernel(k, maxerr)


@pytest.mark.parametrize("k,maxerr", [(8, 2), (17, 3), (32, 0)])
def test_kernel_matches_oracle_slice(gpu, k, maxerr):
    chip_smoke.check_oracle_slice(k, maxerr)
