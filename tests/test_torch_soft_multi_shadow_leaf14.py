"""test_torch_soft_multi_shadow.py's disk case: a point light 0 sampled
on its disk (radius 0.4) with one hard directional extra, leaf 14 (slots
8..13 of a leaf read ``at1``). A file of its own so that each file's
interpret-mode reference runs stay short under xdist."""

import pytest
import torch

from test_torch_multi_shadow import check_bit
from test_torch_soft_multi_shadow import soft_multi_case
from test_torch_soft_shadow import check_counts
from test_torch_traverse import _check_attrs, _check_hits

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def disk14():
    return soft_multi_case(14, disk=True)


def test_soft_multi_hits_match_pallas_disk_leaf14(disk14):
    _check_hits(disk14)


def test_soft_multi_attributes_match_pallas_disk_leaf14(disk14):
    _check_attrs(disk14)


def test_soft_multi_counts_match_pallas_disk_leaf14(disk14):
    jch, (jcnt, _), _, (tcnt, _), _ = disk14
    check_counts(jch, jcnt, tcnt)


def test_soft_multi_mask_bit_matches_pallas_disk_leaf14(disk14):
    jch, (_, jmask), _, (_, tmask), _ = disk14
    check_bit(jch, jmask, tmask, 0)
    assert not ((tmask >> 1) != 0).any()
