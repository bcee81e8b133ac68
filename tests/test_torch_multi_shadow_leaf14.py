"""test_torch_multi_shadow.py's parity checks at leaf 14, where slots
8..13 of a leaf read the second attribute row ``at1``. A file of its own
so that each file's interpret-mode reference runs stay short under
xdist."""

import pytest
import torch

from test_torch_multi_shadow import check_bit, multi_case
from test_torch_traverse import _check_attrs, _check_hits

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def leaf14():
    return multi_case(14)


def test_multi_hits_match_pallas_leaf14(leaf14):
    _check_hits(leaf14)


def test_multi_attributes_match_pallas_leaf14(leaf14):
    _check_attrs(leaf14)


@pytest.mark.parametrize("bit", [0, 1, 2])
def test_multi_mask_bits_match_pallas_leaf14(leaf14, bit):
    jch, jmask, _, tmask, _ = leaf14
    check_bit(jch, jmask, tmask, bit)
