"""test_torch_closest_attrs.py's parity checks at leaf 14, where slots
8..13 of a leaf read the second attribute row ``at1``. A file of its own so
that each file's interpret-mode reference runs stay short under xdist."""

import pytest
import torch

from test_torch_closest_attrs import attrs_case, check_equals_fused
from test_torch_traverse import _check_attrs, _check_hits

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def leaf14():
    return attrs_case(14)


def test_closest_attrs_hits_match_pallas_leaf14(leaf14):
    _check_hits(leaf14[0])


def test_closest_attrs_attributes_match_pallas_leaf14(leaf14):
    _check_attrs(leaf14[0])


def test_closest_attrs_equal_the_fused_phase1_leaf14(leaf14):
    check_equals_fused(leaf14)
