"""test_torch_traverse.py's parity checks at leaf 14, where slots 8..13 of
a leaf read the second attribute row ``at1``. A file of its own so that
each file's interpret-mode reference runs stay short under xdist."""

import pytest
import torch

from test_torch_traverse import (_check_attrs, _check_hits,
                                 _check_occlusion, _parity_case)

torch.set_num_threads(1)

KINDS = ["directional", "point"]


@pytest.fixture(scope="module")
def leaf14():
    return _parity_case(14)


@pytest.mark.parametrize("kind", KINDS)
def test_hits_match_pallas_leaf14(leaf14, kind):
    _check_hits(leaf14[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_attributes_match_pallas_leaf14(leaf14, kind):
    _check_attrs(leaf14[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_occlusion_matches_pallas_leaf14(leaf14, kind):
    _check_occlusion(leaf14[kind])
