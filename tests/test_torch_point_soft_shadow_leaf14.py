"""test_torch_soft_shadow.py's point-light (disk) parity checks at leaf
14, where slots 8..13 of a leaf read the second attribute row ``at1``. A
file of its own so that each file's interpret-mode reference runs stay
short under xdist."""

import pytest
import torch

from test_torch_soft_shadow import check_counts, soft_cases
from test_torch_traverse import _check_attrs, _check_hits

torch.set_num_threads(1)


KINDS = ["psoft"]


@pytest.fixture(scope="module")
def leaf14():
    return soft_cases(14, KINDS)


@pytest.mark.parametrize("kind", KINDS)
def test_point_soft_hits_match_pallas_leaf14(leaf14, kind):
    _check_hits(leaf14[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_point_soft_attributes_match_pallas_leaf14(leaf14, kind):
    _check_attrs(leaf14[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_point_soft_counts_match_pallas_leaf14(leaf14, kind):
    jch, jcnt, _, tcnt, _ = leaf14[kind]
    check_counts(jch, jcnt, tcnt)
