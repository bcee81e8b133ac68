"""test_torch_closest.py's parity check at leaf 14, in a file of its own so
that each file's interpret-mode reference runs stay short under xdist."""

import pytest
import torch

from test_torch_closest import check_closest, closest_case

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def leaf14():
    return closest_case(14)


def test_closest_matches_pallas_leaf14(leaf14):
    check_closest(*leaf14)
