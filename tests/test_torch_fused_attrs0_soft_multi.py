"""test_torch_fused_attrs0.py's checks for a soft light 0 with hard
extras (SOFT_MULTI: a 4 deg cone and two directional lights, zero
stream), in a file of its own so that each file's interpret-mode
reference runs stay short under xdist."""

import pytest
import torch

from test_torch_fused_attrs0 import (attrs0_case, check_equals_attrs1,
                                     check_hits, check_outputs)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["soft_multi"])
def case(request):
    return request.param, attrs0_case(request.param)


def test_attrs0_hits_match_pallas(case):
    check_hits(case[1])


def test_attrs0_shadow_outputs_match_pallas(case):
    check_outputs(case[1], case[0])


def test_attrs0_equals_the_attrs1_walk(case):
    check_equals_attrs1(case[1])
