"""The port's textured (attrs=2) sampling walks, SOFT, PSOFT and
SOFT_MULTI, against the JAX package's interpret-mode kernels with
``textured=True`` and the zero stream: the scene, cases and tolerances of
test_torch_textured_kernels.py, whose checks run here on these modes."""

import pytest
import torch

from test_torch_textured_kernels import _jax, _port, scene  # noqa: F401
from test_torch_textured_kernels import (
    test_hits_and_counters, test_shadow_outputs,  # noqa: F401
    test_textured_attributes, test_textured_walk_extends_the_untextured_one)

torch.set_num_threads(1)

MODES = ("closest_soft_shadow", "closest_point_soft_shadow",
         "closest_soft_multi_shadow")


@pytest.fixture(scope="module", params=MODES)
def case(request, scene):  # noqa: F811
    mode = request.param
    return mode, _jax(mode, scene), _port(mode, scene), \
        _port(mode, scene, textured=False)
