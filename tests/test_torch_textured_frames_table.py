"""Textured frames through the shade table (``inkernel_attrs=False``,
fused and unfused: the table's uv lanes) and the textured rebuild (config
2: the payload columns carry the layer and uv) against tpurt's Renderer,
with the checks and tolerances of test_torch_textured_frames.py."""

import pytest
import torch

from test_torch_textured_frames import check_route, mesh  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("what", ["shade_table", "shade_table_unfused",
                                  "rebuild"])
def test_textured_frame_matches_jax_renderer(mesh, what):  # noqa: F811
    check_route(mesh, what)
