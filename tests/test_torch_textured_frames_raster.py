"""The textured raster frame (the texture pass on the rasterizer's
(tri_id, position)) against tpurt's Renderer, with the checks and
tolerances of test_torch_textured_frames.py, at 64x48."""

import torch

from test_torch_textured_frames import check_route, mesh  # noqa: F401

torch.set_num_threads(1)


def test_textured_raster_frame_matches_jax_renderer(mesh):  # noqa: F811
    check_route(mesh, "raster")
