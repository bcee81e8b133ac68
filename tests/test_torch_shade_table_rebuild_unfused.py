"""test_torch_shade_table_rebuild.py's comparison for the unfused rebuilt
frame (the plain closest hit on the rebuilt tree, the shade table's row
gather, then the any-hit pass), in a file of its own so that each file's
interpret-mode reference runs stay short under xdist."""

import torch

from test_torch_app import _assert_close_frames
from test_torch_shade_table_rebuild import rebuild_frames

torch.set_num_threads(1)


def test_rebuild_unfused_frame_matches_jax_renderer():
    jimg, out, r = rebuild_frames(fused=False)
    assert r.route == "unfused" and r.attr_tables is None
    _assert_close_frames(jimg, out["image"].numpy())
    assert out["walk_counts"].tolist() == [0, 0]
