"""The frame's host constants in one block on the device.

Every value a frame takes from the host is packed, each frame, into one
float32 buffer (page-locked where the frame runs on the card) and reaches
the device with ONE non-blocking copy into a block its owner keeps: the
camera, each light, the shadow bias, the background and the frame seed.
The frame's code reads views of that block, whose addresses never change,
so a CUDA graph captured on one frame reads the next frame's values
(``graphs.py``). Layout, in float32 words:

- 0: camera position(3), target(3), up(3), fov_y, zfar;
- 11: background(3);
- 14: shadow bias;
- 15: the frame seed's 32 bits (``app.frame_seed``), read as int32;
- 16 + 12 i: light i's direction(3), position(3), color(3), intensity,
  radius and cone_cos (cos of its angular radius as numpy rounds it,
  ``passes/shadow.cone_cos``);
- 16 + 12 n (n lights): the raster binning's clip transform, the camera
  basis and the projection's four scales (``raster.setup.clip_constants``,
  float32 values computed on the host), written only for a frame that
  rasterizes its G-buffer (``gbuffer="raster"``) and only when the camera
  or the frame size changed; its position is word 0.

Each word is the float32 rounding that a copy of the host value onto the
device makes (``spans.to_device``), so the device's arithmetic is that of
a frame that copies each value itself; the clip words are the values
the binning would compute from the host camera. The scene box and the
accel's tables are device data already, and the order point of the
near-first child ordering is the camera position.

The buffer is rewritten only once the previous copy out of it has
completed; a frame ends in a host read that follows its copy, so that
wait finds it done.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import numpy as np
import torch

from .raster.setup import CLIP_WORDS, clip_constants
from .types import Camera, Light

BACKGROUND = 11
BIAS = 14
SEED = 15
LIGHTS = 16
LIGHT_WORDS = 12


@dataclasses.dataclass
class BlockCamera(Camera):
    """A camera whose fields are views of the block (``znear`` None), with
    ``clip``, the view f32[13] of the clip words that the raster binning's
    transform reads (``raster.setup.clip_transform``)."""

    clip: Any = None


@dataclasses.dataclass
class BlockLight(Light):
    """A light whose fields are views of the block (``angular_radius``
    None), with ``cone_cos``, the view the soft samplers read in its
    place."""

    cone_cos: Any = None


@dataclasses.dataclass
class FrameViews:
    """The views a frame reads: ``camera``, ``lights``, ``bias`` f32[],
    ``background`` f32[3] and ``seed``, i32[1] holding the frame seed's
    bits (the walks' ``seed``); ``block``, the block up to its clip
    words, which the resolve kernel reads in this layout
    (``kernels/resolve.py``)."""

    camera: BlockCamera
    lights: List[BlockLight]
    bias: torch.Tensor
    background: torch.Tensor
    seed: torch.Tensor
    block: torch.Tensor


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class FrameBlock:
    """The block of ``n_lights`` lights' frames on ``device`` and its host
    buffer; ``write`` fills both and returns the views."""

    def __init__(self, n_lights: int, device):
        self.device = torch.device(device)
        self.n_lights = n_lights
        self._clip_at = n = LIGHTS + LIGHT_WORDS * n_lights
        cuda = self.device.type == "cuda"
        self.host = torch.zeros(n + CLIP_WORDS, dtype=torch.float32,
                                pin_memory=cuda)
        self.block = torch.zeros(n + CLIP_WORDS, dtype=torch.float32,
                                 device=self.device)
        self._copied = torch.cuda.Event() if cuda else None
        self._clip_of = None    # what the clip words were computed from
        b = self.block
        cam = BlockCamera(position=b[0:3], target=b[3:6], up=b[6:9],
                          fov_y=b[9], znear=None, zfar=b[10],
                          clip=b[n:n + CLIP_WORDS])
        lights = []
        for i in range(n_lights):
            o = LIGHTS + LIGHT_WORDS * i
            lights.append(BlockLight(
                direction=b[o:o + 3], position=b[o + 3:o + 6],
                color=b[o + 6:o + 9], intensity=b[o + 9], radius=b[o + 10],
                angular_radius=None, cone_cos=b[o + 11]))
        self.views = FrameViews(camera=cam, lights=lights,
                                bias=b[BIAS],
                                background=b[BACKGROUND:BACKGROUND + 3],
                                seed=b.view(torch.int32)[SEED:SEED + 1],
                                block=b[:n])

    def write(self, cam: Camera, lights: Sequence[Light], config,
              seed: int) -> FrameViews:
        """Pack ``cam``, ``lights``, ``config``'s background and shadow
        bias, the frame seed and, where ``config`` rasterizes its
        G-buffer, the clip words of ``cam`` at its frame size, and copy
        them onto the device (no wait on the device's work) -> the
        views."""
        if len(lights) != self.n_lights:
            raise ValueError(f"{len(lights)} lights in a block of "
                             f"{self.n_lights}")
        if self._copied is not None:     # no wait before the first record
            self._copied.synchronize()
        a = self.host.numpy()
        a[0:3] = _f32(cam.position)
        a[3:6] = _f32(cam.target)
        a[6:9] = _f32(cam.up)
        a[9] = _f32(cam.fov_y)
        a[10] = _f32(cam.zfar)
        a[BACKGROUND:BACKGROUND + 3] = _f32(config.background)
        a[BIAS] = _f32(config.shadow_bias)
        a.view(np.uint32)[SEED] = int(seed) & 0xFFFFFFFF
        for i, light in enumerate(lights):
            o = LIGHTS + LIGHT_WORDS * i
            a[o:o + 3] = _f32(light.direction)
            a[o + 3:o + 6] = _f32(light.position)
            a[o + 6:o + 9] = _f32(light.color)
            a[o + 9] = _f32(light.intensity)
            a[o + 10] = _f32(light.radius)
            a[o + 11] = np.cos(_f32(light.angular_radius))
            self.views.lights[i].kind = light.kind
        if config.gbuffer == "raster":
            # The words follow from the camera's float32 words and the
            # frame size alone: computed again only where these changed.
            of = (a[0:10].tobytes(), config.width, config.height)
            if of != self._clip_of:
                a[self._clip_at:] = clip_constants(cam, config.width,
                                                   config.height)
                self._clip_of = of
        self.block.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        return self.views
