"""tpurt_torch — the PyTorch/CUDA port of the tpurt ray-traced shadows renderer.

The static-scene fused frame runs here: host SBVH build, 8-wide collapse,
leaf attribute rows, and one hand-written CUDA kernel that finds the
closest hit and light 0's hard shadow (``kernels/traverse.py``). The JAX
package ``tpurt`` is the reference it is held against; this package imports
neither ``jax`` nor ``tpurt``.
"""

from .types import (Camera, Light, Mesh, RenderConfig,
                    LIGHT_AREA_CONE, LIGHT_DIRECTIONAL, LIGHT_POINT)

__all__ = [
    "Camera", "Light", "Mesh", "RenderConfig",
    "LIGHT_AREA_CONE", "LIGHT_DIRECTIONAL", "LIGHT_POINT",
]
