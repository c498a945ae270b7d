"""Device compute ops: physics, light baking, the raycast renderer and the fused
observe.

Each op is plain torch, the port's ground truth, mirroring
:mod:`megastep_tpu.ops`; the fused observe and Deathmatch's per-frame re-bake
also have hand-written CUDA kernels (``csrc/observe.cu``, wrapped in
:mod:`.fused`), each held against its plain version.
"""
from . import geom, physics, bake, render, fused
