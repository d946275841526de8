"""Furthest point sampling (FPS).

Counterpart of ``iou3dmatch_tpu/ops/fps.py`` and its Pallas kernel
``fps_pallas.py``. Semantics of the reference CUDA kernel
(``pointnet2/_ext_src/src/sampling_gpu.cu:75-178``): the first index is 0;
points with |p|^2 <= 1e-3 are never chosen; each step updates a running min
of squared distances to the chosen set and takes its argmax, the lowest
index winning on equal values. int32 output, no gradient.

``furthest_point_sample`` launches ``csrc/fps.cu`` on a CUDA tensor and
takes the plain version only for a CPU tensor.
"""
import torch

from . import _build

_MAG_EPS = 1e-3


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS. xyz: (B, N, 3) -> (B, npoint) int32.

    Distances are written out term by term, left to right, so each product
    is rounded on its own, as in the kernel."""
    xyz = xyz.float()
    b = xyz.shape[0]
    x, y, z = xyz.unbind(-1)
    valid = (x * x + y * y + z * z) > _MAG_EPS
    # invalid points hold -1: every distance (>= 0) keeps them out of the argmax
    mind = torch.full_like(x, 1e10).masked_fill(~valid, -1.0)
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    old = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[rows, old]  # (B, 3)
        dx = x - p[:, 0:1]
        dy = y - p[:, 1:2]
        dz = z - p[:, 2:3]
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        old = torch.argmax(mind, dim=1)  # first occurrence on ties
        idx[:, j] = old.to(torch.int32)
    return idx


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Batched FPS. xyz: (B, N, 3) f32 -> (B, npoint) int32."""
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _build.require(xyz, torch.float32, "xyz")
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    b, n, _ = xyz.shape
    if b < 1 or n < 1 or npoint < 1:
        raise ValueError(f"empty FPS: B={b}, N={n}, npoint={npoint}")
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    mind = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    fn = _build.kernel("fps", "fps_launch", (_build.VP,) * 3 + (_build.INT,) * 3 + (_build.VP,))
    _build.check(fn(xyz.data_ptr(), mind.data_ptr(), out.data_ptr(), b, n, npoint,
                    _build.stream(xyz)), "fps")
    furthest_point_sample.launches += 1
    return out


furthest_point_sample.launches = 0
