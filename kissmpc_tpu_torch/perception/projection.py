"""Camera/LiDAR geometry on tensors: a port of
`kissmpc_tpu/perception/projection.py`.

The reference's `DetectorNode` (`obstacle_handling/human_tracking.py`)
projects LiDAR points into the camera through a hardcoded extrinsic
(`:192-200`) and `CameraInfo` intrinsics (`:174-177,235-236`), masks them by
each track's segmentation mask (`:250-257`), and transforms centres to the
map frame (`:285-294`).  Each stage is a plain function on tensors with any
leading batch axes ([..., P, 3] point clouds, padded and masked).

Every operation here is elementwise and written out, so the card and the
CPU select the same points: `SE3.apply` sums its three products in a fixed
order instead of a matrix product (whose summation order differs between
cuBLAS and the CPU), and the range is sqrt(x*x + y*y + z*z) in that order.
Mixed dtypes follow the reference's promotion with 64-bit types enabled: a
float64 intrinsic projects float32 points in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    """A tensor as it is; anything else through numpy, so a list of Python
    floats is float64 as in the reference with 64-bit types enabled."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


class SE3(NamedTuple):
    """Rigid 3-D transform as rotation matrix + translation."""

    rotation: torch.Tensor  # [3, 3]
    translation: torch.Tensor  # [3]

    @staticmethod
    def from_quaternion(translation, quat) -> "SE3":
        """(x, y, z, w) quaternion + translation -> SE3 (the reference's
        hardcoded lidar->camera extrinsic is given in this form,
        `human_tracking.py:192-200`).  Takes tensors or array-likes; the
        result lies where ``quat`` does, in its floating dtype."""
        q = _tensor(quat)
        if not q.is_floating_point():
            q = q.to(torch.float64)
        x, y, z, w = q[0], q[1], q[2], q[3]
        R = torch.stack([
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)]),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)]),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]),
        ])
        return SE3(rotation=R, translation=_tensor(translation).to(q.device))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """[..., 3] -> [..., 3]: row j is R[j,0]*p0 + R[j,1]*p1 + R[j,2]*p2
        + t[j], summed in that order."""
        R = _tensor(self.rotation).to(points.device)
        t = _tensor(self.translation).to(points.device)
        ct = torch.promote_types(torch.promote_types(points.dtype, R.dtype), t.dtype)
        R, t = R.to(ct), t.to(ct)
        p = [points[..., k].to(ct) for k in range(3)]
        rows = [p[0] * R[j, 0] + p[1] * R[j, 1] + p[2] * R[j, 2] + t[j] for j in range(3)]
        return torch.stack(rows, dim=-1)

    def inverse(self) -> "SE3":
        RT = self.rotation.T
        return SE3(rotation=RT, translation=-(RT @ self.translation))

    def compose(self, other: "SE3") -> "SE3":
        return SE3(
            rotation=self.rotation @ other.rotation,
            translation=self.rotation @ other.translation + self.translation,
        )


class Intrinsics(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @staticmethod
    def from_matrix(K) -> "Intrinsics":
        K = _tensor(K).reshape(3, 3)
        return Intrinsics(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2])


def range_filter(points: torch.Tensor, mask: torch.Tensor, max_range: float):
    """Keep points within ``max_range`` of the sensor (<= 5 m in the
    reference, `human_tracking.py:223-225`).  points [..., P, 3], mask
    [..., P] validity."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    return mask & (r <= max_range)


def project_points(intr: Intrinsics, points_cam: torch.Tensor, mask: torch.Tensor,
                   width: int, height: int):
    """Pinhole projection of camera-frame points [..., P, 3].

    Returns (uv [..., P, 2] int32 pixel coords, valid [..., P]): valid
    requires z > 0 and the pixel on-image (`human_tracking.py:235-242`).
    Pixels round half to even, as the reference's `jnp.round` does.
    """
    dev = points_cam.device
    fx, fy, cx, cy = (_tensor(v).to(dev) for v in intr)
    ct = points_cam.dtype
    for v in (fx, fy, cx, cy):
        ct = torch.promote_types(ct, v.dtype)
    x, y, z = (points_cam[..., k].to(ct) for k in range(3))
    z_safe = torch.where(z > 1e-6, z, torch.ones_like(z))
    u = fx.to(ct) * x / z_safe + cx.to(ct)
    v = fy.to(ct) * y / z_safe + cy.to(ct)
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)
    valid = mask & (z > 1e-6) & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    uv = torch.stack([torch.clamp(ui, 0, width - 1), torch.clamp(vi, 0, height - 1)], -1)
    return uv, valid


def points_in_mask(seg_mask: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Select projected points whose pixel lands inside a segmentation mask
    (`human_tracking.py:250-257`).  seg_mask [..., H, W] bool, uv [..., P, 2]
    (u, v), valid [..., P]; the leading axes broadcast.  Returns [..., P]: a
    gather of each point's pixel from its own mask."""
    H, W = seg_mask.shape[-2:]
    lead = torch.broadcast_shapes(seg_mask.shape[:-2], uv.shape[:-2], valid.shape[:-1])
    P = uv.shape[-2]
    flat = seg_mask.expand(*lead, H, W).reshape(*lead, H * W)
    pix = (uv[..., 1].to(torch.int64) * W + uv[..., 0].to(torch.int64)).expand(*lead, P)
    return valid & torch.gather(flat, -1, pix)
