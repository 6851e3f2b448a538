"""Inverse-distance-weighted 3-NN feature upsampling.

Group features at G centers are spread to every point of the full grid by
averaging the 3 nearest centers' features with 1/(d + 1e-8) weights, d the
squared distance (the reference ``pointnet2_utils.interpolating_points``
never takes the square root).  Every grid position is interpolated and
invalid ones are zeroed with the mask.

``three_nn_interpolate`` launches the CUDA kernel (``csrc/interp.cu``) for
CUDA tensors and runs ``_three_nn_plain`` for CPU tensors.  Both compute the
distance as (|p|^2 + |c|^2) - 2 ((px*cx + py*cy) + pz*cz) clamped at 0, pick
the 3 nearest by (distance, index), and sum w0*f0 + w1*f1 + w2*f2 in that
order, so they agree exactly.  This module is the port's counterpart of
both ``ops/interpolate.py`` and ``ops/pallas_interp.py`` of the JAX package.
"""

from __future__ import annotations

import torch

from cmdiad_tpu_torch import kernels

# the kernel writes 16 bytes a lane (4 float32 or 8 bfloat16 values), so
# the feature width must be a multiple of 8 (csrc/interp.cu)
WIDTH_TILE = 8


def _sqnorm3(x: torch.Tensor) -> torch.Tensor:
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]


def _three_nn_plain(points, mask, centers, feats, bf16: bool):
    p = points.to(torch.float32)
    c = centers.to(torch.float32)
    pn = _sqnorm3(p)[..., :, None]                              # (B, P, 1)
    cn = _sqnorm3(c)[..., None, :]                              # (B, 1, G)
    dot = ((p[..., 0:1] * c[..., None, :, 0] + p[..., 1:2] * c[..., None, :, 1])
           + p[..., 2:3] * c[..., None, :, 2])                  # (B, P, G)
    d = torch.clamp_min((pn + cn) - 2.0 * dot, 0.0)
    d = d + 0.0     # -0.0 -> +0.0 so the bit pattern orders like the value
    g = d.shape[-1]
    key = ((d.view(torch.int32).to(torch.int64) << 32)
           | torch.arange(g, device=d.device, dtype=torch.int64))
    sel = torch.topk(key, 3, dim=-1, largest=False, sorted=True).values
    idx = sel & 0xFFFFFFFF                                      # (B, P, 3)
    top = (sel >> 32).to(torch.int32).view(torch.float32)
    recip = 1.0 / (top + 1e-8)
    w = recip / ((recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3])
    f = feats.to(torch.float32)
    if bf16:
        w = w.to(torch.bfloat16).to(torch.float32)
        f = f.to(torch.bfloat16).to(torch.float32)
    b, npts, _ = idx.shape
    rows = torch.gather(f, 1, idx.reshape(b, npts * 3, 1).expand(-1, -1, f.shape[-1]))
    rows = rows.reshape(b, npts, 3, -1)
    out = (w[..., 0:1] * rows[:, :, 0] + w[..., 1:2] * rows[:, :, 1]) \
        + w[..., 2:3] * rows[:, :, 2]
    out = torch.where(mask[..., None], out, torch.zeros((), device=out.device))
    return out.to(torch.bfloat16) if bf16 else out


def _three_nn_cuda(points, mask, centers, feats, bf16: bool, phases: int = 3):
    """The kernel; ``phases`` 1 or 2 runs only its search or only its
    writer (every point written as masked), to time the two apart."""
    b, p, _ = points.shape
    g, d = centers.shape[1], feats.shape[2]
    if g < 3:
        raise ValueError(f"3-NN interpolation needs at least 3 centers, got {g}")
    if d % WIDTH_TILE:
        raise ValueError(f"3-NN interpolation kernel needs a feature width "
                         f"% {WIDTH_TILE} == 0, got {d}")
    pts = points.to(torch.float32).contiguous()
    m = mask.to(torch.uint8).contiguous()
    c = centers.to(torch.float32).contiguous()
    f = feats.to(torch.float32).contiguous()
    kernels.check_cuda_tensor(pts, "points", torch.float32, (b, p, 3))
    kernels.check_cuda_tensor(m, "mask", torch.uint8, (b, p))
    kernels.check_cuda_tensor(c, "centers", torch.float32, (b, g, 3))
    kernels.check_cuda_tensor(f, "feats", torch.float32, (b, g, d))
    out = torch.empty((b, p, d), device=points.device,
                      dtype=torch.bfloat16 if bf16 else torch.float32)
    # the bfloat16 mode's rounded feature rows, written by the launcher
    scratch = torch.empty((b, g, d), device=points.device,
                          dtype=torch.bfloat16) if bf16 else None
    kernels.launch("interp", pts.data_ptr(), m.data_ptr(), c.data_ptr(),
                   f.data_ptr(), scratch.data_ptr() if bf16 else None,
                   b, p, g, d, int(bf16), out.data_ptr(), phases)
    return out


def three_nn_interpolate(points: torch.Tensor, mask: torch.Tensor,
                         centers: torch.Tensor, feats: torch.Tensor,
                         compute_dtype: str = "float32") -> torch.Tensor:
    """IDW-interpolate center features onto all (masked) points.

    points (B, P, 3), mask (B, P), centers (B, G, 3), feats (B, G, D) ->
    (B, P, D), zero rows where mask is False.  ``compute_dtype='bfloat16'``
    rounds weights and features to bfloat16 for the weighted sum and
    returns bfloat16; distances and weights are float32 either way.
    """
    bf16 = compute_dtype == "bfloat16"
    if points.is_cuda:
        return _three_nn_cuda(points, mask, centers, feats, bf16)
    return _three_nn_plain(points, mask, centers, feats, bf16)
