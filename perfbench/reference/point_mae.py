"""Plain Point-MAE feature path as M3DM runs it, one part at a time:
farthest point sampling from the first valid point, the k nearest valid
points of each center, Point-MAE's mini-PointNet and transformer (the
blocks in ``fetch_idx`` through the final LayerNorm), 3-NN inverse-distance
interpolation onto every valid pixel of the organized cloud, then a 3x3
average and an adaptive average pool to a 56x56 grid.

The three selections use the float32 distance forms the configuration's
algorithm states, so that the reference picks what exact float32 picks:
FPS ((dx*dx + dy*dy) + dz*dz), the KNN (|c|^2 + |p|^2) - 2 c.p with the
product as a matrix product, the interpolation (|p|^2 + |c|^2) - 2
((px*cx + py*cy) + pz*cz); ties go to the lower index.  Everything else is
written as the published layers are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.vit import block


def _sq3(x):
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]


@torch.no_grad()
def fps(points, n_valid, num):
    """points (B, P, 3) valid points first, n_valid (B,) -> (B, num) indices."""
    b, p, _ = points.shape
    rows = torch.arange(b, device=points.device)
    valid = torch.arange(p, device=points.device)[None] < n_valid[:, None]
    min_d = torch.where(valid, torch.tensor(1e10, device=points.device),
                        torch.tensor(float("-inf"), device=points.device))
    last = torch.zeros(b, dtype=torch.int64, device=points.device)
    out = torch.empty((b, num), dtype=torch.int64, device=points.device)
    x, y, z = points.unbind(-1)
    for g in range(num):
        out[:, g] = last
        dx, dy, dz = (x - x[rows, last][:, None], y - y[rows, last][:, None],
                      z - z[rows, last][:, None])
        min_d = torch.minimum(min_d, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(min_d, dim=1)
    return out


def knn(points, centers, k):
    """points (n, 3), centers (G, 3) -> (G, k) nearest points, ascending."""
    d = (torch.sum(centers * centers, -1)[:, None] + torch.sum(points * points, -1)[None, :]
         ) - 2.0 * (centers @ points.T)
    d = torch.clamp_min(d, 0.0)
    return torch.sort(d, dim=1, stable=True).indices[:, :k]


def _conv1(sd, name, x):
    w = sd[f"{name}.weight"]
    return F.linear(x, w[:, :, 0], sd[f"{name}.bias"])


def _bn(sd, name, x, eps=1e-5):
    return ((x - sd[f"{name}.running_mean"]) / torch.sqrt(sd[f"{name}.running_var"] + eps)
            * sd[f"{name}.weight"] + sd[f"{name}.bias"])


def encoder(sd, rel, c):
    """rel (G, k, 3) neighbours minus their center -> (G, encoder_dims)."""
    e = "encoder"
    f = torch.relu(_bn(sd, f"{e}.first_conv.1", _conv1(sd, f"{e}.first_conv.0", rel)))
    f = _conv1(sd, f"{e}.first_conv.3", f)                          # (G, k, 256)
    g = torch.amax(f, dim=1, keepdim=True).expand_as(f)
    f = torch.cat([g, f], dim=-1)                                   # (G, k, 512)
    f = torch.relu(_bn(sd, f"{e}.second_conv.1", _conv1(sd, f"{e}.second_conv.0", f)))
    return torch.amax(_conv1(sd, f"{e}.second_conv.3", f), dim=1)


def transformer(sd, tokens, centers, c):
    pos = F.linear(F.gelu(F.linear(centers, sd["pos_embed.0.weight"], sd["pos_embed.0.bias"])),
                   sd["pos_embed.2.weight"], sd["pos_embed.2.bias"])
    x, out = tokens[None], []
    for i in range(c["depth"]):
        x = block(sd, f"blocks.blocks.{i}", x + pos[None], c["num_heads"], c["ln_eps"])
        if i in c["fetch_idx"]:
            out.append(F.layer_norm(x, (x.shape[-1],), sd["norm.weight"], sd["norm.bias"],
                                    c["ln_eps"]))
    return torch.cat(out, dim=-1)[0]


def interpolate(organized_pc, centers, feats, chunk=12544):
    """Every pixel of (H, W, 3) from its 3 nearest centers -> (H*W, D),
    zero where the pixel holds no point."""
    p = organized_pc.reshape(-1, 3)
    valid = torch.all(p != 0.0, dim=-1)
    cn = _sq3(centers)
    out = []
    for s in range(0, p.shape[0], chunk):
        q = p[s:s + chunk]
        dot = (q[:, 0:1] * centers[None, :, 0] + q[:, 1:2] * centers[None, :, 1]) \
            + q[:, 2:3] * centers[None, :, 2]
        d = torch.clamp_min((_sq3(q)[:, None] + cn[None]) - 2.0 * dot, 0.0)
        idx = torch.sort(d, dim=1, stable=True).indices[:, :3]
        r = 1.0 / (torch.gather(d, 1, idx) + 1e-8)
        w = r / ((r[:, 0:1] + r[:, 1:2]) + r[:, 2:3])
        f = (w[:, 0:1] * feats[idx[:, 0]] + w[:, 1:2] * feats[idx[:, 1]]) \
            + w[:, 2:3] * feats[idx[:, 2]]
        out.append(torch.where(valid[s:s + chunk, None], f, torch.zeros_like(f)))
    return torch.cat(out)


def pool(grid, side):
    """(H, W, D) -> 3x3 average, stride 1, then adaptive average to
    (side, side) -> (side * side, D)."""
    x = F.avg_pool2d(grid.permute(2, 0, 1)[None], 3, stride=1)
    return F.adaptive_avg_pool2d(x, side)[0].permute(1, 2, 0).reshape(side * side, -1)


@torch.no_grad()
def patches(sd, organized_pcs, compacted, c, side=56):
    """Point-MAE patch features of a block of parts: organized_pcs (B, H,
    W, 3), compacted (B, capacity, 3) the valid points first -> (B, side *
    side, 768).  ``sd`` has the checkpoint's names without the
    ``MAE_encoder.`` prefix."""
    n_valid = torch.all(compacted != 0.0, dim=-1).sum(1)
    centers_idx = fps(compacted, n_valid, c["num_group"])
    out = []
    for i in range(compacted.shape[0]):
        pts = compacted[i, : int(n_valid[i])]
        centers = pts[centers_idx[i]]
        idx = knn(pts, centers, c["group_size"])
        feats = transformer(sd, encoder(sd, pts[idx] - centers[:, None], c), centers, c)
        h, w, _ = organized_pcs[i].shape
        grid = interpolate(organized_pcs[i], centers, feats).reshape(h, w, -1)
        out.append(pool(grid, side))
    return torch.stack(out)
