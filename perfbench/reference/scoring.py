"""Plain PatchCore scoring of one part against one bank (M3DM's
``compute_s_s_map`` with the configuration's bank-min rule).

The bank row nearest each patch is chosen as the configuration states it:
by |b|^2 - 2 b.q with b and q rounded to bfloat16, the first row among
equals; the distance to the chosen row is then exact, sqrt(sum((q - b)^2))
in float64.  The image score reweights the largest patch distance by the
bank neighbourhood of its row (paper eq. 7, the fitted 3-NN table, self
first); the map is the patch distances, bilinear to the output size and
blurred as PIL's GaussianBlur(4) blurs a float image (three extended box
passes an axis, edges replicated).

That rule leaves a choice among near ties: a program that sums the bf16
product in float32 (the kernel), or whose features differ in the last
bits (so that a few elements round to the other bfloat16), may take
another row whose rounded distance lies within ``near_tie`` of the least.
So besides the answer of the reference's own choice (the product of the
rounded values taken exactly, in float64), ``score`` gives the range of
answers over every such row: per patch the least and largest exact
distance, the maps of both (the bilinear map and the blur have no negative
weight, so they keep the order), and the least and largest image score
over every patch and row that can be the maximum.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# a sound program's features agree with these to this share of each
# patch's largest element (on the card its image scores agree with these to
# about 1e-7); an element closer than that to a bfloat16 rounding boundary
# may round to the other side in the program
FEATURE_TOL = 1e-5


def _fragile(q):
    """(N, D) bool: elements of q within FEATURE_TOL * max|row| of a
    bfloat16 rounding boundary, and (N, D) float64: how far each element's
    rounded value moves if it rounds the other way (one bfloat16 step)."""
    a = q.abs().double()
    r = q.abs().to(torch.bfloat16)
    bits = r.view(torch.int16)
    up = (bits + 1).view(torch.bfloat16).double()
    rd = r.double()
    dn = torch.where(bits > 0, (bits - 1).view(torch.bfloat16).double(), -up)
    to_edge = torch.minimum((rd + up) / 2 - a, a - (rd + dn) / 2)
    tol = FEATURE_TOL * a.amax(1, keepdim=True)
    return to_edge <= tol, torch.maximum(up - rd, rd - dn)


def near_tie(q, bank):
    """(N,) float64: how far above the least rounded distance another row's
    rounded distance may lie and still be the row a sound program picks:
    twice the bound on the difference between two programs' rounded
    distances (every element of q near a rounding boundary rounded the
    other way against the largest bank element of its column, the float32
    sum of the product, the float32 row norm)."""
    d = q.shape[1]
    fragile, step = _fragile(q)
    colmax = bank.abs().amax(0).double()
    flips = 2.0 * (fragile * step * colmax[None]).sum(1)
    bnorm = float(torch.linalg.vector_norm(bank.double(), dim=1).max())
    qnorm = torch.linalg.vector_norm(q.double(), dim=1)
    sums = 2.0 * d * 2.0 ** -24 * qnorm * bnorm + bnorm * bnorm * 2.0 ** -23
    return 2.0 * (flips + sums)


def _rounded_d2(qb, b):
    return (b.double() ** 2).sum(1)[None] - 2.0 * (qb @ b.to(torch.bfloat16).double().T)


def nearest(q, bank, chunk=8192):
    """q (N, D) float32 normalised patches, bank (Nb, D) float32 -> (exact
    float64 distance of the reference's choice (N,), its row (N,), and the
    near ties: (patch, row, exact distance) of every row within
    ``near_tie`` of each patch's least rounded distance, the choice
    included)."""
    qb = q.to(torch.bfloat16).double()
    best_v = torch.full((q.shape[0],), float("inf"), dtype=torch.float64, device=q.device)
    best_i = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for s in range(0, bank.shape[0], chunk):
        d2 = _rounded_d2(qb, bank[s:s + chunk])
        i = torch.argmin(d2, dim=1)
        v = d2.gather(1, i[:, None])[:, 0]
        take = v < best_v
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i + s, best_i)

    def exact(p, r, block=1 << 16):
        return torch.cat([torch.sqrt(((q[p[k:k + block]].double()
                                       - bank[r[k:k + block]].double()) ** 2).sum(1))
                          for k in range(0, p.shape[0], block)])
    top = best_v + near_tie(q, bank)
    pats, rows = [], []
    for s in range(0, bank.shape[0], chunk):
        p, r = torch.nonzero(_rounded_d2(qb, bank[s:s + chunk]) <= top[:, None], as_tuple=True)
        pats.append(p)
        rows.append(r + s)
    pats, rows = torch.cat(pats), torch.cat(rows)
    rows_all = torch.arange(q.shape[0], device=q.device)
    return exact(rows_all, best_i), best_i, (pats, rows, exact(pats, rows))


def box_kernel(sigma2: float) -> np.ndarray:
    """Gwosdek's extended box: integer radius l plus two fractional taps,
    of variance ``sigma2``."""
    l = int(np.floor((np.sqrt(12.0 * sigma2 + 1.0) - 1.0) / 2.0))
    alpha = (sigma2 * (2 * l + 1) - l * (l + 1) * (2 * l + 1) / 3.0) / (
        2.0 * ((l + 1) ** 2 - sigma2))
    c = 1.0 / (2 * l + 1 + 2 * alpha)
    k = np.full(2 * l + 3, c)
    k[0] = k[-1] = alpha * c
    return k


def blur(img, radius=4.0, passes=3):
    """(H, W) float64 -> the same image blurred, three passes an axis."""
    k = torch.tensor(box_kernel(radius * radius / passes), dtype=img.dtype, device=img.device)
    r = k.numel() // 2
    x = img[None, None]
    for _ in range(passes):
        x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), k.view(1, 1, 1, -1))
    for _ in range(passes):
        x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), k.view(1, 1, -1, 1))
    return x[0, 0]


def _map(dist, out_size):
    side = int(round(math.sqrt(dist.shape[0])))
    up = F.interpolate(dist.reshape(1, 1, side, side), size=(out_size, out_size),
                       mode="bilinear", align_corners=False)[0, 0]
    return blur(up)


@torch.no_grad()
def score(patches, mean, std, bank, nn_table, out_size, lam_s, lam_m):
    """patches (Np, D) float32 features of one part -> {"s", "s_lo", "s_hi"}
    lam_s times the image score of the reference's choice and its range,
    and {"m", "m_lo", "m_hi"} lam_m times the (out, out) float64 maps;
    ``bank`` the bank's true rows (normalised), ``nn_table`` its (Nb, 3)
    neighbours, self first."""
    q = (patches - mean) / std
    dist, row, (pats, rows, tie_d) = nearest(q, bank)
    sq = math.sqrt(q.shape[1])

    def eq7(p, r, d, block=1 << 15):
        out = []
        for k in range(0, p.shape[0], block):
            pk, rk, dk = p[k:k + block], r[k:k + block], d[k:k + block]
            neighbours = bank[nn_table[rk, 1:]].double()
            knn = torch.sqrt(((q[pk].double()[:, None] - neighbours) ** 2).sum(-1))
            out.append((1.0 - torch.exp(dk / sq) / torch.exp(knn / sq).sum(1)) * dk)
        return torch.cat(out)

    star = torch.argmax(dist)
    s = eq7(star[None], row[star][None], dist[star][None])[0]
    n = q.shape[0]
    lo = torch.full((n,), float("inf"), dtype=torch.float64, device=q.device)
    hi = torch.zeros(n, dtype=torch.float64, device=q.device)
    lo = lo.scatter_reduce(0, pats, tie_d, "amin")
    hi = hi.scatter_reduce(0, pats, tie_d, "amax")
    can_be_max = tie_d >= lo.max()
    s_range = eq7(pats[can_be_max], rows[can_be_max], tie_d[can_be_max])
    return {"s": lam_s * float(s), "s_lo": lam_s * float(s_range.min()),
            "s_hi": lam_s * float(s_range.max()), "m": lam_m * _map(dist, out_size),
            "m_lo": lam_m * _map(lo, out_size), "m_hi": lam_m * _map(hi, out_size)}
