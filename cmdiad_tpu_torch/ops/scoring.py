"""PatchCore-style memory-bank anomaly scoring.

Nearest-neighbour distance of each test patch to the memory bank, the
image score from the most anomalous patch reweighted by its bank
neighbourhood (paper eq. 7), and a blurred bilinear-upsampled segmentation
map — for a batch of samples at once.

Routing, the same on every device (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors): an ``l2`` bank goes through
``ops.bank_min.bank_min_bf16`` and an ``l2_int8`` bank through
``ops.bank_min.bank_min_int8``; the quantised product chooses the nearest
row and its distance is recomputed exactly in float32.  ``l1`` and
``cos_dist`` take the exact chunked path.  Every dense distance here
(``cdist``, and through it the NN table) computes ``l2_int8`` as exact l2.
"""

from __future__ import annotations

import math

import torch

from cmdiad_tpu_torch.ops.bank_min import bank_min_bf16, bank_min_int8
from cmdiad_tpu_torch.ops.blur import knn_gaussian_blur, quantized_knn_gaussian_blur
from cmdiad_tpu_torch.ops.pooling import bilinear_resize

# Value written into bank padding rows; far from any normalised feature.
PAD_VALUE = 1e6
_FAR = 3.4e38


def cdist(a: torch.Tensor, b: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Dense pairwise distances (N, D) x (M, D) -> (N, M) for the
    reference's three metrics: 'l2' (euclidean), 'l1', 'cos_dist'.  'l2_int8'
    quantises only the bank-min kernel's cross term; here it is exact l2."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if metric in ("l2", "l2_int8"):
        a2 = torch.sum(a * a, -1)[:, None]
        b2 = torch.sum(b * b, -1)[None, :]
        return torch.sqrt(torch.clamp_min(a2 + b2 - 2.0 * (a @ b.T), 0.0))
    if metric == "cos_dist":
        an = a / torch.clamp_min(torch.linalg.norm(a, dim=-1, keepdim=True), 1e-30)
        bn = b / torch.clamp_min(torch.linalg.norm(b, dim=-1, keepdim=True), 1e-30)
        return 1.0 - an @ bn.T
    if metric == "l1":
        chunk = max(1, min(a.shape[0], 2 ** 22 // max(b.shape[0], 1)))
        return torch.cat([torch.sum(torch.abs(a[i:i + chunk, None, :] - b[None]), -1)
                          for i in range(0, a.shape[0], chunk)])
    raise ValueError(f"unknown metric {metric!r}")


def mask_padding_cols(d: torch.Tensor, n_valid, col_offset: int = 0):
    """Force distances to bank padding rows (index >= n_valid) to a huge
    value: under cos_dist a constant padding row could win the min."""
    cols = torch.arange(d.shape[-1], device=d.device) + col_offset
    return torch.where(cols < n_valid, d, torch.tensor(_FAR, device=d.device))


def bank_min_dist(patch: torch.Tensor, bank: torch.Tensor, metric: str = "l2",
                  chunk: int = 8192, n_valid=None):
    """Exact per-patch (min distance (N,), argmin (N,) int64) over the bank,
    scanned in bank chunks with first-occurrence ties."""
    best_v = torch.full((patch.shape[0],), float("inf"), device=patch.device)
    best_i = torch.zeros((patch.shape[0],), dtype=torch.int64, device=patch.device)
    for s in range(0, bank.shape[0], chunk):
        d = cdist(patch, bank[s:s + chunk], metric)
        if n_valid is not None:
            d = mask_padding_cols(d, n_valid, s)
        v, i = torch.min(d, dim=1)
        take = v < best_v
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i + s, best_i)
    return best_v, best_i


def _k_smallest(dist: torch.Tensor, k: int) -> torch.Tensor:
    """k rounds of first-occurrence argmin along the last axis."""
    idxs = []
    for _ in range(k):
        j = torch.argmin(dist, dim=-1)
        idxs.append(j)
        dist = dist.scatter(-1, j[..., None], _FAR)
    return torch.stack(idxs, dim=-1)


def bank_nn_table(bank: torch.Tensor, k: int = 3, n_valid=None,
                  metric: str = "l2", chunk: int = 2048) -> torch.Tensor:
    """Per-row k nearest bank rows, self first — (Nb, k) int64, exact
    float32, first-occurrence ties.  Built once per bank at fit time so
    eq. 7 looks the neighbourhood up instead of scanning the bank."""
    out = []
    for s in range(0, bank.shape[0], chunk):
        dist = cdist(bank[s:s + chunk], bank, metric)
        if n_valid is not None:
            dist = mask_padding_cols(dist, n_valid)
        out.append(_k_smallest(dist, k))
    return torch.cat(out)


def patchcore_finish(patch, bank, min_val, min_idx, feat_hw,
                     out_size: int = 224, metric: str = "l2",
                     n_reweight: int = 3, blur_radius: float = 4.0,
                     n_valid=None, nn_table=None, bank_rows=None,
                     quantized_blur: bool = False):
    """Everything after the bank min pass, for a batch: eq. 7 reweight,
    bilinear upsample, blur (the reference's uint8 blur, bit for bit, with
    ``quantized_blur``).

    patch (B, Np, D), min_val/min_idx (B, Np) -> (s (B,), s_map (B, out, out)).
    ``bank_rows(idx)`` returns the bank's rows at ``idx`` where the caller
    does not hold the whole bank (a row-sharded bank, with ``nn_table``);
    by default they are ``bank[idx]``.
    """
    b = patch.shape[0]
    rows = torch.arange(b, device=patch.device)
    s_idx = torch.argmax(min_val, dim=1)
    s_star = min_val[rows, s_idx]
    m_test = patch[rows, s_idx]                               # (B, D)
    m_star_idx = min_idx[rows, s_idx]
    if nn_table is not None:
        nn_idx = nn_table[m_star_idx]                         # (B, k)
    else:
        w_dist = cdist(bank[m_star_idx], bank, metric)
        if n_valid is not None:
            w_dist = mask_padding_cols(w_dist, n_valid)
        nn_idx = _k_smallest(w_dist, n_reweight)
    # nn_idx[:, 0] is m_star itself (distance 0); eq. 7 uses the others
    neighbours = bank[nn_idx[:, 1:]] if bank_rows is None else bank_rows(nn_idx[:, 1:])
    m_star_knn = torch.linalg.norm(m_test[:, None, :] - neighbours, dim=-1)

    # eq. 7, max-subtracted: the naive exp(s*/sqrt(D)) overflows float32
    # for patches far from the bank; identical in exact arithmetic
    d_sqrt = math.sqrt(patch.shape[-1])
    a = s_star / d_sqrt
    bb = m_star_knn / d_sqrt
    m = torch.maximum(a, torch.amax(bb, dim=1))
    w = 1.0 - torch.exp(a - m) / torch.sum(torch.exp(bb - m[:, None]), dim=1)
    s = w * s_star

    h, w_ = feat_hw
    s_map = bilinear_resize(min_val.reshape(b, h, w_, 1), (out_size, out_size))[..., 0]
    blur = quantized_knn_gaussian_blur if quantized_blur else knn_gaussian_blur
    return s, blur(s_map, blur_radius)


def patchcore_score(patch: torch.Tensor, bank: torch.Tensor, feat_hw,
                    out_size: int = 224, metric: str = "l2",
                    n_reweight: int = 3, blur_radius: float = 4.0,
                    n_valid=None, nn_table=None, bank_operands=None,
                    quantized_blur: bool = False):
    """Image scores and segmentation maps of a batch against one bank.

    patch (B, Np, D) normalised test patches, bank (Nb, D), feat_hw with
    h * w == Np.  Mirrors the reference ``compute_single_s_s_map``:
    s_map = per-patch NN distance, bilinear to out_size², PIL-style blur;
    s = w * s*, with s* the largest patch NN distance and w the eq. 7
    reweight over the bank neighbours of that patch's NN.  ``bank_operands``
    carries the bank's kernel operands when the caller keeps them (the
    keyword arguments of ``bank_min_bf16`` or ``bank_min_int8``).
    """
    b, n, d = patch.shape
    flat = patch.reshape(b * n, d)
    ops = bank_operands or {}
    if metric == "l2":
        min_val, min_idx = bank_min_bf16(flat, bank, **ops)
    elif metric == "l2_int8":
        min_val, min_idx = bank_min_int8(flat, bank, **ops)
    elif metric in ("l1", "cos_dist"):
        min_val, min_idx = bank_min_dist(flat, bank, metric, n_valid=n_valid)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return patchcore_finish(patch, bank, min_val.reshape(b, n),
                            min_idx.reshape(b, n), feat_hw, out_size=out_size,
                            metric=metric, n_reweight=n_reweight,
                            blur_radius=blur_radius, n_valid=n_valid,
                            nn_table=nn_table, quantized_blur=quantized_blur)


def pad_bank(bank: torch.Tensor, bucket: int = 8192) -> torch.Tensor:
    """Pad bank rows up to a multiple of ``bucket`` with PAD_VALUE rows (the
    persisted state layout both packages share)."""
    n = bank.shape[0]
    target = -(-max(n, 1) // bucket) * bucket
    if target == n:
        return bank
    pad = torch.full((target - n, bank.shape[1]), PAD_VALUE, dtype=bank.dtype,
                     device=bank.device)
    return torch.cat([bank, pad], dim=0)
