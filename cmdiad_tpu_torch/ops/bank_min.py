"""Memory-bank min/argmin with a quantised cross term, then an exact refine.

For each query row the bank row minimising |b|^2 - 2 b.q is chosen with
b.q taken over quantised operands (|b|^2 and |q|^2 stay exact float32),
ties going to the lowest row.  Two modes:

* bfloat16 (``bank_min_bf16``, ``dist_method_s='l2'``): operands rounded
  to bfloat16, products summed in float32;
* int8 (``bank_min_int8``, ``dist_method_s='l2_int8'``): operands
  quantised per row to int8 (``quantize_rows``), the s8.s8 -> s32 product
  dequantised as float(prod) * (bscale * qscale).

With ``refine`` the returned distance is then recomputed exactly in float32
from the chosen row, sqrt(sum((q - b)^2)): the quantised product only
chooses the row, and the only residual error is a near-tie choosing another
row whose true distance is reported.

Each mode launches its CUDA kernel (``csrc/bank_min.cu``,
``csrc/bank_min_int8.cu``) for CUDA tensors and runs its plain version for
CPU tensors.  This module is the port's counterpart of the JAX package's
``ops/pallas_scoring.py``.
"""

from __future__ import annotations

import torch

from cmdiad_tpu_torch import kernels

# bank rows and feature width the kernels accept (csrc/bank_min.cu,
# csrc/bank_min_int8.cu)
ROW_TILE = 64
COL_TILE = 64
COL_TILE_INT8 = 128


def _bank_min_plain(q_bf16: torch.Tensor, bank_bf16: torch.Tensor,
                    bnorm: torch.Tensor, chunk: int = 8192):
    """Plain version: (min of |b|^2 - 2 b.q (N,), argmin (N,) int64), the
    product of bfloat16 values taken exactly in float32, bank chunks scanned
    in order with a strict '<' so the first occurrence wins."""
    q = q_bf16.to(torch.float32)
    best_v = torch.full((q.shape[0],), 3.4e38, device=q.device)
    best_i = torch.zeros((q.shape[0],), dtype=torch.int64, device=q.device)
    for s in range(0, bank_bf16.shape[0], chunk):
        prod = q @ bank_bf16[s:s + chunk].to(torch.float32).T
        d2 = bnorm[s:s + chunk][None, :] - 2.0 * prod
        v, i = torch.min(d2, dim=1)
        take = v < best_v
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i + s, best_i)
    return best_v, best_i


def pack_min_keys(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(value float32, row) -> int64 keys whose signed order is the
    lexicographic (value, row) order: the float's bits, magnitude flipped
    for negative values, above the row (0 <= row < 2^31).  -0.0 packs as
    +0.0, which a strict '<' does not tell apart.  Both kernels publish
    these keys with atomicMin (``min_key`` in csrc/bank_min.cu and
    csrc/bank_min_int8.cu)."""
    bits = (v.to(torch.float32) + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (ordered.to(torch.int64) << 32) | idx.to(torch.int64)


def unpack_min_keys(keys: torch.Tensor):
    """Inverse of ``pack_min_keys``: (value float32, row int64)."""
    ordered = (keys >> 32).to(torch.int32)
    bits = torch.where(ordered < 0, ordered ^ 0x7FFFFFFF, ordered)
    return bits.view(torch.float32), keys & 0xFFFFFFFF


def _bank_min_cuda(q_bf16: torch.Tensor, bank_bf16: torch.Tensor,
                   bnorm: torch.Tensor):
    n, d = q_bf16.shape
    nb = bank_bf16.shape[0]
    if nb % ROW_TILE or d % COL_TILE:
        raise ValueError(f"bank-min kernel needs rows % {ROW_TILE} == 0 and "
                         f"width % {COL_TILE} == 0, got ({nb}, {d})")
    kernels.check_cuda_tensor(q_bf16, "queries", torch.bfloat16, (n, d))
    kernels.check_cuda_tensor(bank_bf16, "bank", torch.bfloat16, (nb, d))
    kernels.check_cuda_tensor(bnorm, "bank norms", torch.float32, (nb,))
    keys = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=q_bf16.device)
    kernels.launch("bank_min", q_bf16.data_ptr(), bank_bf16.data_ptr(),
                   bnorm.data_ptr(), n, nb, d, keys.data_ptr())
    return unpack_min_keys(keys)


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantisation: (N, D) float32 -> (int8 (N, D),
    float32 scales (N,)), scale = max(amax, 1e-30) / 127 and
    clip(round(x / scale), -127, 127) with round half to even."""
    x = x.to(torch.float32)
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=1), 1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8).contiguous(), scale.contiguous()


def _bank_min_int8_plain(q_s8: torch.Tensor, qscale: torch.Tensor,
                         bank_s8: torch.Tensor, bscale: torch.Tensor,
                         bnorm: torch.Tensor, chunk: int = 8192):
    """Plain version of the int8 kernel: (min of |b|^2 - 2 p (N,), argmin
    (N,) int64) with p = float(q8.b8) * (bscale * qscale), each operation
    rounded on its own in the kernel's order.  The integer product is taken
    as a float32 product of integers, exact while every partial sum stays
    below 2^24 (127 * 127 * D: widths up to 1040)."""
    d = q_s8.shape[1]
    if 127 * 127 * d >= 2 ** 24:
        raise ValueError(f"width {d}: the float32 product of int8 rows is "
                         f"exact only up to 1040 columns")
    q = q_s8.to(torch.float32)
    best_v = torch.full((q.shape[0],), 3.4e38, device=q.device)
    best_i = torch.zeros((q.shape[0],), dtype=torch.int64, device=q.device)
    for s in range(0, bank_s8.shape[0], chunk):
        prod = q @ bank_s8[s:s + chunk].to(torch.float32).T
        p = prod * (bscale[s:s + chunk][None, :] * qscale[:, None])
        d2 = bnorm[s:s + chunk][None, :] - 2.0 * p
        v, i = torch.min(d2, dim=1)
        take = v < best_v
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i + s, best_i)
    return best_v, best_i


def _bank_min_int8_cuda(q_s8: torch.Tensor, qscale: torch.Tensor,
                        bank_s8: torch.Tensor, bscale: torch.Tensor,
                        bnorm: torch.Tensor, reload: bool = True):
    """The kernel.  ``reload=False`` is a timing aid with wrong results:
    the main loop runs on stages loaded once, so the time has no load to
    wait for."""
    n, d = q_s8.shape
    nb = bank_s8.shape[0]
    if nb % ROW_TILE or d % COL_TILE_INT8:
        raise ValueError(f"int8 bank-min kernel needs rows % {ROW_TILE} == 0 "
                         f"and width % {COL_TILE_INT8} == 0, got ({nb}, {d})")
    kernels.check_cuda_tensor(q_s8, "queries", torch.int8, (n, d))
    kernels.check_cuda_tensor(qscale, "query scales", torch.float32, (n,))
    kernels.check_cuda_tensor(bank_s8, "bank", torch.int8, (nb, d))
    kernels.check_cuda_tensor(bscale, "bank scales", torch.float32, (nb,))
    kernels.check_cuda_tensor(bnorm, "bank norms", torch.float32, (nb,))
    # the launcher fills the keys, runs the kernel and unpacks the keys
    keys = torch.empty((n,), dtype=torch.int64, device=q_s8.device)
    value = torch.empty((n,), dtype=torch.float32, device=q_s8.device)
    row = torch.empty((n,), dtype=torch.int64, device=q_s8.device)
    kernels.launch("bank_min_int8", q_s8.data_ptr(), qscale.data_ptr(),
                   bank_s8.data_ptr(), bscale.data_ptr(), bnorm.data_ptr(),
                   n, nb, d, keys.data_ptr(), value.data_ptr(), row.data_ptr(),
                   int(reload))
    return value, row


def exact_refine(patch: torch.Tensor, bank: torch.Tensor,
                 min_idx: torch.Tensor) -> torch.Tensor:
    """Exact float32 distance of each query row to its chosen bank row, in
    the cancellation-free form sqrt(sum((p - b)^2))."""
    diff = patch.to(torch.float32) - bank[min_idx].to(torch.float32)
    return torch.sqrt(torch.sum(diff * diff, dim=1))


def bank_min_bf16(patch: torch.Tensor, bank: torch.Tensor,
                  refine: bool = True, bank_bf16=None, bnorm=None):
    """(min euclidean distance (N,), argmin (N,) int64) of each row of
    ``patch`` (N, D) over ``bank`` (Nb, D), both float32.

    ``bank_bf16``/``bnorm`` may carry the bank's bfloat16 copy and exact
    squared row norms when the caller keeps them.  Without ``refine`` the
    value is sqrt(max(|q|^2 + min, 0)) from the rounded product.
    """
    p = patch.to(torch.float32).contiguous()
    if bank_bf16 is None:
        bank_bf16 = bank.to(torch.bfloat16).contiguous()
    if bnorm is None:
        bf = bank.to(torch.float32)
        bnorm = torch.sum(bf * bf, dim=1).contiguous()
    q_bf16 = p.to(torch.bfloat16).contiguous()
    if p.is_cuda:
        v, idx = _bank_min_cuda(q_bf16, bank_bf16, bnorm)
    else:
        v, idx = _bank_min_plain(q_bf16, bank_bf16, bnorm)
    return _finish(p, bank, v, idx, refine)


def bank_min_int8(patch: torch.Tensor, bank: torch.Tensor,
                  refine: bool = True, bank_s8=None, bscale=None, bnorm=None):
    """As ``bank_min_bf16`` with the int8 cross term (the JAX package's
    ``compute_dtype='int8'``).  ``bank_s8``/``bscale``/``bnorm`` may carry
    the bank's quantised rows, row scales and exact squared row norms when
    the caller keeps them."""
    p = patch.to(torch.float32).contiguous()
    if bank_s8 is None or bscale is None:
        bank_s8, bscale = quantize_rows(bank)
    if bnorm is None:
        bf = bank.to(torch.float32)
        bnorm = torch.sum(bf * bf, dim=1).contiguous()
    q_s8, qscale = quantize_rows(p)
    if p.is_cuda:
        v, idx = _bank_min_int8_cuda(q_s8, qscale, bank_s8, bscale, bnorm)
    else:
        v, idx = _bank_min_int8_plain(q_s8, qscale, bank_s8, bscale, bnorm)
    return _finish(p, bank, v, idx, refine)


def _finish(p, bank, v, idx, refine):
    """(distance, row): the chosen row's exact distance with ``refine``,
    else sqrt(max(|q|^2 + v, 0)) from the quantised product."""
    if refine:
        return exact_refine(p, bank, idx), idx
    pnorm = torch.sum(p * p, dim=1)
    return torch.sqrt(torch.clamp_min(v + pnorm, 0.0)), idx
