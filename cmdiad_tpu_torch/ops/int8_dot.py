"""Whole-array tensor-core product, int8 or bfloat16: a probe.

The port's counterpart of the JAX package's probe
``benchmarks/probe_int8_dot.py``, which measured s8 x s8 -> s32 against
bf16 x bf16 -> f32 products at the bank kernel's tile shape to decide the
design of the int8 bank-min.  ``int8_dot(a, b)`` computes a . b^T for a
(M, K) and b (N, K), both int8 (-> int32) or both bfloat16 (-> float32).
Both operands are K-contiguous, the layout the bank-min kernels read.  A
CUDA tensor launches the kernel (``csrc/int8_dot.cu``), a CPU tensor runs
``_int8_dot_plain``.  Not on the detection path: ``chip_smoke.py`` drives
it to measure the card's int8-to-bf16 ratio under wgmma.
"""

from __future__ import annotations

import torch

from cmdiad_tpu_torch import kernels

# what the kernel's tiles need of M and N, and the K bytes staged per step
# (csrc/int8_dot.cu)
ROW_TILE = 64
K_BYTES = 128


def _int8_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b^T as a float32 product.  For int8 operands every partial sum
    is an integer below 2^24 while K * 128 * 128 <= 2^24 (K up to 1024),
    so the float32 product is exact and is returned as int32."""
    if a.dtype == torch.int8:
        if a.shape[1] * 128 * 128 > 2 ** 24:
            raise ValueError(f"K = {a.shape[1]}: the float32 product of int8 "
                             f"values is exact only up to K = 1024")
        return (a.to(torch.float32) @ b.to(torch.float32).T).to(torch.int32)
    return a.to(torch.float32) @ b.to(torch.float32).T


def _int8_dot_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[0]
    if a.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"probe kernel takes int8 or bfloat16, got {a.dtype}")
    k_bytes = k * a.element_size()
    if m % ROW_TILE or n % ROW_TILE or k_bytes % K_BYTES:
        raise ValueError(f"probe kernel needs M, N % {ROW_TILE} == 0 and K a "
                         f"multiple of {K_BYTES} bytes, got ({m}, {n}, {k})")
    kernels.check_cuda_tensor(a, "a", a.dtype, (m, k))
    kernels.check_cuda_tensor(b, "b", a.dtype, (n, k))
    is_int8 = a.dtype == torch.int8
    out = torch.empty((m, n), dtype=torch.int32 if is_int8 else torch.float32,
                      device=a.device)
    kernels.launch("int8_dot", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                   m, n, k, int(is_int8))
    return out


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) . b (N, K)^T -> (M, N): int32 for int8 operands, float32
    for bfloat16 operands."""
    if a.dtype != b.dtype:
        raise ValueError(f"operand types differ: {a.dtype} and {b.dtype}")
    if a.is_cuda:
        return _int8_dot_cuda(a, b)
    return _int8_dot_plain(a, b)
