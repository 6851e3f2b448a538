"""Multi-head self-attention of the two backbones, softmax(q.k^T).v.

The port's counterpart of the JAX package's ``ops/flash_attn.py``
(``fused_attention``).  q, k, v are (B, N, H, D) in the compute dtype.

* ``use_flash=False``: the einsum form.  Scores are summed in float32 and
  stored in the compute dtype before a float32 softmax (at bfloat16 that
  rounds the scores, as the JAX package's fallback does).
* ``use_flash=True``: the fused kernel's semantics.  q is pre-scaled in the
  compute dtype; scores are products of compute-dtype operands summed in
  float32 and stay float32; the softmax runs in float32 and the normalised
  p is rounded to the compute dtype before p.v, which accumulates in
  float32; the output is rounded to the compute dtype.

At float32 the two forms take the same float32 operands, products and
accumulation, float32 scores and a float32 softmax, and rounding p to
float32 changes nothing.  They differ in the order of summation and in the
exponential: the kernel takes ``ex2.approx`` (about 2 ulp, denormals
flushed to zero) of log2 e-scaled scores where the einsum form's softmax
takes an accurate ``exp``, and the card tests hold the two within 1e-5.  So
the route depends on the operands and not on ``use_flash`` alone
(``takes_einsum``): a CUDA tensor launches the kernel
(``csrc/flash_attn.cu``) with ``use_flash``, and also without it where it
is float32 at head dim 64 and needs no gradient.  Every other call without
``use_flash`` takes the einsum form; a CPU tensor with ``use_flash`` runs
``_fused_attention_plain``.  A caller that names a ``score_counter`` has
the bytes of the (B, H, N, N) scores the einsum form writes counted under
it (``tracing.count``), 0 where the call took a fused form.
"""

from __future__ import annotations

import torch

from cmdiad_tpu_torch import kernels, tracing

# head dimension the kernel is written for, and the most tokens its
# bfloat16 form takes: it keeps a head's K in shared memory
# (csrc/flash_attn.cu)
HEAD_DIM = 64
MAX_TOKENS_BF16 = 1408


def _einsum_attention(q, k, v, scale: float):
    attn = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    attn = torch.softmax(attn.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v)


def _fused_attention_plain(q, k, v, scale: float):
    """Plain version of the kernel, in the TPU kernel's order of operations."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = torch.einsum("bnhd,bmhd->bhnm", qs.to(torch.float32), k.to(torch.float32))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = (p / torch.sum(p, dim=-1, keepdim=True)).to(q.dtype)
    o = torch.einsum("bhnm,bmhd->bnhd", p.to(torch.float32), v.to(torch.float32))
    return o.to(q.dtype)


def takes_einsum(device_type: str, dtype: torch.dtype, head_dim: int,
                 use_flash: bool, needs_grad: bool) -> bool:
    """Whether ``fused_attention`` takes the einsum form for operands on
    ``device_type`` of ``dtype`` and ``head_dim``: never with ``use_flash``,
    and on a card not for float32 at head dim 64 when no gradient is
    needed (the kernel's)."""
    if use_flash:
        return False
    return not (device_type == "cuda" and dtype == torch.float32
                and head_dim == HEAD_DIM and not needs_grad)


def _fused_attention_cuda(q, k, v, scale: float):
    b, n, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"attention kernel needs head dim {HEAD_DIM}, got {d}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"attention kernel takes bfloat16 or float32, got {q.dtype}")
    if q.dtype == torch.bfloat16 and n > MAX_TOKENS_BF16:
        raise ValueError(f"bfloat16 attention kernel takes at most "
                         f"{MAX_TOKENS_BF16} tokens, got {n}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name}: expected a CUDA {q.dtype} tensor of "
                             f"shape {tuple(q.shape)}")
        if t.stride() != q.stride():
            raise ValueError(f"{name}: q, k and v must share their strides")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    sb, sn, sh, sd = q.stride()
    if sd != 1 or sh != d or sb % 8 or sn % 8:
        raise ValueError(f"attention kernel needs each head's row contiguous "
                         f"and token strides that are multiples of 8, got "
                         f"strides {q.stride()}")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    scale_c = float(torch.tensor(scale, dtype=q.dtype))
    kernels.launch("flash_attn", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), b, n, h, sb, sn, scale_c,
                   int(q.dtype == torch.bfloat16))
    return out


def fused_attention(q, k, v, scale: float, use_flash: bool = False,
                    score_counter: str | None = None):
    """softmax((q·scale)·kᵀ)·v per head: q, k, v (B, N, H, D) -> (B, N, H, D)
    in the compute dtype (see the module docstring for the two forms, the
    route and ``score_counter``)."""
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    einsum = takes_einsum(q.device.type, q.dtype, q.shape[-1], use_flash, needs_grad)
    if score_counter:
        b, n, h, _ = q.shape
        tracing.count(score_counter, einsum * b * h * n * n * q.element_size())
    if einsum:
        return _einsum_attention(q, k, v, scale)
    if q.is_cuda:
        return _fused_attention_cuda(q, k, v, scale)
    return _fused_attention_plain(q, k, v, scale)
