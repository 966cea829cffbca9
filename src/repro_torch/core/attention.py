"""Attention on the policy hot path — public API.

House ref/kernel/ops seam: the model-side grouped-query layout
(B, S, KVH, G, D) goes to the Hopper flash-attention kernel
(kernels/flash_attention/ops.py) for CUDA tensors when `use_kernel` is
on, and to the plain version (kernels/flash_attention/ref.py) for CPU
tensors or with `use_kernel=False`. There is no fallback: a CUDA tensor
with `use_kernel` launches the kernel or raises. Under grad the kernel
path trains through its autograd Function (the forward kernel with each
row's log-sum-exp, then the backward kernel, float32 with at most 32
keys: the policy trunk's calls); elsewhere under grad it raises. A CPU
tensor trains through the plain version's own autograd.
"""
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(qg, k, v, *, causal=True, window=0, use_kernel=False):
    """Grouped-query attention over the model layout.

    qg: (B, S, KVH, G, D) queries grouped per kv head; k, v:
    (B, S, KVH, D). Returns (B, S, KVH, G, D). `window` > 0 keeps only
    the trailing `window` keys per query (sliding-window attention)."""
    if use_kernel and qg.is_cuda:
        return flash_attention(qg, k, v, causal=causal, window=window)
    B, S, KVH, G, D = qg.shape
    q = torch.movedim(qg.reshape(B, S, KVH * G, D), 1, 2)  # (B, H, S, D)
    o = attention_ref(q, torch.movedim(k, 1, 2), torch.movedim(v, 1, 2),
                      causal=causal, window=window)
    return torch.movedim(o, 1, 2).reshape(B, S, KVH, G, D)
