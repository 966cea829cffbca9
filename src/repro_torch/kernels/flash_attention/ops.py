"""Public wrapper matching the model's (B,S,KVH,G,D) layout, with the
kernel's gradient: under grad, a CUDA call goes through `_FlashAttention`
(the forward kernel writing each row's log-sum-exp, then the backward
kernel)."""
import torch

from repro_torch.kernels.flash_attention.kernel import (
    SHORT_SPAN, flash_attention_bwd, flash_attention_fwd_lse,
    flash_attention_grouped, flash_attention_hsd)
from repro_torch.tracing import span


def _head_contiguous(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def _hsd(t, H):
    """(B,S,KVH,G,D) -> a (B,H,S,D) view (a copy only where (KVH, G) do
    not fold into one head dim)."""
    B, S, D = t.shape[0], t.shape[1], t.shape[-1]
    return t.reshape(B, S, H, D).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """Grouped-query flash attention on the model layout, qg (B,S,KVH,G,D)
    and k, v (B,S,KVH,D) float32 CUDA tensors with at most 32 keys: the
    forward kernel with lse, and the backward kernel
    (flash_short_bwd_f32) for dq, dk and dv."""

    @staticmethod
    def forward(ctx, qg, k, v, causal, window):
        B, S, KVH, G, D = qg.shape
        q, kt, vt = _hsd(qg, KVH * G), k.transpose(1, 2), v.transpose(1, 2)
        o, lse = flash_attention_fwd_lse(q, kt, vt, causal=causal,
                                         window=window)
        ctx.save_for_backward(q, kt, vt, o, lse)
        ctx.causal, ctx.window = causal, window
        return o.transpose(1, 2).reshape(B, S, KVH, G, D)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, kt, vt, o, lse = ctx.saved_tensors
        B, S, KVH, G, D = dout.shape
        # autograd may hand a non-contiguous cotangent: the kernel reads
        # any strides with a contiguous head dim
        do = _hsd(_head_contiguous(dout), KVH * G)
        with span("repro_torch.attention.backward"):
            dq, dk, dv = flash_attention_bwd(q, kt, vt, o, lse, do,
                                             causal=ctx.causal,
                                             window=ctx.window)
        return (dq.transpose(1, 2).reshape(B, S, KVH, G, D),
                dk.transpose(1, 2), dv.transpose(1, 2), None, None)


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(qg, k, v, *, causal=True, window=0):
    """qg: (B,S,KVH,G,D); k,v: (B,S,KVH,D). Returns (B,S,KVH,G,D).

    Query head h = kvh*G + g reads kv head kvh. On the card the kernel
    reads the tensors through their strides and writes a (B,S,KVH,G,D)
    buffer: no transpose or pad is copied, and no view is made. Under
    grad (an input requires grad) a CUDA call runs `_FlashAttention`,
    whose backward is a kernel too; it takes float32 with at most 32
    keys, the policy trunk's training calls, and raises elsewhere."""
    qg, k, v = _head_contiguous(qg), _head_contiguous(k), _head_contiguous(v)
    if qg.is_cuda:
        if not _needs_grad(qg, k, v):
            return flash_attention_grouped(qg, k, v, causal=causal,
                                           window=window)
        S = qg.shape[1]
        if qg.dtype != torch.float32 or S > SHORT_SPAN:
            raise RuntimeError(
                f"flash_attention: the backward kernel takes float32 with "
                f"at most {SHORT_SPAN} keys; got {qg.dtype} with {S} keys "
                f"under grad (the reference trains its LMs without "
                f"kernels, use_kernels=False, as launch/train.py does; "
                f"other backward kernels wait in ROADMAP queue 2; run "
                f"under torch.no_grad() to serve)")
        return _FlashAttention.apply(qg, k, v, causal, window)
    B, S, KVH, G, D = qg.shape
    q = qg.reshape(B, S, KVH * G, D).transpose(1, 2)
    o = flash_attention_hsd(q, k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, window=window)
    return o.transpose(1, 2).reshape(B, S, KVH, G, D)
