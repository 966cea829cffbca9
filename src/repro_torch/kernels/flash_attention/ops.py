"""Public wrapper matching the model's (B,S,KVH,G,D) layout."""
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_grouped, flash_attention_hsd)


def _head_contiguous(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention(qg, k, v, *, causal=True, window=0):
    """qg: (B,S,KVH,G,D); k,v: (B,S,KVH,D). Returns (B,S,KVH,G,D).

    Query head h = kvh*G + g reads kv head kvh. On the card the kernel
    reads the tensors through their strides and writes a (B,S,KVH,G,D)
    buffer: no transpose or pad is copied, and no view is made."""
    qg, k, v = _head_contiguous(qg), _head_contiguous(k), _head_contiguous(v)
    if qg.is_cuda:
        return flash_attention_grouped(qg, k, v, causal=causal,
                                       window=window)
    B, S, KVH, G, D = qg.shape
    q = qg.reshape(B, S, KVH * G, D).transpose(1, 2)
    o = flash_attention_hsd(q, k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, window=window)
    return o.transpose(1, 2).reshape(B, S, KVH, G, D)
