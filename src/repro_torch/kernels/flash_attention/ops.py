"""Public wrapper matching the model's (B,S,KVH,G,D) layout."""
from repro_torch.kernels.flash_attention.kernel import flash_attention_hsd


def _head_contiguous(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention(qg, k, v, *, causal=True, window=0):
    """qg: (B,S,KVH,G,D); k,v: (B,S,KVH,D). Returns (B,S,KVH,G,D).

    Folds (KVH,G) into H as h = kvh*G + g, so head h reads kv head
    h // G, and hands the kernel (B,H,S,D) views: no transpose or pad
    is copied."""
    B, S, KVH, G, D = qg.shape
    q = _head_contiguous(qg).reshape(B, S, KVH * G, D).transpose(1, 2)
    o = flash_attention_hsd(q, _head_contiguous(k).transpose(1, 2),
                            _head_contiguous(v).transpose(1, 2),
                            causal=causal, window=window)
    return o.transpose(1, 2).reshape(B, S, KVH, G, D)
