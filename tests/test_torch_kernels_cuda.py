"""The port's Hopper kernels against their plain PyTorch versions, on a
card. Marked `cuda`; each test skips when torch sees no CUDA device (the
kernels have no CPU mode). This file imports no JAX, so it runs on a
machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances are those of tests/test_kernels.py: 2e-5 for f32 (every
product and sum in f32, TF32 off), 3e-2 for bf16 inputs."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_hsd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash_attention_hsd.launches = 0
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("B,KVH,G,S,D,causal,window", [
    (32, 2, 2, 4, 64, True, 0),      # the serving shape
    (2, 2, 2, 384, 64, True, 0),     # ragged against any 128 tile
    (1, 1, 4, 256, 64, True, 64),    # sliding window
    (2, 1, 2, 96, 32, False, 0),     # non-causal
    (1, 1, 2, 512, 256, True, 0),    # D = 256: dynamic shared memory
    (3, 2, 2, 37, 128, True, 5)])    # odd S, window below one tile
def test_flash_attention_matches_plain(cuda, B, KVH, G, S, D, causal,
                                       window, dtype, tol):
    rng = np.random.default_rng(5)
    qg, k, v = (torch.tensor(rng.standard_normal(shape).astype(np.float32),
                             device=cuda).to(getattr(torch, dtype))
                for shape in ((B, S, KVH, G, D), (B, S, KVH, D),
                              (B, S, KVH, D)))
    out = flash_attention(qg, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_hsd.launches == 1
    q = qg.reshape(B, S, KVH * G, D).transpose(1, 2)
    ref = attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window)
    ref = ref.transpose(1, 2).reshape(B, S, KVH, G, D)
    assert out.dtype == qg.dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_attention_valid_len_and_strides(cuda):
    """`valid_len` masks keys at or past it; q, k, v may be strided views
    with a contiguous head dim."""
    rng = np.random.default_rng(6)
    base = torch.tensor(rng.standard_normal((2, 3, 40, 64)).astype(
        np.float32), device=cuda)
    q = base[:, :2].permute(0, 2, 1, 3).transpose(1, 2)  # (2,2,40,64) view
    kv = torch.tensor(rng.standard_normal((2, 1, 40, 64)).astype(
        np.float32), device=cuda)
    out = flash_attention_hsd(q, kv, kv, causal=False, valid_len=29)
    ref = attention_ref(q, kv, kv, causal=False, valid_len=29)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["head_dim", "dtype", "groups"])
def test_flash_attention_refuses_what_it_does_not_take(cuda, bad):
    shapes = {"head_dim": ((1, 2, 8, 48), (1, 1, 8, 48)),
              "dtype": ((1, 2, 8, 64), (1, 1, 8, 64)),
              "groups": ((1, 3, 8, 64), (1, 2, 8, 64))}[bad]
    dt = torch.float16 if bad == "dtype" else torch.float32
    q = torch.zeros(shapes[0], device=cuda, dtype=dt)
    k = torch.zeros(shapes[1], device=cuda, dtype=dt)
    with pytest.raises(ValueError):
        flash_attention_hsd(q, k, k)
    assert flash_attention_hsd.launches == 0
