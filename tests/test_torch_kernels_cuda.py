"""The port's Hopper kernels against their plain PyTorch versions, on a
card. Marked `cuda`; each test skips when torch sees no CUDA device (the
kernels have no CPU mode). This file imports no JAX, so it runs on a
machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Attention tolerances are those of tests/test_kernels.py: 2e-5 for f32
(every product and sum in f32, TF32 off), 3e-2 for bf16 inputs. The scans
(discounted return, its adjoint, V-trace) are f32 throughout; nvcc
contracts `b + c·acc` into one FMA where the plain loop rounds twice, and
the discounted-return kernels compose the steps' maps in parallel over
time, so they are held to rtol = atol = 1e-5 at T <= 128 and 1e-4 at
T = 2048, where the rounding differences of 2048 chained steps add up. The replay
draw's indices must equal the plain draw's exactly (its logits and scores
round as the plain version's do) and its weights agree within
rtol = atol = 1e-5 (the partition function is summed in another order),
ties forced. The per-shard draw of the sharded replay service must
equal its plain version bitwise, indices and scores. The grouped matmul sums f32 products in another order than
the plain einsum: f32 is held to rtol = 1e-4 with atol = 1e-4 x max|ref|;
bf16 outputs against the f32 product of the same bf16 inputs to rtol =
2^-8 (the output's rounding to bf16) with the same atol. The MoE layer on
the card, kernel against use_kernels=False, is held to the same bf16
bounds on the layer output. The chunked WKV is held to its plain version
(the per-step scan), y and the final state, within atol = 2e-4,
rtol = 1e-3, the reference's own (tests/test_kernels.py: the same f32
recurrence blocked in chunks), with bf16 r, k, v, u held against the
plain version on their f32 values; the RWKV time mix on the card, kernel
against use_kernels=False, to the MoE layer's bf16 bounds."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels.advantages.kernel import (
    DiscountedReturn, discounted_return_adjoint_tb, discounted_return_tb)
from repro_torch.kernels.advantages.ref import (
    discounted_return_adjoint_ref, discounted_return_ref)
from repro_torch.kernels.flash_attention.kernel import flash_attention_hsd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gmm.kernel import gmm_ecd
from repro_torch.kernels.gmm.ref import gmm_ref
from repro_torch.kernels.replay_sample.kernel import (prioritized_sample_c,
                                                      shard_topk_c)
from repro_torch.kernels.replay_sample.ref import (
    prioritized_sample_ref, shard_gumbel_topk_stack_ref)
from repro_torch.kernels.vtrace.kernel import vtrace_tb
from repro_torch.kernels.vtrace.ref import vtrace_ref

# (T, B): the training path's, a wide batch, a long horizon
SCAN_SHAPES = [(32, 32), (32, 4096), (2048, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash_attention_hsd.launches = 0
    gmm_ecd.launches = 0
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


# (B, KVH, G, S, D) of the LM zoo's prefills (batch 4, prompt 32): gemma3
# (D = 256, one kv head), stablelm (MHA), whisper's decoder, paligemma's
# 288 tokens (256 patches + 32: a ragged tail at D = 256, one kv head),
# jamba, llama4 (40 query heads over 8)
ZOO_FLASH = [(4, 1, 4, 32, 256), (4, 32, 1, 32, 64), (4, 8, 1, 32, 64),
             (4, 1, 8, 288, 256), (4, 8, 4, 32, 128), (4, 8, 5, 32, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("B,KVH,G,S,D", ZOO_FLASH)
def test_flash_attention_zoo_prefill_shapes(cuda, B, KVH, G, S, D, dtype,
                                            tol):
    rng = np.random.default_rng(S + D + G)
    qg, k, v = (torch.tensor(rng.standard_normal(shape).astype(np.float32),
                             device=cuda).to(getattr(torch, dtype))
                for shape in ((B, S, KVH, G, D), (B, S, KVH, D),
                              (B, S, KVH, D)))
    out = flash_attention(qg, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_hsd.launches == 1
    q = qg.reshape(B, S, KVH * G, D).transpose(1, 2)
    ref = attention_ref(q, k.transpose(1, 2), v.transpose(1, 2), causal=True)
    ref = ref.transpose(1, 2).reshape(B, S, KVH, G, D)
    assert out.dtype == qg.dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.equal(flash_attention(qg, k, v, causal=True), out)


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


@pytest.mark.cuda
def test_flash_attention_refuses_to_cut_the_gradient(cuda):
    """The kernel has no backward yet: an input that requires grad under
    grad mode raises instead of training without an attention gradient;
    under no_grad it runs."""
    q = torch.randn((1, 2, 8, 64), device=cuda, requires_grad=True)
    k = torch.randn((1, 1, 8, 64), device=cuda)
    with pytest.raises(RuntimeError, match="backward"):
        flash_attention_hsd(q, k, k)
    assert flash_attention_hsd.launches == 0
    with torch.no_grad():
        flash_attention_hsd(q, k, k)
    assert flash_attention_hsd.launches == 1


def _bf16_qkv(shape_q, shape_kv, device, seed):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device=device).to(torch.bfloat16)
            for shape in (shape_q, shape_kv, shape_kv))


# bf16 on the tensor cores at every head dim, G = 1, 3 and 8 query heads
# per kv head (the rows of a block are (query, head) pairs), ragged S: one
# row, one past a 16-row warp tile, one past 32, one past two 64-key tiles
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 17, 33, 130])
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_attention_bf16_matches_plain(cuda, D, G, S):
    B, KVH = 2, 2
    qg, k, v = _bf16_qkv((B, S, KVH, G, D), (B, S, KVH, D), cuda, D + S + G)
    out = flash_attention(qg, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_hsd.launches == 1
    q = qg.reshape(B, S, KVH * G, D).transpose(1, 2)
    ref = attention_ref(q, k.transpose(1, 2), v.transpose(1, 2), causal=True)
    ref = ref.transpose(1, 2).reshape(B, S, KVH, G, D)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2,
                               rtol=3e-2)
    assert torch.equal(flash_attention(qg, k, v, causal=True), out)


# windows below, across and above the 64-key tile, non-causal, and
# valid_len cutting the keys, each in bf16 (B, H, S, D) views
@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("causal,window,valid_len", [
    (True, 5, None), (True, 70, None), (True, 300, None),
    (False, 0, None), (False, 0, 77), (True, 0, 100), (True, 40, 140)])
def test_flash_attention_bf16_masks(cuda, D, causal, window, valid_len):
    B, KVH, G, S = 2, 2, 3, 150
    q, k, v = _bf16_qkv((B, KVH * G, S, D), (B, KVH, S, D), cuda, D + S)
    out = flash_attention_hsd(q, k, v, causal=causal, window=window,
                              valid_len=valid_len)
    ref = attention_ref(q, k, v, causal=causal, window=window,
                        valid_len=valid_len)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2,
                               rtol=3e-2)


# strided views: 16-byte strides take the tensor cores, odd element
# strides the CUDA-core kernel; both read the operands where they lie
@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("offset", [0, 8, 3])
def test_flash_attention_bf16_strided(cuda, D, offset):
    B, KVH, G, S = 2, 2, 3, 70
    rng = np.random.default_rng(D + offset)
    base = torch.tensor(rng.standard_normal(
        (B, S, KVH, G + 2, D + 16)).astype(np.float32),
        device=cuda).to(torch.bfloat16)
    qg = base[:, :, :, 1:G + 1, offset:offset + D]      # (B,S,KVH,G,D)
    kv = base[:, :, :, 0, offset:offset + D]            # (B,S,KVH,D)
    vv = base[:, :, :, G + 1, offset:offset + D]
    assert not qg.is_contiguous()
    out = flash_attention(qg, kv, vv, causal=True)
    q = qg.reshape(B, S, KVH * G, D).transpose(1, 2)
    ref = attention_ref(q, kv.transpose(1, 2), vv.transpose(1, 2),
                        causal=True)
    ref = ref.transpose(1, 2).reshape(B, S, KVH, G, D)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2,
                               rtol=3e-2)


def _f32_qkv(shape_q, shape_kv, device, seed):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device=device)
            for shape in (shape_q, shape_kv, shape_kv))


def _flash_kernel_names(fn):
    """The device kernels one call of fn runs, by torch.profiler (a window
    that lost kernel records is run again: `profiling.kernel_us`)."""
    from repro_torch.launch.profiling import kernel_us
    times, launches = kernel_us(fn, calls=1)
    assert times is not None, "every profiler window lost kernel records"
    return list(launches)


# f32 with every key range inside one tile of 32 (the policy trunk's
# calls: S = 4 and 3, G = 2, D = 64) takes the short-span kernel
# flash_short_f32: S from one key to 32, G = 1 to 4 query heads a kv head
# (blocks gather several groups where S * G <= 4, split a group's rows
# in tiles of 16 past 16), every head dim
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 3, 4, 7, 16, 31, 32])
@pytest.mark.parametrize("G", [1, 2, 3, 4])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_f32_short_span_matches_plain(cuda, D, G, S):
    B, KVH = 3, 2
    qg, k, v = _f32_qkv((B, S, KVH, G, D), (B, S, KVH, D), cuda, D + S + G)
    out = flash_attention(qg, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_hsd.launches == 1
    q = qg.reshape(B, S, KVH * G, D).transpose(1, 2)
    ref = attention_ref(q, k.transpose(1, 2), v.transpose(1, 2), causal=True)
    ref = ref.transpose(1, 2).reshape(B, S, KVH, G, D)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    assert torch.equal(flash_attention(qg, k, v, causal=True), out)


@pytest.mark.cuda
@pytest.mark.parametrize("S,kernel", [(4, "flash_short_reg_f32"),
                                      (5, "flash_short_f32"),
                                      (32, "flash_short_f32"),
                                      (33, "flash_fwd")])
def test_flash_f32_takes_the_short_kernel_up_to_32_keys(cuda, S, kernel):
    """Up to 32 keys the f32 call runs a short-span kernel (up to 4 keys
    at D <= 128 the one that keeps Q, K and V in registers); a span of 33
    keys runs flash_fwd<float>, one launch either way."""
    B, KVH, G, D = 2, 2, 2, 64
    qg, k, v = _f32_qkv((B, S, KVH, G, D), (B, S, KVH, D), cuda, S)
    names = _flash_kernel_names(lambda: flash_attention(qg, k, v))
    assert len(names) == 1 and kernel in names[0]
    if kernel == "flash_fwd":
        assert "flash_short" not in names[0]
    q = qg.reshape(B, S, KVH * G, D).transpose(1, 2)
    ref = attention_ref(q, k.transpose(1, 2), v.transpose(1, 2), causal=True)
    torch.testing.assert_close(
        flash_attention(qg, k, v),
        ref.transpose(1, 2).reshape(B, S, KVH, G, D), atol=2e-5, rtol=2e-5)


def _short_and_flash_fwd_outputs(cuda, S, G, D):
    """One call's output from the short-span kernel (kind 2) and from
    flash_fwd<float> (kind 0) on the same inputs."""
    from repro_torch.kernels.flash_attention import kernel as fk
    B, KVH = 2, 2
    qg, k, v = (30 * t for t in _f32_qkv((B, S, KVH, G, D), (B, S, KVH, D),
                                         cuda, S + G + D))
    outs = []
    for kind in (2, 0):  # flash_short_f32, flash_fwd<float>
        out = torch.empty_like(qg)
        fields = list(fk.PARAMS.unpack(fk.grouped_params(qg, k, v, out, True,
                                                         0)))
        assert fields[4] == 2
        fields[4] = kind
        fk._launch(fk.PARAMS.pack(*fields), qg.device)
        outs.append(out)
    torch.cuda.synchronize()
    return outs


# 17-32 keys: one key a lane, one FMA chain over d with q scaled first,
# flash_fwd's butterflies: the short-span kernel gives flash_fwd's bits
# (the f32 LM agreement in chip_smoke.py amplifies any other rounding)
@pytest.mark.cuda
@pytest.mark.parametrize("S,G,D", [(17, 1, 128), (32, 1, 128), (32, 3, 64),
                                   (24, 2, 32), (32, 1, 256)])
def test_flash_f32_short_span_gives_flash_fwd_bits_past_16_keys(cuda, S, G,
                                                                 D):
    short, fwd = _short_and_flash_fwd_outputs(cuda, S, G, D)
    assert torch.equal(short, fwd)


# flash_short_f32 takes one key a lane at every span it runs (5-32 keys,
# and up to 4 at D = 256): flash_fwd's bits there too
@pytest.mark.cuda
@pytest.mark.parametrize("S,G,D", [(5, 2, 64), (9, 1, 128), (16, 4, 32),
                                   (1, 1, 256), (3, 2, 256), (12, 3, 256)])
def test_flash_f32_short_span_gives_flash_fwd_bits_up_to_16_keys(cuda, S, G,
                                                                 D):
    short, fwd = _short_and_flash_fwd_outputs(cuda, S, G, D)
    assert torch.equal(short, fwd)


# the short-span kernel's masks, (B, H, S, D) views: windows below and
# above the span, non-causal, and valid_len cutting a longer S to at most
# 32 keys (the rows past it still attend the first valid_len keys)
@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("S,causal,window,valid_len", [
    (20, True, 5, None), (20, True, 40, None), (20, False, 0, None),
    (20, False, 0, 13), (100, False, 0, 32), (9, True, 4, 7)])
def test_flash_f32_short_span_masks(cuda, D, S, causal, window, valid_len):
    B, KVH, G = 2, 2, 3
    q, k, v = _f32_qkv((B, KVH * G, S, D), (B, KVH, S, D), cuda, D + S)
    out = flash_attention_hsd(q, k, v, causal=causal, window=window,
                              valid_len=valid_len)
    ref = attention_ref(q, k, v, causal=causal, window=window,
                        valid_len=valid_len)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


# strided views: 16-byte strides take 16-byte copies, odd element strides
# 4-byte ones; both read the operands where they lie
@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 256])
@pytest.mark.parametrize("offset", [0, 4, 3])
@pytest.mark.parametrize("S", [3, 4, 17])
def test_flash_f32_short_span_strided(cuda, D, offset, S):
    B, KVH, G = 5, 2, 2
    rng = np.random.default_rng(D + offset + S)
    base = torch.tensor(rng.standard_normal(
        (B, S, KVH, G + 2, D + 8)).astype(np.float32), device=cuda)
    qg = base[:, :, :, 1:G + 1, offset:offset + D]
    kv = base[:, :, :, 0, offset:offset + D]
    vv = base[:, :, :, G + 1, offset:offset + D]
    assert not qg.is_contiguous()
    out = flash_attention(qg, kv, vv, causal=True)
    q = qg.reshape(B, S, KVH * G, D).transpose(1, 2)
    ref = attention_ref(q, kv.transpose(1, 2), vv.transpose(1, 2),
                        causal=True)
    torch.testing.assert_close(
        out, ref.transpose(1, 2).reshape(B, S, KVH, G, D), atol=2e-5,
        rtol=2e-5)
    assert torch.equal(flash_attention(qg.contiguous(), kv.contiguous(),
                                       vv.contiguous(), causal=True), out)


def _scan_tol(T):
    return 1e-5 if T <= 128 else 1e-4


def _scan_inputs(T, B, cuda, seed=7):
    g = torch.Generator(device=cuda).manual_seed(seed)
    base = torch.randn((T, B), generator=g, device=cuda)
    coef = 0.99 * torch.rand((T, B), generator=g, device=cuda)
    init = torch.randn((B,), generator=g, device=cuda)
    return base, coef, init


@pytest.fixture
def scans(cuda):
    for fn in (discounted_return_tb, discounted_return_adjoint_tb,
               vtrace_tb):
        fn.launches = 0
    return cuda


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", SCAN_SHAPES)
def test_discounted_return_matches_plain(scans, T, B):
    base, coef, init = _scan_inputs(T, B, scans)
    out = discounted_return_tb(base, coef, init)
    torch.cuda.synchronize()
    assert discounted_return_tb.launches == 1
    tol = _scan_tol(T)
    torch.testing.assert_close(out, discounted_return_ref(base, coef, init),
                               atol=tol, rtol=tol)
    # strided views (a transposed buffer) are read as they are
    out_t = discounted_return_tb(base.t().contiguous().t(), coef, init)
    torch.testing.assert_close(out_t, out, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", SCAN_SHAPES)
def test_adjoint_matches_plain_autograd(scans, T, B):
    """dbase, dcoef and dinit of the adjoint kernel against autograd
    through the plain forward, for a dense cotangent and for the
    expanded (stride 0) one a mean hands back."""
    tol = _scan_tol(T)
    inputs = _scan_inputs(T, B, scans)
    w = torch.randn((T, B), device=scans)
    for reduce in (lambda o: (o * w).sum(), lambda o: o.mean()):
        leaves = [t.clone().requires_grad_() for t in inputs]
        got = torch.autograd.grad(reduce(DiscountedReturn.apply(*leaves)),
                                  leaves)
        ref = [t.clone().requires_grad_() for t in inputs]
        want = torch.autograd.grad(reduce(discounted_return_ref(*ref)), ref)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=tol, rtol=tol)
    assert discounted_return_tb.launches == 2
    assert discounted_return_adjoint_tb.launches == 2


@pytest.mark.cuda
def test_adjoint_computes_only_what_is_needed(scans):
    base, coef, init = _scan_inputs(32, 32, scans)
    init.requires_grad_()
    DiscountedReturn.apply(base, coef, init).sum().backward()
    assert base.grad is None and coef.grad is None
    ref = init.detach().clone().requires_grad_()
    discounted_return_ref(base, coef, ref).sum().backward()
    torch.testing.assert_close(init.grad, ref.grad, atol=1e-5, rtol=1e-5)
    with pytest.raises(RuntimeError, match="DiscountedReturn"):
        discounted_return_tb(base, coef, init)


# ragged T (one pass of one row a lane, of 4, of 16; several passes)
# and B (a partial 8-column tile, one column; 1029: 32 columns a block)
SCAN_RAGGED = [(T, B) for T in (1, 7, 31, 32, 33, 100, 129, 513, 1100)
               for B in (1, 5, 8, 9, 33, 1029)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", SCAN_RAGGED)
def test_scans_ragged_strided_and_repeatable(scans, T, B):
    """Both scans against their plain versions at ragged T and B; strided
    inputs (a transposed buffer, every other column) and autograd's
    stride-0 cotangent give the same bits as contiguous copies; a second
    call gives the same bits; every subset of the adjoint's gradients
    gives the bits of the full call."""
    tol = _scan_tol(T)
    base, coef, init = _scan_inputs(T, B, scans, seed=T + B)
    g = torch.randn((T, B), device=scans)
    out = discounted_return_tb(base, coef, init)
    torch.testing.assert_close(out, discounted_return_ref(base, coef, init),
                               atol=tol, rtol=tol)
    assert torch.equal(discounted_return_tb(base, coef, init), out)
    wide = torch.randn((T, 2 * B), device=scans)
    wide[:, ::2] = base
    for strided in (base.t().contiguous().t(), wide[:, ::2]):
        assert torch.equal(discounted_return_tb(strided, coef, init), out)
    full = discounted_return_adjoint_tb(g, coef, out, init)
    want = discounted_return_adjoint_ref(g, coef, out, init)
    for a, b in zip(full, want):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)
    again = discounted_return_adjoint_tb(g, coef.t().contiguous().t(), out,
                                         init)
    assert all(torch.equal(a, b) for a, b in zip(again, full))
    for need in itertools.product((False, True), repeat=3):
        got = discounted_return_adjoint_tb(g, coef, out, init, need=need)
        for a, b, n in zip(got, full, need):
            assert (a is None) if not n else torch.equal(a, b)
    ones = torch.ones((), device=scans).expand(T, B)  # stride 0
    dense = discounted_return_adjoint_tb(ones.contiguous(), coef, out, init)
    expanded = discounted_return_adjoint_tb(ones, coef, out, init)
    assert all(torch.equal(a, b) for a, b in zip(expanded, dense))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", SCAN_SHAPES)
def test_vtrace_matches_plain(scans, T, B):
    g = torch.Generator(device=scans).manual_seed(3)
    log_rhos = 0.5 * torch.randn((T, B), generator=g, device=scans)
    discounts = 0.99 * (torch.rand((T, B), generator=g, device=scans)
                        > 0.05).float()
    rewards, values = (torch.randn((T, B), generator=g, device=scans)
                       for _ in range(2))
    boot = torch.randn((B,), generator=g, device=scans)
    vs, adv = vtrace_tb(log_rhos, discounts, rewards, values, boot)
    torch.cuda.synchronize()
    assert vtrace_tb.launches == 1
    r_vs, r_adv = vtrace_ref(log_rhos, discounts, rewards, values, boot)
    tol = _scan_tol(T)
    torch.testing.assert_close(vs, r_vs, atol=tol, rtol=tol)
    torch.testing.assert_close(adv, r_adv, atol=tol, rtol=tol)


def _vtrace_inputs(T, B, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    log_rhos = 0.7 * torch.randn((T, B), generator=g, device=device)
    dones = torch.rand((T, B), generator=g, device=device) < 0.1
    dones[T - 1, ::2] = True
    discounts = 0.99 * (~dones).float()
    rewards, values = (torch.randn((T, B), generator=g, device=device)
                       for _ in range(2))
    boot = torch.randn((B,), generator=g, device=device)
    return log_rhos, discounts, rewards, values, boot


# ragged T (the short kernel's 1..32; the tiled kernel's one pass of 4
# rows a lane and several passes of 16) and B (one column, partial
# 32-column and 8-column blocks, and past 4096)
VTRACE_RAGGED = [(T, B) for T in (1, 3, 31, 32, 33, 127, 128, 129, 513,
                                  2048) for B in (1, 31, 33, 4097)]


def _vtrace_carried(log_rhos, discounts, rewards, values, boot, clip_rho,
                    clip_c):
    """The magnitude each output carries through the recurrence, in f64:
    for vs_t the same recurrence over |delta| (sum over s >= t of
    |delta_s| times the coefficients g c between), for pg_adv_t rho_t g_t
    times that at t + 1. An f32 evaluation in any order errs by a few
    units of roundoff of it."""
    lr, g, r, v, bt = (a.double() for a in (log_rhos, discounts, rewards,
                                            values, boot))
    e = torch.exp(lr)
    rho = e.clamp(max=clip_rho)
    delta = rho * (r + g * torch.cat([v[1:], bt[None]]) - v)
    m = discounted_return_ref(delta.abs(), g * e.clamp(max=clip_c),
                              torch.zeros_like(bt))
    return m, rho * g * torch.cat([m[1:], torch.zeros_like(bt)[None]])


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", VTRACE_RAGGED)
def test_vtrace_ragged_strided_and_repeatable(scans, T, B):
    """V-trace against its plain version at ragged T and B with the clips
    (1, 1), (2, 0.5) and (0.5, 2) and discounts 0 at dones; one launch a
    call; a second call, strided inputs (a transposed buffer, every other
    column, every third bootstrap) and stride-0 ones (a broadcast
    discount row, a broadcast bootstrap) give the bits of contiguous
    copies.

    With c̄ <= 1 the recurrence contracts and both outputs are held to
    scan_tol. With c̄ = 2 its coefficients g c reach 1.98 and |vs| grows
    to ~3e4 over 127 steps; there no f32 evaluation holds scan_tol
    element by element where an output cancels to O(1) (the plain
    version itself lies up to 2.7x scan_tol from its own f64 value at
    T = 128, B = 4097), so the bound is scan_tol relative to the output
    plus the magnitude it carries (`_vtrace_carried`): the kernel's
    reorder stays within ~3% of it, and an error of 1e-3 of that
    magnitude would exceed it 100-fold."""
    tol = _scan_tol(T)
    args = _vtrace_inputs(T, B, scans, seed=T + B)
    for clip_rho, clip_c in ((1.0, 1.0), (2.0, 0.5)):
        got = vtrace_tb(*args, clip_rho=clip_rho, clip_c=clip_c)
        want = vtrace_ref(*args, clip_rho=clip_rho, clip_c=clip_c)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=tol, rtol=tol)
    got = vtrace_tb(*args, clip_rho=0.5, clip_c=2.0)
    want = vtrace_ref(*args, clip_rho=0.5, clip_c=2.0)
    for a, b, m in zip(got, want, _vtrace_carried(*args, 0.5, 2.0)):
        err = (a - b).abs().double()
        assert bool((err <= tol + tol * (b.abs().double() + m)).all())
    assert vtrace_tb.launches == 3
    log_rhos, discounts, rewards, values, boot = args
    out = vtrace_tb(*args)
    assert all(torch.equal(a, b) for a, b in zip(vtrace_tb(*args), out))
    wide = torch.randn((T, 2 * B), device=scans)
    wide[:, ::2] = rewards
    boots = torch.randn((3 * B,), device=scans)
    boots[::3] = boot
    strided = vtrace_tb(log_rhos.t().contiguous().t(), discounts,
                        wide[:, ::2], values.t().contiguous().t(),
                        boots[::3])
    assert all(torch.equal(a, b) for a, b in zip(strided, out))
    row = torch.full((), 0.99, device=scans).expand(T, B)  # stride 0
    one = boot[:1].expand(B)
    dense = vtrace_tb(log_rhos, row.contiguous(), rewards, values,
                      one.contiguous())
    expanded = vtrace_tb(log_rhos, row, rewards, values, one)
    assert all(torch.equal(a, b) for a, b in zip(expanded, dense))


@pytest.mark.cuda
@pytest.mark.parametrize("algo_kwargs", [{}, {"use_vtrace": False}])
def test_impala_learner_step_kernel_matches_plain(scans, algo_kwargs):
    """One IMPALA learner_step on the card from one state and trajectory:
    by default it launches the V-trace kernel once (the naive branch, the
    discounted-return kernel once), with use_kernel=False nothing, and
    the params agree within 1e-5."""
    import repro_torch.envs as envs
    from repro_torch.core import agent as agent_api
    from repro_torch.core.rollout import rollout_fresh
    env = envs.make("cartpole")
    kern = agent_api.make("impala", env=env, **algo_kwargs)
    plain = agent_api.make("impala", env=env, use_kernel=False,
                           **algo_kwargs)
    state = kern.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=scans).manual_seed(1)
    traj, env_state = rollout_fresh(kern.policy, kern.actor_policy(state, 0),
                                    env, gen, 32, 32)
    boot = env.obs(env_state)
    a, la = kern.learner_step(state, traj, boot)
    counts = (vtrace_tb.launches, discounted_return_tb.launches)
    assert counts == ((0, 1) if algo_kwargs else (1, 0))
    b, lb = plain.learner_step(state, traj, boot)
    assert (vtrace_tb.launches, discounted_return_tb.launches) == counts
    torch.testing.assert_close(la["loss"], lb["loss"], atol=1e-5, rtol=1e-5)
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], atol=1e-5,
                                   rtol=1e-5)


# (C, size, n): the DQN path's, a full 1M buffer, nearly empty, odd C,
# empty, n > size, and n above one tile's filled slots
REPLAY_CASES = [(20000, 12800, 64), (1048576, 1048576, 256),
                (4096, 10, 64), (131, 100, 1), (4096, 0, 16), (64, 10, 32),
                (9000, 4100, 1024)]


def _replay_inputs(C, size, ties, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    prio = torch.randn((C,), generator=g, device=device).abs() + 0.01
    u = torch.rand((C,), generator=g, device=device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    if ties:
        prio[1::7] = prio[0]
        gumbel[1::7] = gumbel[0]
    return prio, gumbel, torch.tensor([size], dtype=torch.int32,
                                      device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("C,size,n", REPLAY_CASES)
def test_replay_sample_matches_plain(cuda, C, size, n, ties):
    prio, gumbel, s = _replay_inputs(C, size, ties, cuda)
    prioritized_sample_c.launches = 0
    idx, w = prioritized_sample_c(prio, gumbel, s, n)
    torch.cuda.synchronize()
    assert prioritized_sample_c.launches == 1
    ridx, rw = prioritized_sample_ref(prio, s[0], gumbel, n)
    assert idx.dtype == torch.int32 and torch.equal(idx, ridx)
    torch.testing.assert_close(w, rw, atol=1e-5, rtol=1e-5)
    assert int(idx.max()) < max(size, 1)


# (C, size, n, kind) for the flat draw on the radix select: a tie group
# straddling the n-th place, all-equal priorities, sizes 0, 1, n - 1 and n,
# C = 16384 (one launch) and 16385 (two levels), a buffer filled past one
# 16384-slot tile (the candidates merge across levels), n = 1024
FLAT_SELECT_CASES = [
    (20000, 12800, 64, "straddle"), (40000, 40000, 256, "straddle"),
    (20000, 12800, 64, "equal"), (40000, 30000, 128, "equal"),
    (20000, 0, 64, "random"), (20000, 1, 64, "random"),
    (20000, 63, 64, "random"), (20000, 64, 64, "random"),
    (16384, 16384, 64, "random"), (16385, 16385, 64, "random"),
    (16385, 16384, 1024, "random"), (20000, 20000, 1024, "straddle"),
    (50000, 1024, 1024, "random"), (1024, 1024, 1024, "random"),
]


def _flat_select_inputs(C, size, n, kind, device):
    prio, gumbel, s = _replay_inputs(C, size, False, device, seed=3)
    if kind == "equal":
        prio.fill_(0.5)
        gumbel.fill_(0.25)
    elif kind == "straddle" and size >= n + 24:  # 8 equal at n-1 .. n+20
        order = prioritized_sample_ref(prio, s[0], gumbel, size)[0].long()
        group = order[n + 3 * torch.arange(1, 8, device=device)]
        prio[group] = prio[order[n - 1]].item()
        gumbel[group] = gumbel[order[n - 1]].item()
    return prio, gumbel, s


@pytest.mark.cuda
@pytest.mark.parametrize("C,size,n,kind", FLAT_SELECT_CASES)
def test_replay_sample_select_edges(cuda, C, size, n, kind):
    """The flat draw's select at its edges: indices equal the plain
    draw's (a stable descending sort), weights within rtol = atol = 1e-5,
    one op launch a call, bitwise repeatable."""
    prio, gumbel, s = _flat_select_inputs(C, size, n, kind, cuda)
    prioritized_sample_c.launches = 0
    idx, w = prioritized_sample_c(prio, gumbel, s, n)
    torch.cuda.synchronize()
    assert prioritized_sample_c.launches == 1
    ridx, rw = prioritized_sample_ref(prio, s[0], gumbel, n)
    assert torch.equal(idx, ridx)
    torch.testing.assert_close(w, rw, atol=1e-5, rtol=1e-5)
    again = prioritized_sample_c(prio, gumbel, s, n)
    assert torch.equal(again[0], idx) and torch.equal(again[1], w)
    if kind == "straddle" and size >= n + 24:  # ties cross the n-th place
        full = prioritized_sample_ref(prio, s[0], gumbel, n + 1)[0].long()
        scores = 0.6 * torch.log(prio + 1e-6) + gumbel
        assert scores[full[n - 1]] == scores[full[n]]


@pytest.mark.cuda
def test_replay_sample_repeats_calls_bitwise(cuda):
    """No float atomics: two draws on the same inputs are bitwise equal."""
    prio, gumbel, s = _replay_inputs(300000, 250000, True, cuda, seed=1)
    a = prioritized_sample_c(prio, gumbel, s, 128)
    b = prioritized_sample_c(prio, gumbel, s, 128)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["n_above_C", "float64", "strided",
                                 "size_int64"])
def test_replay_sample_refuses_what_it_does_not_take(cuda, bad):
    prio, gumbel, s = _replay_inputs(256, 200, False, cuda)
    n = 16
    if bad == "n_above_C":
        n = 257
    elif bad == "float64":
        prio = prio.double()
    elif bad == "strided":
        prio = torch.stack([prio, prio], 1)[:, 0]
    else:
        s = s.long()
    prioritized_sample_c.launches = 0
    with pytest.raises(ValueError, match="prioritized_sample_c"):
        prioritized_sample_c(prio, gumbel, s, n)
    assert prioritized_sample_c.launches == 0


@pytest.mark.cuda
def test_dqn_learner_step_kernel_matches_plain(cuda):
    """One DQN learner_step, the replay kernel against the plain draw,
    from one state, trajectory and Gumbel vector."""
    import repro_torch.envs as envs
    from repro_torch.core import agent as agent_api
    from repro_torch.core.rollout import rollout_fresh
    env = envs.make("cartpole")
    kern = agent_api.make("dqn", env=env, total_iters=60, warmup=0,
                          replay_capacity=4096)
    plain = agent_api.make("dqn", env=env, total_iters=60, warmup=0,
                           replay_capacity=4096, use_kernel=False)
    state = kern.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    traj, env_state = rollout_fresh(kern.policy, kern.actor_policy(state, 0),
                                    env, gen, 32, 32)
    g = kern.replay.noise(gen, kern.batch_size)
    prioritized_sample_c.launches = 0
    a, la = kern.learner_step_noise(state, traj, env.obs(env_state), g)
    assert prioritized_sample_c.launches == 1
    b, lb = plain.learner_step_noise(state, traj, env.obs(env_state), g)
    assert prioritized_sample_c.launches == 1
    assert torch.equal(a.extra["replay"]["prio"], b.extra["replay"]["prio"])
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], atol=1e-6,
                                   rtol=1e-6)


# (R, chunk, local nvalids, k): the replay=2 and replay=4 DQN paths
# shapes (size 12800 of 20000), full and ragged 1M-slot shards with an
# empty one, k above the filled count, and k above the last tile's slots
SHARD_CASES = [(2, 10000, (10000, 2800), 64),
               (4, 5000, (5000, 5000, 2800, 0), 64),
               (4, 262144, (262144,) * 4, 256),
               (4, 1048576, (1048576, 1048576, 300000, 0), 256),
               (3, 100, (0, 5, 100), 64), (2, 5000, (5000, 4100), 1024),
               (1, 64, (10,), 64)]


def _shard_inputs(R, chunk, nvalid, ties, device, seed=0):
    prio, gumbel, _ = _replay_inputs(R * chunk, 0, False, device, seed)
    prio, gumbel = prio.view(R, chunk), gumbel.view(R, chunk)
    if ties:
        prio[:, 1::7] = prio[:, :1]
        gumbel[:, 1::7] = gumbel[:, :1]
    return prio, gumbel, torch.tensor(nvalid, dtype=torch.int32,
                                      device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("R,chunk,nvalid,k", SHARD_CASES)
def test_shard_topk_matches_plain(cuda, R, chunk, nvalid, k, ties):
    """Indices equal and scores bitwise: the kernel's scores round as the
    plain version's (__fmul_rn/__fadd_rn), and past each shard's count
    both give (-inf, position)."""
    prio, gumbel, nv = _shard_inputs(R, chunk, nvalid, ties, cuda)
    shard_topk_c.launches = 0
    s, idx = shard_topk_c(prio, gumbel, nv, k)
    torch.cuda.synchronize()
    assert shard_topk_c.launches == 1
    rs, ridx = shard_gumbel_topk_stack_ref(prio, nv, gumbel, k)
    assert idx.dtype == torch.int32 and s.shape == idx.shape == (R, k)
    assert torch.equal(idx, ridx) and torch.equal(s, rs)
    for r, n in enumerate(nvalid):
        tail = torch.arange(min(n, k), k, device=cuda, dtype=torch.int32)
        assert torch.equal(idx[r, min(n, k):], tail)
        assert torch.isneginf(s[r, min(n, k):]).all()


# (R, chunk, local counts, k, kind) for the radix select's edges: a tie
# group straddling the k-th place, shards whose filled slots all score
# the same, k = 1024 and k = chunk, chunks one slot past a 16384-slot tile
# (the last tile below k slots), counts of 0, 1 and k - 1, R = 1 and 7;
# chunks above 16384 slots take more than one select level
SELECT_CASES = [
    (2, 10000, (10000, 2800), 64, "straddle"),
    (4, 40000, (40000, 40000, 17000, 300), 256, "straddle"),
    (2, 10000, (10000, 2800), 64, "equal"),
    (3, 40000, (40000, 20000, 5), 128, "equal"),
    (2, 20000, (20000, 5000), 1024, "random"),
    (2, 1024, (1024, 1000), 1024, "random"),
    (3, 1000, (1000, 500, 0), 1000, "random"),
    (2, 16385, (16385, 16385), 64, "random"),
    (1, 16385, (16385,), 1024, "random"),
    (1, 32769, (32769,), 256, "straddle"),
    (3, 5000, (0, 1, 63), 64, "random"),
    (3, 40000, (0, 1, 255), 256, "random"),
    (1, 10000, (10000,), 64, "random"),
    (7, 5000, (5000, 0, 1, 4999, 2500, 63, 5000), 64, "straddle"),
]


def _select_inputs(R, chunk, counts, k, kind, device):
    prio, gumbel, nv = _shard_inputs(R, chunk, counts, False, device, seed=3)
    if kind == "equal":
        prio.fill_(0.5)
        gumbel.fill_(0.25)
    elif kind == "straddle":  # 8 equal scores at ranks k-1 .. k+6
        order = shard_gumbel_topk_stack_ref(prio, nv, gumbel, chunk)[1].long()
        for r, n in enumerate(counts):
            if n >= k + 24:
                pivot = order[r, k - 1]
                group = order[r, k + 3 * torch.arange(1, 8, device=device)]
                prio[r, group] = prio[r, pivot].item()
                gumbel[r, group] = gumbel[r, pivot].item()
    return prio, gumbel, nv


@pytest.mark.cuda
@pytest.mark.parametrize("R,chunk,counts,k,kind", SELECT_CASES)
def test_shard_topk_select_edges_bitwise(cuda, R, chunk, counts, k, kind):
    """The radix select at its edges: indices and score bits equal the
    plain version's (a stable descending sort), one op launch a call."""
    prio, gumbel, nv = _select_inputs(R, chunk, counts, k, kind, cuda)
    shard_topk_c.launches = 0
    s, idx = shard_topk_c(prio, gumbel, nv, k)
    torch.cuda.synchronize()
    assert shard_topk_c.launches == 1
    rs, ridx = shard_gumbel_topk_stack_ref(prio, nv, gumbel, k)
    assert torch.equal(idx, ridx)
    assert torch.equal(s.view(torch.int32), rs.view(torch.int32))
    if kind == "straddle":  # the tie group crosses the k-th place
        full = shard_gumbel_topk_stack_ref(prio, nv, gumbel, k + 1)[0]
        big = torch.tensor([n >= k + 24 for n in counts], device=cuda)
        assert torch.equal(full[big, k - 1], full[big, k])


@pytest.mark.cuda
def test_shard_topk_repeats_calls_bitwise(cuda):
    prio, gumbel, nv = _shard_inputs(4, 300000, (300000, 250000, 7, 0),
                                     True, cuda, seed=1)
    a = shard_topk_c(prio, gumbel, nv, 128)
    b = shard_topk_c(prio, gumbel, nv, 128)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["k_above_chunk", "float64", "strided",
                                 "nvalid_int64", "nvalid_shape"])
def test_shard_topk_refuses_what_it_does_not_take(cuda, bad):
    prio, gumbel, nv = _shard_inputs(2, 256, (200, 10), False, cuda)
    k = 16
    if bad == "k_above_chunk":
        k = 257
    elif bad == "float64":
        prio = prio.double()
    elif bad == "strided":
        prio = prio.t().contiguous().t()
    elif bad == "nvalid_int64":
        nv = nv.long()
    else:
        nv = nv[:1]
    shard_topk_c.launches = 0
    with pytest.raises(ValueError, match="shard_topk_c"):
        shard_topk_c(prio, gumbel, nv, k)
    assert shard_topk_c.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("R", [2, 4])
def test_sharded_dqn_learner_step_kernel_matches_plain(cuda, R):
    """One DQN learner_step through the sharded replay service, the
    per-shard kernel against its plain version, from one state,
    trajectory and Gumbel vector: bitwise, and the kernel step syncs
    nothing (sync debug mode "error")."""
    import repro_torch.envs as envs
    from repro_torch.core import agent as agent_api
    from repro_torch.core.replay_service import ShardedPrioritizedReplay
    from repro_torch.core.rollout import rollout_fresh
    env = envs.make("cartpole")
    kw = dict(total_iters=60, warmup=0, replay_capacity=4096)
    kern = agent_api.make("dqn", env=env, **kw)
    plain = agent_api.make("dqn", env=env, use_kernel=False, **kw)
    kern.replay = ShardedPrioritizedReplay(4096, "replay", R)
    plain.replay = ShardedPrioritizedReplay(4096, "replay", R,
                                            use_kernel=False)
    state = kern.init(torch.Generator().manual_seed(0))
    state = agent_api.TrainState(
        state.params, state.opt_state,
        {"replay": kern.replay.shard_state(state.extra["replay"])},
        state.ring, state.steps)
    gen = torch.Generator(device=cuda).manual_seed(1)
    traj, env_state = rollout_fresh(kern.policy, kern.actor_policy(state, 0),
                                    env, gen, 32, 32)
    boot = env.obs(env_state)
    g = kern.replay.noise(gen, kern.batch_size)
    shard_topk_c.launches = prioritized_sample_c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, _ = kern.learner_step_noise(state, traj, boot, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert shard_topk_c.launches == 1 and prioritized_sample_c.launches == 0
    b, _ = plain.learner_step_noise(state, traj, boot, g)
    assert shard_topk_c.launches == 1
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.extra["replay"]["prio"], b.extra["replay"]["prio"])


# (E, C, d, f): the LM serving path's (deepseek-moe-16b, batch 4, prompt
# 32: decode C = 8, prefill C = 15), ragged on every axis, C below the
# smallest C-tile, and the zoo's expert counts at narrow widths (jamba's
# 16 experts at its prefill C = 20 and decode C = 8, llama4's 128 at C = 8)
GMM_SHAPES = [(64, 8, 2048, 1408), (64, 8, 1408, 2048), (64, 15, 2048, 1408),
              (64, 15, 1408, 2048), (4, 70, 96, 130), (8, 16, 512, 64),
              (3, 3, 100, 37), (2, 40, 33, 7), (16, 20, 256, 896),
              (16, 8, 896, 256), (128, 8, 320, 512), (128, 8, 512, 320)]


def _gmm_inputs(E, C, d, f, dtype, device, seed=11):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((E, C, d), generator=gen, device=device)
    w = torch.randn((E, d, f), generator=gen, device=device) * d ** -0.5
    return x.to(dtype), w.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", GMM_SHAPES)
def test_gmm_matches_plain(cuda, E, C, d, f, dtype):
    x, w = _gmm_inputs(E, C, d, f, getattr(torch, dtype), cuda)
    out = gmm_ecd(x, w)
    torch.cuda.synchronize()
    assert gmm_ecd.launches == 1
    assert out.dtype == x.dtype and out.shape == (E, C, f)
    ref = gmm_ref(x.float(), w.float())
    atol = 1e-4 * float(ref.abs().max())
    rtol = 1e-4 if dtype == "float32" else 2.0 ** -8
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)
    if dtype == "bfloat16":  # and the plain version in the working type
        torch.testing.assert_close(out.float(), gmm_ref(x, w).float(),
                                   rtol=2.0 ** -7, atol=atol)


# (E, C, d, f) for the bf16 tensor-core kernel: C across the n8 tiles
# (1 and 8: one, 9 and 16: two, 17 and 33: four, the last in two C-tiles),
# d and f not multiples of 8 (plain-load staging), one expert
GMM_BF16_EDGES = [(4, C, 256, 384) for C in (1, 8, 9, 16, 17, 33)] + [
    (3, 20, 100, 130), (2, 9, 77, 61), (1, 15, 2048, 1408), (1, 1, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f", GMM_BF16_EDGES)
def test_gmm_bf16_edges_within_rtol_and_repeatable(cuda, E, C, d, f):
    x, w = _gmm_inputs(E, C, d, f, torch.bfloat16, cuda)
    out = gmm_ecd(x, w)
    torch.cuda.synchronize()
    assert gmm_ecd.launches == 1 and out.shape == (E, C, f)
    ref = gmm_ref(x.float(), w.float())
    torch.testing.assert_close(out.float(), ref, rtol=2.0 ** -8,
                               atol=1e-4 * float(ref.abs().max()))
    assert torch.equal(gmm_ecd(x, w), out)


@pytest.mark.cuda
def test_gmm_bf16_unaligned_rows(cuda):
    """x and w contiguous but 2 bytes off a 16-byte boundary: the same
    kernel stages them with plain loads."""
    x, w = _gmm_inputs(4, 8, 256, 384, torch.bfloat16, cuda)
    xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    ws = torch.empty(w.numel() + 1, dtype=w.dtype, device=cuda)
    xu, wu = xs[1:].view(x.shape), ws[1:].view(w.shape)
    xu.copy_(x)
    wu.copy_(w)
    assert xu.data_ptr() % 16 and wu.data_ptr() % 16
    assert torch.equal(gmm_ecd(xu, wu), gmm_ecd(x, w))


@pytest.mark.cuda
def test_gmm_repeats_calls_bitwise(cuda):
    x, w = _gmm_inputs(64, 15, 2048, 1408, torch.bfloat16, cuda)
    a, b = gmm_ecd(x, w), gmm_ecd(x, w)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["grad", "strided", "float64", "mixed",
                                 "shape"])
def test_gmm_refuses_what_it_does_not_take(cuda, bad):
    x, w = _gmm_inputs(4, 8, 64, 32, torch.float32, cuda)
    if bad == "grad":
        x.requires_grad_(True)
        err = RuntimeError
    else:
        err = ValueError
        if bad == "strided":
            x = x.transpose(1, 2).contiguous().transpose(1, 2)
        elif bad == "float64":
            x, w = x.double(), w.double()
        elif bad == "mixed":
            w = w.to(torch.bfloat16)
        else:
            w = w[:, :32]
    with pytest.raises(err):
        gmm_ecd(x, w)
    assert gmm_ecd.launches == 0


@pytest.mark.cuda
def test_moe_layer_kernel_matches_plain(cuda):
    """One deepseek-moe-16b MoE layer at full width in bf16 on the card:
    use_kernels (three gmm_ecd launches) against the model's einsum."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe as tmoe
    from repro_torch.models.layers import init_params
    cfg = get_config("deepseek-moe-16b")
    tmpl = tmoe.init_moe(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    flat = init_params(tmpl, gen, cuda, torch.bfloat16)
    p = {k: v for k, v in flat.items() if "/" not in k}
    p["shared"] = {k.split("/")[1]: v for k, v in flat.items() if "/" in k}
    x = torch.randn((4, 32, cfg.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        got, aux = tmoe.apply_moe(cfg, p, x, use_kernels=True)
        want, waux = tmoe.apply_moe(cfg, p, x, use_kernels=False)
    torch.cuda.synchronize()
    assert gmm_ecd.launches == 3 and torch.equal(aux, waux)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-2 * float(want.float().abs().max()))


# (B, T, H, N, chunk): the rwkv6-1.6b serve prefill, a prompt of eight
# chunks, the decode step, the reference's sweep (ragged last chunks)
WKV_SHAPES = [(4, 32, 32, 64, 64), (4, 512, 32, 64, 64), (4, 1, 32, 64, 1),
              (2, 100, 3, 16, 32), (1, 37, 1, 8, 16)]
WKV_TOL = dict(atol=2e-4, rtol=1e-3)


def _wkv_inputs(B, T, H, N, device, seed=13):
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    logw = -torch.exp(0.5 * randn(B, T, H, N))
    return (randn(B, T, H, N), randn(B, T, H, N), randn(B, T, H, N), logw,
            0.3 + 0.2 * randn(H, N), 0.2 * randn(B, H, N, N))


@pytest.fixture
def wkv(cuda):
    from repro_torch.kernels.wkv6.kernel import wkv6_btHN
    wkv6_btHN.launches = 0
    return wkv6_btHN


@pytest.mark.cuda
@pytest.mark.parametrize("zero_state", [False, True])
@pytest.mark.parametrize("B,T,H,N,chunk", WKV_SHAPES)
def test_wkv6_matches_plain(wkv, B, T, H, N, chunk, zero_state):
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    r, k, v, logw, u, s0 = _wkv_inputs(B, T, H, N, "cuda")
    if zero_state:  # the Pallas kernel's case: S starts at zero
        s0 = None
    # the kernel writes the final S over the state it is given
    y, S = wkv(r, k, v, logw, u, None if s0 is None else s0.clone(),
               chunk=chunk)
    torch.cuda.synchronize()
    assert wkv.launches == 1
    ry, rS = wkv6_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(y, ry, **WKV_TOL)
    torch.testing.assert_close(S, rS, **WKV_TOL)


@pytest.mark.cuda
def test_wkv6_in_place_and_repeatable(wkv):
    r, k, v, logw, u, s0 = _wkv_inputs(2, 100, 3, 16, "cuda")
    state = s0.clone()
    y, S = wkv(r, k, v, logw, u, state, chunk=32)
    assert S is state  # the final S written over the given state
    y2, S2 = wkv(r, k, v, logw, u, s0.clone(), chunk=32)
    assert torch.equal(y, y2) and torch.equal(S, S2)


@pytest.mark.cuda
def test_wkv6_decode_chain_equals_one_chunked_pass(wkv):
    """Token by token at chunk 1 (the decode step's blocking), carrying
    the state in place, gives the one chunked pass."""
    r, k, v, logw, u, s0 = _wkv_inputs(1, 12, 2, 64, "cuda")
    y_all, S_all = wkv(r, k, v, logw, u, s0.clone(), chunk=4)
    state = s0.clone()
    ys = [wkv(r[:, t:t + 1].contiguous(), k[:, t:t + 1].contiguous(),
              v[:, t:t + 1].contiguous(), logw[:, t:t + 1].contiguous(), u,
              state, chunk=1)[0] for t in range(12)]
    torch.testing.assert_close(torch.cat(ys, 1), y_all, **WKV_TOL)
    torch.testing.assert_close(state, S_all, **WKV_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["grad", "head_dim", "chunk", "strided",
                                 "float64", "bf16", "cpu_state", "shape"])
def test_wkv6_refuses_what_it_does_not_take(wkv, bad):
    N = 80 if bad == "head_dim" else 16
    r, k, v, logw, u, s0 = _wkv_inputs(1, 8, 2, N, "cuda")
    chunk = 65 if bad == "chunk" else 4
    err = ValueError
    if bad == "grad":
        r.requires_grad_(True)
        err = RuntimeError
    elif bad == "strided":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "float64":
        v = v.double()
    elif bad == "bf16":  # r, k, v and u may be bf16; logw may not
        logw = logw.to(torch.bfloat16)
    elif bad == "cpu_state":
        s0 = s0.cpu()
    elif bad == "shape":
        u = u[:1]
    with pytest.raises(err):
        wkv(r, k, v, logw, u, s0, chunk=chunk)
    assert wkv.launches == 0


# the kernel's paths and edges: T below, at and past one sub-chunk (16)
# and one chunk, ragged tails, 512 steps; chunk 1 (the streaming path)
# and 16, 32, 64; N below, at and not a multiple of a column slice
WKV_SWEEP_T = [1, 2, 15, 16, 17, 31, 32, 33, 64, 65, 100, 512]
WKV_SWEEP_CHUNK = [1, 16, 32, 64]


def _wkv_call_checked(wkv, r, k, v, logw, u, s0, chunk):
    """The kernel twice on the same inputs, each writing the final S over
    its own copy of s0 (or from zero): one launch a call, bitwise equal
    results. Returns (y, S)."""
    outs = []
    for _ in range(2):
        state = None if s0 is None else s0.clone()
        before = wkv.launches
        y, S = wkv(r, k, v, logw, u, state, chunk=chunk)
        torch.cuda.synchronize()
        assert wkv.launches == before + 1
        assert state is None or S is state  # written over the given state
        outs.append((y, S))
    (y, S), (y2, S2) = outs
    assert torch.equal(y, y2) and torch.equal(S, S2)
    return y, S


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 16, 64])
@pytest.mark.parametrize("chunk", WKV_SWEEP_CHUNK)
@pytest.mark.parametrize("T", WKV_SWEEP_T)
def test_wkv6_sweep(wkv, T, chunk, N):
    """Kernel against plain, from a nonzero state and from zero."""
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    r, k, v, logw, u, s0 = _wkv_inputs(2, T, 3, N, "cuda", seed=T + N)
    for state in (s0, None):
        y, S = _wkv_call_checked(wkv, r, k, v, logw, u, state, chunk)
        ry, rS = wkv6_ref(r, k, v, logw, u, state)
        torch.testing.assert_close(y, ry, **WKV_TOL)
        torch.testing.assert_close(S, rS, **WKV_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", ["zero", "strong"])
@pytest.mark.parametrize("T,chunk", [(1, 1), (17, 16), (33, 32), (100, 64),
                                     (512, 64), (65, 1)])
def test_wkv6_decay_and_dtypes(wkv, T, chunk, decay, dtype):
    """logw = 0 (no decay: the state only grows) and logw down to -30 a
    step (e^c underflows within a chunk), on f32 or bf16 r, k, v, u; the
    plain version runs on the f32 values of the same inputs."""
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    r, k, v, logw, u, s0 = _wkv_inputs(2, T, 3, 64, "cuda", seed=T)
    if decay == "zero":
        logw = torch.zeros_like(logw)
    else:
        gen = torch.Generator(device="cuda").manual_seed(T + 1)
        logw = -30.0 * torch.rand(logw.shape, generator=gen, device="cuda")
    dt = getattr(torch, dtype)
    r, k, v, u = (a.to(dt) for a in (r, k, v, u))
    y, S = _wkv_call_checked(wkv, r, k, v, logw, u, s0, chunk)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    ry, rS = wkv6_ref(r.float(), k.float(), v.float(), logw, u.float(), s0)
    torch.testing.assert_close(y, ry, **WKV_TOL)
    torch.testing.assert_close(S, rS, **WKV_TOL)


# the heads that make the kernel pick each column-slice width at B = 2
# (wkv6.cu `choose_cw`: 64 columns from B·H = 64 up, 32 from 32, else 16)
WKV_WIDTH_HEADS = {64: 32, 32: 16, 16: 3, 1: 3}


@pytest.mark.cuda
@pytest.mark.parametrize("cw", [16, 32, 64, 1])
@pytest.mark.parametrize("T,chunk", [(32, 64), (100, 32), (512, 64)])
def test_wkv6_every_slice_width(wkv, T, chunk, cw):
    """The chunked path at each column-slice width it takes, reached by
    B·H, and (cw 1) the streaming path at the same T, reached by chunk 1
    (launch/profile_wkv.py times them all)."""
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    H = WKV_WIDTH_HEADS[cw]
    r, k, v, logw, u, s0 = _wkv_inputs(2, T, H, 64, "cuda", seed=cw)
    y, S = _wkv_call_checked(wkv, r, k, v, logw, u, s0,
                             1 if cw == 1 else chunk)
    ry, rS = wkv6_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(y, ry, **WKV_TOL)
    torch.testing.assert_close(S, rS, **WKV_TOL)


@pytest.mark.cuda
def test_rwkv_layer_kernel_matches_plain(cuda):
    """One rwkv6-1.6b time mix at full width on the card, bf16 with
    perturbed constants: use_kernels (one wkv6_btHN launch) against the
    model's own chunked WKV, within the bf16 bounds of the MoE layer."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.wkv6.kernel import wkv6_btHN
    from repro_torch.models import rwkv6
    from repro_torch.models.layers import init_params
    cfg = get_config("rwkv6-1.6b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = init_params(rwkv6.init_rwkv(cfg), gen, cuda, torch.bfloat16)
    p["u"] = 0.5 * torch.randn(p["u"].shape, generator=gen, device=cuda)
    p["w0"] = -5 + 6 * torch.rand(p["w0"].shape, generator=gen, device=cuda)
    x = torch.randn((4, 96, cfg.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    st = {"S": 0.1 * torch.randn((4, 32, 64, 64), generator=gen,
                                 device=cuda),
          "shift": torch.zeros((4, cfg.d_model), dtype=torch.bfloat16,
                               device=cuda)}
    wkv6_btHN.launches = 0
    with torch.inference_mode():
        got, gs = rwkv6.rwkv_time_mix_seq(cfg, p, x, dict(
            st, S=st["S"].clone()), use_kernels=True)  # S written over
        want, ws = rwkv6.rwkv_time_mix_seq(cfg, p, x, st, use_kernels=False)
    torch.cuda.synchronize()
    assert wkv6_btHN.launches == 1
    torch.testing.assert_close(gs["S"], ws["S"], **WKV_TOL)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-2 * float(want.float().abs().max()))


# ---- the flash-attention backward (f32, key spans <= 32) ----
#
# The backward kernel is held to attention_bwd_ref, the plain version fed
# the kernel's own o and lse, within atol = rtol = 1e-4: dk and dv sum up
# to S * G = 128 rows and dq up to 32 keys of f32 products, in another
# order than the plain einsums. Repeats are bitwise (no atomics).
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def cuda_dev():
    return torch.device("cuda")


@pytest.fixture
def flash_bwd(cuda):
    from repro_torch.kernels.flash_attention import kernel as fk
    fk.flash_attention_fwd_lse.launches = 0
    fk.flash_attention_bwd.launches = 0
    return fk


def _bwd_case(fk, q, k, v, do, **mask):
    """The kernel's (o, lse, dq, dk, dv) and the plain backward's on the
    kernel's o and lse."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    o, lse = fk.flash_attention_fwd_lse(q, k, v, **mask)
    got = fk.flash_attention_bwd(q, k, v, o, lse, do, **mask)
    torch.cuda.synchronize()
    want = attention_bwd_ref(q, k, v, o, lse, do, **mask)
    return o, lse, got, want


# every trunk training shape: S 3 (pendulum) and 4 (cartpole, gridworld),
# 4 query heads over 2 kv heads, D 32 (reduced) and 64 (full width), B 1
# up to the largest learner batch (the default fit's 32 x 32 steps)
@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 32, 256, 1024])
@pytest.mark.parametrize("S", [3, 4])
@pytest.mark.parametrize("D", [32, 64])
def test_flash_bwd_matches_plain_at_trunk_shapes(flash_bwd, B, S, D):
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    KVH, G = 2, 2
    q, k, v = _f32_qkv((B, KVH * G, S, D), (B, KVH, S, D), cuda_dev(),
                       B + S + D)
    do = torch.randn_like(q)
    o, lse, got, want = _bwd_case(flash_bwd, q, k, v, do)
    assert (flash_bwd.flash_attention_fwd_lse.launches,
            flash_bwd.flash_attention_bwd.launches) == (1, 1)
    _, lse_ref = attention_lse_ref(q, k, v)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=2e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
    again = flash_bwd.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


# spans 5-32, ragged valid_len (a longer S cut to at most 32 keys: the key
# rows past it get zero dk, dv), windows, non-causal, G 1-4, every head dim
@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("S,G,causal,window,valid_len", [
    (5, 2, True, 0, None), (9, 1, True, 4, 7), (17, 3, True, 0, None),
    (20, 4, False, 0, 13), (32, 2, True, 8, None), (32, 1, False, 0, None),
    (40, 2, True, 0, 32), (100, 3, False, 0, 20), (24, 4, True, 0, 19)])
def test_flash_bwd_spans_masks_and_repeats(flash_bwd, D, S, G, causal,
                                           window, valid_len):
    B, KVH = 3, 2
    q, k, v = _f32_qkv((B, KVH * G, S, D), (B, KVH, S, D), cuda_dev(),
                       D + S + G)
    do = torch.randn_like(q)
    mask = dict(causal=causal, window=window, valid_len=valid_len)
    o, lse, got, want = _bwd_case(flash_bwd, q, k, v, do, **mask)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
    if valid_len is not None:
        assert bool((got[1][:, :, valid_len:] == 0).all())
        assert bool((got[2][:, :, valid_len:] == 0).all())
    again = flash_bwd.flash_attention_bwd(q, k, v, o, lse, do, **mask)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
def test_flash_bwd_row_without_keys_gets_zero_gradients(flash_bwd):
    B, KVH, G, S, D = 2, 2, 2, 6, 64
    q, k, v = _f32_qkv((B, KVH * G, S, D), (B, KVH, S, D), cuda_dev(), 5)
    do = torch.randn_like(q)
    mask = dict(causal=True, window=1, valid_len=2)
    o, lse, got, want = _bwd_case(flash_bwd, q, k, v, do, **mask)
    assert bool(torch.isneginf(lse[:, :, 2:]).all())
    assert bool((got[0][:, :, 2:] == 0).all())
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, **BWD_TOL)


# strided operands and a strided dO (the model layout's views and a
# cotangent autograd may hand over), head dim contiguous
@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 256])
@pytest.mark.parametrize("offset", [0, 4, 3])
@pytest.mark.parametrize("S", [3, 4, 17])
def test_flash_bwd_strided(flash_bwd, D, offset, S):
    B, KVH, G = 5, 2, 2
    rng = np.random.default_rng(D + offset + S)
    H = KVH * G
    base_q = torch.tensor(rng.standard_normal((B, S, H + 2, D + 8)).astype(
        np.float32), device=cuda_dev())
    base_kv = torch.tensor(rng.standard_normal(
        (B, S, 2 * KVH + 1, D + 8)).astype(np.float32), device=cuda_dev())
    q = base_q[:, :, 1:H + 1, offset:offset + D].transpose(1, 2)
    k = base_kv[:, :, :KVH, offset:offset + D].transpose(1, 2)
    v = base_kv[:, :, KVH + 1:, offset:offset + D].transpose(1, 2)
    do = torch.tensor(rng.standard_normal((B, S, KVH * G, D + 5)).astype(
        np.float32), device=cuda_dev())[..., 2:2 + D].transpose(1, 2)
    assert not do.is_contiguous() and do.stride(-1) == 1
    o, lse, got, want = _bwd_case(flash_bwd, q, k, v, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
    contig = flash_bwd.flash_attention_bwd(
        *(t.contiguous() for t in (q, k, v, o)), lse, do.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(contig, got))


# The backward's cutoffs by head dim (flash_attention_bwd.cu): the keys
# its phase 1 takes at a time at D 32 and 64 (4), and the last key count
# at which a block's shared memory holds 4 groups at D 128 and 256 (19,
# 10)
BWD_CUTOFFS = [(32, 4), (64, 4), (128, 19), (256, 10)]
# causal; a window; non-causal with a valid_len cutting a longer S
_BWD_MASKS = [dict(causal=True, window=0, cut=0),
              dict(causal=True, window=3, cut=0),
              dict(causal=False, window=0, cut=2)]


def _bwd_held(fk, q, k, v, do, **mask):
    """The kernel's gradients within BWD_TOL of the plain backward on its
    o and lse, and bitwise on a repeat; returns (o, lse, gradients)."""
    o, lse, got, want = _bwd_case(fk, q, k, v, do, **mask)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
    again = fk.flash_attention_bwd(q, k, v, o, lse, do, **mask)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    return o, lse, got


# each cutoff, one key short of it and one past it, under each mask (5
# groups of 3 query heads)
@pytest.mark.cuda
@pytest.mark.parametrize("mask", range(len(_BWD_MASKS)))
@pytest.mark.parametrize("step", [-1, 0, 1])
@pytest.mark.parametrize("D,cut", BWD_CUTOFFS)
def test_flash_bwd_at_its_cutoffs(flash_bwd, D, cut, step, mask):
    m = _BWD_MASKS[mask]
    n = cut + step
    B, KVH, G, S = 5, 1, 3, n + m["cut"]
    q, k, v = _f32_qkv((B, KVH * G, S, D), (B, KVH, S, D), cuda_dev(),
                       D + n + mask)
    do = torch.randn_like(q)
    _, _, got = _bwd_held(flash_bwd, q, k, v, do, causal=m["causal"],
                          window=m["window"],
                          valid_len=n if m["cut"] else None)
    assert flash_bwd.flash_attention_bwd.launches == 2
    assert bool((got[1][:, :, n:] == 0).all())
    assert bool((got[2][:, :, n:] == 0).all())


# B * KVH groups that leave a block part empty: a block takes 4 groups at
# most, fewer where its shared memory holds fewer (at D 128 and 256 with
# 32 keys, 2 and 1) and fewer where the groups would leave SMs without one
# (132 on an H100: 135 groups take 2 a block, 201 take 2, 401 take 4);
# and rounds of rows past the first (S * G > 8)
@pytest.mark.cuda
@pytest.mark.parametrize("S,D", [(4, 64), (3, 32), (9, 64), (32, 128),
                                 (32, 256)])
@pytest.mark.parametrize("B,KVH", [(1, 1), (7, 3), (135, 1), (67, 3),
                                   (401, 1)])
def test_flash_bwd_groups_not_a_multiple_of_a_block(flash_bwd, B, KVH, S,
                                                    D):
    G = 2
    q, k, v = _f32_qkv((B, KVH * G, S, D), (B, KVH, S, D), cuda_dev(),
                       B + KVH + S)
    _bwd_held(flash_bwd, q, k, v, torch.randn_like(q))


def _misaligned(t, how):
    """t, a (B,H,S,D) view of a (B,S,H,D) layout, copied into a view
    whose base lies 1 or 2 floats into its buffer (`base1`, `base2`) or
    whose rows are D + 1 floats apart (`stride`)."""
    B, H, S, D = t.shape
    if how == "stride":
        buf = torch.empty((B, S, H, D + 1), device=t.device)
        view = buf[..., :D]
    else:
        off = int(how[-1])
        buf = torch.empty(t.numel() + off, device=t.device)
        view = buf[off:].view(B, S, H, D)
    view.copy_(t.transpose(1, 2))
    return view.transpose(1, 2)


# operands whose base or strides break the 16-byte copies (a base 1 or 2
# floats in, rows D + 1 floats apart): the scalar-copy instance, at one
# pass of pairs and at several, bitwise the vector instance on aligned
# copies
@pytest.mark.cuda
@pytest.mark.parametrize("how", ["base1", "base2", "stride"])
@pytest.mark.parametrize("S", [4, 12])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_bwd_unaligned_operands(flash_bwd, D, S, how):
    B, KVH, G = 3, 2, 2
    q, k, v = _f32_qkv((B, KVH * G, S, D), (B, KVH, S, D), cuda_dev(),
                       D + S + len(how))
    do = torch.randn_like(q)
    mis = [_misaligned(t.transpose(1, 2).contiguous().transpose(1, 2), how)
           for t in (q, k, v, do)]
    o, lse, got = _bwd_held(flash_bwd, *mis)
    aligned = flash_bwd.flash_attention_bwd(q, k, v, o.contiguous(), lse,
                                            do)
    assert all(torch.equal(a, b) for a, b in zip(aligned, got))


def _three_buffer_bwd(fk, q, k, v, o, lse, do, *, causal=True, window=0):
    """The backward kernel with dq, dk and dv each in an allocation of its
    own, as the wrapper allocated them before they shared one buffer."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    dq = torch.empty((B, S, H, D), device=q.device)
    dk, dv = (torch.empty((B, S, KVH, D), device=q.device) for _ in range(2))
    st = [t.stride()[:3] for t in (q, k, v, o, do)]
    fk._launch(fk.BWD_PARAMS.pack(
        *(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv)),
        B, H, KVH, S, D, int(causal), int(window), S, D ** -0.5,
        *(x for s in st for x in s), S * H * D, D, H * D,
        *(S * KVH * D, D, KVH * D) * 2), q.device, fk.flash_attention_bwd,
        "flash_attention_bwd")
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


@pytest.mark.cuda
def test_flash_bwd_one_buffer_leaves_projection_grads_bitwise(flash_bwd,
                                                              monkeypatch):
    """dq, dk and dv as views of one buffer: the gradients of the q, k and
    v projections in front of the attention (the trunk's full width, a ppo
    minibatch) are bitwise those of three separate allocations."""
    from repro_torch.kernels.flash_attention import ops
    B, S, KVH, G, D, W = 256, 4, 2, 2, 64, 256
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, S, W), generator=gen, device="cuda")
    ws = [torch.randn((W, n), generator=gen, device="cuda") * W ** -0.5
          for n in (KVH * G * D, KVH * D, KVH * D)]
    dout = torch.randn((B, S, KVH, G, D), generator=gen, device="cuda")

    def grads():
        w = [t.clone().requires_grad_() for t in ws]
        out = ops.flash_attention((x @ w[0]).view(B, S, KVH, G, D),
                                  (x @ w[1]).view(B, S, KVH, D),
                                  (x @ w[2]).view(B, S, KVH, D))
        return torch.autograd.grad(out, w, dout)

    one = grads()
    monkeypatch.setattr(ops, "flash_attention_bwd",
                        lambda *a, **kw: _three_buffer_bwd(flash_bwd, *a,
                                                           **kw))
    three = grads()
    assert flash_bwd.flash_attention_bwd.launches == 2
    assert all(torch.equal(a, b) for a, b in zip(one, three))


# O with lse requested is bitwise O without it, through both short kernels
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 3, 4, 5, 17, 32])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_fwd_lse_leaves_o_bitwise(flash_bwd, S, G, D):
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    B, KVH = 3, 2
    q, k, v = _f32_qkv((B, KVH * G, S, D), (B, KVH, S, D), cuda_dev(),
                       S + G + D)
    o, lse = flash_bwd.flash_attention_fwd_lse(q, k, v)
    assert torch.equal(o, flash_attention_hsd(q, k, v))
    _, lse_ref = attention_lse_ref(q, k, v)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,S", [(torch.bfloat16, 4),
                                     (torch.float32, 33)])
def test_flash_attention_under_grad_refuses_what_the_backward_lacks(
        flash_bwd, dtype, S):
    """bf16, or a span past 32 keys, under grad raises (saying the
    reference trains its LMs with use_kernels=False) instead of training
    through another path."""
    qg = torch.randn((2, S, 2, 2, 64), device=cuda_dev(), dtype=dtype,
                     requires_grad=True)
    k = torch.randn((2, S, 2, 64), device=cuda_dev(), dtype=dtype)
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        flash_attention(qg, k, k)
    assert flash_bwd.flash_attention_fwd_lse.launches == 0
    with torch.no_grad():
        flash_attention(qg, k, k)


@pytest.mark.cuda
def test_flash_attention_function_matches_plain_autograd(flash_bwd):
    """flash_attention under grad on the model layout (the trunk's call):
    one forward-with-lse and one backward launch, gradients within
    BWD_TOL of autograd through the plain version, under
    torch.use_deterministic_algorithms(True), bitwise on a repeat."""
    from repro_torch.core.attention import attention
    B, S, KVH, G, D = 256, 4, 2, 2, 64
    qg, k, v = _f32_qkv((B, S, KVH, G, D), (B, S, KVH, D), cuda_dev(), 9)
    dout = torch.randn_like(qg)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        grads = []
        for _ in range(2):
            ins = [t.clone().requires_grad_() for t in (qg, k, v)]
            out = flash_attention(*ins)
            grads.append(torch.autograd.grad(out, ins, dout))
    finally:
        torch.use_deterministic_algorithms(was)
    assert (flash_bwd.flash_attention_fwd_lse.launches,
            flash_bwd.flash_attention_bwd.launches) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    ins = [t.clone().requires_grad_() for t in (qg, k, v)]
    want = torch.autograd.grad(attention(*ins, use_kernel=False), ins, dout)
    for g, w in zip(grads[0], want):
        torch.testing.assert_close(g, w, **BWD_TOL)


def _trunk_loss_fn(name, agent, traj, boot):
    """(loss_fn over the learner params, params key filter) for one
    learner step's loss of each algorithm on a trajectory."""
    if name == "dqn":
        from repro_torch.core.algos.dqn import prefixed
        batch = {k: v[:64] for k, v in agent.transitions(traj).items()}
        return lambda online, full: agent.dqn.loss(
            {**full, **prefixed("online", online)}, batch)[0]
    if name == "ppo":
        batch = agent.algo.make_batch  # the minibatch is formed per params
        return lambda params, full: agent.algo.loss(
            params, {k: v[:256] for k, v in batch(params, traj,
                                                  boot).items()})
    return lambda params, full: agent.algo.loss(params, traj, boot)


# one full-width trunk learner step per algorithm (4 layers, d_model 256,
# 4 heads over 2 kv heads, D 64, S 4), kernels against use_kernels=False
# on the same params and trajectory: the loss within 1e-5 relative and
# each gradient within 1e-4 x the largest gradient entry (f32 through four
# layers in another order); the step itself is finite and launches the
# backward kernel
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ppo", "a3c", "impala", "dqn"])
def test_full_width_trunk_learner_step_kernel_matches_plain(flash_bwd,
                                                            name):
    import repro_torch.envs as envs
    from repro_torch.core import agent as agent_api
    from repro_torch.core.algos.dqn import sub
    from repro_torch.core.rollout import rollout_fresh
    env = envs.make("cartpole")
    extra = {"warmup": 0} if name == "dqn" else {}
    agents = [agent_api.make(name, env=env, policy="trunk", total_iters=10,
                             trunk_kwargs={"reduced": False,
                                           "use_kernels": uk}, **extra)
              for uk in (True, False)]
    state = agents[0].init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=cuda_dev()).manual_seed(1)
    traj, env_state = rollout_fresh(agents[0].policy,
                                    agents[0].actor_policy(state, 0), env,
                                    gen, 16, 16)
    boot = env.obs(env_state)
    params = sub(state.params, "online") if name == "dqn" else state.params
    results = []
    for ag in agents:
        fn = _trunk_loss_fn(name, ag, traj, boot)
        results.append(agent_api.value_and_grad(
            lambda p: fn(p, state.params), params))
    (lk, gk), (lp, gp) = results
    # a layer's attention a differentiated forward: a3c also through its
    # bootstrap value
    assert flash_bwd.flash_attention_bwd.launches == (8 if name == "a3c"
                                                      else 4)
    torch.testing.assert_close(lk, lp, atol=1e-5, rtol=1e-5)
    scale = max(float(g.abs().max()) for g in gp.values())
    for key in gp:
        torch.testing.assert_close(gk[key], gp[key], rtol=0,
                                   atol=1e-4 * scale)
    new, m = agents[0].learner_step(state, traj, boot, gen)
    assert bool(torch.isfinite(m["loss"]))
    assert flash_bwd.flash_attention_bwd.launches > 4
