"""ctypes binding of the Hopper discounted-return kernels
(csrc/advantages.cu), the port of the Pallas `discounted_return_tb`, and
the autograd Function over them.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version (ref.py). `discounted_return_tb.launches` and
`discounted_return_adjoint_tb.launches` count kernel launches, so a run
can show that its main path went through the kernels.
"""
import ctypes
import functools

import torch

from repro_torch.kernels.common import (check_launch, check_tb, launch_stream,
                                        load_kernels, mat_args, on_device)
from repro_torch.kernels.advantages.ref import (
    discounted_return_adjoint_ref, discounted_return_ref)

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.cache
def _launchers():
    dll = load_kernels()
    fwd = dll.discounted_return_tb
    fwd.argtypes = [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P, _I, _I, _P]
    fwd.restype = _I
    adj = dll.discounted_return_adjoint_tb
    adj.argtypes = ([_P, _I64, _I64] * 3 + [_P, _I64, _P, _P, _P, _I, _I,
                                             _P])
    adj.restype = _I
    return dll, fwd, adj


def discounted_return_tb(base, coef, init):
    """base, coef: (T, B) f32 time-major, any strides; init: (B,). Returns
    out (T, B) contiguous with out_t = base_t + coef_t·out_{t+1},
    out_T = init. No gradient: under autograd use `DiscountedReturn`."""
    if not base.is_cuda:
        return discounted_return_ref(base, coef, init)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (base, coef, init)):
        raise RuntimeError("discounted_return_tb: an input requires grad; "
                           "call DiscountedReturn.apply, whose backward "
                           "is the adjoint kernel")
    T, B = base.shape
    check_tb("discounted_return_tb", T, B, (base, coef), (init,))
    out = torch.empty((T, B), dtype=torch.float32, device=base.device)
    dll, fwd, _ = _launchers()
    with on_device(base.device):
        stream = launch_stream(base.device)
        code = fwd(*mat_args(base), *mat_args(coef), init.data_ptr(),
                   init.stride(0), out.data_ptr(), T, B, stream)
    discounted_return_tb.launches += 1
    check_launch(dll, code, "discounted_return_tb")
    return out


discounted_return_tb.launches = 0


def discounted_return_adjoint_tb(g, coef, out, init, need=(True, True,
                                                          True)):
    """The adjoint scan: g = dL/dout (T, B), any strides (autograd's
    expanded gradients included); coef, out (T, B); init (B,). Returns
    (dbase, dcoef, dinit), with None for each one `need` leaves out."""
    if not g.is_cuda:
        grads = discounted_return_adjoint_ref(g, coef, out, init)
        return tuple(d if n else None for d, n in zip(grads, need))
    T, B = g.shape
    check_tb("discounted_return_adjoint_tb", T, B, (g, coef, out), (init,))
    dev = g.device
    dbase, dcoef = (torch.empty((T, B), dtype=torch.float32, device=dev)
                    if n else None for n in need[:2])
    dinit = torch.empty((B,), dtype=torch.float32, device=dev) \
        if need[2] else None
    dll, _, adj = _launchers()
    with on_device(dev):
        stream = launch_stream(dev)
        code = adj(*mat_args(g), *mat_args(coef), *mat_args(out),
                   init.data_ptr(), init.stride(0), _ptr(dbase),
                   _ptr(dcoef), _ptr(dinit), T, B, stream)
    discounted_return_adjoint_tb.launches += 1
    check_launch(dll, code, "discounted_return_adjoint_tb")
    return dbase, dcoef, dinit


discounted_return_adjoint_tb.launches = 0


class DiscountedReturn(torch.autograd.Function):
    """out = discounted_return_tb(base, coef, init), differentiable: the
    backward is the adjoint kernel, asked only for the gradients autograd
    needs (A3C needs dinit alone, into the bootstrap value)."""

    @staticmethod
    def forward(ctx, base, coef, init):
        out = discounted_return_tb(base, coef, init)
        ctx.save_for_backward(coef, out, init)
        return out

    @staticmethod
    def backward(ctx, g):
        coef, out, init = ctx.saved_tensors
        return discounted_return_adjoint_tb(g, coef, out, init,
                                            need=ctx.needs_input_grad)
