"""ctypes binding of the Hopper discounted-return kernels
(csrc/advantages.cu), the port of the Pallas `discounted_return_tb`, and
the autograd Function over them.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version (ref.py). `discounted_return_tb.launches` and
`discounted_return_adjoint_tb.launches` count kernel launches, so a run
can show that its main path went through the kernels.

Each entry's launch arguments go to the C side as one packed struct (the
layouts of `ScanFwdParams` and `ScanAdjParams` in the source), one
ctypes argument: at the training path's (T, B) = (32, 32) the host's
work per call, not the kernel, sets the call's time
(launch/profile_host_cost.py).
"""
import ctypes
import functools
import struct

import torch

from repro_torch.kernels.common import (check_launch, check_tb, count_launch,
                                        launch_stream, load_kernels, on_device)
from repro_torch.kernels.advantages.ref import (
    discounted_return_adjoint_ref, discounted_return_ref)

# ScanFwdParams: base, coef, init, out; the (row, column) element strides
# of base and coef, init's stride; T, B
FWD_PARAMS = struct.Struct("<4Q5q2i")
# ScanAdjParams: g, coef, out, init, dbase, dcoef, dinit (0 where not
# asked for); the (row, column) strides of g, coef, out, init's stride;
# T, B
ADJ_PARAMS = struct.Struct("<7Q7q2i")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def fwd_params(base, coef, init, out):
    """The forward's packed arguments (ScanFwdParams)."""
    T, B = base.shape
    return FWD_PARAMS.pack(
        base.data_ptr(), coef.data_ptr(), init.data_ptr(), out.data_ptr(),
        *base.stride(), *coef.stride(), init.stride(0), T, B)


def adj_params(g, coef, out, init, dbase, dcoef, dinit):
    """The adjoint's packed arguments (ScanAdjParams); a gradient not
    asked for (None) is a null pointer."""
    T, B = g.shape
    return ADJ_PARAMS.pack(
        g.data_ptr(), coef.data_ptr(), out.data_ptr(), init.data_ptr(),
        _ptr(dbase), _ptr(dcoef), _ptr(dinit), *g.stride(), *coef.stride(),
        *out.stride(), init.stride(0), T, B)


@functools.cache
def _launchers():
    dll = load_kernels()
    fwd, adj = dll.discounted_return_tb, dll.discounted_return_adjoint_tb
    for fn in (fwd, adj):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return dll, fwd, adj


def discounted_return_tb(base, coef, init):
    """base, coef: (T, B) f32 time-major, any strides; init: (B,). Returns
    out (T, B) contiguous with out_t = base_t + coef_t·out_{t+1},
    out_T = init. No gradient: under autograd use `DiscountedReturn`."""
    if not base.is_cuda:
        return discounted_return_ref(base, coef, init)
    if torch.is_grad_enabled() and (base.requires_grad or coef.requires_grad
                                    or init.requires_grad):
        raise RuntimeError("discounted_return_tb: an input requires grad; "
                           "call DiscountedReturn.apply, whose backward "
                           "is the adjoint kernel")
    T, B = base.shape
    check_tb("discounted_return_tb", T, B, (base, coef), (init,))
    dev = base.device
    out = base.new_empty((T, B))  # float32 on base's device, contiguous
    params = fwd_params(base, coef, init, out)
    dll, fwd, _ = _launchers()
    with on_device(dev):
        code = fwd(params, launch_stream(dev))
    count_launch(discounted_return_tb)
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
    dbase = g.new_empty((T, B)) if need[0] else None  # float32, on g's
    dcoef = g.new_empty((T, B)) if need[1] else None  # device
    dinit = g.new_empty((B,)) if need[2] else None
    params = adj_params(g, coef, out, init, dbase, dcoef, dinit)
    dll, _, adj = _launchers()
    with on_device(dev):
        code = adj(params, launch_stream(dev))
    count_launch(discounted_return_adjoint_tb)
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
