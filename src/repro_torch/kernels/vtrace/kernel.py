"""ctypes binding of the Hopper V-trace kernel (csrc/vtrace.cu), the port
of the Pallas `vtrace_tb`.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version (ref.py). `vtrace_tb.launches` counts kernel launches, so a
run can show that its main path went through the kernel.
"""
import ctypes
import functools

import torch

from repro_torch.kernels.common import (check_launch, check_tb, launch_stream,
                                        load_kernels, mat_args, on_device)
from repro_torch.kernels.vtrace.ref import vtrace_ref

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_float


@functools.cache
def _launcher():
    dll = load_kernels()
    fn = dll.vtrace_tb
    fn.argtypes = ([_P, _I64, _I64] * 4 + [_P, _I64, _F, _F, _P, _P, _I, _I,
                                           _P])
    fn.restype = _I
    return dll, fn


def vtrace_tb(log_rhos, discounts, rewards, values, bootstrap,
              clip_rho=1.0, clip_c=1.0):
    """Inputs (T, B) f32 time-major, any strides; bootstrap (B,). Returns
    (vs, pg_adv), contiguous (T, B), as targets: neither carries a
    gradient, as in the reference (ref.py:31, ops.py:24-25)."""
    if not log_rhos.is_cuda:
        return vtrace_ref(log_rhos, discounts, rewards, values, bootstrap,
                          clip_rho=clip_rho, clip_c=clip_c)
    T, B = log_rhos.shape
    check_tb("vtrace_tb", T, B, (log_rhos, discounts, rewards, values),
             (bootstrap,))
    dev = log_rhos.device
    vs = torch.empty((T, B), dtype=torch.float32, device=dev)
    adv = torch.empty((T, B), dtype=torch.float32, device=dev)
    dll, fn = _launcher()
    with on_device(dev):
        stream = launch_stream(dev)
        code = fn(*mat_args(log_rhos), *mat_args(discounts),
                  *mat_args(rewards), *mat_args(values), bootstrap.data_ptr(),
                  bootstrap.stride(0), float(clip_rho), float(clip_c),
                  vs.data_ptr(), adv.data_ptr(), T, B, stream)
    vtrace_tb.launches += 1
    check_launch(dll, code, "vtrace_tb")
    return vs, adv


vtrace_tb.launches = 0
