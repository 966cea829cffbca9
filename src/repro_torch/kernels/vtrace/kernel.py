"""ctypes binding of the Hopper V-trace kernel (csrc/vtrace.cu), the port
of the Pallas `vtrace_tb`.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version (ref.py). `vtrace_tb.launches` counts kernel launches, so a
run can show that its main path went through the kernel.

The launch arguments go to the C side as one packed struct (the layout
of `VtraceParams` in the source), one ctypes argument: at the training
path's (T, B) = (32, 32) the host's work per call, not the kernel, sets
the call's time (launch/profile_host_cost.py).
"""
import ctypes
import functools
import struct

from repro_torch.kernels.common import (check_launch, check_tb, count_launch,
                                        launch_stream, load_kernels, on_device)
from repro_torch.kernels.vtrace.ref import vtrace_ref

# VtraceParams: log_rhos, discounts, rewards, values, bootstrap, vs,
# pg_adv; the (row, column) element strides of the four (T, B) inputs,
# bootstrap's stride; clip_rho, clip_c; T, B
VTRACE_PARAMS = struct.Struct("<7Q9q2f2i")


def vtrace_params(log_rhos, discounts, rewards, values, bootstrap, vs, adv,
                  clip_rho, clip_c):
    """The packed arguments (VtraceParams)."""
    T, B = log_rhos.shape
    return VTRACE_PARAMS.pack(
        log_rhos.data_ptr(), discounts.data_ptr(), rewards.data_ptr(),
        values.data_ptr(), bootstrap.data_ptr(), vs.data_ptr(),
        adv.data_ptr(), *log_rhos.stride(), *discounts.stride(),
        *rewards.stride(), *values.stride(), bootstrap.stride(0),
        clip_rho, clip_c, T, B)


@functools.cache
def _launcher():
    dll = load_kernels()
    fn = dll.vtrace_tb
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
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
    vs = log_rhos.new_empty((T, B))   # float32 on log_rhos' device,
    adv = log_rhos.new_empty((T, B))  # contiguous
    params = vtrace_params(log_rhos, discounts, rewards, values, bootstrap,
                           vs, adv, clip_rho, clip_c)
    dll, fn = _launcher()
    with on_device(dev):
        code = fn(params, launch_stream(dev))
    count_launch(vtrace_tb)
    check_launch(dll, code, "vtrace_tb")
    return vs, adv


vtrace_tb.launches = 0
