"""ctypes binding of the Hopper grouped-matmul kernel (csrc/gmm.cu), the
port of the Pallas `gmm_ecd`.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version (ref.py). `gmm_ecd.launches` counts kernel launches, so a
run can show that its main path went through the kernel. While a
profiler records, a launch given `rows` appends them to the counter
`repro_torch.gmm.row_tiles` with C and the block's rows of C (the
kernel's row tile), from which the share of row tiles that ran follows.
"""
import ctypes
import functools

import torch

from repro_torch.kernels.common import (check_launch, count_launch,
                                        launch_stream, load_kernels, on_device)
from repro_torch.kernels.gmm.ref import gmm_ref
from repro_torch.tracing import count as trace_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    dll = load_kernels()
    fn = dll.gmm_ecd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dll.gmm_ecd_row_tile.argtypes = [ctypes.c_int] * 2
    dll.gmm_ecd_row_tile.restype = ctypes.c_int
    return dll, fn


@functools.cache
def row_tile(dtype, C):
    """The rows of C that one block of the kernel owns at this dtype and
    C (the kernel's own table)."""
    dll, _ = _launcher()
    return dll.gmm_ecd_row_tile(_DTYPES[dtype], C)


def count_row_tiles(rows, C, tile):
    """Records a launch's counts of rows that hold input (a device
    tensor, read only after the traced stretch), C and the row tile, while
    a profiler records."""
    trace_count("repro_torch.gmm.row_tiles",
                {"rows": rows, "capacity": C, "tile": tile})


def _check_rows(rows, x):
    if not isinstance(rows, torch.Tensor) or rows.dtype != torch.int64 \
            or rows.shape != (x.shape[0],) or rows.device != x.device \
            or not rows.is_contiguous():
        desc = (f"{rows.dtype} {tuple(rows.shape)} on {rows.device}"
                f"{'' if rows.is_contiguous() else ', not contiguous'}"
                if isinstance(rows, torch.Tensor) else type(rows).__name__)
        raise ValueError(f"gmm_ecd: rows must be a contiguous int64 (E,) = "
                         f"({x.shape[0]},) tensor on {x.device}; got {desc}")


def gmm_ecd(x, w, rows=None):
    """x: (E,C,d); w: (E,d,f), both contiguous, both float32 or both
    bfloat16. Returns (E,C,f) in x's dtype, f32 accumulation. No padding:
    ragged C, d and f are masked inside the kernel.

    rows: None, or each expert's count of rows of x that hold input, a
    contiguous int64 (E,) tensor on x's device (read on the card, never
    synced). Output rows at or past rows[e] (clamped to [0, C]) are
    exactly zero and x's rows there are never read; the rows below are
    bitwise what the call without `rows` gives."""
    if rows is not None:
        _check_rows(rows, x)
    if not x.is_cuda:
        return gmm_ref(x, w, rows)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        # the kernel writes through ctypes: its output has no grad_fn
        raise RuntimeError(
            "gmm_ecd: x or w requires grad, but there is no gmm backward "
            "kernel: the reference trains its LMs without kernels "
            "(use_kernels=False, as launch/train.py does), and backward "
            "kernels wait in ROADMAP queue 2; run under torch.no_grad() / "
            "inference_mode to serve")
    if x.ndim != 3 or w.ndim != 3 or w.shape[0] != x.shape[0] or \
            w.shape[1] != x.shape[2]:
        raise ValueError(f"gmm_ecd: expected x (E,C,d) and w (E,d,f); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"gmm_ecd: dtypes {x.dtype}, {w.dtype}; expected "
                         f"both float32 or both bfloat16")
    if w.device != x.device:
        raise ValueError("gmm_ecd: x and w on different devices")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm_ecd: x and w must be contiguous")
    E, C, d = x.shape
    f = w.shape[2]
    if E > 65535 or max(C, d, f) >= 2 ** 31:
        raise ValueError(f"gmm_ecd: (E,C,d,f) = {(E, C, d, f)} outside "
                         f"E <= 65535, C, d, f < 2^31")
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    dll, fn = _launcher()
    with on_device(x.device):
        stream = launch_stream(x.device)
        code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  None if rows is None else rows.data_ptr(),
                  _DTYPES[x.dtype], E, C, d, f, stream)
    count_launch(gmm_ecd)
    check_launch(dll, code, "gmm_ecd")
    if rows is not None:
        count_row_tiles(rows, C, row_tile(x.dtype, C))
    return out


gmm_ecd.launches = 0
