"""Training-mode BatchNorm over the link batch: one pass over a row-major
[B, P, C] block whose P planes (SIGN's two endpoints; P = 1 for every
other BatchNorm over the batch) each take their own statistics and share
the affine weight and bias, as P calls on ``x[:, p]`` would.

Replaces no TPU kernel (the JAX package leaves its BatchNorms to XLA).
On the card, PyTorch's BatchNorm takes an input that is not contiguous
with channel stride 1, such as SIGN's endpoint views ``h[:, 0]`` of a
[B, 2, C] block, through a kernel of one block per channel whose few
threads walk every row with uncoalesced loads: at citation2's batch of
261,424 links that bounded BUDDY's training step.  ``csrc/batch_norm.cu``
reads the block as it lies, rows across the threads and 16-byte loads
along a row, in three kernels each way (chunk partials, a merge in a
fixed order, one streaming pass for y or dx), and updates the running
statistics from the biased variance in the merge, plane 0 first, so no
separate statistics pass reads the batch again.  It is bound by HBM
bytes: x read twice and y written once forward, x and dy read twice and
dx written once backward.  No atomics: two calls give the same bits.

Dispatch: a CPU tensor takes :func:`batch_norm_train_plain`, which is
``F.batch_norm`` per plane and ``torch.var_mean`` for the running
statistics, the computation the port ran before the kernel; a CUDA
tensor launches the kernel through :class:`_BatchNormFn`, or raises on
what it does not take (a dtype other than float32 or float64, a layout
that is not contiguous).  Nothing falls back from the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from subgraph_sketching_tpu_torch import spans
from subgraph_sketching_tpu_torch.ops import cuda_build

THREADS = 256        # threads of a chunk block (csrc: kThreads)
BLOCKS_PER_SM = 4    # chunk blocks a streaming multiprocessor is given
ROW_STEPS = 8        # the fewest rows a thread walks in its chunk

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_FORWARD_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int64,) * 8
                     + (ctypes.c_double,) * 2 + (ctypes.c_void_p,))
_BACKWARD_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int64,) * 8
                      + (ctypes.c_void_p,))

# passes launched on the card, by C entry point (each launches its three
# kernels); the plain version never counts
launches = {f"batch_norm_{way}_{s}": 0 for way in ("forward", "backward")
            for s in _SUFFIX.values()}


def layout(rows: int, cols: int, elem_size: int, aligned: bool,
           sms: int) -> tuple:
    """How the kernels cut a [rows, cols] block: (vec, tx, ty, rows per
    chunk, chunks).  A thread loads ``vec`` adjacent columns at once (16
    bytes where the row's bytes and ``aligned`` allow, else one element);
    tx threads lie along a row's columns (at most ``THREADS``, in column
    tiles beyond) and ty = THREADS // tx rows side by side.  Chunks: as
    many as give ``BLOCKS_PER_SM`` blocks to each of ``sms``
    multiprocessors, but no fewer than ``ROW_STEPS`` rows a thread, so a
    narrow or short batch takes few chunks (one at 1,024 rows of 8)."""
    unit = 16 // elem_size
    vec = unit if aligned and cols % unit == 0 else 1
    v = cols // vec
    tx = min(v, THREADS)
    ty = THREADS // tx
    tiles = -(-v // tx)
    most = max(1, BLOCKS_PER_SM * sms // tiles)
    chunks = max(1, min(most, -(-rows // (ROW_STEPS * ty))))
    per = -(-rows // chunks)
    return vec, tx, ty, per, -(-rows // per)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def batch_norm_train_plain(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, running_mean: torch.Tensor,
                           running_var: torch.Tensor, momentum: float,
                           eps: float) -> torch.Tensor:
    """The same function in plain torch: for each plane p in order,
    ``F.batch_norm`` of ``x[:, p]`` with the batch's statistics, and the
    running statistics updated from ``torch.var_mean`` (biased).  Returns
    [B, P, C]."""
    outs = []
    for p in range(x.shape[1]):
        xp = x[:, p]
        outs.append(F.batch_norm(xp, None, None, weight, bias, True, 0.0,
                                 eps))
        with torch.no_grad():
            var, mean = torch.var_mean(xp, dim=0, correction=0)
            running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
            running_var.mul_(1 - momentum).add_(var, alpha=momentum)
    return torch.stack(outs, dim=1)


def _check_cuda_args(x, weight, bias, running_mean, running_var) -> None:
    if x.dtype not in _SUFFIX:
        raise ValueError(f"batch_norm_train: no kernel for {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"batch_norm_train: x {tuple(x.shape)} must be "
                         f"[B, P, C]")
    if x.shape[0] < 2:
        raise ValueError("batch_norm_train: expected more than 1 value "
                         "per channel when training")
    c = x.shape[2]
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t.shape != (c,) or t.dtype != x.dtype:
            raise ValueError(f"batch_norm_train: {name} must be {x.dtype} "
                             f"[{c}], got {t.dtype} {tuple(t.shape)}")
    cuda_build.check_tensors("batch_norm_train",
                             align=x.element_size(), x=x, weight=weight,
                             bias=bias, running_mean=running_mean,
                             running_var=running_var)


def _layout(x: torch.Tensor, *others: torch.Tensor) -> tuple:
    """:func:`layout` for ``x`` and the other blocks a pass streams."""
    rows, planes, channels = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others))
    return layout(rows, planes * channels, x.element_size(), aligned,
                  _sms(x.device.index or 0))


def _forward(x, weight, bias, running_mean, running_var, momentum, eps):
    rows, planes, channels = x.shape
    vec, tx, ty, per, chunks = _layout(x)
    cols = planes * channels
    y = torch.empty_like(x)
    mean = torch.empty(cols, dtype=x.dtype, device=x.device)
    invstd = torch.empty_like(mean)
    part = torch.empty((2, chunks, cols), dtype=x.dtype, device=x.device)
    fn_name = f"batch_norm_forward_{_SUFFIX[x.dtype]}"
    cuda_build.launch(
        cuda_build.entry("batch_norm", fn_name, _FORWARD_ARGTYPES), fn_name,
        x.device, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
        running_mean.data_ptr(), running_var.data_ptr(), part.data_ptr(),
        rows, planes, channels, vec, tx, ty, per, chunks, float(momentum),
        float(eps))
    launches[fn_name] += 1
    return y, mean, invstd


def _backward(dy, x, weight, mean, invstd, need_dx: bool):
    rows, planes, channels = x.shape
    vec, tx, ty, per, chunks = _layout(x, dy)
    cols = planes * channels
    part = torch.empty((2, chunks, cols), dtype=x.dtype, device=x.device)
    sums = torch.empty((2, cols), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(weight)
    fn_name = f"batch_norm_backward_{_SUFFIX[x.dtype]}"
    cuda_build.launch(
        cuda_build.entry("batch_norm", fn_name, _BACKWARD_ARGTYPES), fn_name,
        x.device, dy.data_ptr(), x.data_ptr(), weight.data_ptr(),
        mean.data_ptr(), invstd.data_ptr(), part.data_ptr(), sums.data_ptr(),
        None if dx is None else dx.data_ptr(), dweight.data_ptr(),
        dbias.data_ptr(), rows, planes, channels, vec, tx, ty, per, chunks)
    launches[fn_name] += 1
    return dx, dweight, dbias


class _BatchNormFn(torch.autograd.Function):
    """The kernel's forward and backward passes: the spans ``bn.forward``
    and ``bn.backward`` (three kernels each)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        with spans.span("bn.forward"):
            y, mean, invstd = _forward(x, weight, bias, running_mean,
                                       running_var, momentum, eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        with spans.span("bn.backward"):
            dx, dweight, dbias = _backward(dy.contiguous(), x, weight, mean,
                                           invstd, ctx.needs_input_grad[0])
        return dx, dweight, dbias, None, None, None, None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, momentum: float,
                     eps: float) -> torch.Tensor:
    """Training-mode BatchNorm of ``x`` [B, P, C] (module docstring):
    returns [B, P, C] normalised by each plane's batch statistics and
    updates ``running_mean`` / ``running_var`` [C] in place, plane 0 first.
    The caller counts the P batches in ``num_batches_tracked``."""
    if x.device.type == "cpu":
        with spans.span("bn.forward"):
            return batch_norm_train_plain(x, weight, bias, running_mean,
                                          running_var, momentum, eps)
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_train: unsupported device {x.device}")
    _check_cuda_args(x, weight, bias, running_mean, running_var)
    return _BatchNormFn.apply(x, weight, bias, running_mean, running_var,
                              momentum, eps)
