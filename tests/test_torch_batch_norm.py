"""The link batch's training-mode BatchNorm (``ops/batch_norm.py``) on the
CPU: its plain version, which is what ``BatchNorm`` ran before the
kernel (``F.batch_norm`` of each endpoint, then ``torch.var_mean`` for
the running statistics), held bit for bit against two calls of that
code; gradients by float64 ``gradcheck``; ``SIGN``'s one call over the
[B, 2, C] block against its two calls on the endpoints; eval mode, the
masked path (SEALGIN) and the mesh path (``_across_ranks``) untouched;
the kernels' layout and the wrapper's refusals.  The kernel itself runs
in ``tests/test_torch_cuda.py``."""

import copy

import pytest
import torch
import torch.nn.functional as F

from subgraph_sketching_tpu_torch.models import gnn
from subgraph_sketching_tpu_torch.models.gnn import SIGN, batch_norm
from subgraph_sketching_tpu_torch.ops import batch_norm as bn_ops


def _two_call_batch_norm(bn, x):
    """``BatchNorm``'s training mode before the kernel, one call per
    endpoint ``x[:, p]`` (or on ``x`` itself for [B, C])."""
    def one(xp):
        out = F.batch_norm(xp, None, None, bn.weight, bn.bias, True, 0.0,
                           bn.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(xp, dim=0, correction=0)
            m = bn.momentum
            bn.running_mean.mul_(1 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1 - m).add_(var, alpha=m)
            bn.num_batches_tracked.add_(1)
        return out

    if x.dim() == 2:
        return one(x)
    return torch.stack([one(x[:, p]) for p in range(x.shape[1])], dim=1)


def _module(c: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    bn = batch_norm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return bn


@pytest.mark.parametrize("rows", [2, 7, 1024])
@pytest.mark.parametrize("channels", [1, 8, 128])
@pytest.mark.parametrize("planes", [1, 2])
def test_plain_is_the_two_call_batch_norm(planes, channels, rows):
    g = torch.Generator().manual_seed(rows * 10 + channels)
    shape = (rows, channels) if planes == 1 else (rows, planes, channels)
    x = 2.0 * torch.randn(shape, generator=g) + 0.7
    dy = torch.randn(shape, generator=g)
    new, old = _module(channels), _module(channels)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = new(xa), _two_call_batch_norm(old, xb)
    assert torch.equal(ya, yb)
    (ya * dy).sum().backward()
    (yb * dy).sum().backward()
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(new.weight.grad, old.weight.grad)
    assert torch.equal(new.bias.grad, old.bias.grad)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(new, name), getattr(old, name)), name
    assert int(new.num_batches_tracked) == planes


@pytest.mark.parametrize("planes", [1, 2])
def test_plain_gradients_by_gradcheck(planes):
    g = torch.Generator().manual_seed(planes)
    x = torch.randn((6, planes, 3), generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = (torch.rand(3, generator=g, dtype=torch.float64) + 0.5) \
        .requires_grad_()
    b = torch.randn(3, generator=g, dtype=torch.float64, requires_grad=True)
    rm = torch.zeros(3, dtype=torch.float64)
    rv = torch.ones(3, dtype=torch.float64)

    def f(x, w, b):
        return bn_ops.batch_norm_train(x, w, b, rm.clone(), rv.clone(), 0.1,
                                       1e-5)

    assert torch.autograd.gradcheck(f, (x, w, b))


def test_sign_block_is_its_two_endpoint_calls():
    """SIGN's one call a hop block over [B, 2, C] against the same module's
    two calls on h[:, 0] and h[:, 1]: outputs, gradients, and each
    BatchNorm's running statistics and ``num_batches_tracked`` (+1 an
    endpoint)."""
    torch.manual_seed(3)
    sign = SIGN(16, 32, 24, K=2, dropout=0.0).train()
    ref = copy.deepcopy(sign)
    x = torch.randn(50, 2, 48)

    def two_calls(m, xs):
        hs = []
        for k, xk in enumerate(torch.chunk(xs, m.K + 1, dim=-1)):
            h = getattr(m, f"lin_{k}")(xk)
            bn = getattr(m, f"bn_{k}")
            h = torch.stack([bn(h[:, 0, :]), bn(h[:, 1, :])], dim=1)
            hs.append(torch.relu(h))
        return m.lin_out(torch.cat(hs, dim=-1))

    ya, yb = sign(x), two_calls(ref, x)
    assert torch.equal(ya, yb)
    ya.square().sum().backward()
    yb.square().sum().backward()
    for (name, pa), pb in zip(sign.named_parameters(), ref.parameters()):
        assert torch.equal(pa.grad, pb.grad), name
    for (name, ba), bb in zip(sign.named_buffers(), ref.buffers()):
        assert torch.equal(ba, bb), name
    assert [int(getattr(sign, f"bn_{k}").num_batches_tracked)
            for k in range(3)] == [2, 2, 2]


def test_eval_mode_normalises_each_endpoint_by_the_running_statistics():
    bn = _module(8).eval()
    x = torch.randn(9, 2, 8)
    want = torch.stack([F.batch_norm(x[:, p], bn.running_mean,
                                     bn.running_var, bn.weight, bn.bias,
                                     False, 0.1, bn.eps) for p in range(2)],
                       dim=1)
    assert torch.equal(bn(x), want)
    assert torch.equal(bn(x[:, 1]), want[:, 1])
    assert int(bn.num_batches_tracked) == 0


def _refuse_the_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("batch_norm_train called")
    monkeypatch.setattr(gnn, "batch_norm_train", refuse)


def test_masked_path_is_untouched(monkeypatch):
    _refuse_the_op(monkeypatch)
    bn = _module(4)
    x = torch.randn(12, 4)
    mask = torch.arange(12) % 3 != 0
    rm = bn.running_mean.clone()
    got = bn(x, mask=mask)
    real = x[mask]
    mean = real.mean(0)
    var = torch.clamp((real * real).mean(0) - mean * mean, min=0.0)
    want = (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.9 * rm + 0.1 * mean)
    assert int(bn.num_batches_tracked) == 1


def test_mesh_path_is_untouched(monkeypatch):
    """With a mesh, each endpoint takes ``_across_ranks`` (here one rank,
    its sums summed over itself) in order, never the op."""
    _refuse_the_op(monkeypatch)
    monkeypatch.setattr(gnn, "sum_across_ranks", lambda t, group: t)

    class OneRank:
        data_size = 1

        def group(self, axis):
            return None

    bn, ref = _module(8), _module(8)
    bn.mesh = OneRank()
    x = torch.randn(10, 2, 8)
    got = bn(x)
    want = _two_call_batch_norm(ref, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.running_mean, ref.running_mean)
    torch.testing.assert_close(bn.running_var, ref.running_var)
    assert int(bn.num_batches_tracked) == 2


def test_the_plain_version_launches_nothing():
    before = dict(bn_ops.launches)
    _module(8)(torch.randn(5, 2, 8))
    assert bn_ops.launches == before


# ---------------------------------------------------------------- layout --

def test_layout_at_the_main_path_shapes():
    # a citation2 SIGN block, float32, on 132 multiprocessors
    assert bn_ops.layout(261424, 256, 4, True, 132) == (4, 64, 4, 496, 528)
    # BUDDY's bn_labels [B, 8]: 32 rows a warp, 256 chunks of 8 steps
    assert bn_ops.layout(261424, 8, 4, True, 132) == (4, 2, 128, 1022, 256)
    # bn_RA [B, 1]: one element a thread
    assert bn_ops.layout(261424, 1, 4, True, 132)[:3] == (1, 1, 256)
    # ELPH's head at 1,024 rows: one chunk where rows are narrow
    assert bn_ops.layout(1024, 8, 4, True, 132) == (4, 2, 128, 1024, 1)
    assert bn_ops.layout(1024, 1024, 4, True, 132) == (4, 256, 1, 8, 128)
    # float64: two elements in 16 bytes; a misaligned block: one
    assert bn_ops.layout(1000, 256, 8, True, 132)[:3] == (2, 128, 2)
    assert bn_ops.layout(1000, 256, 4, False, 132)[:3] == (1, 256, 1)


@pytest.mark.parametrize("rows", [2, 3, 255, 1024, 4097, 261424])
@pytest.mark.parametrize("cols", [1, 3, 6, 8, 12, 256, 1024, 2500])
@pytest.mark.parametrize("elem", [4, 8])
def test_layout_covers_every_row_and_column(rows, cols, elem):
    vec, tx, ty, per, chunks = bn_ops.layout(rows, cols, elem, True, 132)
    assert cols % vec == 0 and vec * elem in (elem, 16)
    assert 1 <= tx * ty <= bn_ops.THREADS
    assert chunks >= 1 and (chunks - 1) * per < rows <= chunks * per
    tiles = -(-(cols // vec) // tx)
    assert tiles * tx * vec >= cols
    assert chunks * tiles <= max(tiles, bn_ops.BLOCKS_PER_SM * 132)


# ------------------------------------------------------------- refusals --

def test_wrapper_refuses_another_device():
    x = torch.empty((4, 1, 2), device="meta")
    w = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bn_ops.batch_norm_train(x, w, w, w, w, 0.1, 1e-5)


@pytest.mark.parametrize("case", ["dtype", "rank", "one_row", "weight",
                                  "stride"])
def test_kernel_arguments_are_checked(case):
    """What the card's path refuses (``_check_cuda_args``, here on CPU
    tensors): a 16-bit block, a block that is not [B, P, C], one row, a
    parameter of another dtype or shape, a strided block."""
    x = torch.randn(8, 2, 4)
    w = torch.ones(4)
    args = [x, w, w.clone(), torch.zeros(4), torch.ones(4)]
    if case == "dtype":
        args[0] = x.half()
    elif case == "rank":
        args[0] = x[:, 0]
    elif case == "one_row":
        args[0] = x[:1]
    elif case == "weight":
        args[1] = w.double()
    else:
        args[0] = torch.randn(8, 4, 2).transpose(1, 2)
    with pytest.raises(ValueError):
        bn_ops._check_cuda_args(*args)
    bn_ops._check_cuda_args(x, w, w.clone(), torch.zeros(4), torch.ones(4))
