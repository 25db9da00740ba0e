"""The plain versions of the port's two OSConv kernels (kernels 6 and 7) and
the autograd Function around them, against the JAX package's Pallas kernels
run in interpret mode on the CPU. Inputs are made with numpy from a seed and
go through both; the port is NCHW, the JAX package NHWC, so the tests
transpose. Tolerances are stated at each check.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from savsr_tpu.ops.pallas.osconv_kernel import (osconv_agg_train as jax_agg_train,
                                                osconv_pallas_agg, osconv_pallas_dagg)
from savsr_tpu_torch.ops.osconv import (dagg_chunks, osconv_agg, osconv_agg_plain,
                                        osconv_agg_train, osconv_dagg, osconv_dagg_plain)

# (B, H, W, Cin, Cout, k, padding): pad 1, pad 0 and pad 2 (the dx call of a
# pad-0 conv), Cin != Cout, odd H and W, and a 1x1 kernel
SHAPES = [(2, 13, 10, 48, 32, 3, 1), (1, 10, 12, 16, 8, 3, 0), (2, 9, 11, 8, 24, 3, 2),
          (2, 7, 5, 12, 20, 1, 0)]


def _inputs(shape, seed=0):
    b, h, w, cin, cout, k, pad = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    agg = (rng.standard_normal((b, k, k, cin, cout)) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, h + 2 * pad - k + 1, w + 2 * pad - k + 1, cout)).astype(np.float32)
    return x, agg, g


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_agg_plain_matches_pallas_f32(shape):
    """f32: <= 1e-5 absolute (sums of <= 432 products of O(1) x O(0.1)
    values, in another order)."""
    x, agg, _ = _inputs(shape)
    pad = shape[-1]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(osconv_pallas_agg(jnp.asarray(x), jnp.asarray(agg), pad))
    got = osconv_agg(_nchw(x), torch.from_numpy(agg), pad).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


def test_agg_plain_matches_pallas_bf16():
    """bf16 in, f32 accumulation, one rounding of the output on both sides:
    outputs may land one bf16 step (2^-8 relative) apart."""
    x, agg, _ = _inputs(SHAPES[0], seed=1)
    xb, ab = jnp.asarray(x, jnp.bfloat16), jnp.asarray(agg, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(osconv_pallas_agg(xb, ab, 1).astype(jnp.float32))
    got = osconv_agg(_nchw(x).bfloat16(), torch.from_numpy(agg).bfloat16(), 1)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dagg_plain_matches_pallas(shape):
    """f32 output [B, P, Cin, Cout]: <= 1e-4 relative to its max (sums over
    all pixels, in another order)."""
    x, _, g = _inputs(shape, seed=2)
    k, pad = shape[-2:]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(osconv_pallas_dagg(jnp.asarray(x), jnp.asarray(g), k, k, pad))
    got = osconv_dagg(_nchw(x), _nchw(g), k, k, pad)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    # bf16 inputs still give an f32 gradient
    got16 = osconv_dagg(_nchw(x).bfloat16(), _nchw(g).bfloat16(), k, k, pad)
    assert got16.dtype == torch.float32
    assert np.abs(got16.numpy() - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_agg_train_forward_and_gradients_match_jax(shape):
    """The Function (forward, dx through the forward on flipped/swapped
    weights at padding k-1-p, dagg) against jax.grad through the JAX
    package's custom_vjp: value <= 1e-5, gradients <= 1e-4 of their max."""
    x, agg, cot = _inputs(shape, seed=3)
    pad = shape[-1]

    def loss(xx, aa):
        return (jax_agg_train(xx, aa, pad) * cot).sum()

    with pltpu.force_tpu_interpret_mode():
        y_ref = np.asarray(jax_agg_train(jnp.asarray(x), jnp.asarray(agg), pad))
        gx_ref, ga_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(agg))
    xt = _nchw(x).requires_grad_()
    at = torch.from_numpy(agg).requires_grad_()
    y = osconv_agg_train(xt, at, pad)
    (y * _nchw(cot)).sum().backward()
    assert np.abs(y.detach().numpy().transpose(0, 2, 3, 1) - y_ref).max() <= 1e-5
    gx = xt.grad.numpy().transpose(0, 2, 3, 1)
    for got, want in ((gx, np.asarray(gx_ref)), (at.grad.numpy(), np.asarray(ga_ref))):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


def test_agg_train_honours_needs_input_grad():
    x, agg, _ = _inputs(SHAPES[1], seed=4)
    xt, at = _nchw(x).requires_grad_(), torch.from_numpy(agg)
    osconv_agg_train(xt, at, 0).sum().backward()
    assert xt.grad is not None and at.grad is None
    xt, at = _nchw(x), torch.from_numpy(agg).requires_grad_()
    osconv_agg_train(xt, at, 0).sum().backward()
    assert at.grad is not None and at.grad.dtype == at.dtype


def test_plain_versions_equal_a_grouped_convolution():
    """The plain versions against one library call each (F.conv2d with
    groups=B on the [1, B*C, H, W] view, and its autograd): <= 1e-5."""
    import torch.nn.functional as F

    b, h, w, cin, cout, k, pad = SHAPES[0]
    x, agg, g = (torch.from_numpy(a) for a in _inputs(SHAPES[0], seed=5))
    xt = x.permute(0, 3, 1, 2).contiguous()
    wt = agg.permute(0, 4, 3, 1, 2).reshape(b * cout, cin, k, k).requires_grad_()
    ref = F.conv2d(xt.reshape(1, b * cin, h, w), wt, padding=pad, groups=b).reshape(b, cout, h, w)
    assert float((osconv_agg_plain(xt, agg, pad) - ref.detach()).abs().max()) <= 1e-5
    gt = g.permute(0, 3, 1, 2).contiguous()
    (ref * gt).sum().backward()
    want = wt.grad.reshape(b, cout, cin, k * k).permute(0, 3, 2, 1)
    got = osconv_dagg_plain(xt, gt, k, k, pad)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_wrapper_refusals():
    x = torch.zeros(2, 4, 6, 6)
    agg = torch.zeros(2, 3, 3, 4, 5)
    g = torch.zeros(2, 5, 6, 6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        osconv_agg(x.double(), agg.double(), 1)
    with pytest.raises(ValueError, match="dtype"):
        osconv_agg(x, agg.bfloat16(), 1)
    with pytest.raises(ValueError, match="batch mismatch"):
        osconv_agg(x, agg[:1], 1)
    with pytest.raises(ValueError, match="input channels"):
        osconv_agg(x[:, :3].contiguous(), agg, 1)
    with pytest.raises(ValueError, match="padding"):
        osconv_agg(x, agg, 3)
    with pytest.raises(ValueError, match="kernel size"):
        osconv_agg(x, torch.zeros(2, 5, 5, 4, 5), 1)
    with pytest.raises(ValueError, match="contiguous"):
        osconv_agg(x.transpose(2, 3), agg, 1)
    with pytest.raises(ValueError, match="batch mismatch"):
        osconv_dagg(x, g[:1], 3, 3, 1)
    with pytest.raises(ValueError, match="conv output"):
        osconv_dagg(x, g, 3, 3, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        osconv_dagg(x.half(), g.half(), 3, 3, 1)


@pytest.mark.parametrize("b,cin,cout,h,w", [(8, 192, 64, 60, 60), (8, 320, 64, 60, 60),
                                             (8, 64, 64, 60, 60), (1, 16, 8, 10, 12),
                                             (2, 48, 32, 13, 10), (1, 4, 4, 1, 1),
                                             (3, 40, 72, 37, 9), (2, 100, 64, 13, 130)])
def test_dagg_chunks_cover_the_rows(b, cin, cout, h, w):
    """The CUDA-core weight-gradient launch plan: chunks of rows that cover
    every row of x exactly once, none empty, and as many blocks as fit one
    wave of a 132-SM card (more only when a single chunk already exceeds
    it)."""
    sms = 132
    n, rows = dagg_chunks(b, cin, cout, h, w, sms)
    covered = np.concatenate([np.arange(i * rows, min(h, (i + 1) * rows)) for i in range(n)])
    assert np.array_equal(covered, np.arange(h))
    assert (n - 1) * rows < h <= n * rows
    blocks = b * -(-cin // 64) * -(-cout // 64) * -(-w // 64)
    assert n * blocks <= sms or n == 1