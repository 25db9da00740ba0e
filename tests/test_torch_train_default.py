"""The port's training forward and backward at f32 weights and
``matmul_precision: default`` on the CPU, against the JAX package's.

On a TPU every conv and dot at DEFAULT precision is one bf16 pass (operands
rounded to bf16, exact products, f32 sums), the transposed products of the
backward too, since JAX's transpose rules pass the precision on: there the
cotangent and the other operand are rounded. XLA:CPU ignores the
precision, so the JAX side runs under ``tpu_default_dots``
(tests/test_torch_fast.py), whose rounding passes its gradient straight
through and which also replaces the module-level conv that JAX's conv
transposes call. The JAX side is ``SAVSR.apply(train=True,
osconv_impl="pallas_train")``; its two OSConv kernels pin HIGHEST precision
for f32 and run here through their plain reference, the einsum against
which the JAX package's own tests hold them (tests/test_pallas_kernels.py),
at that precision (interpret mode would double this file's time), and its
alignment loop as one ``lax.scan`` (``train_loop: scan``, the same math as
the unrolled loop: a sixth less compile).

Bounds. Near the output the port's gradients agree with the JAX package's
to ~1e-6 of their scale; deeper in, each bf16 rounding of a cotangent that
an f32 sum in another order lands the other way moves everything upstream,
and the early alignment layers' gradients scatter by up to ~7% of their
max (taking the port's own conv sums in f64 moves them by up to 14%). So
every gradient is held at 0.25 of its max (plus 1e-6 of the largest
gradient, for the gradients that train-mode BatchNorm makes zero up to
rounding), and the gradient as a whole at 2e-3 relative L2 (measured
4.1e-4). The port at ``float32`` (true f32) sits 28x further from the
shimmed JAX gradients than the port at ``default``, which shows on this
one JAX compile that the shim bites: at least 10x is required.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import savsr_tpu.ops.pallas.osconv_kernel as jax_osconv_kernel
from savsr_tpu.archs.savsr_arch import SAVSR as JaxSAVSR
from savsr_tpu.models.base_model import split_params
from savsr_tpu.ops.osconv import extract_patches
from savsr_tpu.utils.convert import convert_state_dict
from savsr_tpu_torch.archs.savsr_arch import SAVSR
from savsr_tpu_torch.utils.convert import load_into, params_to_jax
from test_torch_fast import tpu_default_dots

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SMALL_CFG = dict(num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5,
                 interval=0, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)
SCALE = (2.0, 2.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's small CPU tensors: beside XLA's
    thread pool (and the suite's other workers) more threads only contend."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _state():
    return dict(np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")))


def _osconv_agg_reference(x, agg, padding=1):
    """osconv_agg_train's function (the einsum engine) at the kernels'
    pinned HIGHEST precision; JAX differentiates it at that precision."""
    b, kh, kw, ci, co = agg.shape
    patches = extract_patches(x, (kh, kw), 1, padding)
    return jnp.einsum("bhwpi,bpio->bhwo", patches, agg.reshape(b, kh * kw, ci, co),
                      precision=jax.lax.Precision.HIGHEST)


def _jax_side(lq, gt):
    params = {k: jnp.asarray(v) for k, v in convert_state_dict(_state()).items()}
    trainable, stats = split_params(params)
    jm = JaxSAVSR(**SMALL_CFG, osconv_impl="pallas_train", remat_train=False,
                  matmul_precision="default", train_loop="scan")

    def loss_fn(tr):
        out, ups = jm.apply({**tr, **stats}, jnp.asarray(lq), SCALE, train=True)
        return jnp.sqrt((out - jnp.asarray(gt)) ** 2 + 1e-12).mean(), ups

    kernel = jax_osconv_kernel.osconv_agg_train
    jax_osconv_kernel.osconv_agg_train = _osconv_agg_reference
    try:
        with tpu_default_dots():
            (loss, ups), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
            return (float(loss), {k: np.asarray(v) for k, v in grads.items()},
                    {k: np.asarray(v) for k, v in ups.items()})
    finally:
        jax_osconv_kernel.osconv_agg_train = kernel


def _port_side(lq, gt, precision):
    model = SAVSR(**SMALL_CFG, matmul_precision=precision, remat_train=False)
    load_into(model, {k: torch.from_numpy(v) for k, v in _state().items()})
    sr, ups = model.train()(torch.from_numpy(lq.transpose(0, 1, 4, 2, 3).copy()), SCALE,
                            train=True)
    loss = torch.sqrt((sr - torch.from_numpy(gt.transpose(0, 3, 1, 2).copy())) ** 2
                      + 1e-12).mean()
    loss.backward()
    return (float(loss.detach()), params_to_jax({k: p.grad for k, p in model.named_parameters()}),
            params_to_jax(ups))


@pytest.fixture(scope="module")
def runs():
    """One seeded batch of the golden's size through the JAX package (once)
    and the port at default and at float32."""
    rng = np.random.default_rng(16)
    lq = rng.random((2, 7, 12, 12, 3), dtype=np.float32)
    gt = rng.random((2, 24, 24, 3), dtype=np.float32)
    return {"jax": _jax_side(lq, gt), "default": _port_side(lq, gt, "default"),
            "float32": _port_side(lq, gt, "float32")}


def _grad_distance(grads, ref) -> float:
    """The whole gradient's relative L2 distance from ``ref``."""
    num = sum(float(((grads[k] - v).astype(np.float64) ** 2).sum()) for k, v in ref.items())
    return (num / sum(float((v.astype(np.float64) ** 2).sum()) for v in ref.values())) ** 0.5


def test_default_training_matches_jax(runs):
    """Loss <= 3e-6 (measured 6.9e-7; the float32 port 1.3e-5), every
    BatchNorm running-stat update <= 1e-4 (2.0e-5; 3.2e-4), every gradient
    within 0.25 of its max + 1e-6 of the largest, the whole gradient within
    2e-3 relative L2 (see the module docstring)."""
    j_loss, j_grads, j_ups = runs["jax"]
    loss, grads, ups = runs["default"]
    assert abs(loss - j_loss) <= 3e-6
    assert set(ups) == set(j_ups)
    for k, v in j_ups.items():
        assert np.abs(ups[k].astype(np.float64) - v).max() <= 1e-4, k
    assert set(grads) == set(j_grads)
    top = max(np.abs(v).max() for v in j_grads.values())
    for k, v in j_grads.items():
        assert np.abs(grads[k] - v).max() <= 0.25 * np.abs(v).max() + 1e-6 * top, k
    assert _grad_distance(grads, j_grads) <= 2e-3


def test_float32_training_is_10x_further_from_jax_default(runs):
    """The shim bites: the port in true f32 sits at least 10x further from
    the shimmed JAX gradients than the port at default."""
    j_grads = runs["jax"][1]
    assert (_grad_distance(runs["float32"][1], j_grads)
            >= 10 * _grad_distance(runs["default"][1], j_grads))


def test_default_products_round_operands_and_cotangent():
    """conv2d and dot_einsum at ``fast`` with gradients: the value is the f32
    product of the bf16-rounded operands (+ bias); each operand's gradient
    is the transposed product of the bf16-rounded cotangent and the other
    rounded operand, passed straight through the rounding; the bias's is the
    unrounded cotangent's sum."""
    from savsr_tpu_torch.archs.arch_util import conv2d, dot_einsum

    def r(t):
        return t.to(torch.bfloat16).float()

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 5, 6), dtype=np.float32)).requires_grad_()
    conv = torch.nn.Conv2d(3, 4, 3)
    g = torch.from_numpy(rng.standard_normal((2, 4, 5, 6), dtype=np.float32))
    y = conv2d(x, conv, 1, fast=True)
    assert torch.equal(y, F.conv2d(r(x), r(conv.weight), padding=1) + conv.bias[:, None, None])
    y.backward(g)
    assert torch.equal(x.grad, torch.nn.grad.conv2d_input(x.shape, r(conv.weight), r(g),
                                                          padding=1))
    assert torch.equal(conv.weight.grad, torch.nn.grad.conv2d_weight(
        r(x), conv.weight.shape, r(g), padding=1))
    assert torch.equal(conv.bias.grad, g.sum(dim=(0, 2, 3)))

    a = torch.from_numpy(rng.standard_normal((3, 7), dtype=np.float32)).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((7, 2), dtype=np.float32)).requires_grad_()
    gz = torch.from_numpy(rng.standard_normal((3, 2), dtype=np.float32))
    z = dot_einsum("ik,kj->ij", a, b, fast=True)
    assert torch.equal(z, r(a) @ r(b))
    z.backward(gz)
    assert torch.equal(a.grad, r(gz) @ r(b).t())
    assert torch.equal(b.grad, r(a).t() @ r(gz))


def test_unknown_matmul_precision_raises():
    with pytest.raises(ValueError, match="matmul_precision 'highest'"):
        SAVSR(**SMALL_CFG, matmul_precision="highest")
