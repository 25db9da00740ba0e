"""The port's training forward (SAVSR.forward(train=True),
archs/train_engine.py) against the JAX package's
(SAVSR.apply(train=True, osconv_impl="pallas_train"), Pallas kernels in
interpret mode) and against the torch oracle's gradients, at the small
config, on the CPU. Tolerances are stated at each check.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from savsr_tpu.archs.savsr_arch import SAVSR as JaxSAVSR
from savsr_tpu.models.base_model import split_params
from savsr_tpu.utils.convert import convert_state_dict
from savsr_tpu_torch.archs.arch_util import TrainCtx, batch_norm, grid_sample_bilinear, sta_conv
from savsr_tpu_torch.archs.savsr_arch import SAVSR
from savsr_tpu_torch.utils.convert import load_into, params_to_jax

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SMALL_CFG = dict(num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5,
                 interval=0, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)


def _state():
    return dict(np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")))


def _model(**kw):
    m = SAVSR(**SMALL_CFG, **kw)
    load_into(m, {k: torch.from_numpy(v) for k, v in _state().items()})
    return m.train()


def _charbonnier(sr, gt):
    return torch.sqrt((sr - gt) ** 2 + 1e-12).mean()


def _loss_and_grads(model, lq, gt, scale=(2.0, 2.0)):
    model.zero_grad()
    sr, updates = model(lq, scale, train=True)
    loss = _charbonnier(sr, gt)
    loss.backward()
    return sr.detach(), float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}, updates


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    return (rng.random((2, 7, 12, 12, 3), dtype=np.float32),
            rng.random((2, 24, 24, 3), dtype=np.float32))


@pytest.fixture(scope="module")
def port_run(batch):
    lq, gt = batch
    return _loss_and_grads(_model(remat_train=False),
                           torch.from_numpy(lq.transpose(0, 1, 4, 2, 3).copy()),
                           torch.from_numpy(gt.transpose(0, 3, 1, 2).copy()))


def test_train_forward_loss_and_gradients_match_jax(batch, port_run):
    """One jax.value_and_grad of the JAX model on a 2x7x12x12 batch: output
    <= 1e-5, loss <= 1e-6, every BatchNorm running-stat update <= 1e-6, every
    gradient <= 1e-4 of its own max (floor 1e-9 for the dead routing
    biases), the bound tests/test_grad_parity.py holds the JAX engines to."""
    lq, gt = batch
    sr, loss, grads, updates = port_run
    params = {k: jnp.asarray(v) for k, v in convert_state_dict(_state()).items()}
    trainable, stats = split_params(params)
    jm = JaxSAVSR(**SMALL_CFG, osconv_impl="pallas_train", remat_train=False)

    def loss_fn(tr):
        out, ups = jm.apply({**tr, **stats}, jnp.asarray(lq), (2.0, 2.0), train=True)
        return jnp.sqrt((out - jnp.asarray(gt)) ** 2 + 1e-12).mean(), (out, ups)

    with pltpu.force_tpu_interpret_mode():
        (j_loss, (j_sr, j_ups)), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            trainable)
    assert np.abs(sr.numpy().transpose(0, 2, 3, 1) - np.asarray(j_sr)).max() <= 1e-5
    assert abs(loss - float(j_loss)) <= 1e-6
    ours = params_to_jax(updates)
    assert set(ours) == set(j_ups)
    for k, v in j_ups.items():
        assert np.abs(ours[k].astype(np.float64) - np.asarray(v)).max() <= 1e-6, k
    ours = params_to_jax(grads)
    assert set(ours) == set(j_grads)
    for k, v in j_grads.items():
        v = np.asarray(v)
        assert np.abs(ours[k] - v).max() <= max(1e-4 * np.abs(v).max(), 1e-9), k


def test_train_forward_matches_torch_oracle_gradients():
    """Loss within 1e-5 and every gradient within 2e-3 of its own max of
    tests/goldens/savsr_small_grads.npz (the bounds of
    tests/test_grad_parity.py)."""
    golden = np.load(os.path.join(GOLDEN_DIR, "savsr_small_grads.npz"))
    _, loss, grads, _ = _loss_and_grads(_model(remat_train=False),
                                        torch.from_numpy(golden["lq"]),
                                        torch.from_numpy(golden["gt"]))
    assert abs(loss - float(golden["loss"])) < 1e-5
    ref = {k[2:]: golden[k] for k in golden.files if k.startswith("g/")}
    assert set(ref) == set(grads)
    worst = max((np.abs(grads[k].numpy() - v).max() / (np.abs(v).max() + 1e-6), k)
                for k, v in ref.items())
    assert worst[0] < 2e-3, worst


@pytest.mark.parametrize("kw", [dict(remat_train=True), dict(remat_train=False, remat_stau=True),
                                dict(remat_train=True, remat_policy="dots", train_loop="scan")],
                         ids=["remat_train", "remat_stau", "dots+scan"])
def test_remat_gives_identical_gradients(batch, port_run, kw):
    """torch.utils.checkpoint recomputes the same arithmetic: loss,
    gradients and BatchNorm updates (chained through the recomputed
    segments) are identical to the no-remat step."""
    lq, gt = batch
    _, loss0, grads0, ups0 = port_run
    _, loss, grads, ups = _loss_and_grads(_model(**kw),
                                          torch.from_numpy(lq.transpose(0, 1, 4, 2, 3).copy()),
                                          torch.from_numpy(gt.transpose(0, 3, 1, 2).copy()))
    assert loss == loss0
    assert set(ups) == set(ups0) and all(torch.equal(ups[k], ups0[k]) for k in ups0)
    assert all(torch.equal(grads[k], grads0[k]) for k in grads0)


@pytest.mark.parametrize("scale", [(2.0, 2.0), (1.5, 3.5)], ids=str)
def test_training_engine_in_eval_mode_matches_serving_engine(batch, scale):
    """engines="train" with train=False (running statistics) against the
    serving forward on the fused kernels' plain versions: <= 1e-5."""
    lq = torch.from_numpy(batch[0].transpose(0, 1, 4, 2, 3).copy())
    with torch.no_grad():
        a = _model(engines="train").eval()(lq, scale)
    b = _model().eval()(lq, scale)
    assert a.shape == b.shape
    assert float((a - b).abs().max()) <= 1e-5


def test_train_flag_needs_the_training_engine():
    with pytest.raises(ValueError, match="training engine"):
        _model(engines="eval")(torch.zeros(1, 7, 3, 8, 8), 2.0, train=True)


def test_batch_norm_train_mode_chains_and_tracks_unbiased_variance():
    """Train-mode batch_norm against nn.BatchNorm2d in training mode applied
    twice (momentum 0.1, biased variance normalises, unbiased is tracked,
    num_batches_tracked += 1 per application): <= 1e-6."""
    rng = np.random.default_rng(0)
    bn = torch.nn.BatchNorm2d(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.random(5).astype(np.float32) + 0.5))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(5).astype(np.float32)))
    ref = torch.nn.BatchNorm2d(5)
    ref.load_state_dict(bn.state_dict())
    ref.train()
    ctx = TrainCtx(train=True)
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((3, 5, 4, 6)).astype(np.float32))
        assert float((batch_norm(x, bn, ctx) - ref(x)).detach().abs().max()) <= 1e-6
    assert int(bn.num_batches_tracked) == 0  # the module itself is untouched
    upd = ctx.stats[bn]
    assert int(upd["num_batches_tracked"]) == 2
    assert float((upd["running_mean"] - ref.running_mean).abs().max()) <= 1e-6
    assert float((upd["running_var"] - ref.running_var).abs().max()) <= 1e-6
    # eval mode and a [B, C] vector (the ScaleAttention's BatchNorm)
    v = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    ref.eval()
    assert float((batch_norm(v, ref) - ref(v[:, :, None, None])[:, :, 0, 0]).detach().abs().max()) <= 1e-6


def test_grid_sample_and_sta_conv_match_jax():
    """grid_sample_bilinear (zeros padding, align_corners=True, samples in
    and out of range) and the unfused sta_conv against the JAX package's:
    <= 1e-5."""
    from savsr_tpu.archs.arch_util import grid_sample_bilinear as jax_grid_sample
    from savsr_tpu.archs.savsr_arch import sta_conv as jax_sta_conv

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 9, 6)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 11, 13, 2)).astype(np.float32)
    want = np.asarray(jax_grid_sample(jnp.asarray(x), jnp.asarray(grid)))
    got = grid_sample_bilinear(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                               torch.from_numpy(grid)).numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - want).max() <= 1e-5
    kern = rng.standard_normal((2, 7, 9, 6 * 25)).astype(np.float32)
    want = np.asarray(jax_sta_conv(jnp.asarray(x), jnp.asarray(kern)))
    got = sta_conv(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                   torch.from_numpy(kern.transpose(0, 3, 1, 2).copy())).numpy()
    assert np.abs(got.transpose(0, 2, 3, 1) - want).max() <= 1e-5
