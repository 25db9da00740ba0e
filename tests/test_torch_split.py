"""The port's split serving tier (``conv_precision: split``) on the CPU
against the JAX package: the pair helpers, the split conv's plain version
(``conv_fused_split_plain``) against the Pallas pair-carry kernels in
interpret mode, the whole split forward against ``SAVSR(conv_engine="chw",
conv_precision="split")`` at SMALL_CFG, its distance from the port's strict
and bf16 tiers, training (where split does nothing) and the CLI's ``--tier
split``. Inputs are seeded numpy arrays; tolerances are stated at each check.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from savsr_tpu.archs import chw_engine as jchw
from savsr_tpu.archs.savsr_arch import SAVSR as JaxSAVSR
from savsr_tpu.ops.pallas.chw_conv import (chw_to_nhwc, conv1x1_chw, conv3x3_chw_parts,
                                           nhwc_to_chw)
from savsr_tpu.utils.convert import convert_state_dict
from savsr_tpu_torch.archs.savsr_arch import SAVSR
from savsr_tpu_torch.ops.conv import Pair, conv_fused_split_plain, pair_merge, pair_split
from savsr_tpu_torch.utils.convert import load_into

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SMALL_CFG = dict(num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5,
                 interval=0, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)
SCALE = (1.5, 3.5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's small CPU tensors: beside the
    suite's other workers more threads only contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _state():
    return dict(np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")))


def _port(**kw):
    m = SAVSR(**SMALL_CFG, **kw).eval()
    load_into(m, {k: torch.from_numpy(v) for k, v in _state().items()})
    return m


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# (a) the pair helpers
# ---------------------------------------------------------------------------


def test_pair_split_and_merge_equal_jax_bit_for_bit():
    """hi and lo of the same f32 values over 12 decades, and their merge,
    equal the JAX package's to the bit (its pc-interleaved channels read
    back as planes)."""
    rng = np.random.default_rng(0)
    b, c, h, w, pc = 2, 32, 5, 7, 16
    x = (rng.standard_normal((b, c, h, w)) * 10.0 ** rng.uniform(-6, 6, (b, c, h, w)))
    x = x.astype(np.float32)
    xp = np.asarray(jchw.pair_split(jnp.asarray(x.reshape(b, c, h * w)), pc))
    v = xp.reshape(b, c // pc, 2, pc, h, w)
    want_hi, want_lo = (v[:, :, i].reshape(b, c, h, w) for i in (0, 1))
    got = pair_split(torch.from_numpy(x))
    assert got.hi.dtype == got.lo.dtype == torch.bfloat16
    for t, want in ((got.hi, want_hi), (got.lo, want_lo)):
        assert np.array_equal(t.view(torch.int16).numpy(), want.view(np.int16))
    merged = np.asarray(jchw.pair_merge(jnp.asarray(xp), pc)).reshape(b, c, h, w)
    assert np.array_equal(pair_merge(got).numpy(), merged)


# ---------------------------------------------------------------------------
# (b) the split conv's plain version against the Pallas pair-carry kernels
# ---------------------------------------------------------------------------

# (label, k, input channels, pair chunk width of the JAX layout, Cout,
#  per-sample weight, pair residual, output): a pair input of one chunk and
#  of two (chained through pre_add), the 1x1 over three chunks, the OSConv's
#  per-sample weight (no bias), raw f32 frames (pre-split, _split_x), and an
#  f32 output (the trunk's conv_last)
CONV_CASES = [
    ("3x3 C64 pc64 res", 3, 64, 64, 64, False, True, "pair"),
    ("3x3 C128 pc64 res", 3, 128, 64, 128, False, True, "pair"),
    ("1x1 96->32 pc32", 1, 96, 32, 32, False, False, "pair"),
    ("3x3 per-sample 64->64", 3, 64, 64, 64, True, False, "pair"),
    ("3x3 raw f32 3->64", 3, 3, None, 64, False, False, "pair"),
    ("3x3 C64 res f32 out", 3, 64, 64, 64, False, True, "f32"),
]


def _jax_split_conv(x, wt, bias, res, k, pc, out, lrelu):
    """The JAX engine's split conv through the Pallas kernels (interpret
    mode), as chw_engine.conv3 / conv1 call them. x, res NHWC [B, h, w, C];
    wt HWIO [k, k, Ci, Co] or per sample [B, k, k, Ci, Co]. Returns the
    merged f32 output, NHWC."""
    b, h, w, c = x.shape
    cout = wt.shape[-1]
    xc = nhwc_to_chw(jnp.asarray(x))
    ones = jnp.ones((cout, 1), jnp.float32)
    bcol = jnp.asarray(bias).reshape(cout, 1)
    res_p = None if res is None else jchw.pair_split(nhwc_to_chw(jnp.asarray(res)), pc or cout)
    wj = jnp.asarray(wt)
    with pltpu.force_tpu_interpret_mode():
        if k == 1:
            y = conv1x1_chw(jchw.pair_split(xc, pc), jchw._pack_w1_pair(wj[0, 0], pc), bcol,
                            ones, None, res_p, h=h, w=w, lrelu=lrelu, out_dtype=jnp.float32,
                            in_pair=True, out_pair=out == "pair",
                            res_pair=res_p is not None, pc=pc)
        elif pc is None:  # raw f32: [hi, lo, hi] stacked in XLA, Cin padded to 8
            xs = [jchw._split_x(jchw._pad_cin(xc))]
            wpad = jnp.pad(wj, ((0, 0), (0, 0), (0, (-c) % 8), (0, 0)))
            y = conv3x3_chw_parts(xs, [jchw._pack_split_w3(wpad, b)], bcol, ones, res_p, h=h,
                                  w=w, lrelu=lrelu, out_dtype=jnp.float32, in_pairs=[False],
                                  out_pair=out == "pair", res_pair=res_p is not None,
                                  pc=cout)
            pc = cout
        else:
            xp = jchw.pair_split(xc, pc)
            n = c // pc
            xs = [xp[:, 2 * pc * j:2 * pc * (j + 1)] for j in range(n)]
            w3s = [jchw._pack_split_w3(wj[..., pc * j:pc * (j + 1), :], b) for j in range(n)]
            y = conv3x3_chw_parts(xs, w3s, bcol, ones, res_p, h=h, w=w, lrelu=lrelu,
                                  out_dtype=jnp.float32, in_pairs=[True] * n,
                                  out_pair=out == "pair", res_pair=res_p is not None, pc=pc)
    if out == "pair":
        y = jchw.pair_merge(y, pc)
    return np.asarray(chw_to_nhwc(y, h, w))


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_split_conv_plain_matches_pallas_pair_kernels(case):
    """Merged values within 1e-5 x max|ref|: both sum exact products of
    bf16 values in f32, in different orders, and round the result to a
    pair (~2^-17 relative) the same way."""
    label, k, c, pc, cout, per_sample, with_res, out = case
    rng = np.random.default_rng(sum(map(ord, label)))
    b, h, w = (2 if per_sample else 1), 10, 12
    lrelu = (0.6, 0.4)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wshape = ((b,) if per_sample else ()) + (k, k, c, cout)
    wt = (rng.standard_normal(wshape) * (c * k * k) ** -0.5).astype(np.float32)
    bias = (np.zeros(cout) if per_sample else rng.standard_normal(cout) * 0.1).astype(np.float32)
    res = rng.standard_normal((b, h, w, cout)).astype(np.float32) if with_res else None
    want = _jax_split_conv(x, wt, bias, res, k, pc, out, lrelu)

    # the port: NCHW, weight [(B,) Cout, Cin, k, k]
    w_oihw = torch.from_numpy(np.ascontiguousarray(np.moveaxis(wt, (-1, -2), (-4, -3))))
    got = conv_fused_split_plain(pair_split(_nchw(x)) if pc else _nchw(x), w_oihw,
                                 None if per_sample else torch.from_numpy(bias), lrelu=lrelu,
                                 residual=None if res is None else pair_split(_nchw(res)),
                                 out=out)
    if out == "pair":
        assert isinstance(got, Pair) and got.hi.dtype == torch.bfloat16
        got = pair_merge(got)
    assert got.dtype == torch.float32
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# (c) the whole split forward
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def forwards():
    """One window of the small golden input at x(1.5, 3.5): the JAX split
    forward (one compile, Pallas in interpret mode) and the port's split,
    strict and bf16 forwards, [1, 3, H, W] f32."""
    x = np.load(os.path.join(GOLDEN_DIR, "savsr_small_forward.npz"))["x"][:1]
    params = {k: jnp.asarray(v) for k, v in convert_state_dict(_state()).items()}
    jmodel = JaxSAVSR(**SMALL_CFG, conv_engine="chw", conv_precision="split")
    y_jax = np.asarray(jax.jit(functools.partial(jmodel.apply, scale=SCALE))(
        params, jnp.asarray(x.transpose(0, 1, 3, 4, 2)))[0]).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x)
    out = {"jax": y_jax,
           "split": _port(conv_precision="split")(xt, SCALE).numpy(),
           "strict": _port()(xt, SCALE).numpy(),
           "bf16": _port().to(torch.bfloat16)(xt.bfloat16(), SCALE).float().numpy()}
    return out


def test_split_forward_matches_jax_split(forwards):
    """Max abs <= 2e-4 on outputs in [0, 1]: a pair rounds at ~2^-16 at
    each conv, so two sum orders may land one lo step apart."""
    assert forwards["split"].shape == forwards["jax"].shape == (1, 3, 16, 49)
    assert np.abs(forwards["split"] - forwards["jax"]).max() <= 2e-4


def test_split_tracks_strict_far_beyond_bf16(forwards):
    """As the JAX package holds its own split tier (tests/test_split_conv.py):
    < 2e-3 from strict f32 and at least 30x closer than the bf16 tier."""
    err_split = float(np.abs(forwards["split"] - forwards["strict"]).max())
    err_bf16 = float(np.abs(forwards["bf16"] - forwards["strict"]).max())
    assert err_split < 2e-3, err_split
    assert err_split * 30 < err_bf16, (err_split, err_bf16)


def test_split_needs_f32_weights():
    model = _port(conv_precision="split").to(torch.bfloat16)
    with pytest.raises(ValueError, match="conv_precision: split"):
        model(torch.zeros((1, 7, 3, 8, 8), dtype=torch.bfloat16), 2.0)


# ---------------------------------------------------------------------------
# (d) training ignores the split tier
# ---------------------------------------------------------------------------


def test_split_is_noop_in_training():
    """conv_precision: split is eval only: the training forward is the same
    with it or without it, to the bit (the port's counterpart of the JAX
    package's test of the same name)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((1, 7, 3, 12, 12), dtype=np.float32))
    outs = [_port(conv_precision=p).train()(x, (2.0, 2.0), train=True)[0].detach()
            for p in ("split", "native")]
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# (e) the CLI
# ---------------------------------------------------------------------------


def test_cli_tier_split_writes_the_direct_split_forward(tmp_path):
    """``--tier split --device cpu`` writes, for every frame, the uint8 BGR
    frame of a direct split forward of its window."""
    import cv2

    from savsr_tpu_torch.data.data_util import generate_frame_indices
    from savsr_tpu_torch.inference import build_serving_model, main, to_uint8_bgr
    from savsr_tpu_torch.utils.convert import params_to_jax

    rng = np.random.default_rng(2)
    clip = tmp_path / "clip"
    clip.mkdir()
    frames = (rng.random((5, 10, 12, 3)) * 255).astype(np.uint8)
    for i, f in enumerate(frames):
        cv2.imwrite(str(clip / f"{i:08d}.png"), f)
    ckpt = tmp_path / "net_g.npz"
    np.savez(ckpt, **{f"params/{k}": v for k, v in params_to_jax(_port().state_dict()).items()})
    yml = tmp_path / "net.yml"
    yml.write_text("network_g:\n  type: SAVSR\n"
                   + "".join(f"  {k}: {v}\n" for k, v in SMALL_CFG.items()))
    assert main(["-i", str(clip), "-o", str(tmp_path / "out"), "-s", "2", "-w", str(ckpt),
                 "--opt", str(yml), "--tier", "split", "--device", "cpu",
                 "--windows", "2"]) == 0

    model = build_serving_model("split", SMALL_CFG)
    load_into(model, {k: torch.from_numpy(v) for k, v in _state().items()})
    assert model.cfg.conv_precision == "split" and model.cfg.matmul_precision == "float32"
    lr = torch.from_numpy(frames[..., ::-1].astype(np.float32) / 255.0).permute(0, 3, 1, 2)
    for i in range(5):
        win = lr[generate_frame_indices(i, 5, 7, padding="reflection")][None]
        want = to_uint8_bgr(model(win, (2.0, 2.0)))[0].numpy()
        got = cv2.imread(str(tmp_path / "out" / f"{i:08d}.png"))
        assert got.shape == (20, 24, 3) and np.array_equal(got, want), i
