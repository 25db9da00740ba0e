"""The port's fast serving tier (f32 weights and carries at
``matmul_precision: default``) on the CPU against the JAX package, and the
bf16 STAU's rounding of its hat x-weights.

On a TPU an f32 dot at DEFAULT precision is one bf16 pass: both operands
rounded to bf16, exact products, f32 sums. XLA:CPU ignores the precision
and computes in f32, so the JAX side runs here under ``tpu_default_dots``, a
test-local shim that rounds the f32 operands of every ``dot_general`` and
``conv_general_dilated`` at None/DEFAULT precision (the Pallas kernels'
dots in interpret mode, ``@`` and ``jnp.einsum`` of the XLA heads; the
bilinear resize pinned to highest precision stays f32), as the TPU does.
The rounding is XLA's reduce_precision to bf16's bits (round to nearest
even), which no floating-point simplification of the compiled program
drops.

Tolerances: the convs, STA and the tail round only their inputs, so the
port's plain versions agree with the shimmed Pallas kernels to f32's 1e-5
of the output's scale; STAU rounds values inside the kernel (f0, sa, r*fc,
fea), where a different f32 sum order may round one value the other way:
at most one bf16 ulp of the output's largest value, and rarely. The whole
forward composes ~200 such convs: one rounding that lands the other way
moves the rest of the network, so the forward is held at the tier's own
floor, measured as the port's fast forward against itself with its conv
sums taken in reverse channel order (max 5.3e-4, mean 1.09e-4 on this
input), and well inside the tier's distance from strict.
"""

import contextlib
import functools
import os

import jax
import jax._src.lax.convolution as jax_conv_impl
import jax._src.lax.lax as jax_lax_impl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from savsr_tpu.archs.arch_util import Ctx
from savsr_tpu.archs.savsr_arch import SAVSR as JaxSAVSR
from savsr_tpu.archs.savsr_arch import _stau_sta_rows, stau_apply, tail_fused_apply
from savsr_tpu.ops.pallas.chw_conv import (chw_to_nhwc, conv1x1_chw, conv3x3_chw, nhwc_to_chw,
                                           pack_w3)
from savsr_tpu.utils.convert import convert_state_dict
from savsr_tpu_torch import ops
from savsr_tpu_torch.archs import savsr_arch as port_arch
from savsr_tpu_torch.archs.savsr_arch import SAVSR
from savsr_tpu_torch.ops.conv import conv_fused_fast
from savsr_tpu_torch.ops.sta import sta_conv_fused_fast
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


# ---------------------------------------------------------------------------
# the shim: the TPU's one bf16 pass at DEFAULT precision
# ---------------------------------------------------------------------------


def _round_bf16(t):
    """f32 -> the nearest bf16 value (ties to even), kept in f32, by XLA's
    reduce_precision (8 exponent and 7 mantissa bits: bf16's), which no
    floating-point simplification removes; straight through under
    differentiation (t + (round(t) - t) is round(t) exactly, and its
    gradient to t is the identity). The same values as rounding on the bits
    (round to nearest even), at a third less of a training graph's compile."""
    if t.dtype != jnp.float32:
        return t
    r = jax.lax.reduce_precision(t, exponent_bits=8, mantissa_bits=7)
    return t + jax.lax.stop_gradient(r - t)


def _default(precision) -> bool:
    if precision is None:
        return True
    if isinstance(precision, (tuple, list)):
        return all(_default(p) for p in precision)
    if isinstance(precision, str):
        return precision.lower() in ("default", "bfloat16", "fastest")
    return precision == jax.lax.Precision.DEFAULT


@contextlib.contextmanager
def tpu_default_dots():
    """Inside: every f32 dot_general / conv_general_dilated at None or
    DEFAULT precision takes its operands rounded to bf16, the transposed
    products of a gradient too (JAX's transpose rules call the module-level
    ``dot_general`` and ``conv_general_dilated`` of jax._src.lax, which the
    shim replaces, with the primal's precision): there the cotangent is
    rounded, while the rounding of a forward operand passes its gradient
    straight through. The compile caches are cleared on entry and exit: the
    kernels are jitted, and a trace cached on either side would skip (or
    keep) the shim."""
    dot0, conv0, einsum0 = jax.lax.dot_general, jax.lax.conv_general_dilated, jnp.einsum

    def dot(lhs, rhs, dimension_numbers, precision=None, preferred_element_type=None, **kw):
        if _default(precision):
            lhs, rhs = _round_bf16(lhs), _round_bf16(rhs)
        return dot0(lhs, rhs, dimension_numbers, precision=precision,
                    preferred_element_type=preferred_element_type, **kw)

    def conv(lhs, rhs, *args, precision=None, **kw):
        if _default(precision):
            lhs, rhs = _round_bf16(lhs), _round_bf16(rhs)
        return conv0(lhs, rhs, *args, precision=precision, **kw)

    def einsum(*args, **kw):  # binds its dot_general at import: hand it the shim's
        kw.setdefault("_dot_general", dot)
        return einsum0(*args, **kw)

    jax.clear_caches()
    jax.lax.dot_general = jax_lax_impl.dot_general = dot  # Pallas bodies; jnp.matmul
    jax.lax.conv_general_dilated = jax_conv_impl.conv_general_dilated = conv  # + transposes
    jnp.einsum = einsum
    try:
        yield
    finally:
        jax.lax.dot_general = jax_lax_impl.dot_general = dot0
        jax.lax.conv_general_dilated = jax_conv_impl.conv_general_dilated = conv0
        jnp.einsum = einsum0
        jax.clear_caches()


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# (a) each fast plain kernel against its Pallas kernel under the shim
# ---------------------------------------------------------------------------


def _conv_case(label):
    """(jax fn, port fn) of a conv case, NHWC out."""
    rng = np.random.default_rng(sum(map(ord, label)))
    # 17 and 66: widths off a multiple of 4 (the kernel's pitch-padded f32 copy)
    b, h, w = 2, 10, 66 if label.endswith("width 66") else 17
    if label == "conv1x1 3 parts":
        cin, cout = 48, 16
        x = rng.standard_normal((b, h, w, cin), dtype=np.float32)
        wt = (rng.standard_normal((cin, cout)) * cin ** -0.5).astype(np.float32)
        bias = rng.standard_normal((cout,), dtype=np.float32)
        res = rng.standard_normal((b, h, w, cout), dtype=np.float32)

        def jax_fn():
            y = conv1x1_chw(nhwc_to_chw(jnp.asarray(x)), jnp.asarray(wt.T),
                            jnp.asarray(bias).reshape(-1, 1), jnp.ones((cout, 1), jnp.float32),
                            None, nhwc_to_chw(jnp.asarray(res)), h=h, w=w, lrelu=(0.6, 0.4))
            return np.asarray(chw_to_nhwc(y, h, w))

        def port_fn():
            xt = _nchw(x)
            return _nhwc(conv_fused_fast([xt[:, :16], xt[:, 16:32], xt[:, 32:]],
                                         torch.from_numpy(wt.T.copy())[:, :, None, None],
                                         torch.from_numpy(bias), lrelu=(0.6, 0.4),
                                         residual=_nchw(res)))
        return jax_fn, port_fn
    per_sample = label == "conv3x3 per-sample"
    cin, cout = 32, 16
    x = rng.standard_normal((b, h, w, cin), dtype=np.float32)
    wt = (rng.standard_normal((b if per_sample else 1, 3, 3, cin, cout))
          * (9 * cin) ** -0.5).astype(np.float32)
    bias = (np.zeros(cout) if per_sample else rng.standard_normal(cout)).astype(np.float32)
    scale = (np.ones((b, cout)) if per_sample else rng.uniform(0.5, 1.5, (b, cout)))
    scale = scale.astype(np.float32)
    pre = None if per_sample else rng.standard_normal((b, h, w, cout), dtype=np.float32)
    res = None if per_sample else rng.standard_normal((b, h, w, cout), dtype=np.float32)

    def jax_fn():
        w3 = (jnp.stack([pack_w3(jnp.asarray(wt[i])) for i in range(b)]) if per_sample
              else pack_w3(jnp.asarray(wt[0])))
        y = conv3x3_chw(nhwc_to_chw(jnp.asarray(x)), w3, jnp.asarray(bias).reshape(-1, 1),
                        jnp.asarray(scale)[:, :, None],
                        None if pre is None else nhwc_to_chw(jnp.asarray(pre)),
                        None if res is None else nhwc_to_chw(jnp.asarray(res)),
                        h=h, w=w, lrelu=(0.6, 0.4))
        return np.asarray(chw_to_nhwc(y, h, w))

    def port_fn():
        w_oihw = np.moveaxis(wt, (-1, -2), (-4, -3))
        xt = _nchw(x)
        return _nhwc(conv_fused_fast(
            [xt[:, :12], xt[:, 12:]],
            torch.from_numpy(np.ascontiguousarray(w_oihw if per_sample else w_oihw[0])),
            None if per_sample else torch.from_numpy(bias),
            pre_add=None if pre is None else _nchw(pre),
            out_scale=None if per_sample else torch.from_numpy(scale), lrelu=(0.6, 0.4),
            residual=None if res is None else _nchw(res)))
    return jax_fn, port_fn


def _sta_case():
    rng = np.random.default_rng(12)
    b, h, w, c = 1, 9, 13, 16
    x = rng.standard_normal((b, h, w, c), dtype=np.float32)
    st = rng.standard_normal((b, h, w, c), dtype=np.float32)
    wk = (0.2 * rng.standard_normal((25 * c, c))).astype(np.float32)  # torch [25C, C]
    bias = (0.1 * rng.standard_normal((25 * c,))).astype(np.float32)
    params = {"kernel_conv.0.weight": jnp.asarray(wk.T[None, None]),
              "kernel_conv.0.bias": jnp.asarray(bias)}

    def jax_fn():
        rows = jax.jit(lambda p, x, st: _stau_sta_rows(Ctx(p), "", x, st, 5, 128))(
            params, jnp.asarray(x), jnp.asarray(st))
        return np.asarray(rows)[..., :w].transpose(0, 1, 3, 2)  # NHWC

    def port_fn():
        return _nhwc(sta_conv_fused_fast(_nchw(x), _nchw(st),
                                         torch.from_numpy(wk)[:, :, None, None],
                                         torch.from_numpy(bias)))
    return jax_fn, port_fn


def _stau_case(dtype=torch.float32):
    """STA + STAU with the coordinate head inline, on the STAU golden
    fixture at x(2.5, 1.7): the JAX CHW engine against the port's
    ``stau_apply`` (fast; bf16 with ``dtype``)."""
    sd = dict(np.load(os.path.join(GOLDEN_DIR, "stau_state.npz")))
    io = np.load(os.path.join(GOLDEN_DIR, "module_io.npz"))
    scale = (2.5, 1.7)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    params = {k: jnp.asarray(v).astype(jdt) for k, v in convert_state_dict(sd).items()}

    def jax_fn():
        y = jax.jit(lambda p, x, st: stau_apply(Ctx(p, conv_engine="chw"), "", x, scale, st, 32))(
            params, jnp.asarray(io["stau_x"].transpose(0, 2, 3, 1)).astype(jdt),
            jnp.asarray(io["stau_st"].transpose(0, 2, 3, 1)).astype(jdt))
        return np.asarray(y.astype(jnp.float32))

    def port_fn():
        m = port_arch.STAUpsample(32)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        m = m.to(dtype)
        with torch.no_grad():
            y = port_arch.stau_apply(m, torch.from_numpy(io["stau_x"]).to(dtype), scale,
                                     torch.from_numpy(io["stau_st"]).to(dtype),
                                     fast=dtype == torch.float32)
        return _nhwc(y.float())
    return jax_fn, port_fn


def _tail_case():
    rng = np.random.default_rng(13)
    b, c, h0, w0 = 2, 16, 9, 13
    H, W = port_arch.get_hw(h0, w0, (2.5, 1.7))
    sr = rng.standard_normal((b, H, W, c), dtype=np.float32)
    xc = rng.random((b, h0, w0, 3), dtype=np.float32)
    wt = (0.1 * rng.standard_normal((3, c, 3, 3))).astype(np.float32)  # torch layout
    bias = (0.1 * rng.standard_normal((3,))).astype(np.float32)
    wp = -(-W // 128) * 128
    sr_rows = np.zeros((b, H, c, wp), np.float32)
    sr_rows[..., :W] = sr.transpose(0, 1, 3, 2)
    params = {"tail.weight": jnp.asarray(wt.transpose(2, 3, 1, 0)),
              "tail.bias": jnp.asarray(bias)}

    def jax_fn():
        return np.asarray(jax.jit(lambda p, sr, xc: tail_fused_apply(Ctx(p), sr, xc, h0, w0, H, W))(
            params, jnp.asarray(sr_rows), jnp.asarray(xc)))

    def port_fn():
        tail = torch.nn.Conv2d(c, 3, 3, padding=1)
        tail.load_state_dict({"weight": torch.from_numpy(wt), "bias": torch.from_numpy(bias)})
        with torch.no_grad():
            return _nhwc(port_arch.tail_fused_apply(tail, _nchw(sr), _nchw(xc), fast=True))
    return jax_fn, port_fn


KERNEL_CASES = {
    "conv3x3 shared, full epilogue": lambda: _conv_case("conv3x3 shared, full epilogue"),
    "conv3x3 per-sample": lambda: _conv_case("conv3x3 per-sample"),
    "conv3x3 shared, width 66": lambda: _conv_case("conv3x3 shared, width 66"),
    "conv1x1 3 parts": lambda: _conv_case("conv1x1 3 parts"),
    "sta": _sta_case,
    "stau": _stau_case,
    "tail": _tail_case,
}


BITE_CASES = ("conv3x3 shared, full epilogue", "tail")


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_fast_plain_kernel_matches_pallas_under_default_precision(case):
    """Rows 1-3 and 5: max abs <= 1e-5 x max|ref| (f32 sums of the same
    exact products in another order). Row 4 (STAU, coordinate head and STA
    included): max abs <= 2^-8 x max|ref| (one bf16 ulp at an internal
    rounding point) and mean abs <= 1e-6 (such roundings are rare). The
    shim bites: the shimmed Pallas output is more than 1e-3 x max|ref|
    from the unshimmed one (checked on the full-epilogue conv and the tail,
    a second compile each; the forward shows it for the rest)."""
    jax_fn, port_fn = KERNEL_CASES[case]()
    plain = jax_fn() if case in BITE_CASES else None
    with tpu_default_dots():
        want = jax_fn()
    got = port_fn()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want)
    if case == "stau":
        assert err.max() <= 2.0 ** -8 * scale and err.mean() <= 1e-6, (err.max(), err.mean())
    else:
        assert err.max() <= 1e-5 * scale, err.max()
    assert plain is None or np.abs(want - plain).max() > 1e-3 * scale


def test_bf16_stau_rounds_its_hat_weights_as_the_pallas_kernel():
    """The bf16 STAU against the JAX CHW engine's bf16 STAU on the golden
    fixture: mean abs <= 7e-4 with the hat x-weights rounded to bf16 (as
    ``stau_kernel.py:107`` rounds them); with them left in f32 the mean is
    1.31e-3 (shown here by undoing the rounding)."""
    import savsr_tpu_torch.ops.stau as stau_ops

    jax_fn, port_fn = _stau_case(torch.bfloat16)
    want = jax_fn()
    err = np.abs(port_fn() - want)
    assert err.mean() <= 7e-4, err.mean()
    gather = stau_ops.bilinear_gather
    stau_ops.bilinear_gather = lambda x, fy, fx, col_dtype=None: gather(x, fy, fx)
    try:
        unrounded = np.abs(port_fn() - want).mean()
    finally:
        stau_ops.bilinear_gather = gather
    assert unrounded > 1e-3 > err.mean(), (unrounded, err.mean())


# ---------------------------------------------------------------------------
# (b) the small-config forward
# ---------------------------------------------------------------------------


def _state():
    return dict(np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")))


def _port(**kw):
    m = SAVSR(**SMALL_CFG, **kw).eval()
    load_into(m, {k: torch.from_numpy(v) for k, v in _state().items()})
    return m


@pytest.fixture(scope="module")
def forwards():
    """One window of the small golden input at x(1.5, 3.5): the JAX
    package's ``matmul_precision="default"`` forward (CHW engine) under the
    shim (one compile), and the port's fast, strict, split and bf16 forwards
    with the fast tier's plain-version calls, [1, 3, H, W] f32."""
    x = np.load(os.path.join(GOLDEN_DIR, "savsr_small_forward.npz"))["x"][:1]
    params = {k: jnp.asarray(v) for k, v in convert_state_dict(_state()).items()}
    jmodel = JaxSAVSR(**SMALL_CFG, conv_engine="chw", matmul_precision="default")
    with tpu_default_dots():
        y_jax = np.asarray(jax.jit(functools.partial(jmodel.apply, scale=SCALE))(
            params, jnp.asarray(x.transpose(0, 1, 3, 4, 2)))[0]).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x)
    fast = _port(matmul_precision="default")
    ops.reset_counts()
    out = {"jax": y_jax, "fast": fast(xt, SCALE).numpy(), "calls": dict(ops.plain_calls),
           "strict": _port()(xt, SCALE).numpy(),
           "split": _port(conv_precision="split")(xt, SCALE).numpy(),
           "bf16": _port().to(torch.bfloat16)(xt.bfloat16(), SCALE).float().numpy()}
    statics = fast.stau_statics(x.shape[-2:], SCALE, dtype=torch.float32)
    out["statics"] = (statics, fast(xt, SCALE, stau_statics=statics).numpy())
    return out


def test_fast_forward_matches_jax_default_precision(forwards):
    """Max abs <= 1e-3 and mean abs <= 2e-4 on outputs in [0, 1] (the
    tier's floor, see the module docstring), and the mean at least 5x below
    the JAX fast forward's own distance from strict (the port's strict
    forward is the unshimmed JAX forward's within 1e-5, tests/
    test_torch_savsr.py: so the shim bites)."""
    got, want = forwards["fast"], forwards["jax"]
    assert got.shape == want.shape == (1, 3, 16, 49)
    err = np.abs(got - want)
    assert err.max() <= 1e-3 and err.mean() <= 2e-4, (err.max(), err.mean())
    assert 5 * err.mean() < np.abs(want - forwards["strict"]).mean()


def test_fast_forward_runs_the_fast_kernels_only(forwards):
    """On the CPU the fast tier calls the fast plain versions (1 STA,
    STAU and tail a forward) and nothing of the other tiers."""
    calls = forwards["calls"]
    assert calls["conv3x3_fast"] > 0 and calls["conv1x1_fast"] > 0
    assert calls["sta_fast"] == calls["stau_fast"] == calls["tail_fast"] == 1
    for k in ("conv3x3", "conv1x1", "sta", "stau", "tail", "conv3x3_split", "conv1x1_split"):
        assert calls[k] == 0, k


def test_fast_lies_between_bf16_and_split(forwards):
    """As phase 11 of chip_smoke.py holds it on the card: deviation PSNR
    against strict at least the bf16 tier's, and max abs against strict at
    least 10x the split tier's (the fast tier is not secretly strict)."""
    strict = forwards["strict"]

    def psnr(y):
        return 10 * np.log10(1.0 / np.mean((y - strict) ** 2))

    assert psnr(forwards["fast"]) >= psnr(forwards["bf16"])
    err_fast = np.abs(forwards["fast"] - strict).max()
    assert err_fast >= 10 * np.abs(forwards["split"] - strict).max(), err_fast


def test_fast_statics_carry_the_bf16_kernels_plan(forwards):
    """The fast tier runs STAU on the bf16 kernel's fast mode, so its statics
    carry that kernel's tile (at the fast mode's capacity,
    tests/test_torch_stau_plan.py), and a forward on them equals the inline
    one."""
    from savsr_tpu_torch.ops.stau import PLAN_COLS, PLAN_ROWS

    statics, y = forwards["statics"]
    H, W = forwards["fast"].shape[2:]
    assert tuple(statics["stau_plan"].shape) == (-(-H // PLAN_ROWS) * -(-W // PLAN_COLS), 8)
    assert np.array_equal(y, forwards["fast"])


# ---------------------------------------------------------------------------
# (c) tiers and routing
# ---------------------------------------------------------------------------


def test_tiers_match_the_jax_cli(capsys):
    """The port's ``--tier`` choices are the JAX CLI's, and each tier builds
    a network with the JAX package's precisions; f32 split with default
    precision raises naming both options."""
    from savsr_tpu import inference as jax_inference
    from savsr_tpu_torch.inference import TIERS, build_serving_model

    with pytest.raises(SystemExit):
        jax_inference.main(["--help"])
    assert "{" + ",".join(TIERS) + "}" in capsys.readouterr().out
    for tier in TIERS:
        jcfg, cfg = jax_inference.build_serving_model(tier).cfg, build_serving_model(tier).cfg
        assert (cfg.matmul_precision, cfg.conv_precision) == (jcfg.matmul_precision,
                                                              jcfg.conv_precision), tier
    model = SAVSR(**SMALL_CFG, matmul_precision="default", conv_precision="split")
    with pytest.raises(NotImplementedError, match="conv_precision: split.*matmul_precision"):
        model.serving_tier()


def test_cli_tier_fast_writes_the_direct_fast_forward(tmp_path):
    """``--tier fast --device cpu`` writes, for every frame, the uint8 BGR
    frame of a direct fast forward of its window (one batch of 4)."""
    import cv2

    from savsr_tpu_torch.data.data_util import generate_frame_indices
    from savsr_tpu_torch.inference import build_serving_model, main, to_uint8_bgr
    from savsr_tpu_torch.utils.convert import params_to_jax

    rng = np.random.default_rng(3)
    clip = tmp_path / "clip"
    clip.mkdir()
    frames = (rng.random((4, 10, 12, 3)) * 255).astype(np.uint8)
    for i, f in enumerate(frames):
        cv2.imwrite(str(clip / f"{i:08d}.png"), f)
    ckpt = tmp_path / "net_g.npz"
    np.savez(ckpt, **{f"params/{k}": v for k, v in params_to_jax(_port().state_dict()).items()})
    yml = tmp_path / "net.yml"
    yml.write_text("network_g:\n  type: SAVSR\n"
                   + "".join(f"  {k}: {v}\n" for k, v in SMALL_CFG.items()))
    assert main(["-i", str(clip), "-o", str(tmp_path / "out"), "-s", "2", "-w", str(ckpt),
                 "--opt", str(yml), "--tier", "fast", "--device", "cpu",
                 "--windows", "4"]) == 0

    model = build_serving_model("fast", SMALL_CFG)
    load_into(model, {k: torch.from_numpy(v) for k, v in _state().items()})
    assert model.serving_tier() == "fast"
    lr = torch.from_numpy(frames[..., ::-1].astype(np.float32) / 255.0).permute(0, 3, 1, 2)
    wins = torch.stack([lr[generate_frame_indices(i, 4, 7, padding="reflection")]
                        for i in range(4)])
    want = to_uint8_bgr(model(wins, (2.0, 2.0))).numpy()
    for i in range(4):
        got = cv2.imread(str(tmp_path / "out" / f"{i:08d}.png"))
        assert got.shape == (20, 24, 3) and np.array_equal(got, want[i]), i


def test_eval_yaml_with_default_precision_runs_the_fast_tier(tmp_path):
    """An f32 eval whose network_g says ``matmul_precision: default`` runs
    the fast plain versions (and no strict one) through ``python -m
    savsr_tpu_torch.test``, with finite metrics."""
    import cv2

    from savsr_tpu_torch.test import test_pipeline
    from savsr_tpu_torch.utils.convert import params_to_jax

    rng = np.random.default_rng(4)
    gt = tmp_path / "GT" / "clip"
    gt.mkdir(parents=True)
    img = (rng.random((20, 24, 3)) * 255).astype(np.uint8)
    for i in range(4):
        cv2.imwrite(str(gt / f"{i:08d}.png"), np.roll(img, i, axis=1))
    np.savez(tmp_path / "net_g.npz",
             **{f"params/{k}": v for k, v in params_to_jax(_port().state_dict()).items()})
    net = "".join(f"  {k}: {v}\n" for k, v in SMALL_CFG.items())
    cfg = tmp_path / "fast.yml"
    cfg.write_text(f"""
name: fast_eval
model_type: ASVSRModel
num_gpu: 1
manual_seed: 0
datasets:
  test_01:
    name: Vid4_x2
    type: ASVideoTestDataset
    dataroot_gt: {tmp_path}/GT
    dataroot_lq: {tmp_path}/GT
    io_backend:
      type: disk
    cache_data: false
    num_frame: 7
    padding: reflection
    use_arbitrary_scale_downsampling: true
    downsampling_scale: !!python/tuple [2.0, 2.0]
    downsampling_mode: torch
network_g:
  type: SAVSR
{net}  matmul_precision: default
path:
  pretrain_network_g: {tmp_path}/net_g.npz
  strict_load_g: true
  resume_state: ~
val:
  save_img: false
  suffix: ~
  metrics:
    psnr_y:
      type: calculate_psnr
      crop_border: 0
      test_y_channel: true
""")
    ops.reset_counts()
    results = test_pipeline(str(tmp_path), ["-opt", str(cfg), "--device", "cpu"])
    calls = dict(ops.plain_calls)
    assert np.isfinite(results["Vid4_x2"]["psnr_y"])
    assert calls["conv3x3_fast"] > 0
    assert calls["sta_fast"] == calls["stau_fast"] == calls["tail_fast"] == 4  # a frame each
    assert calls["conv3x3"] == calls["sta"] == calls["stau"] == calls["tail"] == 0
