"""The port's trainer (savsr_tpu_torch.models) against the torch oracle's
6-step trajectory, its gradient accumulation, its optimizer/scheduler
factory against the JAX package's, and the checkpoint interchange between
the two packages. Everything runs on the CPU (the OSConv kernels' plain
versions); tolerances are stated at each check.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from savsr_tpu_torch.models import build_model
from savsr_tpu_torch.utils.convert import params_from_jax, params_to_jax

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
TRAJ = os.path.join(GOLDEN_DIR, "savsr_small_trajectory.npz")
STATE = os.path.join(GOLDEN_DIR, "savsr_small_state.npz")
NET = dict(type="SAVSR", num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5,
           interval=0, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2,
           center_frame_idx=None, osconv_impl="pallas_train", remat_train=False)


def _opt(tmp_path, init_npz=None, **train):
    return {
        "name": "traj", "model_type": "ASVSRModel", "num_gpu": 1, "is_train": True,
        "dist": False, "rank": 0, "world_size": 1, "manual_seed": 0, "device": "cpu",
        "network_g": dict(NET),
        "path": {"pretrain_network_g": init_npz, "strict_load_g": True, "log": str(tmp_path),
                 "models": str(tmp_path), "training_states": str(tmp_path)},
        "datasets": {}, "scale": (2.0, 2.0),
        "train": {
            "ema_decay": 0.999, "bf16": False,
            "optim_g": {"type": "Adam", "lr": 2e-4, "weight_decay": 0,
                        "betas": [0.9, 0.999], "eps": 1e-8},
            # effectively-constant lr over 6 iters (cos over 1e9 period)
            "scheduler": {"type": "CosineAnnealingRestartLR", "periods": [1000000000],
                          "restart_weights": [1], "eta_min": 1e-7},
            "total_iter": 10, "warmup_iter": -1,
            "pixel_opt": {"type": "CharbonnierLoss", "loss_weight": 1.0, "reduction": "mean"},
            **train,
        },
    }


def _init_npz(tmp_path):
    """The torch oracle's initial state as a JAX-layout pretrain npz, so the
    model goes through its production load path."""
    sd = {k: torch.from_numpy(v) for k, v in np.load(STATE).items()}
    path = str(tmp_path / "init.npz")
    np.savez(path, **{f"params/{k}": v for k, v in params_to_jax(sd).items()})
    return path


def _check(got, ref, what, atol, rtol):
    err = np.abs(got - ref).max()
    assert err < atol + rtol * np.abs(ref).max(), (what, err, np.abs(ref).max())


def test_training_trajectory_matches_torch_oracle(tmp_path):
    """6 lockstep steps (Adam, EMA 0.999, BatchNorm momentum) against
    tests/goldens/savsr_small_trajectory.npz, at the bounds of
    tests/test_train_trajectory.py: loss 2e-5; params and EMA
    atol 2e-5 + rtol 5e-4 (2.5e-3 on the final trainables); BatchNorm
    statistics atol 5e-6 + rtol 3e-3."""
    golden = np.load(TRAJ)
    steps = int(golden["loss"].shape[0])
    model = build_model(_opt(tmp_path, _init_npz(tmp_path)))

    def tracked(prefix):
        head = f"{prefix}/"
        return {k[len(head):]: golden[k] for k in golden.files if k.startswith(head)}

    for t in range(steps):
        model.update_learning_rate(t + 1, warmup_iter=-1)
        # the golden batches are NTCHW; the loader's batches are channel-last
        model.feed_data({"lq": golden["lq"][t].transpose(0, 1, 3, 4, 2),
                         "gt": golden["gt"][t].transpose(0, 2, 3, 1), "scale": (2.0, 2.0)})
        model.optimize_parameters(t + 1)
        loss = model.log_dict["l_pix"]
        assert abs(loss - float(golden["loss"][t])) < 2e-5, (t, loss)
        ours_p = {k: v.numpy() for k, v in model.net_g.state_dict().items()}
        ours_e = {k: v.numpy() for k, v in model.params_ema.items()}
        for k, ref in tracked(f"t{t}/p").items():
            _check(ours_p[k], ref, (t, "p", k), atol=2e-5, rtol=5e-4)
        for k, ref in tracked(f"t{t}/e").items():
            _check(ours_e[k], ref, (t, "e", k), atol=2e-5, rtol=5e-4)
        for k, ref in tracked(f"t{t}/b").items():
            _check(ours_p[k], ref, (t, "b", k), atol=5e-6, rtol=3e-3)

    final_p, final_e = tracked("final/p"), tracked("final/e")
    ours_p = {k: v.numpy() for k, v in model.net_g.state_dict().items()}
    ours_e = {k: v.numpy() for k, v in model.params_ema.items()}
    assert set(final_p) == set(ours_p)
    for k, ref in final_p.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            _check(ours_p[k], ref, ("final b", k), atol=5e-6, rtol=3e-3)
        else:
            _check(ours_p[k], ref, ("final p", k), atol=2e-5, rtol=2.5e-3)
    for k, ref in final_e.items():
        _check(ours_e[k], ref, ("final e", k), atol=2e-5, rtol=5e-4)


def test_accum_steps_is_the_mean_of_micro_batch_gradients(tmp_path):
    """accum_steps: 2 on a batch of 2: the gradient equals the mean of the
    two micro-batch gradients taken one after the other, with the BatchNorm
    statistics of the first chained into the second (exact up to the f32
    sum's order: 1e-6 relative to each gradient's max), and the statistics
    after the step are those of two consecutive forwards."""
    golden = np.load(TRAJ)
    init = _init_npz(tmp_path)
    lq = golden["lq"][0].transpose(0, 1, 3, 4, 2)
    gt = golden["gt"][0].transpose(0, 2, 3, 1)

    model = build_model(_opt(tmp_path, init, accum_steps=2))
    model.update_learning_rate(1)
    model.feed_data({"lq": lq, "gt": gt, "scale": (2.0, 2.0)})
    model.optimize_parameters(1)
    got = {k: p.grad.clone() for k, p in model.net_g.named_parameters()}
    got_stats = {k: v.clone() for k, v in model.net_g.named_buffers()}

    ref = build_model(_opt(tmp_path, init))
    ref.feed_data({"lq": lq, "gt": gt, "scale": (2.0, 2.0)})
    want = None
    for m in range(2):
        ref.net_g.zero_grad()
        total, _, updates = ref._loss(ref.lq[m:m + 1], ref.gt[m:m + 1], (2.0, 2.0))
        total.backward()
        ref._apply_stats(updates)
        g = {k: p.grad.clone() for k, p in ref.net_g.named_parameters()}
        want = g if want is None else {k: (want[k] + g[k]) / 2 for k in g}
    for k in want:
        tol = max(1e-6 * float(want[k].abs().max()), 1e-10)
        assert float((got[k] - want[k]).abs().max()) <= tol, k
    for k, v in ref.net_g.named_buffers():
        assert torch.allclose(got_stats[k].float(), v.float(), rtol=0, atol=1e-7), k
    assert int(got_stats["adapt.0.mask.1.num_batches_tracked"]) == 2

    with pytest.raises(ValueError, match="accum_steps"):
        bad = build_model(_opt(tmp_path, init, accum_steps=3))
        bad.feed_data({"lq": lq, "gt": gt, "scale": (2.0, 2.0)})
        bad.optimize_parameters(1)


def test_bf16_step_keeps_f32_masters(tmp_path):
    """train: bf16 is a whole cast inside the graph: gradients, parameters,
    BatchNorm statistics and EMA stay f32, and the loss stays within bf16's
    reach of the f32 step's (5e-2 relative: the small net's activations pass
    ~60 bf16 roundings)."""
    golden = np.load(TRAJ)
    init = _init_npz(tmp_path)
    data = {"lq": golden["lq"][0].transpose(0, 1, 3, 4, 2),
            "gt": golden["gt"][0].transpose(0, 2, 3, 1), "scale": (2.0, 2.0)}
    model = build_model(_opt(tmp_path, init, bf16=True))
    model.update_learning_rate(1)
    model.feed_data(data)
    model.optimize_parameters(1)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.net_g.parameters())
    assert all(v.dtype in (torch.float32, torch.int64) for v in model.net_g.buffers())
    assert all(v.dtype in (torch.float32, torch.int64) for v in model.params_ema.values())
    loss = model.log_dict["l_pix"]
    assert abs(loss - float(golden["loss"][0])) < 5e-2 * float(golden["loss"][0])


# --------------------------------------------------------------------------- #
# optimizers and schedules against the JAX package's
# --------------------------------------------------------------------------- #


def _toy_problem(seed=0, n=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(16, n).astype(np.float32), rng.randn(16).astype(np.float32),
            rng.randn(n).astype(np.float32), rng.randn(1).astype(np.float32))


OPTIMS = [
    ("Adam", dict(lr=0.05, weight_decay=0.01, betas=[0.9, 0.99])),
    ("AdamW", dict(lr=0.05, weight_decay=0.01, betas=[0.9, 0.99])),
    ("Adamax", dict(lr=0.05, weight_decay=0, betas=[0.9, 0.99])),
    ("SGD", dict(lr=0.05, weight_decay=0.01, momentum=0.9)),
    ("RMSprop", dict(lr=0.01, weight_decay=0, alpha=0.9)),
    ("ASGD", dict(lr=0.05, weight_decay=0.01, lambd=1e-2, t0=4)),
    ("Rprop", dict(lr=0.05)),
]


@pytest.mark.parametrize("optim_type,kwargs", OPTIMS, ids=[o[0] for o in OPTIMS])
def test_optimizer_factory_matches_jax_package(optim_type, kwargs):
    """12 steps on a 2-tensor least-squares problem, with a stepped lr
    schedule, through each package's optimizer factory and lr handling:
    parameters agree to rtol 2e-5 / atol 2e-6 (f32 arithmetic in another
    order)."""
    from savsr_tpu.models.base_model import BaseModel as JBase
    from savsr_tpu_torch.models.base_model import BaseModel as TBase

    X, y, w0, b0 = _toy_problem()
    steps = 12
    lrs = [kwargs["lr"] * (0.5 if t >= 6 else 1.0) for t in range(steps)]

    jm = JBase.__new__(JBase)
    tx = jm.get_optimizer(optim_type, **dict(kwargs))
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = tx.init(params)
    grad_fn = jax.grad(lambda p: jnp.mean((X @ p["w"] + p["b"] - y) ** 2))
    for t in range(steps):
        upd, state = tx.update(grad_fn(params), state, params)
        if not jm._opt_self_scaled:
            upd = jax.tree_util.tree_map(lambda u: u * lrs[t], upd)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)

    tm = TBase.__new__(TBase)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    b = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    tm.optimizers = [tm.get_optimizer(optim_type, [w, b], **dict(kwargs))]
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    for t in range(steps):
        tm.schedulers = [lambda it, t=t: lrs[t]]
        tm.update_learning_rate(t + 1)
        tm.optimizers[0].zero_grad()
        ((Xt @ w + b - yt) ** 2).mean().backward()
        tm.optimizers[0].step()
    assert tm._opt_self_scaled == jm._opt_self_scaled
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(params["b"]), rtol=2e-5, atol=2e-6)


SCHEDULERS = [
    {"type": "CosineAnnealingRestartLR", "periods": [10, 20], "restart_weights": [1, 0.5],
     "eta_min": 1e-7},
    {"type": "MultiStepRestartLR", "milestones": [5, 12], "gamma": 0.5, "restarts": [0, 15],
     "restart_weights": [1, 0.3]},
    {"type": "constant"},
]


@pytest.mark.parametrize("sched", SCHEDULERS, ids=[s["type"] for s in SCHEDULERS])
def test_schedules_and_warmup_match_jax_package(sched):
    """The port's copy of the schedules and the warmup rule give the JAX
    package's learning rates exactly, iteration by iteration."""
    from savsr_tpu.models.base_model import BaseModel as JBase
    from savsr_tpu_torch.models.base_model import BaseModel as TBase

    opt = {"train": {"scheduler": dict(sched), "optim_g": {"lr": 2e-4}}}
    jm, tm = JBase.__new__(JBase), TBase.__new__(TBase)
    jm.opt = tm.opt = opt
    tm.optimizers = []
    jm.setup_schedulers()
    tm.setup_schedulers()
    for it in range(1, 32):
        jm.update_learning_rate(it, warmup_iter=4)
        tm.update_learning_rate(it, warmup_iter=4)
        assert jm._current_lrs == tm._current_lrs, it


# --------------------------------------------------------------------------- #
# checkpoint interchange
# --------------------------------------------------------------------------- #


def test_params_to_jax_inverts_params_from_jax():
    from savsr_tpu.utils.convert import convert_state_dict

    sd = dict(np.load(STATE))
    jax_params = convert_state_dict(sd)
    back = params_to_jax(params_from_jax(jax_params))
    assert set(back) == set(jax_params)
    for k, v in jax_params.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        assert np.array_equal(back[k], v), k


def test_checkpoint_interchange_with_jax_package(tmp_path):
    """A checkpoint the port writes loads in the JAX package (load_network,
    strict key check against a fresh JAX init) with params and params_ema
    equal to the port's state, and the JAX package's file loads back into
    the port."""
    from savsr_tpu.archs.savsr_arch import SAVSR as JSAVSR
    from savsr_tpu.models.base_model import BaseModel as JBase

    model = build_model(_opt(tmp_path, _init_npz(tmp_path)))
    with torch.no_grad():  # make EMA differ from params
        for v in model.params_ema.values():
            if v.dtype == torch.float32:
                v.mul_(0.5)
    model.save(epoch=0, current_iter=6)
    path = str(tmp_path / "net_g_6.npz")
    assert os.path.isfile(path) and os.path.isfile(str(tmp_path / "6.state"))

    jm = JBase.__new__(JBase)
    net_kwargs = {k: v for k, v in NET.items() if k != "type"}
    fresh = JSAVSR(**net_kwargs).init(jax.random.PRNGKey(0))
    for key, state in (("params", model.net_g.state_dict()), ("params_ema", model.params_ema)):
        loaded = jm.load_network(path, key)
        jm.check_loaded_keys(fresh, loaded, strict=True)
        want = params_to_jax(state)
        for k, v in loaded.items():
            assert v.shape == fresh[k].shape and np.array_equal(v, want[k]), (key, k)

    # the JAX package's own writer -> the port
    jm.save_network({"params": {k: np.asarray(v) for k, v in fresh.items()}}, str(tmp_path),
                    "net_j", 1)
    opt = _opt(tmp_path, str(tmp_path / "net_j_1.npz"))
    back = build_model(opt)
    want = params_from_jax({k: np.asarray(v) for k, v in fresh.items()})
    for k, v in back.net_g.state_dict().items():
        assert torch.equal(v, want[k]), k

    # resume: the optimizer state of the port's own .state file
    state = torch.load(str(tmp_path / "6.state"), map_location="cpu", weights_only=True)
    assert state["iter"] == 6 and state["epoch"] == 0
    back.resume_training(state)
