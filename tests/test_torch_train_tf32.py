"""The f32 training step's backward runs with TF32 off, as its forward does.

On the card PyTorch's process default is ``torch.backends.cudnn.allow_tf32
= True``: a backward outside the forward's precision guard ran cuDNN in
TF32 and put the card's f32 gradients 6.0e-5 relative L2 from the CPU's
(2.8e-7 with TF32 off). The flags are read inside the backward of the
trainer's own step (``SRModel.optimize_parameters``) by a gradient hook on
every parameter, with both flags set to True before the step.
"""

import numpy as np
import pytest
import torch

SMALL_NET = dict(type="SAVSR", num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5,
                 interval=0, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)


def _opt(precision: str) -> dict:
    return {
        "name": "tf32", "model_type": "ASVSRModel", "num_gpu": 1, "is_train": True,
        "dist": False, "rank": 0, "world_size": 1, "manual_seed": 0, "device": "cpu",
        "network_g": dict(SMALL_NET, matmul_precision=precision),
        "path": {"pretrain_network_g": None, "strict_load_g": True},
        "train": {"ema_decay": 0, "optim_g": {"type": "Adam", "lr": 1e-4},
                  "scheduler": {"type": "CosineAnnealingRestartLR", "periods": [10],
                                "restart_weights": [1], "eta_min": 1e-7},
                  "total_iter": 1, "warmup_iter": -1,
                  "pixel_opt": {"type": "CharbonnierLoss", "loss_weight": 1.0,
                                "reduction": "mean"}},
    }


@pytest.mark.parametrize("precision", ["float32", "default"])
def test_f32_step_backward_runs_with_tf32_off(precision):
    """At matmul_precision float32 and at default (f32 weights: every
    product one bf16 pass, which the f32 op is exactly only with TF32 off)
    every parameter's gradient is computed with
    ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` False; the flags are back to
    their values after the step."""
    from savsr_tpu_torch.models import build_model

    torch.manual_seed(0)
    model = build_model(_opt(precision))
    rng = np.random.default_rng(0)
    model.feed_data({"lq": rng.random((1, 7, 12, 12, 3), dtype=np.float32),
                     "gt": rng.random((1, 24, 24, 3), dtype=np.float32), "scale": (2.0, 2.0)})
    seen = []

    def record(grad):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return grad

    params = list(model.net_g.parameters())
    hooks = [p.register_hook(record) for p in params]
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        model.optimize_parameters(1)
        after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
        for h in hooks:
            h.remove()
    assert len(seen) == sum(p.grad is not None for p in params) > 0
    assert set(seen) == {(False, False)}, sorted(set(seen))
    assert after == (True, True)
