"""The port's CPU training forward does not depend on the thread count.

One whole tier-1 run once saw the first training forward of a worker give
loss 0.29711607 where every other run gives 0.29711705 (the JAX package:
0.29711717; tests/test_torch_train_forward.py holds the two within 1e-6).
The cause was not found: 1-8 threads, six concurrent processes and 16
alignments of the input buffer all give the same loss. This test keeps
the known suspect, the split of CPU reductions and GEMMs over threads,
from moving the result: the forward and the loss at 1, 2 and the default
number of threads, each in a fresh model, agree with each other within the
bounds of tests/test_torch_train_forward.py (output 1e-5, loss 1e-6) and
with the JAX package's loss on this batch within 1e-6.
"""

import os

import numpy as np
import torch

from savsr_tpu_torch.archs.savsr_arch import SAVSR
from savsr_tpu_torch.utils.convert import load_into

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SMALL_CFG = dict(num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5,
                 interval=0, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)
# jax.value_and_grad of savsr_tpu's SAVSR.apply(train=True,
# osconv_impl="pallas_train") on this batch (the value
# test_train_forward_loss_and_gradients_match_jax compares with)
JAX_LOSS = 0.29711717


def _forward(threads: int):
    state = dict(np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")))
    model = SAVSR(**SMALL_CFG, remat_train=False)
    load_into(model, {k: torch.from_numpy(v) for k, v in state.items()})
    rng = np.random.default_rng(3)
    lq = rng.random((2, 7, 12, 12, 3), dtype=np.float32).transpose(0, 1, 4, 2, 3).copy()
    gt = rng.random((2, 24, 24, 3), dtype=np.float32).transpose(0, 3, 1, 2).copy()
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        sr, _ = model.train()(torch.from_numpy(lq), (2.0, 2.0), train=True)
        loss = torch.sqrt((sr - torch.from_numpy(gt)) ** 2 + 1e-12).mean()
    finally:
        torch.set_num_threads(old)
    return sr.detach(), float(loss.detach())


def test_training_forward_is_independent_of_the_thread_count():
    runs = [_forward(n) for n in (1, 2, torch.get_num_threads())]
    sr0, loss0 = runs[0]
    for sr, loss in runs[1:]:
        assert float((sr - sr0).abs().max()) <= 1e-5
        assert abs(loss - loss0) <= 1e-6
    for _, loss in runs:
        assert abs(loss - JAX_LOSS) <= 1e-6, loss
