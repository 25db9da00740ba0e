"""Evaluation entry point: ``python -m savsr_tpu_torch.test -opt <cfg.yml>``.

The port's counterpart of ``savsr_tpu/test.py`` (lbasicsr/test.py): one
loader per ``test_*`` dataset block, the model of ``model_type`` with its
``pretrain_network_g`` weights, and for each dataset the eval scale
(``downsampling_scale`` > ``val_scale`` > ``scale``) and
``model.validation``: per-folder, per-frame metrics, logged and returned,
and with ``val: save_img`` the SR frames under
``results/<name>/visualization/<dataset>/<folder>/``. Runs on CUDA unless
``--device cpu`` is given (every kernel then takes its plain PyTorch
version); asking for CUDA without a card is an error.

``network_g: conv_precision: split`` evaluates on the split serving tier
(the split conv's pair carries; STA, STAU and the tail in f32), and
``network_g: matmul_precision: default`` on the fast tier (every product
one bf16 pass with f32 sums, the fast kernels). Not ported
yet, each raising NotImplementedError with the option's name: ``val:
bucket_eval`` / ``bucket_auto``, the NIQE metric, the recurrent test sets
and models.

With ``--launcher pytorch`` under torchrun (one process per GPU) each
dataset's items are strided over the ranks and the per-frame metrics summed
(models/video_base_model.py): the results equal one process's. With
``mesh: {spatial: S}`` in the config (``{data: D, spatial: S}`` on D x S
ranks) each frame is split by height over S ranks, which exchange halo rows
around every conv (parallel/spatial.py); band 0 of each group gathers the
output, scores it and writes it.

Usage:
  python -m savsr_tpu_torch.test -opt options/test/SAVSR/test_SAVSR_Vid4_asBI.yml
  python -m savsr_tpu_torch.test -opt tiny.yml --device cpu
  python -m torch.distributed.run --nproc_per_node N -m savsr_tpu_torch.test \
      -opt options/test/SAVSR/test_SAVSR_Vid4_asBI.yml --launcher pytorch
  (the same with mesh: {spatial: N} in the config: each frame over N GPUs)
"""

from __future__ import annotations

import logging
import os
from os import path as osp
from typing import Optional

from .data import build_dataloader, build_dataset
from .models import build_model
from .utils.dist_util import barrier, destroy_dist
from .utils.logger import get_env_info, get_root_logger
from .utils.misc import get_time_str, make_exp_dirs
from .utils.options import dict2str, parse_options


def test_pipeline(root_path: str, args_list: Optional[list] = None,
                  stats: Optional[list] = None) -> dict:
    """Run the evaluation described by ``-opt``; return {dataset name:
    {metric: mean over its folders}}. ``stats``: an optional list that
    receives one dict per evaluated frame (dataset, folder, frame, and the
    host seconds of its load, STAU statics, forward up to the output on the
    host, and metrics and image write); the device is synchronised around
    the statics and the forward only when it is given."""
    opt, _ = parse_options(root_path, is_train=False, args_list=args_list)
    opt["root_path"] = root_path

    make_exp_dirs(opt)
    barrier()  # rank 0 made (and renamed) the results directory
    log_file = osp.join(opt["path"]["log"], f"test_{opt['name']}_{get_time_str()}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    test_loaders = []
    for _, dataset_opt in sorted(opt["datasets"].items()):
        test_set = build_dataset(dataset_opt)
        test_loaders.append(build_dataloader(test_set, dataset_opt))
        logger.info(f"Number of test images in {dataset_opt['name']}: {len(test_set)}")

    model = build_model(opt)
    model.eval_stats = stats

    results = {}
    for test_loader in test_loaders:
        ds_opt = test_loader.dataset.opt
        logger.info(f"Testing {ds_opt['name']}...")
        # the per-dataset arbitrary scale (reference test.py:40-45)
        for key in ("downsampling_scale", "val_scale"):
            if ds_opt.get(key) is not None:
                model.opt["scale"] = ds_opt[key]
                break
        model.validation(test_loader, current_iter=opt["name"], tb_logger=None,
                         save_img=opt["val"]["save_img"])
        if hasattr(model, "last_metric_results"):
            results[ds_opt["name"]] = dict(model.last_metric_results)
    return results


def main(argv=None):
    try:
        return test_pipeline(os.getcwd(), argv)
    finally:
        destroy_dist()


if __name__ == "__main__":
    main()
