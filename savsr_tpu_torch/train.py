"""Training entry point: ``python -m savsr_tpu_torch.train -opt <cfg.yml>``.

The port's counterpart of ``savsr_tpu/train.py`` (behaviour of
lbasicsr/train.py:94-255: epoch/iter loop, auto resume, periodic log, save and
validation, prefetching) on one CUDA device; ``--device cpu`` runs it on the
CPU (the kernels' plain versions). Without ``--device`` it runs on CUDA and
raises if there is no card. With a ``val:`` block, every ``val_*`` dataset
is validated every ``val: val_freq`` iterations and once more after the
final save (the eval forward in f32 on the EMA weights; see
models/sr_model.py).

Not ported yet, each raising NotImplementedError with the option's name:
``train: bucket_train``, ``train: degrade_on_device``, perceptual/GAN
losses, ``val: bucket_eval``, the recurrent model family, REDS, lmdb,
multi-GPU.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import time
from os import path as osp

import torch

from .data import EnlargedSampler, build_dataloader, build_dataset
from .data.loader import CPUPrefetcher, DevicePrefetcher
from .models import build_model
from .utils.logger import (AvgTimer, MessageLogger, get_env_info, get_root_logger,
                           init_tb_logger)
from .utils.misc import check_resume, get_time_str, make_exp_dirs, mkdir_and_rename
from .utils.options import copy_opt_file, dict2str, parse_options


def reject_unported(opt: dict) -> None:
    """Raise for the options of the JAX package's trainer that the port
    does not run yet, naming the option (nothing is silently skipped)."""
    wandb = (opt.get("logger") or {}).get("wandb") or {}
    if wandb.get("project") is not None:
        raise NotImplementedError("logger: wandb is not ported yet")


def init_tb_loggers(opt):
    if opt["logger"].get("use_tb_logger") and "debug" not in opt["name"]:
        return init_tb_logger(log_dir=osp.join(opt["root_path"], "tb_logger", opt["name"]))
    return None


def create_train_val_dataloader(opt, logger):
    train_loader, val_loaders = None, []
    for phase, dataset_opt in opt["datasets"].items():
        if phase.split("_")[0] == "val":
            val_set = build_dataset(dataset_opt)
            val_loaders.append(build_dataloader(val_set, dataset_opt))
            continue
        if phase != "train":
            raise ValueError(f"Dataset phase {phase} is not recognized.")
        enlarge = dataset_opt.get("dataset_enlarge_ratio", 1)
        train_set = build_dataset(dataset_opt, seed=opt["manual_seed"])
        train_sampler = EnlargedSampler(len(train_set), opt["world_size"], opt["rank"], enlarge)
        train_loader = build_dataloader(train_set, dataset_opt, sampler=train_sampler,
                                        seed=opt["manual_seed"])
        num_iter_per_epoch = math.ceil(
            len(train_set) * enlarge / (dataset_opt["batch_size_per_gpu"] * opt["world_size"]))
        total_iters = int(opt["train"]["total_iter"])
        total_epochs = math.ceil(total_iters / num_iter_per_epoch)
        logger.info(
            "Training statistics:"
            f"\n\tNumber of train images: {len(train_set)}"
            f"\n\tDataset enlarge ratio: {enlarge}"
            f"\n\tBatch size per device: {dataset_opt['batch_size_per_gpu']}"
            f"\n\tWorld size (process count): {opt['world_size']}"
            f"\n\tRequire iter number per epoch: {num_iter_per_epoch}"
            f"\n\tTotal epochs: {total_epochs}; iters: {total_iters}.")
    return train_loader, val_loaders, total_epochs, total_iters


def validate(model, val_loaders, opt, current_iter, tb_logger) -> None:
    for val_loader in val_loaders:
        model.validation(val_loader, current_iter, tb_logger, opt["val"]["save_img"])


def load_resume_state(opt):
    resume_state_path = None
    if opt["auto_resume"]:
        state_path = opt["path"]["training_states"]
        if osp.isdir(state_path):
            states = [v for v in os.listdir(state_path) if v.endswith(".state")]
            if states:
                max_state = max(float(v.split(".state")[0]) for v in states)
                resume_state_path = osp.join(state_path, f"{max_state:.0f}.state")
                opt["path"]["resume_state"] = resume_state_path
    elif opt["path"].get("resume_state"):
        resume_state_path = opt["path"]["resume_state"]
    if resume_state_path is None:
        return None
    resume_state = torch.load(resume_state_path, map_location="cpu", weights_only=True)
    check_resume(opt, resume_state["iter"])
    return resume_state


def train_pipeline(root_path, args_list=None, stats=None):
    """Run the training described by ``-opt`` and return the model.
    ``stats``: an optional list that receives, after every iteration,
    (iteration, host seconds since the previous iteration's end, the logged
    values if this iteration logged, else None). Nothing synchronises for
    it: a step's time is the device's only where the iteration logs."""
    opt, args = parse_options(root_path, is_train=True, args_list=args_list)
    opt["root_path"] = root_path
    reject_unported(opt)

    resume_state = load_resume_state(opt)
    if resume_state is None:
        make_exp_dirs(opt)
        if opt["logger"].get("use_tb_logger") and "debug" not in opt["name"]:
            mkdir_and_rename(osp.join(opt["root_path"], "tb_logger", opt["name"]))
    copy_opt_file(args.opt, opt["path"]["experiments_root"])

    log_file = osp.join(opt["path"]["log"], f"train_{opt['name']}_{get_time_str()}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    tb_logger = init_tb_loggers(opt)

    train_loader, val_loaders, total_epochs, total_iters = create_train_val_dataloader(opt,
                                                                                      logger)

    model = build_model(opt)
    if resume_state:
        model.resume_training(resume_state)
        logger.info(f"Resuming training from epoch: {resume_state['epoch']}, "
                    f"iter: {resume_state['iter']}.")
        start_epoch = resume_state["epoch"]
        current_iter = resume_state["iter"]
    else:
        start_epoch = 0
        current_iter = 0

    msg_logger = MessageLogger(opt, current_iter, tb_logger)

    # prefetcher selection (reference train.py:148-158): 'device' (alias
    # 'cuda') keeps the next batch uploading while the current step runs;
    # default/'cpu' reads ahead on host workers only
    prefetch_mode = opt["datasets"]["train"].get("prefetch_mode")
    if prefetch_mode in ("device", "cuda"):
        prefetcher = DevicePrefetcher(train_loader, model.prepare_batch, model.device)
        logger.info(f"Use DevicePrefetcher (prefetch_mode={prefetch_mode}).")
    elif prefetch_mode is None or prefetch_mode == "cpu":
        prefetcher = CPUPrefetcher(train_loader)
    else:
        raise ValueError(
            f"Wrong prefetch_mode {prefetch_mode}. Supported ones are: None, 'cpu', 'device'.")

    logger.info(f"Start training from epoch: {start_epoch}, iter: {current_iter}")
    data_timer, iter_timer = AvgTimer(), AvgTimer()
    start_time = time.time()
    epoch = start_epoch

    for epoch in range(start_epoch, total_epochs + 1):
        train_loader.set_epoch(epoch)
        prefetcher.reset()
        train_data = prefetcher.next()

        while train_data is not None:
            data_timer.record()
            current_iter += 1
            if current_iter > total_iters:
                break
            model.update_learning_rate(current_iter,
                                       warmup_iter=opt["train"].get("warmup_iter", -1))
            model.feed_data(train_data)
            model.optimize_parameters(current_iter)
            iter_timer.record()
            if current_iter == 1:
                msg_logger.reset_start_time()

            logged = None
            if current_iter % opt["logger"]["print_freq"] == 0:
                logged = dict(model.log_dict)  # the step's one host sync
                log_vars = {"epoch": epoch, "iter": current_iter,
                            "lrs": model.get_current_learning_rate(current_iter),
                            "time": iter_timer.get_avg_time(),
                            "data_time": data_timer.get_avg_time()}
                log_vars.update(logged)
                msg_logger(log_vars)

            if stats is not None:
                stats.append((current_iter, time.time() - iter_timer.start_time, logged))

            if current_iter % opt["logger"]["save_checkpoint_freq"] == 0:
                logger.info("Saving models and training states.")
                model.save(epoch, current_iter)

            if opt.get("val") is not None and current_iter % opt["val"]["val_freq"] == 0:
                validate(model, val_loaders, opt, current_iter, tb_logger)

            data_timer.start()
            iter_timer.start()
            train_data = prefetcher.next()
        if current_iter > total_iters:
            break

    consumed = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    logger.info(f"End of training. Time consumed: {consumed}")
    logger.info("Save the latest model.")
    model.save(epoch=-1, current_iter=-1)
    if opt.get("val") is not None:
        validate(model, val_loaders, opt, current_iter, tb_logger)
    return model


def main(argv=None):
    return train_pipeline(os.getcwd(), argv)


if __name__ == "__main__":
    main()
