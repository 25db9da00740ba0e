"""VideoBaseModel: windowed-VSR validation with per-folder, per-frame metrics.

Counterpart of ``savsr_tpu/models/video_base_model.py`` (lbasicsr/models/
video_base_model.py) on one process: every item of the dataset in order
(the JAX package strides them over processes: rank 0 of 1 here), each
frame's metrics into its folder's row, then per-folder means, their mean
over the folders, the best-value records and ``last_metric_results``.
"""

from __future__ import annotations

import time
from collections import Counter
from os import path as osp
from typing import Dict

import numpy as np

from ..data.resize import resize_pt
from ..metrics import calculate_metric
from ..metrics.psnr_ssim import calculate_psnr_pt, calculate_ssim_pt
from ..utils.img_util import array2img, imwrite
from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel


@MODEL_REGISTRY.register()
class VideoBaseModel(SRModel):
    """Base video SR model (windowed per-frame evaluation)."""

    def dist_validation(self, dataloader, current_iter, tb_logger, save_img):
        """Validate on ``dataloader.dataset``. An arbitrary-scale dataset's
        ``downsampling_scale`` is the eval scale while it runs; the model's
        scale and its current batch (lq, gt) are restored afterwards, so
        what comes after a validation in training runs at its own batch's
        scale."""
        dataset = dataloader.dataset
        restore = (self.scale, self.opt.get("scale"), getattr(self, "lq", None),
                   getattr(self, "gt", None))
        if dataset.opt.get("downsampling_scale", 0) != 0:
            self.opt["scale"] = dataset.opt["downsampling_scale"]
        try:
            self._validate(dataset, current_iter, tb_logger, save_img)
        finally:
            self.scale, opt_scale, self.lq, self.gt = restore
            if opt_scale is None:
                self.opt.pop("scale", None)
            else:
                self.opt["scale"] = opt_scale

    def _validate(self, dataset, current_iter, tb_logger, save_img) -> None:
        dataset_name = dataset.opt["name"]
        with_metrics = self.opt["val"].get("metrics") is not None
        if with_metrics:
            self.metric_results: Dict[str, np.ndarray] = {}
            for folder, num_frame in Counter(dataset.data_info["folder"]).items():
                self.metric_results[folder] = np.zeros(
                    (num_frame, len(self.opt["val"]["metrics"])), dtype=np.float64)
            self._initialize_best_metric_results(dataset_name)

        for idx in range(len(dataset)):
            t0 = time.perf_counter()
            val_data = dict(dataset[idx])
            val_data["lq"] = val_data["lq"][None]
            val_data["gt"] = val_data["gt"][None]
            folder = val_data["folder"]
            frame_idx = int(val_data["idx"].split("/")[0])
            lq_path = val_data["lq_path"]

            t1 = self._eval_clock()
            self._statics_s = 0.0
            self.feed_data(val_data)
            self.test()
            visuals = self.get_current_visuals()  # ends in the output's copy to the host
            t2 = time.perf_counter()
            result_img = array2img(visuals["result"][0])
            metric_data = {"img": result_img}
            if "gt" in visuals:
                metric_data["img2"] = array2img(visuals["gt"][0])

            if save_img:
                if self.opt["is_train"]:
                    raise NotImplementedError("saving image is not supported during training.")
                if "vimeo" in dataset_name.lower():
                    sp = lq_path.split("/")
                    img_name = f"{sp[-3]}_{sp[-2]}_{sp[-1].split('.')[0]}"
                else:
                    img_name = osp.splitext(osp.basename(lq_path))[0]
                suffix = self.opt["val"].get("suffix") or self.opt["name"]
                imwrite(result_img, osp.join(self.opt["path"]["visualization"], dataset_name,
                                             folder, f"{img_name}_{suffix}.png"))

            if with_metrics:
                if self.opt["val"].get("metrics_device", False):
                    # for in-training monitoring only: the float path (no
                    # uint8 rounding) is 0.01-0.03 dB off the host metrics
                    results = self._device_metrics()
                else:
                    results = [calculate_metric(metric_data, opt_)
                               for opt_ in self.opt["val"]["metrics"].values()]
                self.metric_results[folder][frame_idx] += results
            if self.eval_stats is not None:
                self.eval_stats.append(dict(
                    dataset=dataset_name, folder=folder, frame=frame_idx, load_s=t1 - t0,
                    statics_s=self._statics_s, forward_s=t2 - t1 - self._statics_s,
                    post_s=time.perf_counter() - t2))

        if with_metrics:
            self._log_validation_metric_values(current_iter, dataset_name, tb_logger)

    def _device_metrics(self):
        """The ``val: metrics`` of the current output against gt on the
        device (NCHW, [0, 1]); only PSNR and SSIM have a device form."""
        out, gt = self.output.float(), self.gt.float()
        if out.shape != gt.shape:
            out = resize_pt(out, (gt.shape[-2], gt.shape[-1]))
        out = out.clamp(0.0, 1.0)
        results = []
        for m_opt in self.opt["val"]["metrics"].values():
            y, cb = m_opt.get("test_y_channel", False), m_opt.get("crop_border", 0)
            if "psnr" in m_opt["type"]:
                results.append(float(calculate_psnr_pt(out, gt, cb, y)[0]))
            elif "ssim" in m_opt["type"]:
                results.append(float(calculate_ssim_pt(out, gt, cb, y)[0]))
            else:
                raise ValueError(f"metrics_device does not support {m_opt['type']}")
        return results

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img):
        self.dist_validation(dataloader, current_iter, tb_logger, save_img)

    def validation(self, dataloader, current_iter, tb_logger, save_img=False):
        self.dist_validation(dataloader, current_iter, tb_logger, save_img)

    def _log_validation_metric_values(self, current_iter, dataset_name, tb_logger):
        metric_results_avg = {folder: arr.mean(axis=0)
                              for folder, arr in self.metric_results.items()}
        total_avg_results = {m: 0.0 for m in self.opt["val"]["metrics"].keys()}
        for vec in metric_results_avg.values():
            for idx, metric in enumerate(total_avg_results.keys()):
                total_avg_results[metric] += float(vec[idx])
        for metric in total_avg_results.keys():
            total_avg_results[metric] /= len(metric_results_avg)
            self._update_best_metric_result(dataset_name, metric, total_avg_results[metric],
                                            current_iter)

        log_str = f"Validation {dataset_name}\n"
        for metric_idx, (metric, value) in enumerate(total_avg_results.items()):
            log_str += f"\t # {metric}: {value:.4f}"
            for folder, vec in metric_results_avg.items():
                log_str += f"\t # {folder}: {float(vec[metric_idx]):.4f}"
            rec = self.best_metric_results[dataset_name][metric]
            log_str += f"\n\t    Best: {rec['val']:.4f} @ {rec['iter']} iter\n"
        get_root_logger().info(log_str)
        if tb_logger:
            for metric_idx, (metric, value) in enumerate(total_avg_results.items()):
                tb_logger.add_scalar(f"metrics/{metric}", value, current_iter)
                for folder, vec in metric_results_avg.items():
                    tb_logger.add_scalar(f"metrics/{metric}/{folder}", float(vec[metric_idx]),
                                         current_iter)
        self.last_metric_results = total_avg_results
