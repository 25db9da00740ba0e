"""SAVSR video upscaler on the GPU: LR frames in -> SR frames out.

The port's counterpart of ``python -m savsr_tpu.inference``. Point it at a
folder of frames (or a folder of clip subfolders), pick a scale — integer,
fractional, or asymmetric — and it writes upscaled images. Serving stack:
the fused CUDA kernels of the CHW serving engine, frame-invariant STAU and
tail operands computed once per (clip shape, scale), ``--windows`` windows
per forward (as one batch), uint8/BGR conversion on the device, the next
chunk computing while the previous one is copied out, and image encoding on
writer threads. Precision tiers:

  bf16   (default) bf16 params/activations, f32 accumulation in the kernels
  fast   f32 params and carries; every product in one bf16 pass (operands
         rounded to bf16, exact products, f32 sums) on the tensor cores, as
         a TPU runs f32 at default precision; epilogues, STA's filter, STAU's
         row weights and residual and the tail's row mix in f32
  split  f32 params; every conv up to the trunk's end a 3-pass bf16 hi/lo
         contraction on the tensor cores (f32 sums) with bf16 hi/lo pair
         carries between convs (~2^-16 relative error a conv); STA, STAU,
         the tail and the small heads in f32 with TF32 off
  strict f32 everywhere with TF32 off (matmuls and cuDNN convs) —
         reference-parity outputs

Runs on CUDA unless ``--device cpu`` is given (then every kernel takes its
plain PyTorch version); asking for CUDA without a card is an error.

Usage:
  python -m savsr_tpu_torch.inference -i lr_frames/ -o out/ -s 4 -w savsr.pth
  python -m savsr_tpu_torch.inference -i clips_root/ -o out/ -s 1.5 3.5 \
      -w net_g.npz --tier strict --device cpu
  python -m savsr_tpu_torch.inference -i lr_frames/ -o out/ -s 4 -w savsr.pth --tier split
  python -m savsr_tpu_torch.inference -i lr_frames/ -o out/ -s 4 -w savsr.pth --tier fast
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .archs.arch_util import resolve_device
from .archs.savsr_arch import SAVSR, SAVSRConfig, get_hw
from .data.data_util import generate_frame_indices, paths_from_folder, read_img_seq
from .utils.convert import load_checkpoint, load_into
from .utils.img_util import imwrite
from .utils.logger import get_root_logger

TIERS = ("bf16", "fast", "split", "strict")
# the architecture fields an options file's network_g block may set (the
# tier sets the precisions)
ARCH_KEYS = {f.name for f in dataclasses.fields(SAVSRConfig)} - {"matmul_precision",
                                                                  "conv_precision"}


def flagship_net_kwargs() -> dict:
    """The published SAVSR configuration (reference
    options/train/SAVSR/train_SAVSR_Vimeo90K_asBI.yml:98-110)."""
    return dict(
        num_in_ch=3, num_feat=64, num_frame=7, slid_win=3, fusion_win=5,
        interval=0, w1_num_block=4, w2_num_block=2, n_resgroups=4,
        n_resblocks=8,
    )


def tier_dtype(tier: str) -> torch.dtype:
    return torch.bfloat16 if tier == "bf16" else torch.float32


def build_serving_model(tier: str, net_kwargs: Optional[dict] = None) -> SAVSR:
    if tier not in TIERS:
        raise ValueError(f"tier {tier!r} not in {TIERS}")
    kwargs = flagship_net_kwargs()
    kwargs.update(net_kwargs or {})
    kwargs["matmul_precision"] = "default" if tier in ("bf16", "fast") else "float32"
    kwargs["conv_precision"] = "split" if tier == "split" else "native"
    return SAVSR(**kwargs).eval()


def load_params(model: SAVSR, path: str, tier: str, param_key: str = "params",
                device="cuda") -> SAVSR:
    """Checkpoint (.npz JAX / .pth torch) -> model on ``device`` at the
    tier's dtype, with strict key checking (KeyError on mismatch)."""
    load_into(model, load_checkpoint(path, param_key))
    return model.to(device=resolve_device(device), dtype=tier_dtype(tier))


def to_uint8_bgr(sr: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] RGB float -> [N, H, W, 3] uint8 BGR, on sr's device:
    clamp to [0, 1], x255, round half to even, cast."""
    sr8 = torch.round(sr.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return sr8.flip(1).permute(0, 2, 3, 1).contiguous()


def upscale_clip(model: SAVSR, frames: np.ndarray, scale, tier: str, num_frame: int,
                 padding: str, chunk: int = 8, stats: Optional[list] = None):
    """frames [T, h, w, 3] float32 RGB in [0, 1] -> yields [H, W, 3] uint8 BGR
    SR frames in order. ``chunk`` windows go through one batched forward;
    chunk k+1 is dispatched before chunk k is copied out, so on the GPU the
    copy and the consumer's encoding overlap the next chunk's compute.
    ``stats`` (optional list) receives (frames, seconds) per chunk, from
    dispatch until its frames are on the host."""
    logger = get_root_logger()
    device = model.gamma.device
    dtype = tier_dtype(tier)
    t_total, h, w = frames.shape[:3]
    chunk = max(1, min(chunk, t_total))
    cuda = device.type == "cuda"

    statics = model.stau_statics((h, w), scale, dtype=dtype, device=device)
    frames_dev = torch.from_numpy(np.ascontiguousarray(frames)).to(device=device, dtype=dtype)
    frames_dev = frames_dev.permute(0, 3, 1, 2).contiguous()  # [T, 3, h, w]
    indices = [generate_frame_indices(i, t_total, num_frame, padding=padding)
               for i in range(t_total)]
    H, W = get_hw(h, w, scale)

    def dispatch(c0):
        t0 = time.perf_counter()
        sel = torch.tensor(indices[c0:c0 + chunk])
        if cuda:
            sel = sel.pin_memory().to(device, non_blocking=True)
        sr8 = to_uint8_bgr(model(frames_dev[sel], scale, stau_statics=statics))
        host = torch.empty(sr8.shape, dtype=torch.uint8, pin_memory=cuda)
        host.copy_(sr8, non_blocking=cuda)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        return host, done, t0

    def materialize(pending):
        host, done, t0 = pending
        if done is not None:
            done.synchronize()
        if stats is not None:
            stats.append((host.shape[0], time.perf_counter() - t0))
        return [host[i].numpy() for i in range(host.shape[0])]

    t_loop0 = time.perf_counter()
    pending = None
    for c0 in range(0, t_total, chunk):
        nxt = dispatch(c0)
        if pending is not None:
            yield from materialize(pending)
        pending = nxt
    last = materialize(pending)
    # log before the final yields: the consumer may not resume the generator
    t_loop = time.perf_counter() - t_loop0
    logger.info(f"clip loop: {t_total} frames {h}x{w} -> {H}x{W} in {t_loop:.3f} s "
                f"({t_total / max(t_loop, 1e-9):.2f} fps incl. first chunk) on {device}")
    yield from last


def discover_clips(input_dir: str) -> dict:
    """{clip_name: [frame paths]} — subfolders are clips; a flat folder of
    frames is one clip named after the folder."""
    subdirs = sorted(d for d in os.listdir(input_dir)
                     if os.path.isdir(os.path.join(input_dir, d)))
    if subdirs:
        return {d: paths_from_folder(os.path.join(input_dir, d)) for d in subdirs}
    name = os.path.basename(os.path.normpath(input_dir)) or "clip"
    return {name: paths_from_folder(input_dir)}


def main(argv=None, stats: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-i", "--input", required=True,
                    help="folder of LR frames, or folder of clip subfolders")
    ap.add_argument("-o", "--output", required=True, help="output folder")
    ap.add_argument("-s", "--scale", type=float, nargs="+", required=True,
                    metavar="S", help="upscale factor: one value or H W")
    ap.add_argument("-w", "--weights", required=True,
                    help="checkpoint (.npz JAX or .pth torch)")
    ap.add_argument("--param_key", default="params",
                    help="checkpoint key (params | params_ema)")
    ap.add_argument("--tier", choices=TIERS, default="bf16")
    ap.add_argument("--num_frame", type=int, default=7)
    ap.add_argument("--padding", default="reflection",
                    choices=("replicate", "reflection", "reflection_circle", "circle"))
    ap.add_argument("--windows", type=int, default=8, metavar="N",
                    help="windows per batched forward (clamped to the clip length)")
    ap.add_argument("--ext", default="png", choices=("png", "bmp", "jpg"),
                    help="output image format")
    ap.add_argument("--opt", default=None,
                    help="options YAML whose network_g block overrides the "
                         "flagship architecture (type/strict-load keys ignored)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    if len(args.scale) > 2:
        ap.error("--scale takes one value or two (H W)")
    scale = (args.scale[0], args.scale[-1])
    device = resolve_device(args.device)

    logger = get_root_logger()
    net_kwargs = {}
    if args.opt:
        from .utils.options import yaml_load

        net = yaml_load(args.opt).get("network_g") or {}
        net_kwargs = {k: v for k, v in net.items() if k in ARCH_KEYS and v is not None}
        # the JAX package's engine settings (conv_engine, osconv_impl, ...)
        # name engines this port does not have; the tier sets the precision
        ignored = sorted(set(net) - ARCH_KEYS - {"type", "strict_load_g"})
        if ignored:
            logger.info(f"--opt: ignoring settings of the JAX engines: {ignored}")

    model = load_params(build_serving_model(args.tier, net_kwargs), args.weights,
                        args.tier, args.param_key, device)

    clips = discover_clips(args.input)
    n_frames = sum(len(v) for v in clips.values())
    logger.info(f"{len(clips)} clip(s), {n_frames} frames -> x{scale[0]}x{scale[1]} "
                f"[tier={args.tier}, device={device}]")
    t0 = time.perf_counter()
    done = 0
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                            thread_name_prefix="savsr-write") as writer:
        futures = []
        for clip, paths in clips.items():
            if not paths:
                logger.warning(f"{clip}: no frames found, skipping")
                continue
            frames = read_img_seq(paths)
            out_dir = os.path.join(args.output, clip) if len(clips) > 1 else args.output
            n_clip = 0
            for p, sr in zip(paths, upscale_clip(model, frames, scale, args.tier,
                                                 args.num_frame, args.padding,
                                                 chunk=args.windows, stats=stats)):
                name = os.path.splitext(os.path.basename(p))[0]
                futures.append(writer.submit(imwrite, sr,
                                             os.path.join(out_dir, f"{name}.{args.ext}")))
                n_clip += 1
            done += n_clip
            logger.info(f"{clip}: {n_clip} frames -> {out_dir}")
        for f in futures:
            f.result()  # surface write errors; also joins all IO
    wall = time.perf_counter() - t0
    logger.info(f"done: {done} frames in {wall:.1f} s "
                f"({done / max(wall, 1e-9):.2f} fps incl. IO)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
