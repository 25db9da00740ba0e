"""Spatial sharding of the port's eval forward (``mesh: {data, spatial}``,
``savsr_tpu_torch/parallel/spatial.py``) on the CPU: each frame split by
height over the ranks of a band group, at the small config, with the
kernels' plain versions.

Two launches under ``torch.distributed.run`` over gloo: 2 ranks at
``{spatial: 2}`` and 4 ranks at ``{data: 2, spatial: 2}``. The LR height is
odd, so ``pad_spatial`` reflects a row that the last band owns and the two
bands differ in height (16 and 18 rows of 34).

The forward: every tier (strict, bf16, split, fast) on a seeded window at
x(1.5, 2.5), gathered on band 0 of each group, and the model's x8
self-ensemble (whose transposed passes split the transposed height), is
held against the port's one-process forward of the same tier: **equal to
the bit** (bound 0, so at least 10x tighter than any tier's distance from
strict: bf16 6.82e-3, fast 3.33e-3, split 3.28e-7 max abs on this input).
Strict is also held
against the JAX package's forward (``SAVSR.apply(..., conv_engine="chw")``,
as tests/test_torch_savsr.py runs it) within 1e-5, the JAX package's own
bound for a sharded frame (tests/test_spatial_sharding.py); measured
1.19e-7.

Both sides run with PyTorch's oneDNN convolutions off. With them on, the
CPU's ``F.conv2d`` (the plain version of every conv here) blocks its sums
by the frame's height, so a band's conv rounds a row differently from the
whole frame's (a 3x3 of 48 channels: 3e-5); the sharded forward then sits,
measured, 1.19e-7 (strict), 3.91e-3 (bf16), 2.38e-7 (split) and 5.56e-4
(fast) max abs from one process. Without them every conv here sums each
pixel in one order at any height, and the sharding's own math (halos,
GAPs over the bands' row sums, the mask head's reach, STA's replicated
edges, the STAU window's shift, the tail's extra row) is exact.

The eval: the eval pipeline on two seeded 4-frame clips at x2 (17-row LR
frames: bands of 8 and 10 rows), with PNGs: per-folder psnr_y and ssim_y
equal to the bit to the one-process run (bound 1e-4), and only band 0 of
each group writes. The geometry: band splits, even starts, halo widths,
the LR reach of an HR band from real statics, and a thin band raising.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
SMALL_CFG = dict(num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5,
                 interval=0, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)
TIERS = ("strict", "bf16", "split", "fast")
LR_HW, SCALE = (33, 20), (1.5, 2.5)
MESHES = {"s2": {"spatial": 2}, "d2s2": {"data": 2, "spatial": 2}}
WORLDS = {"s2": 2, "d2s2": 4}

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
torch.backends.mkldnn.enabled = False
work, tag = sys.argv[1], sys.argv[2]
rank = int(os.environ["RANK"])

import savsr_tpu_torch.models.video_base_model as vbm
from savsr_tpu_torch.models import build_model
from savsr_tpu_torch.parallel import get_mesh_from_opt
from savsr_tpu_torch.parallel.spatial import gather_rows
from savsr_tpu_torch.test import test_pipeline
from savsr_tpu_torch.utils.dist_util import destroy_dist
from savsr_tpu_torch.utils.options import parse_options

sys.path.insert(0, work)
from tiers import build

writes = [0]
_imwrite = vbm.imwrite


def imwrite(*a, **k):
    writes[0] += 1
    return _imwrite(*a, **k)


vbm.imwrite = imwrite
results = test_pipeline(work, ["-opt", os.path.join(work, f"eval_{tag}.yml"), "--device", "cpu",
                               "--launcher", "pytorch"])
mesh = get_mesh_from_opt({"dist": True, "mesh": json.loads(sys.argv[3])})
bands = mesh.bands
x = torch.from_numpy(np.load(os.path.join(work, "x.npy")))
scale = tuple(json.loads(sys.argv[4]))
out, info = {}, {"axes": mesh.shape, "band": mesh.band, "data_index": mesh.data_index,
                 "writes": writes[0], "results": results, "stats": {}}
for tier in ("strict", "bf16", "split", "fast"):
    model, dt = build(tier, work)
    statics = model.stau_statics(x.shape[-2:], scale, dtype=dt, band=bands)
    before = dict(bands.stats)
    y = model(x.to(dt), scale, stau_statics=statics, band=bands)
    info["stats"][tier] = {k: bands.stats[k] - before[k] for k in before}
    info["lr"], info["hr"] = statics["band"]["lr"], statics["band"]["hr"]
    y = gather_rows(y, bands, statics["band"]["hr"])
    if y is not None:
        out[tier] = y.float().numpy()
# the x8 self-ensemble through the model (its transposed passes split the
# transposed height)
opt, _ = parse_options(work, False, ["-opt", os.path.join(work, f"eval_{tag}.yml"), "--device",
                                     "cpu", "--launcher", "pytorch"])
model = build_model(opt)
model.feed_data({"lq": x, "scale": scale})
model.test_selfensemble()
if model.output is not None:
    out["selfensemble"] = model.output.numpy()
np.savez(os.path.join(work, f"{tag}_rank{rank}.npz"), **out)
with open(os.path.join(work, f"{tag}_rank{rank}.json"), "w") as f:
    json.dump(info, f)
destroy_dist()
'''

# the tiers' models, shared by the workers and the test process
TIERS_PY = r'''
import os
import numpy as np
import torch
from savsr_tpu_torch.archs.savsr_arch import SAVSR

SMALL_CFG = {cfg}
EXTRA = {{"strict": {{}}, "bf16": {{"matmul_precision": "default"}},
          "split": {{"conv_precision": "split"}}, "fast": {{"matmul_precision": "default"}}}}


def build(tier, work):
    """The small network at ``tier`` with the golden weights, and its dtype."""
    sd = dict(np.load(os.path.join(work, "state.npz")))
    model = SAVSR(**SMALL_CFG, **EXTRA[tier]).eval()
    model.load_state_dict({{k: torch.from_numpy(v) for k, v in sd.items()}}, strict=True)
    dt = torch.bfloat16 if tier == "bf16" else torch.float32
    return model.to(dt), dt
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _eval_yml(work, name: str, mesh: dict = None) -> str:
    net = "".join(f"  {k}: {v}\n" for k, v in SMALL_CFG.items())
    mesh_block = "" if mesh is None else "mesh:\n" + "".join(
        f"  {k}: {v}\n" for k, v in mesh.items())
    return f"""
name: {name}
model_type: ASVSRModel
num_gpu: 1
manual_seed: 0
{mesh_block}datasets:
  test_01:
    name: Vid4_x2
    type: ASVideoTestDataset
    dataroot_gt: {work}/GT
    dataroot_lq: {work}/GT
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
{net}path:
  pretrain_network_g: {work}/small.pth
  strict_load_g: true
  resume_state: ~
  results_root: {work}/results
val:
  save_img: true
  metrics:
    psnr_y:
      type: calculate_psnr
      crop_border: 0
      test_y_channel: true
    ssim_y:
      type: calculate_ssim
      crop_border: 0
      test_y_channel: true
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The small config's golden weights (a state npz and a checkpoint),
    the seeded window, the configs, and two 4-frame clips of 34x44."""
    import cv2

    work = tmp_path_factory.mktemp("spatial")
    sd = dict(np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")))
    np.savez(work / "state.npz", **sd)
    torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, work / "small.pth")
    (work / "tiers.py").write_text(TIERS_PY.format(cfg=repr(SMALL_CFG)))
    rng = np.random.default_rng(7)
    np.save(work / "x.npy", rng.random((1, 7, 3) + LR_HW, dtype=np.float32))
    for tag, mesh in MESHES.items():
        (work / f"eval_{tag}.yml").write_text(_eval_yml(work, f"eval_{tag}", mesh))
    (work / "eval_one.yml").write_text(_eval_yml(work, "eval_one"))
    for clip in ("calendar", "city"):
        d = work / "GT" / clip
        d.mkdir(parents=True)
        img = (rng.random((34, 44, 3)) * 255).astype(np.uint8)
        for i in range(4):
            cv2.imwrite(str(d / f"{i:08d}.png"), np.roll(img, 2 * i, axis=1))
    return work


@pytest.fixture(scope="module")
def launches(world):
    """Both launches under torch.distributed.run, started at once; the
    test process computes the references meanwhile."""
    work = world
    (work / "worker.py").write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = {}
    for tag, mesh in MESHES.items():
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
               str(WORLDS[tag]), "--master_addr", "127.0.0.1", "--master_port",
               str(_free_port()), str(work / "worker.py"), str(work), tag, json.dumps(mesh),
               json.dumps(SCALE)]
        procs[tag] = subprocess.Popen(cmd, env=env, cwd=str(work), stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    return procs


@pytest.fixture(scope="module")
def one_process(world, launches):
    """The port's one-process forward of each tier and its eval, oneDNN off
    as in the workers."""
    sys.path.insert(0, str(world))
    try:
        from tiers import build
    finally:
        sys.path.remove(str(world))
    from savsr_tpu_torch.models import build_model
    from savsr_tpu_torch.test import test_pipeline
    from savsr_tpu_torch.utils.options import parse_options

    x = torch.from_numpy(np.load(world / "x.npy"))
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    mkldnn = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        out = {}
        for tier in TIERS:
            model, dt = build(tier, world)
            out[tier] = model(x.to(dt), SCALE).float().numpy()
        results = test_pipeline(str(world), ["-opt", str(world / "eval_one.yml"), "--device",
                                             "cpu"])
        opt, _ = parse_options(str(world), False, ["-opt", str(world / "eval_one.yml"),
                                                   "--device", "cpu"])
        model = build_model(opt)
        model.feed_data({"lq": x, "scale": SCALE})
        model.test_selfensemble()
        out["selfensemble"] = model.output.numpy()
    finally:
        torch.set_num_threads(old)
        torch.backends.mkldnn.enabled = mkldnn
    return out, results


@pytest.fixture(scope="module")
def jax_strict(world, launches):
    """The JAX package's strict forward of the window (its CHW engine, as
    tests/test_torch_savsr.py runs it), computed while the launches run."""
    import functools

    import jax
    import jax.numpy as jnp

    from savsr_tpu.archs.savsr_arch import SAVSR as JaxSAVSR
    from savsr_tpu.utils.convert import convert_state_dict

    sd = dict(np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")))
    params = {k: jnp.asarray(v) for k, v in convert_state_dict(sd).items()}
    x = np.load(world / "x.npy")
    jmodel = JaxSAVSR(**SMALL_CFG, conv_engine="chw")
    y = jax.jit(functools.partial(jmodel.apply, scale=SCALE))(
        params, jnp.asarray(x.transpose(0, 1, 3, 4, 2)))[0]
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def ranks(world, launches, one_process, jax_strict):
    """{tag: [(rank's npz, its json) for each rank]} once both launches
    have ended."""
    for tag, p in launches.items():
        try:
            out, _ = p.communicate(timeout=300)
        finally:
            if p.returncode != 0:  # a timeout or a failed launch: stop them all
                for q in launches.values():
                    q.kill()
        assert p.returncode == 0, out[-4000:]
    return {tag: [(dict(np.load(world / f"{tag}_rank{r}.npz")),
                   json.loads((world / f"{tag}_rank{r}.json").read_text()))
                  for r in range(WORLDS[tag])] for tag in MESHES}


@pytest.mark.parametrize("tier", TIERS + ("selfensemble",))
@pytest.mark.parametrize("tag", list(MESHES))
def test_sharded_forward_equals_one_process(ranks, one_process, tag, tier):
    """Band 0 of every group holds the gathered frame, equal to the bit to
    the one-process forward of the tier, and the strict x8 self-ensemble
    (the model's ``test_selfensemble``) to one process's (the other bands
    hold none); every rank exchanged rows."""
    want = one_process[0][tier]
    for out, info in ranks[tag]:
        if tier in info["stats"]:
            assert info["stats"][tier]["exchanges"] > 0 and info["stats"][tier]["bytes"] > 0
        if info["band"] == 0:
            assert out[tier].shape == want.shape
            assert np.array_equal(out[tier], want), np.abs(out[tier] - want).max()
        else:
            assert tier not in out


def test_sharded_strict_forward_matches_jax(ranks, jax_strict):
    """The sharded strict forward within 1e-5 max abs of the JAX package's
    CHW engine on the same window and weights."""
    y_jax = jax_strict
    for tag in MESHES:
        for out, info in ranks[tag]:
            if info["band"] == 0:
                assert out["strict"].shape == y_jax.shape
                assert np.abs(out["strict"] - y_jax).max() <= 1e-5


@pytest.mark.parametrize("tag", list(MESHES))
def test_sharded_eval_equals_one_process_and_band0_writes(world, ranks, one_process, tag):
    """The eval's per-dataset psnr_y / ssim_y equal one process's to the bit
    (bound 1e-4) on every rank; the mesh has its axes; band 0 of each group
    wrote its group's frames' PNGs and the other bands none; every frame
    was written once."""
    want = one_process[1]
    infos = [info for _, info in ranks[tag]]
    spatial = MESHES[tag]["spatial"]
    data = MESHES[tag].get("data", 1)
    frames = 2 * 4
    for r, info in enumerate(infos):
        assert info["axes"] == {"data": data, "spatial": spatial}
        assert (info["band"], info["data_index"]) == (r % spatial, r // spatial)
        for ds, metrics in want.items():
            for k, v in metrics.items():
                assert abs(info["results"][ds][k] - v) <= 1e-4
        assert info["results"] == want
        assert info["writes"] == (frames // data if info["band"] == 0 else 0)
    vis = world / "results" / f"eval_{tag}" / "visualization" / "Vid4_x2"
    assert sum(len(files) for _, _, files in os.walk(vis)) == frames


@pytest.mark.parametrize("height,count,want", [
    (34, 2, [(0, 16), (16, 34)]),
    (180, 2, [(0, 90), (90, 180)]),
    (18, 2, [(0, 8), (8, 18)]),
    (576, 4, [(0, 144), (144, 288), (288, 432), (432, 576)]),
    (52, 3, [(0, 16), (16, 34), (34, 52)]),
])
def test_band_rows(height, count, want):
    """Bands cover the padded frame in order, start on even rows (OSAdapt's
    pooling pairs), differ by at most one row pair, and are no thinner than
    the widest halo (the mask head's reach, which exceeds STA's and a
    conv's)."""
    from savsr_tpu_torch.parallel import spatial

    rows = spatial.band_rows(height, count)
    assert rows == want
    assert rows[0][0] == 0 and rows[-1][1] == height
    assert all(a % 2 == 0 and b == c for (a, b), (c, _) in zip(rows, rows[1:] + [(height, 0)]))
    sizes = [b - a for a, b in rows]
    assert max(sizes) - min(sizes) <= 2 and min(sizes) >= spatial.MASK_REACH
    assert spatial.HALO == 1 < spatial.STA_REACH == 2 < spatial.MASK_REACH == 8
    assert spatial.crop_rows(rows, height - 1)[-1] == (rows[-1][0], height - 1)


@pytest.mark.parametrize("height,count", [(30, 4), (14, 2), (33, 2)])
def test_thin_or_odd_band_raises(height, count):
    """A band thinner than the widest halo, or an odd padded height, raises
    a ValueError that names the cause."""
    from savsr_tpu_torch.parallel import spatial

    with pytest.raises(ValueError, match="thinner than the widest halo|is odd"):
        spatial.band_rows(height, count)


@pytest.mark.parametrize("scale", [(1.5, 2.5), (4.0, 4.0), (3.05, 3.05)])
def test_hr_band_reach_from_statics(scale):
    """The HR rows of each band (one row beyond each side, clipped) reach
    LR rows inside their window and nowhere else inside the frame: every
    bilinear tap (floor and floor + 1 of fy_f and fy_s) that lies in the
    frame lies in the band's window; the band's fy planes are the frame's
    shifted by the window's start, exactly; HR bands tile the output."""
    from savsr_tpu_torch.archs.savsr_arch import SAVSR
    from savsr_tpu_torch.ops.stau import plan_geometry, stau_window_plan
    from savsr_tpu_torch.parallel import BandGroup

    sd = dict(np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")))
    model = SAVSR(**SMALL_CFG).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    h, w = LR_HW
    statics = model.stau_statics((h, w), scale)
    pix, H = statics["pix"], statics["pix"].shape[1]
    covered = []
    for index in range(2):
        bs = model.stau_statics((h, w), scale, band=BandGroup(index, 2, (0, 1)))["band"]
        (y0, y1), (e0, e1), (l0, l1) = bs["hr"][index], bs["hr_ext"], bs["windows"][index]
        covered.append((y0, y1))
        assert (e0, e1) == (max(y0 - 1, 0), min(y1 + 1, H)) and 0 <= l0 < l1 <= h
        for p in (0, 2):
            assert torch.equal(bs["pix"][p] + l0, pix[p, e0:e1])
            f = torch.floor(pix[p, e0:e1])
            for tap in (f, f + 1):
                inside = (tap >= 0) & (tap <= h - 1)
                assert bool(((tap[inside] >= l0) & (tap[inside] < l1)).all())
        assert torch.equal(bs["pix"][[1, 3]], pix[[1, 3], e0:e1])
        assert torch.equal(bs["tail_j0"], statics["tail_j0"][e0:e1])
        rows, cols = plan_geometry(torch.float32)[:2]
        W = pix.shape[2]
        assert torch.equal(bs["stau_plan"], stau_window_plan(
            bs["pix"], l1 - l0, w, *plan_geometry(torch.float32)))
        assert tuple(bs["stau_plan"].shape) == (-(-(e1 - e0) // rows) * -(-W // cols), 8)
    assert covered[0][0] == 0 and covered[0][1] == covered[1][0] and covered[1][1] == H
