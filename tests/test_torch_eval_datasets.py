"""The port's eval datasets (savsr_tpu_torch.data.video_test_dataset) and
test loaders against the JAX package's on the same tiny clips: every
dataset block of both shipped test configs, with its dataroots pointed at
them, builds in the port, and items are identical (lq and gt to the bit;
folder, idx, border, lq_path and scale equal), with and without
``cache_data``; the Vimeo90K-test and DUF-protocol sets likewise."""

import os

import numpy as np
import pytest

from savsr_tpu.data import build_dataset as jax_build_dataset
from savsr_tpu_torch.data import build_dataloader, build_dataset
from savsr_tpu_torch.utils.options import yaml_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_YMLS = [os.path.join(REPO, "options", "test", "SAVSR", f"test_SAVSR_{n}_asBI.yml")
             for n in ("Vid4", "UDM10")]
KEYS = ("folder", "idx", "border", "lq_path", "scale")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two Vid4-style clips of 5 frames at 64x80 (GT: the shipped configs'
    scale steps need 59 rows and 75 columns at x2.95 and x3.75), an LR folder
    of 16x20 frames for the x4 sets, and four Vimeo-style septuplets."""
    import cv2

    root = tmp_path_factory.mktemp("eval_clips")
    rng = np.random.default_rng(0)
    for clip in ("calendar", "city"):
        img = (rng.random((64, 80, 3)) * 255).astype(np.uint8)
        for sub, hw in (("GT", None), ("LR", (20, 16))):
            d = root / sub / clip
            d.mkdir(parents=True)
            for i in range(5):
                frame = np.roll(img, 3 * i, axis=1)
                if hw is not None:
                    frame = cv2.resize(frame, hw, interpolation=cv2.INTER_AREA)
                cv2.imwrite(str(d / f"{i:08d}.png"), frame)
    keys = ["00001/0001", "00001/0002", "00002/0001", "00002/0002"]
    for key in keys:
        d = root / "vimeo" / key
        d.mkdir(parents=True)
        img = (rng.random((32, 44, 3)) * 255).astype(np.uint8)
        for i in range(1, 8):
            cv2.imwrite(str(d / f"im{i}.png"), np.roll(img, i, axis=0))
    (root / "vimeo_meta.txt").write_text("".join(f"{k} 7 (32,44,3)\n" for k in keys))
    return root


def _assert_items_equal(got, want, where):
    assert set(got) == set(want), where
    for k in ("lq", "gt"):
        assert got[k].dtype == want[k].dtype == np.float32, (where, k)
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), (where, k)
    for k in KEYS:
        assert got.get(k) == want.get(k), (where, k)


def _both(opt):
    return build_dataset(dict(opt)), jax_build_dataset(dict(opt))


@pytest.mark.parametrize("cache_data", [False, True])
@pytest.mark.parametrize("yml", TEST_YMLS, ids=["Vid4", "UDM10"])
def test_shipped_test_blocks_build_and_match_jax(clips, yml, cache_data):
    blocks = yaml_load(yml)["datasets"]
    assert len(blocks) == (48 if "Vid4" in yml else 42)
    for phase, opt in blocks.items():
        opt = dict(opt, phase=phase.split("_")[0], cache_data=cache_data,
                   dataroot_gt=str(clips / "GT"), dataroot_lq=str(clips / "GT"))
        port, jds = _both(opt)
        assert len(port) == len(jds) == 10, opt["name"]
        _assert_items_equal(port[0], jds[0], opt["name"])


def test_every_item_and_the_test_loader(clips):
    """All items of one asymmetric block, in the loader's order (batch 1, no
    shuffle), equal the JAX dataset's; reflection padding at both ends."""
    block = next(b for b in yaml_load(TEST_YMLS[0])["datasets"].values()
                 if b["name"] == "Vid4_x3.5_x1.5")
    opt = dict(block, phase="test", dataroot_gt=str(clips / "GT"),
               dataroot_lq=str(clips / "GT"))
    assert opt["downsampling_scale"] == (3.5, 1.5)
    port, jds = _both(opt)
    loader = build_dataloader(port, opt)
    batches = list(loader)
    assert len(batches) == len(port) == 10
    for i, batch in enumerate(batches):
        want = jds[i]
        assert batch["lq"].shape == (1,) + want["lq"].shape
        assert np.array_equal(batch["lq"][0], want["lq"])
        assert np.array_equal(batch["gt"][0], want["gt"])
        assert batch["folder"] == [want["folder"]] and batch["idx"] == [want["idx"]]
        assert batch["border"].tolist() == [want["border"]]
    assert [jds[i]["border"] for i in range(5)] == [1, 1, 1, 1, 1]  # 5 frames, window 7


def test_paired_video_test_dataset_matches_jax(clips):
    """VideoTestDataset on an LR folder (no arbitrary-scale degradation)."""
    for cache_data in (False, True):
        opt = dict(name="Vid4_BI", type="VideoTestDataset", phase="test",
                   dataroot_gt=str(clips / "GT"), dataroot_lq=str(clips / "LR"),
                   io_backend=dict(type="disk"), cache_data=cache_data, num_frame=7,
                   padding="reflection")
        port, jds = _both(opt)
        for i in (0, 7):
            _assert_items_equal(port[i], jds[i], (cache_data, i))
        assert port[0]["lq"].shape == (7, 16, 20, 3)


@pytest.mark.parametrize("kind", ["VideoTestVimeo90KDataset", "ASVideoTestVimeo90KDataset"])
def test_vimeo90k_test_sets_match_jax(clips, kind):
    opt = dict(name="Vimeo90K_test", type=kind, phase="test",
               dataroot_gt=str(clips / "vimeo"), dataroot_lq=str(clips / "vimeo"),
               meta_info_file=str(clips / "vimeo_meta.txt"), io_backend=dict(type="disk"),
               cache_data=False, num_frame=7, padding="reflection",
               downsampling_scale=(2.5, 1.5), downsampling_mode="torch")
    port, jds = _both(opt)
    assert len(port) == len(jds) == 4
    for i in (0, 3):
        _assert_items_equal(port[i], jds[i], i)


@pytest.mark.parametrize("use_duf", [True, False])
def test_duf_test_set_matches_jax(clips, use_duf):
    opt = dict(name="Vid4_BD", type="VideoTestDUFDataset", phase="test",
               dataroot_gt=str(clips / "GT"), dataroot_lq=str(clips / "LR"),
               io_backend=dict(type="disk"), cache_data=False, num_frame=7,
               padding="reflection", use_duf_downsampling=use_duf, scale=4)
    port, jds = _both(opt)
    for i in (0, 6):
        _assert_items_equal(port[i], jds[i], i)


def test_recurrent_test_sets_are_refused_by_name(clips):
    opt = dict(name="x", type="ASVideoRecurrentTestDataset", phase="test",
               dataroot_gt=str(clips / "GT"), cache_data=True, num_frame=7)
    with pytest.raises(NotImplementedError, match="ASVideoRecurrentTestDataset"):
        build_dataset(opt)
