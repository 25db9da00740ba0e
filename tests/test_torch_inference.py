"""The port's serving CLI (savsr_tpu_torch.inference) against the JAX CLI,
its device rule, and the rule that the port imports neither JAX nor the
JAX package."""

import ast
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_feat=16, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("torch_infer")
    d = root / "clipA"
    d.mkdir()
    rng = np.random.default_rng(0)
    img = (rng.random((20, 24, 3)) * 255).astype(np.uint8)
    for i in range(5):
        cv2.imwrite(str(d / f"{i:08d}.png"), np.roll(img, i, axis=1))
    return d


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A tiny JAX checkpoint (.npz, params/ prefix), as the JAX training
    writes it, and the options YAML that selects its architecture."""
    import jax

    from savsr_tpu.inference import build_serving_model

    params = build_serving_model("strict", TINY).init(jax.random.PRNGKey(3))
    d = tmp_path_factory.mktemp("torch_ckpt")
    path = d / "net_g.npz"
    np.savez(path, **{f"params/{k}": np.asarray(v) for k, v in params.items()})
    yml = d / "net.yml"
    # conv_engine is a JAX engine setting, as in the shipped test options;
    # the port ignores it
    yml.write_text("network_g:\n  type: SAVSR\n  conv_engine: chw\n"
                   + "\n".join(f"  {k}: {v}" for k, v in TINY.items()) + "\n")
    return str(path), str(yml)


def _frames(out_dir):
    import cv2

    paths = sorted(out_dir.glob("*.png"))
    return [p.name for p in paths], np.stack([cv2.imread(str(p)) for p in paths])


def test_cli_frames_match_jax_cli(clip_dir, tiny_ckpt, tmp_path):
    """Strict tier on the CPU: the port's frames equal the JAX CLI's within
    one 8-bit step (the two sum in different orders, so a value on a
    rounding boundary may land one step apart)."""
    from savsr_tpu.inference import main as jax_main
    from savsr_tpu_torch.inference import main

    ckpt, yml = tiny_ckpt
    common = ["-i", str(clip_dir), "-s", "2", "-w", ckpt, "--opt", yml, "--tier", "strict"]
    assert jax_main(common + ["-o", str(tmp_path / "jax"), "--no_aot"]) == 0
    assert main(common + ["-o", str(tmp_path / "port"), "--device", "cpu",
                          "--windows", "2"]) == 0
    names_j, jax_frames = _frames(tmp_path / "jax")
    names_p, port_frames = _frames(tmp_path / "port")
    assert names_p == names_j and len(names_p) == 5
    assert port_frames.shape == (5, 40, 48, 3)
    diff = np.abs(port_frames.astype(np.int16) - jax_frames.astype(np.int16))
    assert diff.max() <= 1


def test_cli_chunking_is_exact(clip_dir, tiny_ckpt, tmp_path):
    """Windows batched per forward (with a short last chunk) write the same
    bytes as one window per forward; an asymmetric scale rounds the size as
    the reference does."""
    from savsr_tpu_torch.inference import main

    ckpt, yml = tiny_ckpt
    outs = {}
    for n in (1, 3):
        out = tmp_path / f"n{n}"
        assert main(["-i", str(clip_dir), "-o", str(out), "-s", "1.5", "2.5", "-w", ckpt,
                     "--opt", yml, "--tier", "strict", "--device", "cpu",
                     "--windows", str(n)]) == 0
        outs[n] = {p.name: p.read_bytes() for p in out.glob("*.png")}
    assert len(outs[1]) == 5 and outs[1] == outs[3]
    _, frames = _frames(tmp_path / "n1")
    assert frames.shape[1:] == (30, 60, 3)  # round(20*1.5), round(24*2.5)


def test_cuda_request_without_a_card_raises(clip_dir, tiny_ckpt, tmp_path):
    from savsr_tpu_torch.archs.arch_util import resolve_device
    from savsr_tpu_torch.inference import main

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    ckpt, yml = tiny_ckpt
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-i", str(clip_dir), "-o", str(tmp_path / "x"), "-s", "2", "-w", ckpt,
              "--opt", yml])
    assert not (tmp_path / "x").exists()


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "savsr_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_sources()
    assert len(files) > 10 and os.path.isfile(os.path.join(REPO, "chip_smoke.py"))
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "savsr_tpu"):
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert bad == []


# the modules of the training path: each must be among the files the check
# above walks, and importing all of them must not pull JAX in
TRAINING_MODULES = [
    "ops.osconv", "archs.train_engine", "archs", "losses", "losses.basic_loss",
    "losses.loss_util", "models", "models.base_model", "models.sr_model",
    "models.video_base_model", "models.asvsr_model", "models.lr_scheduler", "data",
    "data.loader", "data.transforms", "data.resize", "data.vimeo90k_dataset",
    "utils.registry", "utils.misc", "utils.file_client", "utils.options", "utils.logger",
    "train",
]


def test_training_modules_are_covered_and_import_without_jax():
    import subprocess
    import sys

    walked = {os.path.relpath(p, os.path.join(REPO, "savsr_tpu_torch")) for p in _port_sources()}
    for mod in TRAINING_MODULES:
        rel = mod.replace(".", os.sep)
        assert rel + ".py" in walked or os.path.join(rel, "__init__.py") in walked, mod
    code = ("import importlib, sys\n"
            f"mods = {TRAINING_MODULES!r}\n"
            "for m in mods: importlib.import_module('savsr_tpu_torch.' + m)\n"
            "import savsr_tpu_torch.inference\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'savsr_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
