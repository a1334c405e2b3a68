"""chip_smoke.py's CPU-checkable parts: its device check, its choice of
compile cache, its ground-truth gate, and that it fails (with no result
line) wherever no GPU or no repository is present. The GPU phases
themselves run only on the card, through `python chip_smoke.py`."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(args, cwd, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def test_import_does_not_load_jax():
    out = _run(["-c", "import sys, chip_smoke; print('jax' in sys.modules)"], ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu(jax.devices("cpu"))
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu([])


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_compile_cache_dir(env_dir):
    environ = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": env_dir}
    got = chip_smoke.compile_cache_dir(environ, "/repo")
    assert got == (env_dir or os.path.join("/repo", ".jax_cache"))


@pytest.mark.parametrize("offset,passes", [(0.0, True), (3.0, False)])
def test_gt_gate_on_tiny_frame(offset, passes):
    """The scene's own ground-truth maps pass every gate; a map off by 3 px
    everywhere fails EPE and bad2."""
    from stereomatch_tpu.synthetic import render_scene

    sc = render_scene(1, 96, 128, 16)
    g = chip_smoke.gt_gate(sc.disp_left + offset, sc.disp_right + offset, sc, 16)
    assert g["ok"] is passes, g
    if passes:
        assert g["epe"] < 1e-6 and g["bad2"] == 0.0
        assert g["valid_share"] > chip_smoke.VALID_MIN


@pytest.mark.parametrize("bare", [False, True])
def test_fails_without_gpu_or_repo(tmp_path, bare):
    """On the CPU, and from a directory holding only the script, it exits
    non-zero and prints no result line."""
    if bare:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    out = _run(["chip_smoke.py"], cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_server_compiles_without_pillow_or_cv2():
    """The main path imports neither Pillow nor OpenCV: with both made
    unimportable, the serving module imports and a tiny video server
    compiles and serves one frame on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['PIL'] = sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from stereomatch_tpu.config import production_mst_config\n"
        "from stereomatch_tpu.serving import compile_mst_video_server\n"
        "cfg = production_mst_config(8, min_cc_size=20, c=800.0, forest_backend='device')\n"
        "srv = compile_mst_video_server(24, 32, cfg=cfg, reuse_forest=True,\n"
        "                               volume_guided=False, fine_iterations=1)\n"
        "img = np.random.default_rng(0).random((24, 32, 3), np.float32) * 255\n"
        "dl, dr = srv.collect(srv.submit_pair(img, np.roll(img, -2, axis=1)))\n"
        "assert dl.shape == (24, 32) and np.isfinite(dl).all()\n"
        "print('served')\n"
    )
    out = _run(["-c", code], ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("served")
