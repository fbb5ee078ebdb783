"""The port's config copy, its import isolation from JAX, and its device
rule."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import legoloam_tpu.config as jc
import legoloam_tpu_torch.config as tc
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.ops import _native, ccl_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ["DEFAULT", "REFERENCE", "VLP16", "HDL32E", "VLS128", "OS1_16",
           "OS1_64"] + [f"for_sensor:{n}" for n in sorted(jc.SENSORS)]


def _preset(mod, name):
    if name.startswith("for_sensor:"):
        return mod.for_sensor(name.split(":", 1)[1])
    return getattr(mod, name)


@pytest.mark.parametrize("name", PRESETS)
def test_config_preset_equal(name):
    a, b = _preset(jc, name), _preset(tc, name)
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_config_apply_overrides_equal():
    kvs = ["nn_max_dist=2.0", "submap_mode=recent", "knn_backend=xla"]
    a = jc.apply_overrides(jc.DEFAULT.mapping, kvs)
    b = tc.apply_overrides(tc.DEFAULT.mapping, kvs)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


PORT_MODULES = [
    "ops.deskew", "ops.icp", "ops.voxel", "ops.knn_cuda", "ops.smallalg",
    "models.posegraph", "models.loopclosure", "models.relocalize",
    "models.mapping", "models.pipeline", "utils.interop",
    "utils.synthetic", "cli", "__main__", "utils.io", "utils.checkpoint",
    "utils.export", "utils.profiling", "utils.memory", "utils.debugdump",
    "utils.metrics", "evals.kidnap", "evals.loop_recovery", "evals.long",
    "parallel.mesh", "parallel.costs", "parallel.frontend_dp",
    "parallel.posegraph_dist", "parallel.mapping_dist",
    "parallel.pipeline_dist", "parallel.dryrun"]


def test_port_imports_no_jax():
    """Importing every module of the port (the IMU, ICP, pose-graph, loop
    closure and relocalization modules, the CLI, the utilities, the
    evaluations and the distributed paths among them), and chip_smoke
    without running it, loads neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import legoloam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,\n"
        "                                                p.__name__ + '.')]\n"
        f"missing = set('legoloam_tpu_torch.' + m for m in {PORT_MODULES!r})"
        " - set(names)\n"
        "assert not missing, missing\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'legoloam_tpu' or k.startswith('legoloam_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_init_slam_state_needs_a_device():
    """No device given and no CUDA device: the entry point raises instead
    of falling back to the CPU; an explicit CPU device works."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.init_slam_state(tc.DEFAULT)
    small = tc.DEFAULT.replace(mapping=dataclasses.replace(
        tc.DEFAULT.mapping, max_keyframes=4))
    st = tpipe.init_slam_state(small, device="cpu")
    assert st.mapping.kf.t.device.type == "cpu"


def test_cpu_tensors_take_the_plain_version():
    """A wrapper given CPU tensors runs its plain version and counts no
    kernel launch."""
    _native.reset_counts()
    seeds = torch.ones((4, 8), dtype=torch.bool)
    conn_h = torch.ones((4, 8), dtype=torch.bool)
    conn_v = torch.zeros((3, 8), dtype=torch.bool)
    labels, rmin, rmax = ccl_cuda.label_propagation(seeds, conn_h, conn_v, 32)
    assert labels[:, 0].tolist() == [0, 8, 16, 24]
    assert all(k.launches == 0 for k in _native.KERNELS.values())
    assert set(_native.KERNELS) == {"ccl", "picks", "knn"}
