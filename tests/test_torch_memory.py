"""Memory accounting against the JAX package (``legoloam_tpu/utils/
memory.py``): the port builds its state on the meta device where the JAX
package uses ``jax.eval_shape``, and both must count the same bytes.

Tolerance: none — every byte count is equal.
"""

import dataclasses

import pytest

from legoloam_tpu import config as jc
from legoloam_tpu.utils import memory as jmem
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.utils import memory as tmem

from _torch_parity import port_cfg

# tests/test_memory.py::test_v5e16_hdl32e_per_shard_budget's configuration:
# a 32,768-keyframe HDL-32E map with doubled per-scan caps.
HDL32E_32K = jc.DEFAULT.replace(
    sensor=jc.HDL32E, mapping=dataclasses.replace(
        jc.DEFAULT.mapping, max_keyframes=32768, scan_corner_cap=4096,
        scan_surf_cap=16384))


@pytest.mark.parametrize("name", ["DEFAULT", "hdl32e"])
def test_slam_state_bytes_match_jax(name):
    cfg = jc.DEFAULT if name == "DEFAULT" else jc.for_sensor(name)
    assert tmem.slam_state_bytes(port_cfg(cfg)) == \
        jmem.slam_state_bytes(cfg)


def test_default_state_total():
    assert tmem.slam_state_bytes(port_cfg(jc.DEFAULT))["total"] == 547055832


@pytest.mark.parametrize("n_devices", [1, 16])
def test_dist_state_bytes_match_jax(n_devices):
    assert tmem.dist_state_bytes(port_cfg(HDL32E_32K), n_devices) == \
        jmem.dist_state_bytes(HDL32E_32K, n_devices)


def test_meta_tally_matches_a_real_state():
    """The meta-device tally equals the bytes of a state built on the CPU,
    and builds nothing."""
    cfg = port_cfg(jc.DEFAULT.replace(mapping=dataclasses.replace(
        jc.DEFAULT.mapping, max_keyframes=32, scan_corner_cap=64,
        scan_surf_cap=128, submap_corner_cap=256, submap_surf_cap=512)))
    real = tpipe.init_slam_state(cfg, device="cpu")
    assert tmem.slam_state_bytes(cfg)["total"] == tmem.tree_bytes(real)
    meta = tpipe.init_slam_state(cfg, device="meta")
    assert all(t.is_meta for t in tmem._leaves(meta))


def test_summary_matches_jax():
    cfg = port_cfg(HDL32E_32K)
    assert tmem.summary(cfg, 16) == jmem.summary(HDL32E_32K, 16)
    assert tmem.summary(cfg) == jmem.summary(HDL32E_32K)
    assert tmem.fmt_gib(3 * 2**29) == "1.500 GiB"
