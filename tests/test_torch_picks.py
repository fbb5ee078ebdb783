"""Kernel K2's design (csrc/picks.cu), modelled on the CPU and held to its
contract: the labels of ``features_cuda.pick_labels_plain``, bit for bit.

``_model_labels`` is the kernel's algorithm in plain numpy: per-section
lane slabs (lane l of section j holds cells sp_j + l + 32m), ordered int32
keys (an edge candidate's curvature bits, a surf candidate's ~bits, INT_MIN
for every other cell), the two-stage reduction (each lane's first largest
key, then the warp's largest key and the lowest index holding it), the
suppression reach [q - reachL, q + reachR] of each pick from the column
gaps, and one exchange per trip in which every section applies every
published interval that overlaps it (only its neighbours' where no section
of the ring is shorter than halfwin: the model asserts that nothing else
can reach then).

Inputs: ray-cast VLP-16 (16 x 1800) and OS1-16 (16 x 1024) scans through the
port's frontend on the CPU, the same scans with ranges quantised to 1/256 m
(flat ground ties at curvature exactly 0), and the seeded stress rings of
``synthetic.pick_stress_rings`` (counts 0, 5, 11, 12, 13, 40 and H, column
gaps every few cells, spikes on the section boundaries) at sections 1, 6
and 12, at the DEFAULT (4/20/8) and REFERENCE (2/20/4) pick counts.
Tolerance: none — labels are equal.  On quantised ranges the plain version
and the model also equal the JAX package's Pallas kernel in interpret mode
(unquantised, XLA:CPU's FMA contraction reorders flat ties, see
tests/test_torch_frontend.py).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.config import DEFAULT as JD
from legoloam_tpu.ops.features_pallas import pick_labels_pallas
from legoloam_tpu_torch import config as tcfg
from legoloam_tpu_torch.ops import features, features_cuda, projection
from legoloam_tpu_torch.ops import segmentation
from legoloam_tpu_torch.ops.se3 import Pose
from legoloam_tpu_torch.utils import synthetic

INT_MIN = int(np.iinfo(np.int32).min)
INT_MAX = int(np.iinfo(np.int32).max)
COUNTS = {"default": tcfg.DEFAULT.feat, "reference": tcfg.REFERENCE.feat}


def _shift(a, k, fill):
    """out[:, i] = a[:, i + k], ``fill`` beyond the row."""
    out = np.full_like(a, fill)
    h = a.shape[1]
    if k >= 0:
        out[:, :h - k] = a[:, k:]
    else:
        out[:, -k:] = a[:, :h + k]
    return out


def _sections(count, sections, halfwin):
    """(sp, ep) per (ring, section); empty sections have ep = sp - 1."""
    S = sections
    e = count - halfwin - 1
    j = np.arange(S)[None]
    sp = (halfwin * (S - j) + e[:, None] * j) // S
    ep = (halfwin * (S - 1 - j) + e[:, None] * (j + 1)) // S - 1
    ep[:, -1] = e - 1
    ok = (sp <= ep) & (e[:, None] > halfwin)
    return sp, np.where(ok, ep, sp - 1)


def _cells(rng, col, ground, count, f):
    """The kernel's prologue: each cell's ordered key (INT_MIN where marked
    by occlusion or a parallel beam) and its suppression reach."""
    n, h = rng.shape
    hw = f.curvature_halfwin
    f32 = np.float32
    idx = np.arange(h)[None]
    cnt = np.clip(count, 0, h)[:, None]
    in0 = idx < cnt
    acc = f32(-2 * hw) * rng
    for k in range(1, hw + 1):
        acc = acc + _shift(rng, k, 0.0)
        acc = acc + _shift(rng, -k, 0.0)
    curv = acc * acc
    assert curv.dtype == np.float32
    cok = in0 & (idx >= hw) & (idx < cnt - hw)
    bits = curv.view(np.int32).astype(np.int64)
    key = np.full((n, h), INT_MIN, np.int64)
    key = np.where(cok & ~ground & (curv > f32(f.edge_threshold)), bits, key)
    key = np.where(cok & ground & (curv < f32(f.surf_threshold)), ~bits, key)

    r1, rm = _shift(rng, 1, 0.0), _shift(rng, -1, 0.0)
    cdiff = np.abs(_shift(col.astype(np.int64), 1, 10 ** 6) - col)
    close = in0 & _shift(in0, 1, False) & (cdiff < f.occlusion_col_gap)
    jump = f32(f.occlusion_range_jump)
    occl_self = close & (rng > r1 + jump)
    occl_next = close & (r1 > rng + jump)
    lim = f32(f.parallel_beam_frac) * rng
    marked = in0 & (np.abs(rm - rng) > lim) & (np.abs(r1 - rng) > lim)
    for k in range(6):
        marked |= _shift(occl_self, k, False) | _shift(occl_next, -(k + 1),
                                                       False)
    key = np.where(marked, INT_MIN, key)

    # Reach: clear gap bits from q rightwards (ffs) and from q-1 leftwards
    # (clz), capped at halfwin and the row's ends.
    gap = cdiff > f.occlusion_col_gap
    pos = np.broadcast_to(idx, (n, h))
    nxt = np.where(gap, pos, h)
    nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
    prv = np.maximum.accumulate(np.where(gap, pos, -1), axis=1)
    prv = _shift(prv, -1, -1)                     # last gap strictly left
    reach_r = np.minimum(np.minimum(nxt - pos, hw), h - 1 - pos)
    reach_l = np.minimum(np.minimum(pos - 1 - prv, hw), pos)
    return key, reach_l, reach_r


def _model_labels(rng, col, ground, count, f, stats=None):
    """Labels by the kernel's algorithm (see the module docstring).  With a
    dict ``stats``: the number of intervals applied by another section of
    the ring ("cross") and by a section two or more away ("far"), and of
    picks on a section's first or last cell ("boundary")."""
    rng, col = np.asarray(rng, np.float32), np.asarray(col, np.int32)
    ground, count = np.asarray(ground, bool), np.asarray(count, np.int64)
    n, h = rng.shape
    S = f.sections
    key, reach_l, reach_r = _cells(rng, col, ground, count, f)
    hw = f.curvature_halfwin
    sp, ep = _sections(np.clip(count, 0, h), S, hw)
    # Every section holds at least floor((e - s) / S) cells.
    far = (np.clip(count, 0, h) - 2 * hw - 1) // S < hw
    m_lane = max(1, -(-int((ep - sp + 1).max()) // 32))
    lanes = np.arange(32)
    cell = (sp[:, :, None, None] + lanes[None, None, :, None]
            + 32 * np.arange(m_lane)[None, None, None, :])   # (n, S, 32, M)
    live = cell <= ep[:, :, None, None]
    rows = np.arange(n)[:, None, None, None]
    cc = np.clip(cell, 0, h - 1)
    v = np.where(live, key[rows, cc], INT_MIN)
    rl = np.where(live, reach_l[rows, cc], 0)
    rr = np.where(live, reach_r[rows, cc], 0)
    sec = np.arange(S)
    label = np.zeros((n, h), np.int32)
    edge_trips = f.edge_less_per_section
    for t in range(edge_trips + f.surf_per_section):
        edge = t < edge_trips
        if t == edge_trips:
            v = np.where(v >= 0, INT_MIN, v)
        lane_m = v.argmax(-1)                           # first: lowest index
        lane_v = np.take_along_axis(v, lane_m[..., None], -1)[..., 0]
        lane_i = sp[..., None] + lanes + 32 * lane_m    # (n, S, 32)
        best = lane_v.max(-1)                           # __reduce_max_sync
        have = best >= (0 if edge else INT_MIN + 1)
        cand = np.where(lane_v == best[..., None], lane_i, INT_MAX)
        owner = cand.argmin(-1)                         # __reduce_min_sync
        q = np.take_along_axis(cand, owner[..., None], -1)[..., 0]
        m_own = np.take_along_axis(lane_m, owner[..., None], -1)[..., 0]
        ri, si = np.nonzero(have)
        label[ri, q[ri, si]] = (2 if t < f.edge_per_section else 1) \
            if edge else -1
        lo = np.full((n, S), INT_MAX, np.int64)          # no pick: empty
        hi = np.full((n, S), INT_MIN, np.int64)
        lo[ri, si] = q[ri, si] - rl[ri, si, owner[ri, si], m_own[ri, si]]
        hi[ri, si] = q[ri, si] + rr[ri, si, owner[ri, si], m_own[ri, si]]
        if stats is not None:
            stats["boundary"] += int(((q == sp) | (q == ep))[have].sum())
        for k in range(S):                              # the exchange
            lk, hk = lo[:, k:k + 1], hi[:, k:k + 1]     # (n, 1)
            overlap = (lk <= ep) & (hk >= sp)           # (n, S)
            beyond = overlap & (np.abs(sec - k) >= 2)
            # Rings whose sections all hold >= halfwin cells apply only the
            # neighbours' intervals: nothing else can reach.
            assert not (beyond & ~far[:, None]).any()
            if stats is not None:
                stats["cross"] += int((overlap & (sec != k)).sum())
                stats["far"] += int(beyond.sum())
            hit = overlap[..., None, None] \
                & (cell >= lk[..., None, None]) & (cell <= hk[..., None, None])
            v = np.where(hit, INT_MIN, v)
    return label


@functools.lru_cache(maxsize=None)
def _scan(sensor: str, seed: int = 0):
    """K2's inputs (numpy) of a ray-cast scan from a seeded pose, through
    the port's frontend on the CPU, as ``features.extract_features`` forms
    them."""
    cfg = tcfg.for_sensor(sensor)
    rs = np.random.RandomState(seed)
    t = torch.tensor([rs.uniform(-3.0, 3.0), rs.uniform(-3.0, 3.0), 0.8],
                     dtype=torch.float32)
    pts, valid, ring = synthetic.raycast_scan(
        synthetic.default_scene(), Pose(torch.eye(3), t), cfg.sensor)
    img = projection.project_scan(pts, valid, cfg.sensor, ring=ring)
    seg = segmentation.segment(img, cfg.sensor, cfg.seg)
    c, count = features._compact_rings(img, seg)
    in_ring = torch.arange(img.rng.shape[1])[None] < count[:, None]
    rng = torch.where(in_ring, c["rng"], torch.zeros_like(c["rng"]))
    return tuple(a.numpy() for a in (rng, c["col"], c["ground"], count))


def _quantised(inputs):
    rng, col, ground, count = inputs
    q = np.round(rng * np.float32(256.0)) / np.float32(256.0)
    return q.astype(np.float32), col, ground, count


def _plain(inputs, f):
    return features_cuda.pick_labels_plain(
        *(torch.from_numpy(np.array(a)) for a in inputs), f).numpy()


@pytest.mark.parametrize("counts", ["default", "reference"])
@pytest.mark.parametrize("quantise", [False, True])
@pytest.mark.parametrize("sensor", ["vlp16", "os1_16"])
def test_model_equals_plain_on_scans(sensor, quantise, counts):
    f = COUNTS[counts]
    inputs = _scan(sensor)
    if quantise:
        inputs = _quantised(inputs)
        key, _, _ = _cells(*inputs, f)
        assert (key == ~0).sum() > 100    # surf candidates at curvature 0
    want = _plain(inputs, f)
    assert np.array_equal(_model_labels(*inputs, f), want)
    assert (want == 2).sum() > 20 and (want == -1).sum() > 50


@pytest.mark.parametrize("sensor", ["vlp16", "os1_16"])
def test_quantised_scans_equal_pallas(sensor):
    """On quantised ranges the plain version, the model and the JAX
    package's Pallas kernel (interpret mode) give the same labels."""
    f = tcfg.DEFAULT.feat
    inputs = _quantised(_scan(sensor))
    want = _plain(inputs, f)
    lab_p = pick_labels_pallas(*(jnp.asarray(a) for a in inputs), JD.feat,
                               interpret=True)
    assert np.array_equal(np.asarray(lab_p), want)
    assert np.array_equal(_model_labels(*inputs, f), want)


@pytest.mark.parametrize("counts", ["default", "reference"])
@pytest.mark.parametrize("sections,h", [(1, 1800), (6, 1800), (12, 1800),
                                        (6, 1022)])
def test_model_equals_plain_on_stress_rings(sections, h, counts):
    """Counts 0..H, column gaps every few cells, ties at curvature 0 and
    spikes on the section boundaries.  The cases are exercised: picks land
    on section boundaries, intervals cross into other sections and, with
    12 sections of a 40-cell ring, past the neighbouring one."""
    f = dataclasses.replace(COUNTS[counts], sections=sections)
    inputs = tuple(a.numpy() for a in synthetic.pick_stress_rings(
        sections + h, h, sections))
    want = _plain(inputs, f)
    stats = dict.fromkeys(("cross", "far", "boundary"), 0)
    assert np.array_equal(_model_labels(*inputs, f, stats), want)
    assert (want[:3] == 0).all()          # counts 0, 5, 11: no section
    assert (want == 2).sum() > 10 and (want == -1).sum() > 10
    assert stats["boundary"] > 0
    if sections > 1:
        assert stats["cross"] > 0
    if sections == 12:
        assert stats["far"] > 0


def test_ordered_keys_follow_curvature():
    """Curvature = acc * acc is >= 0 and never -0, so its float bits order
    as the floats do and ~bits in reverse (the kernel's ordered keys)."""
    rs = np.random.RandomState(3)
    acc = np.concatenate([
        [0.0, -0.0, 1e-45, -1e-45, 1e-20, 0.3, -0.3, 1e19, -1e20],
        rs.standard_normal(2000), rs.choice([0.0, 1 / 256, -0.5], 300)])
    with np.errstate(over="ignore"):      # 1e20 squared: inf, as on the card
        curv = acc.astype(np.float32) * acc.astype(np.float32)
    assert np.isinf(curv).any() and (curv == 0).any() and not np.signbit(
        curv).any()
    bits = curv.view(np.int32).astype(np.int64)
    for keys, vals in ((bits, curv), (~bits, -curv)):
        o = np.argsort(vals, kind="stable")
        assert np.array_equal(o, np.argsort(keys, kind="stable"))
        assert np.array_equal(np.diff(vals[o]) == 0, np.diff(keys[o]) == 0)
    assert (~bits > INT_MIN).all()
