"""How ``correct`` is decided: the plain reference (the program kind's
``Reference``, built from ``reference/``) follows the program over the
window's sampled segments and the outputs and states are compared.

The first segment starts at scan 0 from the empty state, so there the
reference works out everything, the map included, on its own.  Each later
segment starts from the program's state as the harness copied it to the
host before the segment's first scan (the reference cannot follow a whole
window of thousands of scans in less time than the window); the state the
program left after the segment's last scan is compared with the
reference's, so each state transition the program made inside a segment is
checked, and the first segment checks the start.

The numbers compared, each the worst over the kept scans:

  * ``pose_gap_m``: the largest gap between a position the program gave
    (odometry, mapped and fused pose; odometry alone: its pose) and the
    reference's, in metres;
  * ``rot_gap``: the largest gap between an entry of such a rotation
    matrix and the reference's;
  * ``state_gap``: the largest gap over the float entries of the state
    after each segment (feature clouds, keyframe store, submap cache, poses,
    twist);
  * ``state_mismatch``: the number of integer and flag entries of those
    states that differ.

The reference runs with TF32 off; the control (``control.py``) is the
same reference with TF32 on, put in the program's place.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

from .drivers import Plan, flatten

NUMBERS = ("pose_gap_m", "rot_gap", "state_gap", "state_mismatch")


@contextmanager
def tf32(on: bool):
    """Matrix products in TF32 (``on``) or in float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fill(template, host: dict, prefix: str = ""):
    """``template``'s tree with each leaf taken from ``host`` by path, on
    the template's device."""
    if isinstance(template, torch.Tensor):
        src = host[prefix]
        if src.shape != template.shape or src.dtype != template.dtype:
            raise ValueError(f"state leaf {prefix}: {tuple(src.shape)} "
                             f"{src.dtype}, reference "
                             f"{tuple(template.shape)} {template.dtype}")
        return src.to(template.device, copy=True)
    return type(template)(*(
        _fill(getattr(template, n), host, f"{prefix}.{n}" if prefix else n)
        for n in template._fields))


def follow(reference, plan: Plan, before: dict, stream,
           use_tf32: bool = False):
    """The program kind's ``Reference`` (``programs/<kind>.py``) over each
    segment of ``plan``: the first from the empty state, the others from
    ``before`` (host states by scan).
    Returns (outputs by scan, host state after each segment by its last
    scan).  Scans are made with TF32 off whatever ``use_tf32`` says."""
    outputs, after = {}, {}
    for k0, n in plan.segments:
        state = reference.empty()
        if k0 > 0:
            state = _fill(state, before[k0])
        for k in range(k0, k0 + n):
            scan = stream.scan(k)
            with tf32(use_tf32):
                state, out = reference.step(state, k, scan)
            outputs[k] = {name: (p.R.cpu(), p.t.cpu())
                          for name, p in out.items()}
        after[k0 + n - 1] = {p: t.cpu() for p, t in flatten(state).items()}
        del state
    return outputs, after


def host_outputs(outputs: dict) -> dict:
    """The program's kept outputs, {scan: {name: Pose}}, on the host."""
    return {k: {name: (p.R.cpu(), p.t.cpu()) for name, p in out.items()}
            for k, out in outputs.items()}


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.double() - b.double()).abs()
    if d.numel() == 0:
        return 0.0
    bad = torch.isnan(d)
    if bool(torch.any(bad & ~(torch.isnan(a) & torch.isnan(b)))):
        return math.inf
    return float(torch.nan_to_num(d, nan=0.0).max())


def numbers(judged_out: dict, judged_after: dict, ref_out: dict,
            ref_after: dict) -> dict:
    """The compared numbers (``NUMBERS``) of judged outputs and states
    against the reference's; a scan or a state missing on the judged side
    makes every number infinite."""
    if set(judged_out) != set(ref_out) or set(judged_after) \
            != set(ref_after):
        return {n: math.inf for n in NUMBERS}
    pose_gap = rot_gap = 0.0
    for k, ro in ref_out.items():
        jo = judged_out[k]
        for name, (R, t) in ro.items():
            pose_gap = max(pose_gap, _gap(jo[name][1], t))
            rot_gap = max(rot_gap, _gap(jo[name][0], R))
    state_gap, mismatch = 0.0, 0
    for k, rs in ref_after.items():
        js = judged_after[k]
        for path, r in rs.items():
            j = js[path]
            if j.shape != r.shape:
                return {n: math.inf for n in NUMBERS}
            if r.dtype.is_floating_point:
                state_gap = max(state_gap, _gap(j, r))
            else:
                mismatch += int(torch.count_nonzero(j != r))
    return {"pose_gap_m": pose_gap, "rot_gap": rot_gap,
            "state_gap": state_gap, "state_mismatch": float(mismatch)}


def judge(values: dict, limits: dict) -> bool:
    """Every compared number within its limit (a number is compared where
    the cell's limits name it)."""
    return all(values[n] <= limits[n] for n in limits)
