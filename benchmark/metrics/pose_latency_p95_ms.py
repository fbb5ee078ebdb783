"""95th percentile over every scan of the window of the time from the
scan's due time to its fused pose on the host (the open loop copies the
step's ``drivers.HOST_POSE``, ``fused_pose``, to the host)."""

from benchmark import yardstick


def read(ctx):
    if not ctx.rec.latency_ms:
        return None
    return yardstick.percentile(ctx.rec.latency_ms, 0.95)
