"""Seconds from the harness's start to the first timed scan: imports, the
kernel build (or its cache), staging the first chunk, the warm-up that
captures every step variant, a fresh state.  A mix's pre-roll (a fixed
number of seconds of the step after the warm-up, ``harness.preroll``) is
left out: its length is set by the clock, not by the program."""


def read(ctx):
    return ctx.setup_s
