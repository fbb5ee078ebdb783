"""Seconds from the harness's start to the first timed scan: imports, the
kernel build (or its cache), staging the first chunk, the warm-up that
captures every step variant, a fresh state.  The pre-roll (the step after
the warm-up, for the mix's seconds and on the card until its start
transient has ended, ``harness.preroll``) is left out: its length is set
by the clock and the card, not by the program."""


def read(ctx):
    return ctx.setup_s
