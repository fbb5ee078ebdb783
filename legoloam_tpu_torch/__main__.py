"""``python -m legoloam_tpu_torch``: the command-line runner (``cli.py``)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
