"""Distributed paths on torch.distributed: one process per rank (port of
``legoloam_tpu/parallel/``)."""
