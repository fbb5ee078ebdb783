"""The plain reference the benchmark holds ``legoloam_tpu_torch`` to: a
frozen copy of the port's plain PyTorch path (projection, segmentation
with K1's plain sweeps, features with K2's plain trip loop, odometry, the
scan-to-map step with the exact k-NN in K3's place, fusion), run eagerly
with TF32 off.  It imports nothing of the port, so a later change to the
port cannot move it.  ``step`` holds the per-scan step; every other module
is a copy of the port's module of the same name (``ccl``, ``picks`` and
``knn`` of ``ops/ccl_cuda.py``, ``ops/features_cuda.py`` and
``ops/knn_cuda.py``) without its kernel launch."""
