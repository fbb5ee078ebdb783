"""The benchmark of ``legoloam_tpu_torch`` on an NVIDIA H100: one command
runs one cell once (``python3 -m benchmark.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``)."""
