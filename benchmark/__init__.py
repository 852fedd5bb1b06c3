"""The benchmark of ``pointnet_autoencoder_tpu_torch`` on an NVIDIA H100.
``python3 -m benchmark.run --workload <cell> ...`` runs one cell; see
``benchmark/README.md``."""
