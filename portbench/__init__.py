"""The benchmark of the PyTorch port (``repro_torch``) on one NVIDIA H100.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; see ``README.md``."""
