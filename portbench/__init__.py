"""The benchmark of arp_tpu_torch on NVIDIA GPUs: ``python3 -m portbench.run --workload <cell> ...``.

Cells, configurations, traffic kinds and per-layer metrics are found by name
(``workloads/<cell>.json``, ``configs/<config>.json``, ``traffic/<kind>.py``,
``metrics/<metric>.py``); ``reference/`` holds the plain PyTorch versions that
decide ``correct``; ``roofline.py`` holds the published peaks and the formulas.
"""
