"""The benchmark of seqlib_tpu_torch, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card.
Configurations, traffic mixes and per-layer metrics are files of their
own under ``configs/``, ``traffic/`` and ``metrics/``, found by name;
``clients/`` holds the code that plays one kind of client,
``gen/`` the seeded generators and ``reference/`` the plain reference
that decides ``correct``.  Nothing here imports JAX or the JAX package.
"""
