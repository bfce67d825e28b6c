"""The benchmark of ``fastoptsolver_tpu_torch``, the PyTorch and CUDA port.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``); ``BENCHMARK.json`` at the
checkout's root names the cells and metrics, and ``spec.py`` says where
each item's files are. Nothing here imports JAX or the JAX package.
"""
