"""The benchmark of the PyTorch / CUDA port (``repro_torch``) on an H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything a cell needs is found by name: the model
configuration in ``configs/<config>.json``, the traffic mix in
``traffic/<mix>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.  The plain float32 reference that decides
``correct`` is in ``reference/``; peaks and operation / byte counts in
``roofline.py``.  Nothing here imports JAX or the JAX package.
"""
