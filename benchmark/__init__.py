"""The benchmark of infidex_tpu_torch, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one CUDA card
and prints one JSON line. Everything a cell needs is found by name:
configurations in ``configs/<name>.json``, traffic mixes in
``traffic/<name>.json``, per-layer metric readers in
``metrics/<name>.py``. The plain reference that decides ``correct`` is
under ``reference/``. Nothing here imports ``jax``, ``jaxlib`` or
``infidex_tpu``.
"""
