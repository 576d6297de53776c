"""The benchmark of infidex_tpu_torch, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one CUDA card
and prints one JSON line. Everything a cell needs is found by name:
configurations in ``configs/<name>.json``, each naming its deployment
in ``deployments/<name>.py`` (documents, engine, reference); traffic
mixes in ``traffic/<name>.json``, each naming its entry in
``entries/<name>.py`` and its query generator in
``generators/<name>.py``; per-layer metric readers in
``metrics/<name>.py``. The plain references that decide ``correct`` are
under ``reference/``. So a new deployment or traffic mix arrives as new
files. Nothing here imports ``jax``, ``jaxlib`` or ``infidex_tpu``.
"""
