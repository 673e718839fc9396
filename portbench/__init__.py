"""The benchmark of ``quiver_tpu_torch`` on one NVIDIA H100: a harness
driven by ``BENCHMARK.json`` and the data files beside this module
(``configs/``, ``traffic/``, ``limits/``) and the per-layer readers in
``metrics/``; its own plain reference in ``reference/``."""
