"""quiverlint — static analysis for the CUDA hot-path contract.

Rule catalogue (``python -m quiver_tpu_torch.analysis --list-rules``):

  QT001  host-sync-in-hot-path   synchronize / .cpu() / host casts of
                                 tensors / pageable uploads in hot modules
  QT003  lock-discipline         _guarded_by-declared attributes mutated
                                 outside their lock
  QT004  import-layering         import-time dependency on the telemetry
                                 HTTP exporter from library modules
  QT005  library-hygiene         mutable default args, bare except:
  QT006  metric-name-hygiene     non-literal or malformed metric names
  QT007  silent-pipeline-except  pipeline threads that swallow exceptions
  QT008  data-race-candidate     state written from two thread roots
                                 without a common lock
  QT009  lock-order-inversion    cycles in the lock-acquisition order
  QT010  unreaped-thread-root    threads started and never joined
  QT011  durable-write-path      raw writes in the recovery package
  QT012  wall-clock-in-hot-path  durations measured on time.time()
  QT014  unbounded-executable-key  program-registry keys fed by raw data

Programmatic use::

    from quiver_tpu_torch.analysis import analyze_paths, LintConfig
    result = analyze_paths(["quiver_tpu_torch"], root=repo_root)

Runtime companions, none imported here (the linter stays stdlib-only):
:mod:`.retrace_guard`, the build guard and its pytest plugin
(``@pytest.mark.torch_retrace_budget(n)``); :mod:`.witness`, the lock
witness; :mod:`.transfer_witness`, the host-transfer witness over the
no-sync regions of :mod:`.staging`.
"""

from .baseline import DEFAULT_BASELINE_NAME
from .core import Finding, LintConfig, LintResult, analyze_paths
from .rules import RULE_CLASSES, all_rules

__all__ = [
    "Finding", "LintConfig", "LintResult", "analyze_paths",
    "all_rules", "RULE_CLASSES", "DEFAULT_BASELINE_NAME",
]
