"""Sample & library statistics (reference L2, SURVEY.md §1).

Parity surface of ``svtyper/parsers.py::Sample/Library`` plus the ``-l``
JSON cache schema (SPEC.md §7). Bootstrap scans are vectorized over
columnar read batches instead of per-read Python objects.
"""

from svtyper_tpu_torch.stats.library import Library, Sample  # noqa: F401
