"""Genotype models (reference L4 math, SURVEY.md §1).

``bayes`` holds the scalar float64 Bayesian genotyper — the parity
definition of ``classic.py::bayes_gt/log_choose``. The batched device
implementation lives in ``svtyper_tpu.ops``/``svtyper_tpu.gt``.
"""

from svtyper_tpu_torch.models.bayes import (  # noqa: F401
    ALT_PROBS,
    ALT_PROBS_DUP,
    GenotypeResult,
    bayes_gt,
    genotype_from_counts,
    log_choose,
)
