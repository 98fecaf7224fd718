"""Pure-Python float64 oracle — the parity baseline (SPEC.md preamble).

Implements the reconstructed reference algorithm per-read/per-fragment,
exactly as SPEC.md §§2–8 pin it down. The vectorized engine
(``svtyper_tpu/evidence`` + ``svtyper_tpu/gt``) must agree with this
bit-for-bit on formatted output; ``tests/test_parity.py`` enforces it.
Deliberately unoptimized — clarity over speed.
"""

from svtyper_tpu_torch.oracle.engine import OracleEngine, classify_fragments  # noqa: F401
