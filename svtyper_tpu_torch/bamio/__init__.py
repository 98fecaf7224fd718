"""BAM/BGZF/BAI I/O — the native-boundary layer.

Replaces the reference's L0 dependency chain ``pysam → htslib`` (SURVEY.md
§1, §2.1) with a from-scratch implementation. Two backends share one
interface:

- ``svtyper_tpu.bamio.bam.BamFile`` — pure Python + numpy (always available).
- ``svtyper_tpu.bamio.native`` — C++ core (``_native/``) loaded via ctypes,
  decoding BGZF blocks and BAM records into the same columnar batches.

Both decode reads into :class:`svtyper_tpu.bamio.columns.ReadBatch`
(structure-of-arrays) rather than per-read objects: the evidence layer is
vectorized end-to-end (SURVEY.md §3.5).
"""

from svtyper_tpu_torch.bamio.bam import BamFile, open_bam  # noqa: F401
from svtyper_tpu_torch.bamio.columns import ReadBatch  # noqa: F401
