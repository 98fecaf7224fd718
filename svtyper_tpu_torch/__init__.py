"""svtyper_tpu_torch — the svtyper-tpu genotyper on PyTorch and CUDA.

A port of ``svtyper_tpu``'s device half to PyTorch, beside the JAX
package, which stays the reference. It imports ``torch`` and never
``jax``; the host half (BAM/CRAM decoding, VCF I/O, library statistics,
the compact-wire builder, the oracle) is imported from ``svtyper_tpu``
modules that are themselves free of jax. Module names follow the JAX
package's:

- ``ops``       the GL stage: ``gl`` (torch, both float branches) and
                ``gl_kernel`` (the hand-written CUDA kernel for Hopper
                and its plain twin); ``csrc/`` holds the CUDA source.
- ``evidence``  ``classify_compact``: compact wire → ``[N,5]`` counts.
- ``gt``        ``TorchEngine``, the chunked streaming engine, sharded
                over one or more devices.
- ``cli``       the ``svtyper`` / ``svtyper-sso`` command lines.
- ``parallel``  ``shard_slices``, the ``SVT_DIST_*`` multi-host gather
                over gloo, and the multi-device dryrun.
- ``utils``     format-precision parity checks shared by the tests and
                ``chip_smoke.py``.
"""

from svtyper_tpu.version import __version__  # noqa: F401
