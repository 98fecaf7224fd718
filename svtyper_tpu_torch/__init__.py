"""svtyper_tpu_torch — the svtyper-tpu genotyper on PyTorch and CUDA.

A port of ``svtyper_tpu`` to PyTorch, beside the JAX package, which
stays the reference. It imports ``torch``, never ``jax``, and nothing of
``svtyper_tpu``: the host half (BAM/CRAM decoding in ``bamio``, VCF I/O
in ``vcfio``, ``stats``, ``breakpoints``, the compact-wire builder in
``evidence/extract.py``, the float64 ``oracle``, ``output``, the
checkpoints, ``simulate``) is the port's own copy of the JAX package's
jax-free modules, at the same paths, with only their imports changed
(``scripts/copy_host_half.py``). Module names follow the JAX package's;
the device half is:

- ``ops``       the GL stage: ``gl`` (torch, both float branches) and
                ``gl_kernel`` (the hand-written CUDA kernel for Hopper
                and its plain twin); ``classify_kernel``, the engine's
                classifier on the wire (a CUDA kernel beside its plain
                version); ``csrc/`` holds the CUDA sources.
- ``evidence``  ``classify_compact``: compact wire → ``[N,5]`` counts.
- ``gt``        ``TorchEngine``, the chunked streaming engine, sharded
                over one or more devices.
- ``cli``       the ``svtyper`` / ``svtyper-sso`` command lines.
- ``parallel``  ``shard_slices``, the ``SVT_DIST_*`` multi-host gather
                over gloo, and the multi-device dryrun.
- ``utils``     format-precision parity checks shared by the tests and
                ``chip_smoke.py``.
"""

from svtyper_tpu_torch.version import __version__  # noqa: F401
