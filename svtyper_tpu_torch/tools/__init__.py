"""Operational entry points that drive ``TorchEngine`` and the GL kernel.

Each module runs as ``python -m svtyper_tpu_torch.tools.<name>`` and has
a plain function that tests and ``chip_smoke.py`` call:

- ``gl_bench``         the CUDA GL kernel against its plain twin and the
                       torch ``genotype_batch`` (``scripts/pallas_vs_jnp.py``);
- ``classify_bench``   versions of the classify kernel (this checkout's
                       and another's) timed in turns on one chunk of the
                       engine's prep;
- ``profile_chunks``   chunk-size sweep with the prep/send/sync split
                       (``scripts/profile_tpu.py``);
- ``scaling_curve``    variants/s over 1, 2, 4, 8 devices, output held
                       against one device (``scripts/scaling_curve.py``);
- ``soak``             a long streaming run, library or CLI, with the
                       flat-memory check (``scripts/soak_1m.py``);
- ``dump_chunk_args``  one chunk's ``svt_fetch_chunk`` arguments for the
                       native replay harness
                       (``scripts/native_profile/dump_chunk_args.py``;
                       the harness is ``native_profile/replay_harness.cpp``);
- ``profile_prep``     the engine's host prep per chunk, split into
                       preamble, native fetch, export and the rest, plus
                       a cProfile (``scripts/profile_prep.py``);
- ``reference_parity`` the output contract against a hall-lab/svtyper
                       checkout, or a mock one
                       (``scripts/run_reference_parity.sh``), with its
                       diff ``parity_diff`` (``scripts/parity_diff.py``);
- ``make_example_data`` the ``data/`` example BAM and VCF
                       (``scripts/make_example_data.py``);
- ``bench``            end-to-end variants/s of the engine and the CLI
                       against the float64 oracle, with the accuracy
                       gate (``bench.py``);
- ``first_use``        a card's first use in a fresh process split into
                       its parts, each part's interpreter-lock share
                       (CUDA only; no JAX counterpart).

With no ``device`` a tool that drives the engine runs on CUDA and exits
non-zero where there is none; the CPU runs only when a caller passes
``device="cpu"``. ``parity_diff`` and ``make_example_data`` touch no
device.

``RefuseJax`` lives here, free of imports, so that a child process can
install it before it imports anything of the port.
"""

# what the port never imports: jax, and the JAX package itself
REFUSED = ("jax", "jaxlib", "svtyper_tpu")


class RefuseJax:
    """Meta-path hook: the port runs without jax and without the JAX
    package (``svtyper_tpu``; ``svtyper_tpu_torch`` is the port)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("import refused (%s)" % name)
        return None
