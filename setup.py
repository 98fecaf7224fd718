"""Package metadata (parity surface of the reference setup.py:
console_scripts ``svtyper`` / ``svtyper-sso``, SURVEY.md §2.1)."""

import os

from setuptools import find_packages, setup

HERE = os.path.dirname(os.path.abspath(__file__))
version = {}
with open(os.path.join(HERE, "svtyper_tpu", "version.py")) as fh:
    exec(fh.read(), version)

setup(
    name="svtyper-tpu",
    version=version["__version__"],
    description=(
        "TPU-native Bayesian structural-variant genotyper "
        "(capabilities of hall-lab/svtyper)"
    ),
    long_description=open(os.path.join(HERE, "README.md")).read(),
    long_description_content_type="text/markdown",
    license="MIT",
    packages=find_packages(
        include=[
            "svtyper_tpu", "svtyper_tpu.*",
            "svtyper_tpu_torch", "svtyper_tpu_torch.*",
        ]
    ),
    package_data={
        "svtyper_tpu.bamio": ["_native/*.cpp", "_native/Makefile"],
        "svtyper_tpu_torch": ["csrc/*.cu"],
        "svtyper_tpu_torch.bamio": ["_native/*.cpp", "_native/Makefile"],
        "svtyper_tpu_torch.tools": ["native_profile/*.cpp"],
    },
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    # the PyTorch/CUDA port (svtyper_tpu_torch); its CUDA kernel is
    # built by nvcc at first use
    extras_require={"torch": ["torch"]},
    entry_points={
        "console_scripts": [
            "svtyper=svtyper_tpu.cli.classic:main",
            "svtyper-sso=svtyper_tpu.cli.sso:main",
            # the PyTorch/CUDA port; it needs no jax, so a machine
            # without jax installs it with `pip install --no-deps -e .`
            "svtyper-torch=svtyper_tpu_torch.cli.classic:main",
            "svtyper-torch-sso=svtyper_tpu_torch.cli.sso:main",
        ]
    },
)
