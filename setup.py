"""Package setup (ref: the reference repo's setup.py).

Builds the native stage-DP solver as part of installation; the library
also self-builds it lazily at first use via csrc/Makefile.
"""
import os
import subprocess

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py


class BuildNative(build_py):

    def run(self):
        csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "csrc")
        if os.path.exists(os.path.join(csrc, "Makefile")):
            try:
                subprocess.run(["make", "-C", csrc], check=True)
            except Exception as e:  # pylint: disable=broad-except
                print(f"warning: native build skipped ({e})")
        super().run()


setup(
    name="alpa_tpu",
    version="0.1.0",
    description=("TPU-native automatic inter- and intra-operator "
                 "parallelization for JAX programs"),
    packages=find_packages(include=["alpa_tpu", "alpa_tpu.*",
                                    "alpa_tpu_torch", "alpa_tpu_torch.*"]),
    package_data={"alpa_tpu": ["_native/*.so"],
                  "alpa_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "scipy",
    ],
    cmdclass={"build_py": BuildNative},
)
