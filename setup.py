"""Packaging (reference src/setup.py parity: console script entry point,
setup.py:31-33). The native IO extension is built lazily via make (see
deepcv_tpu/runtime/Makefile) rather than at install time, since it is an
optional accelerator with a pure-numpy fallback."""
from setuptools import setup, find_packages

setup(
    name="deepcv_tpu",
    version="0.1.0",
    description="TPU-native computer-vision framework (JAX/XLA/Pallas rebuild "
                "of DeepCV's capabilities)",
    packages=find_packages(include=["deepcv_tpu", "deepcv_tpu.*",
                                    "deepcv_tpu_torch", "deepcv_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "pyyaml",
    ],
    extras_require={
        "test": ["pytest"],
        "host-data": ["torch", "pillow"],
    },
    package_data={"deepcv_tpu.runtime": ["*.cpp", "Makefile"],
                  "deepcv_tpu_torch": ["csrc/*.cu"]},
    entry_points={
        "console_scripts": [
            "deepcv-tpu = deepcv_tpu.cli:main",
        ],
    },
)
