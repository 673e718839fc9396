"""Build/packaging for quiver_tpu.

Reference parity: the reference's ``setup.py`` + CMake build
(``/root/reference/setup.py``, ``CMakeLists.txt``) compile a CUDA torch
extension; here the native piece is a plain C++ shared library (ctypes ABI,
no pybind11) compiled with g++ — either at install time (this file) or
lazily on first use (``quiver_tpu/cpp/native.py``).
"""

import subprocess
from pathlib import Path

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        src = Path(__file__).parent / "quiver_tpu/cpp/csrc/quiver_cpu.cpp"
        out = Path(__file__).parent / "quiver_tpu/cpp/libquiver_cpu.so"
        try:
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                 "-pthread", "-o", str(out), str(src)],
                check=True,
            )
        except Exception as e:  # lazy build still available at runtime
            print(f"[setup] native build skipped: {e}")
        super().run()


setup(
    name="quiver-tpu",
    version="0.1.0",
    description=(
        "TPU-native graph-learning data layer: neighbor sampling, cached "
        "feature store, distributed feature exchange, GNN serving"
    ),
    packages=find_packages(include=["quiver_tpu", "quiver_tpu.*",
                                    "quiver_tpu_torch", "quiver_tpu_torch.*"]),
    package_data={"quiver_tpu.cpp": ["csrc/*.cpp", "*.so"],
                  "quiver_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    cmdclass={"build_py": BuildWithNative},
)
