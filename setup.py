"""Package build: pure-Python package + the native decoders
(csrc/ -> cpc2_tpu/ops/lib*.so, loaded via ctypes): the from-scratch FLAC
decoder always, and the FFmpeg-backed mp3/compressed shim when the libav*
dev headers are present.

The reference's setup.py builds its one native component (the Cython DTW
kernel); ours builds the C++ audio decoders — the DTW kernel here is a
Pallas TPU kernel and needs no host build step.
"""

import subprocess
from pathlib import Path

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        root = Path(__file__).parent
        csrc = root / "csrc"
        if (csrc / "Makefile").exists():
            print("building native decoders (make -C csrc)")
            subprocess.check_call(["make", "-C", str(csrc)])
        super().run()


setup(
    name="cpc2_tpu",
    version="0.1.0",
    description="TPU-native Contrastive Predictive Coding on raw audio "
                "(JAX/XLA/Pallas), feature-complete with MarvinLvn/CPC2",
    packages=find_packages(include=["cpc2_tpu", "cpc2_tpu.*",
                                    "cpc2_torch", "cpc2_torch.*"]),
    package_data={"cpc2_tpu.ops": ["libflacdec.so", "libaudiodec.so"],
                  "cpc2_tpu.utils": ["small_grid.json"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "scipy"],
    extras_require={"interop": ["torch"], "research": ["scikit-learn"],
                    "data": ["pandas"]},
    cmdclass={"build_py": BuildWithNative},
    entry_points={
        "console_scripts": [
            "cpc2-train=cpc2_tpu.train:cli",
        ],
    },
)
