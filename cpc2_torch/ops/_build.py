"""Build, load and call the port's CUDA kernels (`cpc2_torch/csrc/*.cu`).

Each source is compiled to an object by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain
C interface that is loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). The build runs at first use, into `build/cpc2_torch_kernels/`
beside the package, and is skipped while the library is newer than every
source. Importing this module builds nothing.

`LAUNCHES` counts, per kernel, the calls that launched it on the card; a
run sets the counts to 0 and reads them afterwards to show which kernels
its path went through.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cpc2_torch_kernels"
SOURCES = ("lstm.cu", "ffn.cu", "infonce.cu", "dtw.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
LIBRARY = BUILD_DIR / "libcpc2_kernels.so"

KERNELS = ("lstm_fwd", "lstm_bwd", "ffn_fwd", "ffn_bwd", "infonce_fwd",
           "infonce_bwd", "dtw")
LAUNCHES = {name: 0 for name in KERNELS}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# Argument types of each C entry point: device pointers, then sizes and
# scalars, then the stream (see the `extern "C"` blocks of csrc/*.cu).
_SIGNATURES = {
    "cpc2_lstm_fwd": [_P] * 10 + [_I] * 3 + [_P],
    "cpc2_lstm_bwd": [_P] * 13 + [_I] * 3 + [_P],
    "cpc2_ffn_fwd": [_P] * 8 + [_I] * 4 + [_U, _F, _P],
    "cpc2_ffn_bwd": [_P] * 12 + [_I] * 4 + [_U, _F, _P],
    "cpc2_infonce_fwd": [_P] * 4 + [_I] * 5 + [_P],
    "cpc2_infonce_bwd": [_P] * 6 + [_I] * 5 + [_P],
    "cpc2_dtw": [_P] * 4 + [_I] * 3 + [_P],
}

_lib = None


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return found


def _up_to_date() -> bool:
    if not LIBRARY.exists():
        return False
    deps = [CSRC / s for s in SOURCES] + list(CSRC.glob("*.cuh"))
    return LIBRARY.stat().st_mtime >= max(d.stat().st_mtime for d in deps)


def build(force: bool = False) -> Path:
    """Compile the kernels (one `nvcc` per source, in parallel) and link
    them into `LIBRARY`. The compiler's `-Xptxas -v` report (registers,
    shared memory, spills per kernel) is kept in `build.log`."""
    if not force and _up_to_date():
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-Xptxas", "-v"]
    jobs = []
    for src in SOURCES:
        obj = BUILD_DIR / (src + ".o")
        cmd = [nvcc, *flags, "-c", str(CSRC / src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / "libcpc2_kernels.so.tmp"
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *[str(obj) for _src, obj, _p in jobs]],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}"
                           f"{link.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The device of `tensors`, which must all lie on one CUDA device."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device or device.type != "cuda":
            raise ValueError(f"{name}: every tensor must lie on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
    return device


def check_f32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call `fn_name` of the library with `args` followed by the current
    stream of `device`; raise if the launch failed, else count it under
    `kernel`."""
    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {code}")
    LAUNCHES[kernel] += 1


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
