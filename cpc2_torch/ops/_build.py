"""Build, load and call the port's CUDA kernels (`cpc2_torch/csrc/*.cu`),
and build and load its host libraries (`cpc2_torch/csrc/host/*.cc`).

Each CUDA source is compiled to an object by its own `nvcc` process, all
started together, and the objects are linked into one shared library with
a plain C interface that is loaded with `ctypes` (no PyTorch headers, so a
build takes seconds). The build runs at first use, into
`build/cpc2_torch_kernels/` beside the package, and is skipped while the
library is newer than every source. Importing this module builds nothing.

The host libraries (the audio decoders and the host DTW) are built apart, one `g++` each
(`build_host`), into the same directory: they need no `nvcc` and no card,
so the CPU tests build them too.

A build holds an exclusive `fcntl` lock on `BUILD_DIR/.build.lock`, and
looks again whether the library is up to date once it has the lock: ranks
that start at once on a fresh tree build it once, the others wait and load
what it built. The lock goes with the process that holds it, so a build
cut off leaves nothing to clear.

`LAUNCHES` counts, per kernel, the calls that launched it on the card; a
run sets the counts to 0 and reads them afterwards to show which kernels
its path went through.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cpc2_torch_kernels"
SOURCES = ("lstm.cu", "ffn.cu", "infonce.cu", "dtw.cu", "attention.cu",
           "attention_bf16io.cu", "encoder.cu", "adam.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
LIBRARY = BUILD_DIR / "libcpc2_kernels.so"

# `lstm_fwd`/`lstm_bwd` are the LSTM's resident cluster kernels,
# `lstm_*_grid` its cooperative whole-card kernels for widths whose W_hh
# slice does not fit a cluster (`ops/lstm.py:lstm_plan`). `ffn_fwd`/`ffn_bwd` are the FFN's bf16
# kernels (`--precision bf16mix`), `ffn_*_fp32` its fp32 ones (`--precision
# fp32`), `ffn_*_bf16io` the bf16 ones' bf16-in/bf16-out variant
# (`--precision bf16`), as are `attention_*_bf16io` the attention's.
# `infonce_*_grouped` count the InfoNCE kernels' launches under a grouped
# pool's plan (`--neg_pool_group`, `ops/infonce.py:infonce_plan`),
# `infonce_*_gathered` on a pool gathered over the ranks
# (`--global_negatives`), the others' on the batch's own pool. `dtw` counts every DTW launch, `dtw_lanes` and `dtw_wave` each route's
# (`ops/dtw.py:dtw_plan`). `adam_bf16_moment` is `optim.py`'s Adam with a
# bf16 first moment (`--adam_mu_dtype bf16`).
KERNELS = ("lstm_fwd", "lstm_bwd", "lstm_fwd_grid", "lstm_bwd_grid",
           "ffn_fwd", "ffn_bwd", "ffn_fwd_fp32", "ffn_bwd_fp32",
           "ffn_fwd_bf16io", "ffn_bwd_bf16io",
           "infonce_fwd", "infonce_bwd", "infonce_fwd_grouped",
           "infonce_bwd_grouped", "infonce_fwd_gathered",
           "infonce_bwd_gathered", "dtw", "dtw_lanes", "dtw_wave",
           "attention_fwd", "attention_bwd", "attention_fwd_bf16io",
           "attention_bwd_bf16io", "encoder_fwd", "encoder_bwd",
           "adam_bf16_moment")
LAUNCHES = {name: 0 for name in KERNELS}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_L = ctypes.c_long
# Argument types of each C entry point: device pointers, then sizes and
# scalars, then the stream (see the `extern "C"` blocks of csrc/*.cu).
_SIGNATURES = {
    "cpc2_lstm_fwd": [_P] * 10 + [_I] * 5 + [_P],
    "cpc2_lstm_bwd": [_P] * 16 + [_I] * 5 + [_P],
    "cpc2_lstm_fwd_grid": [_P] * 10 + [_I] * 10 + [_P],
    "cpc2_lstm_bwd_grid": [_P] * 15 + [_I] * 10 + [_P],
    "cpc2_lstm_grid_layout": [_I] * 4 + [_P],
    "cpc2_lstm_smem": [_I] * 4,
    "cpc2_lstm_max_clusters": [_I] * 4,
    "cpc2_ffn_fwd": [_P] * 8 + [_L] + [_I] * 5 + [_U, _F, _P],
    "cpc2_ffn_bwd": [_P] * 12 + [_L] + [_I] * 7 + [_U, _F, _P],
    "cpc2_ffn_fwd_bf16": [_P] * 8 + [_I] * 4 + [_U, _F, _P],
    "cpc2_ffn_bwd_bf16": [_P] * 12 + [_I] * 4 + [_U, _F, _P],
    "cpc2_ffn_fwd_bf16io": [_P] * 10 + [_I, _U, _F, _P],
    "cpc2_ffn_bwd_bf16io": [_P] * 12 + [_I, _U, _F, _P],
    "cpc2_ffn_bf16_workspace": [_I] * 5,
    "cpc2_ffn_io_max_clusters": [_I],
    "cpc2_infonce_fwd": [_P] * 4 + [_I] * 12 + [_L, _P],
    "cpc2_infonce_bwd": [_P] * 7 + [_I] * 25 + [_L, _P],
    "cpc2_dtw": [_P] * 4 + [_I] * 11 + [_P],
    "cpc2_dtw_layout": [_I] * 4 + [_P],
    "cpc2_attention_fwd": [_P] * 7 + [_I, _U, _F, _F, _P],
    "cpc2_attention_bwd": [_P] * 12 + [_I, _U, _F, _F, _P],
    "cpc2_attention_fwd_bf16io": [_P] * 7 + [_I, _U, _F, _F, _P],
    "cpc2_attention_bwd_bf16io": [_P] * 12 + [_I, _U, _F, _F, _P],
    "cpc2_adam_bf16_moment": [_P] * 6 + [_I, _F, _F, _F, _F, _P],
    "cpc2_encoder_fwd": [_P] * 9 + [_I] * 3 + [_P],
    "cpc2_encoder_bwd": [_P] * 14 + [_L] + [_I] * 3 + [_P],
}

# Entry points that return something other than a CUDA error code.
_RESTYPES = {"cpc2_ffn_bf16_workspace": _L, "cpc2_lstm_smem": _L}

_lib = None

HOST_CSRC = CSRC / "host"
# Host libraries: name -> (source in HOST_CSRC, libraries it links, headers
# of which one must exist for it to build, or () for none).
_FFMPEG_HEADERS = ("/usr/include/x86_64-linux-gnu/libavformat/avformat.h",
                   "/usr/include/libavformat/avformat.h")
HOST_LIBRARIES = {
    "flacdec": ("flacdec.cc", (), ()),
    "audiodec": ("audiodec.cc", ("-lavformat", "-lavcodec", "-lavutil"),
                 _FFMPEG_HEADERS),
    "dtwhost": ("dtwhost.cc", (), ()),
}
_LL, _IP = ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
_FP = ctypes.POINTER(ctypes.c_float)
# (restype, argtypes) of each host library's C entry points.
_HOST_SIGNATURES = {
    "flacdec": {
        "flac_info_file": (_LL, [ctypes.c_char_p, _IP, _IP]),
        "flac_decode_file": (_LL, [ctypes.c_char_p, _FP, _LL, _IP, _IP]),
    },
    "audiodec": {
        "audec_decode_file": (_LL, [ctypes.c_char_p, ctypes.POINTER(_FP),
                                    _IP, _IP]),
        "audec_free": (None, [_FP]),
        "audec_info_file": (_LL, [ctypes.c_char_p, _IP, _IP]),
    },
    "dtwhost": {
        "dtw_host_batch": (None, [_FP, _LL, ctypes.c_int, ctypes.c_int, _IP,
                                  _IP, _FP]),
    },
}
_host_libs: dict = {}
_host_lock = threading.Lock()


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


@contextlib.contextmanager
def _build_lock():
    """`BUILD_DIR`'s lock between processes, held inside the block."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build(force: bool = False) -> Path:
    """Compile the kernels (one `nvcc` per source, in parallel) and link
    them into `LIBRARY`, under the build lock. The compiler's `-Xptxas -v`
    report (registers, shared memory, spills per kernel) is kept in
    `build.log`."""
    if not force and _up_to_date():
        return LIBRARY
    with _build_lock():
        if not force and _up_to_date():
            return LIBRARY
        return _build_kernels()


def _build_kernels() -> Path:
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


def host_buildable(name: str) -> bool:
    """Whether host library `name` can be built here: the FFmpeg shim
    needs FFmpeg's development headers, as `csrc/Makefile` decides."""
    headers = HOST_LIBRARIES[name][2]
    return not headers or any(os.path.exists(h) for h in headers)


def build_host(name: str, force: bool = False) -> Path:
    """Compile host library `name` with `g++ -O3 -fPIC -std=c++17 -shared`
    into `BUILD_DIR/lib<name>.so`, unless it is newer than its source,
    under the build lock. Raises with the compiler's output when the
    build fails."""
    source, libs, _headers = HOST_LIBRARIES[name]
    src = HOST_CSRC / source
    out = BUILD_DIR / f"lib{name}.so"

    def current() -> bool:
        return (not force and out.exists()
                and out.stat().st_mtime >= src.stat().st_mtime)
    if current():
        return out
    if not host_buildable(name):
        raise RuntimeError(f"{name}: none of {list(_headers)} exists")
    with _build_lock():
        if current():
            return out
        return _build_host(src, libs, out)


def _build_host(src: Path, libs, out: Path) -> Path:
    # written under another name and renamed, which is atomic: a process
    # that loads the library without the lock never sees half of it
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-shared",
                           "-o", str(tmp), str(src), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def host_library(name: str) -> ctypes.CDLL:
    """Host library `name`, built first if needed and loaded once (under a
    lock: the data loader decodes from a thread pool)."""
    with _host_lock:
        lib = _host_libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(name)))
            for fn_name, (restype, argtypes) in _HOST_SIGNATURES[
                    name].items():
                fn = getattr(lib, fn_name)
                fn.restype, fn.argtypes = restype, argtypes
            _host_libs[name] = lib
        return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The multiprocessors of `device`, which the kernels' plans size their
    grids and splits by."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def launch(kernel, fn_name: str, device: torch.device, *args,
           times: int = 1) -> None:
    """Call `fn_name` of the library with `args` followed by the current
    stream of `device`; raise if the launch failed, else count it `times`
    (the launches that call made) under `kernel` (a name, or a tuple of
    names each counted)."""
    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {code}")
    for name in (kernel,) if isinstance(kernel, str) else kernel:
        LAUNCHES[name] += times


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
