"""Build the CUDA sources under ``csrc/`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, for ``sm_90a`` (Hopper). Building happens at first
use, never at import: :func:`build` starts one ``nvcc`` per missing source,
all at once, and waits for them. A library's file name carries a digest of
its sources and flags, so an edited source never loads a stale build.

The libraries go to ``build/kernels/`` at the root of the checkout (listed
in ``.gitignore``), or to ``$REPRO_TORCH_BUILD_DIR`` when that is set.
``nvcc`` is taken from ``$PATH``, else from ``$CUDA_HOME/bin``, else from
``/usr/local/cuda/bin``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("delta_quantize", "snapshot_fused", "chain_apply", "fingerprint",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# C entry points of each library: argument types (the stream comes last and
# every entry point returns the launch's cudaError_t as an int)
SIGNATURES = {
    "delta_quantize": {
        "mgit_delta_quantize": (_P, _I32, _P, _I32, _P, _P, _I64, _I64, _F32,
                                _I32, _P),
        "mgit_dequant_apply": (_P, _I32, _P, _P, _I32, _I64, _F32, _I32, _P),
    },
    "snapshot_fused": {
        "mgit_snapshot_fused": (_P, _P, _P, _P, _I64, _F32, _I32, _P),
    },
    "chain_apply": {
        "mgit_chain_apply": (_P, _P, _P, _I64, _I32, _F32, _I32, _P),
    },
    "fingerprint": {
        "mgit_fingerprint": (_P, _I32, _I64, _I64, _P, _I32, _P),
    },
    "flash_attention": {
        "mgit_flash_attention": (_P, _P, _P, _P) + (_I32,) * 9
        + (_F32, _I32, _I32, _P),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel could not be built or launched, or there is no card.

    Its own class so that code which classifies failures (a pull's
    three-way auto-merge) can tell the kernel layer's errors from its own
    and let them propagate."""


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` that is not built yet, in parallel.

    Returns the wall seconds each compile took (0.0 for one already built).
    ``nvcc``'s ``-Xptxas -v`` report (registers, spills) of each library is
    kept beside it as ``<name>.log``. Raises if any compile fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.mgit_error_string.argtypes = [ctypes.c_int]
            lib.mgit_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call ``fn`` of library ``name`` on ``device``'s current stream.

    ``args`` are the entry point's arguments before the device index and
    the stream. Raises if the launch reports a CUDA error."""
    lib = library(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(*args, device.index, stream)
    if err:
        raise KernelError(f"{fn}: CUDA error {err} "
                           f"({lib.mgit_error_string(err).decode()})")


# -- checks every wrapper makes before it launches ---------------------------

def on_card(*tensors: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for ``tensors``.

    False when they all lie on the CPU: the wrapper then runs its plain
    version. True when they all lie on one CUDA device and are contiguous.
    Raises for anything else, so a CUDA tensor never reaches a plain
    version."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"tensors on {sorted(map(str, devices))}: expected "
                         f"all on one CUDA device, or all on the CPU")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return True


def require_dtype(dtype: torch.dtype, allowed: Sequence[torch.dtype],
                  what: str) -> None:
    """Raise unless ``dtype`` is one of ``allowed``: NotImplementedError for
    a float type a float kernel does not take, TypeError for anything
    else."""
    if dtype in allowed:
        return
    names = " and ".join(str(a).removeprefix("torch.") for a in allowed)
    if dtype.is_floating_point and any(a.is_floating_point for a in allowed):
        raise NotImplementedError(
            f"{what} is {dtype}: this CUDA kernel takes {names}")
    raise TypeError(f"{what} is {dtype}, expected {names}")


_count_lock = threading.Lock()


def count_launch(wrapper, dtype: str = "") -> None:
    """Add one to ``wrapper.launches``, the count a run reads to show that
    it went through the kernel, and to ``wrapper.launches_by_dtype[dtype]``
    when the launch names its operand types. Called right after each
    launch."""
    with _count_lock:
        wrapper.launches += 1
        if dtype:
            by = wrapper.launches_by_dtype
            by[dtype] = by.get(dtype, 0) + 1
