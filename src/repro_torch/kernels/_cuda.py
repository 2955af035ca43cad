"""Build and load the port's hand-written CUDA kernels.

Every ``repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface and
loaded with :mod:`ctypes`. The build runs at first use, never at import
(this module imports nothing that needs a card or a compiler), into the
checkout's ``build/kernels/``; each library's file name carries a hash of
its source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source builds anew and an unchanged one is loaded as it is.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
all of them.

A build that fails raises with the compiler's output. Nothing falls back
to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("segment_sum", "fused_gather_aggregate", "src_scatter",
           "edge_softmax", "fused_edge_softmax_aggregate", "sparse_adam",
           "gather_rows")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_symbols: Dict[tuple, Callable] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install path."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns ``{name: {"seconds",
    "path", "log"}}`` for the sources it compiled (the log holds
    ``-Xptxas -v``'s registers and spills)."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, out in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        results, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name} (exit "
                              f"{proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            results[name] = {"seconds": time.perf_counter() - t0,
                             "path": str(out), "log": log}
    finally:
        for proc, tmp, _out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def kernel_resources(log: str) -> Dict[str, str]:
    """Each kernel's ``-Xptxas -v`` report in a build log ("Used N
    registers, ..." and its spill line), by its name demangled with the
    toolkit's ``cu++filt`` where there is one."""
    found, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
        elif current and "spill" in line:
            found[current] = line.strip()
        elif current and "Used" in line and "registers" in line:
            found[current] = (found.get(current, "") + "; "
                              + line.split(":", 1)[-1].strip()).lstrip("; ")
    filt = shutil.which("cu++filt", path=str(Path(nvcc_path()).parent))
    if found and filt:
        names = subprocess.run([filt], input="\n".join(found),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(found):
            return dict(zip(names, found.values()))
    return found


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def symbol(name: str, sym: str, argtypes: Sequence) -> Callable:
    """The C entry point ``sym`` of kernel library ``name`` (built on first
    use), with its ``argtypes`` set and an ``int`` (``cudaError_t``)
    result."""
    key = (name, sym)
    fn = _symbols.get(key)
    if fn is None:
        fn = getattr(load(name), sym)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _symbols[key] = fn
    return fn


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the ``void*`` a C entry
    point takes."""
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda_f32(what: str, **tensors) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on the
    card, all on one device."""
    devices = set()
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what} needs CUDA tensors, got {name} on "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {name} of "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{what}: tensors on several devices {devices}")


def check_index(what: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous 1-D int32 tensor on
    ``device``."""
    for name, t in tensors.items():
        if (t.dtype != torch.int32 or t.dim() != 1
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"{what}: {name} must be a contiguous (E,) "
                             f"int32 tensor on {device}")


def aligned16(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary (float4
    columns need it)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {err}")
