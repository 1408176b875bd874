"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled for
``sm_90a`` into ``build/repro_torch_kernels/<name>-<hash>.so`` (the hash is
of the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source or header rebuilds) and loaded with
``ctypes``.  Nothing is built when the module is imported: :func:`load`
builds on first call, and :func:`build_all` builds every source at once,
one ``nvcc`` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("evo_attention_fwd", "evo_attention_bwd", "triangle_mult_fwd",
           "triangle_mult_bwd", "flash_attention_fwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def build_dir() -> pathlib.Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return CSRC.parents[2] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                           "the port's kernels are compiled on the machine "
                           "that holds the GPU")
    return found


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:12]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: pathlib.Path, pending) -> None:
    if pending is None:
        return
    proc, tmp = pending
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log[-6000:]}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> float:
    """Compile every named source that is not built yet, in parallel.

    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in names}
        for n, (out, pending) in started.items():
            _finish(n, out, pending)
    return time.perf_counter() - t0


def _kernel_name(mangled: str) -> str:
    """The first length-prefixed identifier of a mangled name that ends in
    ``kernel``, else the mangled name."""
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            i += 1
            continue
        start = i + m.end()
        ident = mangled[start:start + int(m.group())]
        if ident.endswith("kernel"):
            return ident
        i = start + len(ident)
    return mangled


def ptxas_report(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed for each kernel of ``csrc/<name>.cu``:
    one line per kernel, its name, then its registers, shared memory and
    spills."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        return ""
    out, kernel, spill = [], None, ""
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = _kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and kernel is not None:
            out.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {spill}")
            kernel = None
    return "\n".join(out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
