"""Builds the CUDA sources under csrc/ with nvcc at first use and loads them
with ctypes (a plain C interface; no PyTorch headers, so a build takes
seconds).

The shared library goes to ``<repo>/build/gamer_tpu_torch/``, named by a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one is reused within the checkout. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "gamer_tpu_torch"
SOURCES = ("march.cu", "noise_probe.cu")
HEADERS = ("noise.cuh",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "-std=c++17", "-fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC")

_LIB = None
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    """nvcc from PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ARCH).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into a shared library (reused if already built from the
    same sources) and return its path. ``BUILD_INFO`` records the nvcc
    version, the compiler's register/spill report and the build time."""
    lib = BUILD_DIR / f"libgamer_kernels_{_source_hash()}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True,
                          log=log.read_text() if log.exists() else "")
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    procs = []
    for src in SOURCES:
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src}.o"),
               str(CSRC / src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    out = []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        out.append(text)
        if proc.returncode != 0:
            for _, other in procs:
                other.wait()
            shutil.rmtree(work, ignore_errors=True)
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{text}")
    tmp = work / "lib.so"
    cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp),
           *(str(work / f"{src}.o") for src in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    text = "".join(out) + proc.stdout + proc.stderr
    log.write_text(text)
    BUILD_INFO.update(path=str(lib), seconds=seconds, cached=False,
                      nvcc=version, log=text)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # pages, n_page, page_stride, n_frames, table, n_table, perm, out,
        # frame_size, rows, kind, stream
        lib.gamer_march_batch.argtypes = [p, i, i, i, p, i, p, p, i, i, i, p]
        lib.gamer_march_batch.restype = i
        # page, n_page, table, n_table, perm, dirs, n_rays, out, kind, stream
        lib.gamer_march_rays.argtypes = [p, i, p, i, p, p, i, p, i, p]
        lib.gamer_march_rays.restype = i
        # points, n, perm, octaves, persistence, scale, weights, n_weights,
        # lacunarity, offset, gain, out, kind, stream
        lib.gamer_noise_probe.argtypes = [p, i, p, i, f, f, p, i, f, f, f, p,
                                          i, p]
        lib.gamer_noise_probe.restype = i
        lib.gamer_error_string.argtypes = [i]
        lib.gamer_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
