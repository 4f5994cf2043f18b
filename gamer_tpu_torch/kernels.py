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
import re
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


def _source_hash(csrc: Path, sources: tuple) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ARCH).encode())
    for name in sources + HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
          sources: tuple = SOURCES) -> Path:
    """Compile ``sources`` of ``csrc`` (the package's csrc/ by default) into
    a shared library in ``build_dir`` (reused if already built from the
    same sources) and return its path; the compiler's output goes beside it
    (``.log``). ``BUILD_INFO`` records the nvcc version, the compiler's
    register/spill report and the build time."""
    lib = build_dir / f"libgamer_kernels_{_source_hash(csrc, sources)}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True,
                          log=log.read_text() if log.exists() else "")
        return lib
    nvcc = nvcc_path()
    build_dir.mkdir(parents=True, exist_ok=True)
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    work = Path(tempfile.mkdtemp(dir=build_dir))
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    procs = []
    for src in sources:
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src}.o"),
               str(csrc / src)]
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
           *(str(work / f"{src}.o") for src in sources)]
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
    """The loaded kernel library of the package's csrc/."""
    global _LIB
    if _LIB is None:
        _LIB = load(build())
    return _LIB


def load(path) -> ctypes.CDLL:
    """A kernel library built from csrc/, with its C signatures declared."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # pages, n_page, page_stride, n_frames, table, n_table, noise, out,
    # frame_size, rows, kind, grid, counter, stream
    lib.gamer_march_batch.argtypes = [p, i, i, i, p, i, p, p, i, i, i, i,
                                      p, p]
    lib.gamer_march_batch.restype = i
    # page, n_page, table, n_table, noise, dirs, n_rays, out, kind, grid,
    # counter, stream
    lib.gamer_march_rays.argtypes = [p, i, p, i, p, p, i, p, i, i, p, p]
    lib.gamer_march_rays.restype = i
    # page, n_page, table, n_table, noise, out, frame_size, band_rows,
    # n_bands, kind, grid, counters, flags, abort_word, stream
    lib.gamer_march_progressive.argtypes = [p, i, p, i, p, p, i, i, i, i, i,
                                            p, p, p, p]
    lib.gamer_march_progressive.restype = i
    # pages, n_page, n_frames, table, n_table, noise, out, frame_size,
    # tile_row_stride, n_tile_rows, kind, grid, counter, stream
    lib.gamer_march_dealt.argtypes = [p, i, i, p, i, p, p, i, i, i, i, i, p,
                                      p]
    lib.gamer_march_dealt.restype = i
    # flags, n_bands, next_band, event, timeout_ms (CDLL: the GIL is
    # released while it waits)
    lib.gamer_progress_wait.argtypes = [p, i, i, p, i]
    lib.gamer_progress_wait.restype = i
    # points, n, perm, octaves, persistence, scale, weights, n_weights,
    # lacunarity, offset, gain, out, kind, stream
    lib.gamer_noise_probe.argtypes = [p, i, p, i, f, f, p, i, f, f, f, p,
                                      i, p]
    lib.gamer_noise_probe.restype = i
    # table, pairs, stream
    lib.gamer_iq_table_fill.argtypes = [p, i, p]
    lib.gamer_iq_table_fill.restype = i
    # table, lo, n_args, bad (3 unsigned), stream
    lib.gamer_iq_table_check.argtypes = [p, i, i, p, p]
    lib.gamer_iq_table_check.restype = i
    # table, n_idx, bad (2 unsigned), stream
    lib.gamer_perlin_grad_check.argtypes = [p, i, p, p]
    lib.gamer_perlin_grad_check.restype = i
    # kind, form (0 frames, 1 ray list, 2 progressive, 3 dealt)
    lib.gamer_march_occupancy.argtypes = [i, i]
    lib.gamer_march_occupancy.restype = i
    lib.gamer_march_block_threads.argtypes = []
    lib.gamer_march_block_threads.restype = i
    lib.gamer_error_string.argtypes = [i]
    lib.gamer_error_string.restype = ctypes.c_char_p
    return lib


def cuobjdump_path() -> str | None:
    """cuobjdump from the CUDA toolkit beside nvcc, else the copy Triton's
    package carries; None where neither exists."""
    try:
        beside = Path(nvcc_path()).parent / "cuobjdump"
        if beside.exists():
            return str(beside)
    except RuntimeError:
        pass
    found = shutil.which("cuobjdump")
    if found:
        return found
    try:
        import triton
    except ImportError:
        return None
    bundled = (Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
               / "cuobjdump")
    return str(bundled) if bundled.exists() else None


# SASS opcode classes of sass_mix, by the opcode's name before the first dot
SASS_CLASSES = {
    "LDS": ("LDS",),
    "local (stack, spills)": ("LDL", "STL"),
    "MUFU": ("MUFU",),
    "FP32 add/mul/fma": ("FADD", "FMUL", "FFMA"),
    "FP32 compare/select/minmax": ("FSETP", "FSEL", "FMNMX", "FSET"),
    "integer": ("IADD3", "IMAD", "IMUL", "LOP3", "SHF", "LEA", "ISETP",
                "IABS", "IMNMX", "SEL", "SHL", "SHR", "PRMT", "I2F", "F2I",
                "FRND", "POPC", "FLO", "BREV", "VIADD", "VIMNMX", "I2FP",
                "F2IP", "IDP", "BMSK", "SGXT"),
    "branch/sync": ("BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT",
                    "BSSY", "BSYNC", "WARPSYNC", "BAR", "BPT", "YIELD"),
}


def ptxas_report(log_text: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes, static shared memory bytes)} from a build log's ``-Xptxas -v``
    report: the first register and the first spill line after each
    "Compiling entry function" line."""
    found, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = found[m.group(1)] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.setdefault("spill", (int(m.group(1)), int(m.group(2))))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur.setdefault("registers", int(m.group(1)))
            m = re.search(r"(\d+) bytes smem", line)
            cur.setdefault("smem", int(m.group(1)) if m else 0)
    return {name: (got["registers"], *got["spill"], got["smem"])
            for name, got in found.items() if len(got) == 3}


def sass_functions(lib_path) -> dict | None:
    """{function name: [its SASS instructions, without addresses and
    encodings]} of a built library, in cuobjdump's order, from one
    ``cuobjdump -sass``; None without cuobjdump."""
    tool = cuobjdump_path()
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is None or "/*" not in line or ";" not in line:
            continue
        body = line.split("*/", 1)[1].strip()
        if body and not body.startswith("/*"):
            cur.append(" ".join(body.split(";")[0].split()))
    return funcs


def sass_mix(lib_path, patterns) -> dict | None:
    """Static instruction counts, by SASS_CLASSES (and "other", "total"), of
    the first function in the built library whose mangled name contains each
    of ``patterns`` (``sass_functions``): {pattern: counts, or None where no
    function matches}; None without cuobjdump."""
    funcs = sass_functions(lib_path)
    if funcs is None:
        return None
    mixes = dict.fromkeys(patterns)
    for pat in patterns:
        name = next((n for n in funcs if pat in n), None)
        if name is None:
            continue
        counts = mixes[pat] = dict.fromkeys((*SASS_CLASSES, "other",
                                             "total"), 0)
        for ins in funcs[name]:
            words = ins.split()
            op = words[1] if words[0].startswith("@") else words[0]
            op = op.split(".", 1)[0]
            counts[next((c for c, ops in SASS_CLASSES.items() if op in ops),
                        "other")] += 1
            counts["total"] += 1
    return mixes
