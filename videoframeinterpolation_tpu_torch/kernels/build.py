"""Build the port's CUDA kernels with one ``nvcc`` call and bind them with ctypes.

Every ``kernels/csrc/*.cu`` file exposes a plain C interface (no PyTorch
headers), so the build is a single command that takes seconds::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -DVFI_THREADS_PER_SM=2048 ... \
         -o _build/libvfi_torch_kernels.so csrc/*.cu

The ``-D`` flags are :data:`DEFINES`: the card's figures and the kernels'
launch limits that the launch plans in Python read too, defined here once.
The library goes into ``videoframeinterpolation_tpu_torch/_build/`` (listed
in ``.gitignore``) and is rebuilt only when the hash of the sources
changes. What ``ptxas`` reports for each kernel (registers, spills) is kept
beside it and read by :func:`ptxas_report`. Nothing is built or loaded when this module is imported: the
first call of :func:`load_library` does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libvfi_torch_kernels.so"
PTXAS_LOG = LIB_NAME + ".ptxas.txt"
# The H100 (sm_90a, the one target): SMs, threads and shared memory per SM,
# the most dynamic shared memory a block may opt into, and what the runtime
# reserves for each resident block.
SMS = 132
THREADS_PER_SM = 2048
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMEM_RESERVED = 1024
# The most threads a block of the backward's shared-memory feature kernel has.
BWD_FEAT_THREADS = 512
# What the sources are compiled with, as -D flags.
DEFINES = {"VFI_THREADS_PER_SM": THREADS_PER_SM, "VFI_SMEM_PER_BLOCK": SMEM_PER_BLOCK,
           "VFI_BWD_FEAT_THREADS": BWD_FEAT_THREADS}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              *(f"-D{name}={value}" for name, value in DEFINES.items())]

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argtypes; every function returns a cudaError_t as int.
SIGNATURES = {
    "vfi_deformable_sample_f32": [_P] * 4 + [_I] * 9 + [_P],
    "vfi_deformable_sample_bf16": [_P] * 4 + [_I] * 9 + [_P],
    "vfi_deformable_sample_bwd_f32": [_P] * 7 + [_I] * 11 + [_P],
    "vfi_deformable_sample_bwd_bf16": [_P] * 7 + [_I] * 11 + [_P],
    "vfi_row_gather_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "vfi_row_gather_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
    "vfi_lane_gather_f32": [_P, _P, _P, _I, _I, _I, _P],
    "vfi_lane_gather_bf16": [_P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin``, then torch's ``CUDA_HOME``, then
    ``/usr/local/cuda/bin``, then ``PATH``."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    homes.append("/usr/local/cuda")
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def sources_hash() -> str:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_release(nvcc: str) -> str:
    """The ``release`` line of ``nvcc --version``."""
    out = subprocess.run([nvcc, "--version"], check=True, capture_output=True,
                         text=True).stdout
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else out.strip()


def build(verbose: bool = True) -> Path:
    """Compile the library unless a build of the same sources exists."""
    digest = sources_hash()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib_path.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return lib_path
    nvcc = find_nvcc()
    if verbose:
        print(f"nvcc: {nvcc} ({nvcc_release(nvcc)})", flush=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a temporary name and rename, so a concurrent reader never
    # sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    (BUILD_DIR / PTXAS_LOG).write_text(proc.stderr)
    stamp.write_text(digest)
    return lib_path


def ptxas_report() -> list[dict]:
    """Registers and spill bytes of every kernel of the last build, from
    ``ptxas -v``, with the names demangled by ``cu++filt`` where the
    toolkit has it."""
    log = BUILD_DIR / PTXAS_LOG
    if not log.is_file():
        return []
    rows, current = [], None
    for line in log.read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            current = {"function": m.group(1)}
            rows.append(current)
        elif current is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif current is not None and (m := re.search(r"Used (\d+) registers", line)):
            current["registers"] = int(m.group(1))
    filt = Path(find_nvcc()).with_name("cu++filt")
    if rows and filt.is_file():
        names = subprocess.run([str(filt)], input="\n".join(r["function"] for r in rows),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        for row, name in zip(rows, names):
            row["function"] = name
    return rows


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every function's types."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
