"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` source of the package is compiled by
``nvcc`` for ``sm_90a`` (one process per source, all started together) and
linked into one shared library with a plain C interface under
``build/torch_ext/`` at the repository root, named by a hash of the sources
so an edited source is rebuilt.  The library is loaded with ``ctypes``;
nothing here includes PyTorch's headers, so the build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each exported function: (argtypes, restype).
_SIGNATURES = {
    "pamnet_triplet_aggregate": ([_P] * 6 + [_I, _I, _P], _I),
    "pamnet_sbf_modulate": ([_P] * 11 + [_I, _I, _I, _P], _I),
    "pamnet_row_gather": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "pamnet_edge_message": ([_P] * 8 + [_I, _I, _P], _I),
    "pamnet_gather_product": ([_P] * 5 + [_I, _I, _I, _P], _I),
    "pamnet_edge_message_backward": ([_P] * 10 + [_I, _I, _P], _I),
    "pamnet_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpamnet_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the shared library unless it exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for src, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check_operand(what: str, name: str, t, dtype, device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor
    on the CUDA ``device`` of ``shape`` (None entries match any size): what
    the kernels' vector loads assume."""
    ok = (device.type == "cuda" and t.device == device and t.dtype == dtype
          and t.is_contiguous()
          and t.data_ptr() % 16 == 0
          and (shape is None or (t.dim() == len(shape) and all(
              s is None or s == n for s, n in zip(shape, t.shape)))))
    if not ok:
        want = "" if shape is None else " " + str(tuple(shape)).replace("None", "*")
        raise ValueError(
            f"{what}: {name} must be a contiguous, 16-byte aligned {dtype}{want} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ', not contiguous'}"
            f"{'' if t.data_ptr() % 16 == 0 else ', misaligned'}"
        )


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().pamnet_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
