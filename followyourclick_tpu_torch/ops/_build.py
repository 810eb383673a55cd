"""Build and load the port's CUDA kernels (``csrc/``) at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per source,
all started together, and links the objects into one shared library with a
plain C interface, loaded through ``ctypes``. The library goes to
``followyourclick_tpu_torch/_build/`` (listed in ``.gitignore``) under a name
keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the previous build. Nothing is built on import.

The library links against the CUDA runtime only. The TMA kernels' tensor
maps come from the driver's ``cuTensorMapEncodeTiled``, which
``csrc/hopper.cuh`` takes through the runtime's driver entry-point query
(``cudaGetDriverEntryPointByVersion``), so no ``-lcuda`` is needed.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

# dtype codes of the C entry points, and the shared-memory sizes the
# wrappers size their tiles against: the H100's 227 KB per block, and the
# softer budget they try first (a smaller row tile gives more blocks to
# spread over the 132 SMs; the hard limit serves only where nothing fits it)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448
SMEM_BUDGET = 150 * 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "fyc_cross_attention_bf16": (_I, [_P] * 4 + [_I] * 5 + [_F, _P]),
    "fyc_flash_attention": (_I, [_P] * 4 + [_I] * 5 + [_F, _I, _P]),
    "fyc_geglu": (_I, [_P] * 6 + [_I] * 5 + [_P]),
    "fyc_geglu_down_bf16": (_I, [_P] * 5 + [_I] * 3 + [_P]),
    "fyc_geglu_up_bf16": (_I, [_P] * 4 + [_I] * 4 + [_P]),
    "fyc_group_norm": (_I, [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P]),
    "fyc_group_norm_cluster": (_I, [_P] * 4 + [_I] * 6 + [_F, _I, _I, _P]),
    "fyc_group_norm_max_clusters": (_I, [_I] * 4),
    "fyc_ln_cross_attention": (_I, [_P] * 9 + [_I] * 6 + [_F, _F, _I, _I,
                                                          _P]),
    "fyc_ln_cross_attention_smem_bytes": (ctypes.c_longlong, [_I] * 6),
    "fyc_ln_geglu": (_I, [_P] * 8 + [_I, _I, _I, _F, _I, _I, _I, _P]),
    "fyc_ln_geglu_smem_bytes": (ctypes.c_longlong, [_I, _I]),
    "fyc_linear_bf16": (_I, [_P] * 3 + [_I] * 3 + [_P]),
    "fyc_ln_rows_bf16": (_I, [_P] * 5 + [_I, _I, _I, _F, _P]),
    "fyc_motion_block": (_I, [_P, _P, ctypes.POINTER(_P), _P]
                         + [_I] * 5 + [_F, _F, _I, _P]),
    "fyc_motion_block_smem_bytes": (ctypes.c_longlong, [_I] * 3),
    "fyc_qkv_bf16": (_I, [_P] * 5 + [_I, _I, _P]),
    "fyc_temporal_attention": (_I, [_P] * 4 + [_I] * 4 + [_F, _I, _P]),
    "fyc_temporal_attention_smem_bytes": (ctypes.c_longlong, [_I] * 3),
    "fyc_temporal_block": (_I, [_P, ctypes.POINTER(_P), _P] + [_I] * 5
                           + [_F, _P]),
    "fyc_temporal_block_smem_bytes": (ctypes.c_longlong, [_I] * 3),
}


def tile_positions(f: int, smem_bytes) -> int:
    """Whole positions of ``f`` frame rows per block for the motion-module
    kernels: the most (of 4, 2, 1, with at most 64 rows) whose tile takes no
    more than the budget by ``smem_bytes(g)``, else 1 if that fits the shared
    memory at all, else 0."""
    for g in (4, 2, 1):
        if g * f <= 64 and smem_bytes(g) <= SMEM_BUDGET:
            return g
    return 1 if f <= 64 and smem_bytes(1) <= MAX_SMEM else 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfyc_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The compiler's report (registers, shared memory, spills) of every source
    is kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            procs.append((src.name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report, failed = [], []
        for name, _, proc in procs:
            text = proc.communicate()[0]
            report.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{text[-4000:]}")
        out.with_suffix(".log").write_text("".join(report))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, out.name)
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib,
                               *[obj for _, obj, _ in procs]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr[-8000:]}")
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``t``'s device, as
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives it, without
    building a ``Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_device(t: torch.Tensor):
    """A context that makes ``t``'s card the current device (a no-op where
    it already is)."""
    idx = t.get_device()
    if idx == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(idx)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
