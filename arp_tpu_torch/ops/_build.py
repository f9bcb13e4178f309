"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so it compiles in seconds into ``build/arp_tpu_torch/`` at the root of
the checkout.  The library's file name carries a hash of the source, of the
headers beside it (``csrc/*.cuh``) and of the flags, so an edited source is
rebuilt.  Importing this module needs no
``nvcc`` and no GPU; a missing ``nvcc`` or a failed build raises with the
compiler's output, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arp_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from arp_tpu_torch/csrc at first use"
    )


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless already built; returns (library, compiler log).

    The log holds ptxas's register and shared-memory report when this call
    compiled, and is empty when the library was already on disk.
    """
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    return lib, log


_PTR = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_longlong

# Each library's C entry point and its argtypes: c_void_p for every pointer
# and the stream (a bare int would be cut to 32 bits), and every launch
# returns its cudaError_t.
_ENTRY_POINTS = {
    "flash_attn_fwd": ("arp_flash_attn_fwd", (
        [_PTR] * 5  # q, k, v, kv_pad, out
        + [_I32] * 5  # dtype, batch, n, heads, head_dim
        + [_I64] * 12  # (b, n, h) strides of q, k, v, out
        + [_I32] * 3  # mask_kind, num_obs_token, num_token_per_step
        + [ctypes.c_float, _PTR]  # scale, stream
    )),
    "int8_gemm": ("arp_int8_gemm", (
        [_PTR] * 6  # x, a_scale, wt, ws, bias, out
        + [_I32] * 4  # dtype, M, N, K
        + [_I64, _I32, _PTR]  # lda, act, stream
    )),
    "int8_matmul": ("arp_int8_matmul", (
        [_PTR] * 4  # x, q, scale, out
        + [_I32] * 4  # dtype, M, N, K
        + [_I64, _PTR]  # lda, stream
    )),
}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built and loaded once per process."""
    symbol, argtypes = _ENTRY_POINTS[name]
    path, _ = build(name)
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = _I32
    return lib


def build_all(names) -> dict[str, tuple[Path, str]]:
    """Build several libraries at once, one nvcc each, all started together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))

