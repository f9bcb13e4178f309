"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so it compiles in seconds into ``build/arp_tpu_torch/`` at the root of
the checkout.  The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt.  Importing this module needs no
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
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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


@functools.lru_cache(maxsize=None)
def flash_attn_lib() -> ctypes.CDLL:
    """K1 (csrc/flash_attn_fwd.cu), built and loaded once per process."""
    path, _ = build("flash_attn_fwd")
    lib = ctypes.CDLL(str(path))
    fn = lib.arp_flash_attn_fwd
    fn.argtypes = (
        [_PTR] * 5  # q, k, v, kv_pad, out
        + [_I32] * 5  # dtype, batch, n, heads, head_dim
        + [_I64] * 12  # (b, n, h) strides of q, k, v, out
        + [_I32] * 3  # mask_kind, num_obs_token, num_token_per_step
        + [ctypes.c_float, _PTR]  # scale, stream
    )
    fn.restype = _I32
    return lib
