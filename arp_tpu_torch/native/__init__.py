"""The port's C++ sources and their build: ``gridenv.cpp`` (the fake grid engine) and ``arps.cpp``
(the ARPS shard reader and the host's Pillow-exact resize).

:func:`build_library` compiles one source with ``g++`` at first use into
``build/arp_tpu_torch/native/`` at the root of the checkout, under a file name
that carries a hash of the source and the flags, so an edited source or other
flags build anew.  Without ``g++``, or when the build fails, it raises with the
compiler's output; nothing falls back to another implementation.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arp_tpu_torch" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")  # no -march=native: a checkout may move to another host


def build_library(source: Path, stem: str, build_dir: Path = BUILD_DIR, libs: tuple = ()) -> Path:
    """Compile ``source`` into ``build_dir/lib<stem>-<hash>.so`` unless already built; returns its path.

    ``libs`` go after the source (``-lz``).  Raises RuntimeError when ``g++`` is missing or the build
    fails."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS + libs).encode()).hexdigest()[:16]
    lib = build_dir / f"lib{stem}-{digest}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: lib{stem} is built from {source}")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(source), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {source}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # complete before it appears under its name
    return lib
