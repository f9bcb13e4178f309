"""ARPS shard format: writer, converter and reader (port of arp_tpu/data/arps.py).

HDF5 demo files convert once into per-key ``.arps`` shards; the dataset then
reads records through the port's native reader (``native/arps.cpp``: a C++
thread pool decompressing zlib records in parallel, the GIL released).  The
format is the JAX package's byte for byte: a shard written by one package is
read by the other.

The native library is built with ``g++`` at first use and linked with zlib
(``native/__init__.py``).  Where it cannot be built the reader raises with the
compiler's output; the pure-Python reader runs only when asked for
(``force_python=True``).  The library also holds ``pil_resize_batch``, the
host's resize (``ops/preprocess.py::resize_bicubic_pil_host``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib

import numpy as np

from ..native import BUILD_DIR, SOURCE_DIR, build_library

SOURCE = SOURCE_DIR / "arps.cpp"
_DTYPES = {0: np.uint8, 1: np.int32, 2: np.int64, 3: np.float32}
_DTYPE_CODES = {np.dtype(np.uint8): 0, np.dtype(np.int32): 1, np.dtype(np.int64): 2, np.dtype(np.float32): 3}
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=None)
def native_lib() -> ctypes.CDLL:
    """``arps.cpp``'s library (the reader and the host resize), built at first use and loaded once."""
    lib = ctypes.CDLL(str(build_library(SOURCE, "arps", BUILD_DIR, libs=("-lz",))))
    lib.arps_open.restype = ctypes.c_void_p
    lib.arps_open.argtypes = [ctypes.c_char_p]
    lib.arps_close.restype = None
    lib.arps_close.argtypes = [ctypes.c_void_p]
    lib.arps_count.restype = ctypes.c_uint64
    lib.arps_count.argtypes = [ctypes.c_void_p]
    lib.arps_record_bytes.restype = ctypes.c_uint64
    lib.arps_record_bytes.argtypes = [ctypes.c_void_p]
    lib.arps_ndim.restype = ctypes.c_uint32
    lib.arps_ndim.argtypes = [ctypes.c_void_p]
    lib.arps_shape.restype = None
    lib.arps_shape.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.arps_dtype.restype = ctypes.c_uint32
    lib.arps_dtype.argtypes = [ctypes.c_void_p]
    lib.arps_read_batch.restype = ctypes.c_int
    lib.arps_read_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, _U8P,
                                    ctypes.c_int]
    lib.pil_resize_batch.restype = None
    lib.pil_resize_batch.argtypes = [
        _U8P, _U8P, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        _I32P, _I32P, ctypes.c_int32,
        _I32P, _I32P, ctypes.c_int32,
        ctypes.c_int32,
    ]
    return lib


def write_arps(path: str, data: np.ndarray, compress: bool = True, level: int = 1) -> None:
    """Write an (N, ...) array as an ARPS shard (record i = data[i]); a record that zlib does not
    shrink is stored raw."""
    data = np.ascontiguousarray(data)
    code = _DTYPE_CODES[data.dtype]
    n = data.shape[0]
    record_shape = data.shape[1:]
    payloads = []
    for i in range(n):
        raw = data[i].tobytes()
        if compress:
            comp = zlib.compress(raw, level)
            payloads.append(comp if len(comp) < len(raw) else raw)
        else:
            payloads.append(raw)
    offsets = np.zeros(n + 1, np.uint64)
    for i, p in enumerate(payloads):
        offsets[i + 1] = offsets[i] + len(p)
    with open(path, "wb") as f:
        f.write(b"ARPS")
        f.write(struct.pack("<II", 1, len(record_shape)))
        f.write(struct.pack(f"<{len(record_shape)}Q", *record_shape))
        f.write(struct.pack("<IQ", code, n))
        f.write(offsets.tobytes())
        for p in payloads:
            f.write(p)


class ArpsReader:
    """Batch record reader: the native one, or with ``force_python=True`` the pure-Python one."""

    def __init__(self, path: str, num_threads: int = 8, force_python: bool = False):
        self.path = path
        self.num_threads = num_threads
        self._handle = None
        self._lib = None if force_python else native_lib()
        if self._lib is not None:
            self._handle = self._lib.arps_open(os.fsencode(path))
            if not self._handle:
                raise IOError(f"native open failed for {path}")
            ndim = self._lib.arps_ndim(self._handle)
            shape = (ctypes.c_uint64 * ndim)()
            self._lib.arps_shape(self._handle, shape)
            self.record_shape = tuple(int(s) for s in shape)
            self.dtype = np.dtype(_DTYPES[self._lib.arps_dtype(self._handle)])
            self.count = int(self._lib.arps_count(self._handle))
        else:
            self._open_python()

    def _open_python(self):
        with open(self.path, "rb") as f:
            if f.read(4) != b"ARPS":
                raise IOError(f"{self.path} is not an ARPS shard")
            version, ndim = struct.unpack("<II", f.read(8))
            if version != 1:
                raise IOError(f"{self.path}: ARPS version {version}, this reader reads 1")
            self.record_shape = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            code, n = struct.unpack("<IQ", f.read(12))
            self.dtype = np.dtype(_DTYPES[code])
            self.count = n
            self._py_offsets = np.frombuffer(f.read(8 * (n + 1)), np.uint64)
            self._py_data_start = f.tell()
        self._record_bytes = int(np.prod(self.record_shape)) * self.dtype.itemsize

    def read_batch(self, indices) -> np.ndarray:
        indices = np.ascontiguousarray(indices, np.uint64)
        n = len(indices)
        out = np.empty((n,) + tuple(self.record_shape), self.dtype)
        if self._handle is not None:
            rc = self._lib.arps_read_batch(self._handle, indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
                                           out.ctypes.data_as(_U8P), self.num_threads)
            if rc != 0:
                raise IOError(f"arps_read_batch failed rc={rc}")
            return out
        with open(self.path, "rb") as f:
            for i, idx in enumerate(indices):
                if idx >= self.count:
                    raise IndexError(f"record {idx} of {self.count}")
                begin = int(self._py_offsets[idx])
                end = int(self._py_offsets[idx + 1])
                f.seek(self._py_data_start + begin)
                payload = f.read(end - begin)
                raw = payload if len(payload) == self._record_bytes else zlib.decompress(payload)
                out[i] = np.frombuffer(raw, self.dtype).reshape(self.record_shape)
        return out

    def close(self):
        if self._handle is not None:
            self._lib.arps_close(self._handle)
            self._handle = None

    def __len__(self):
        return self.count

    def __del__(self):
        self.close()


def convert_hdf5(hdf5_path: str, out_dir: str, keys=None, compress: bool = True) -> dict:
    """Convert HDF5 demo datasets to per-key ARPS shards; returns {key: shard path}.

    bool datasets become uint8 and other dtypes the format lacks float32, as in JAX."""
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    written = {}
    with h5py.File(hdf5_path, "r") as g:
        for key in keys or list(g.keys()):
            data = np.asarray(g[key])
            if data.dtype == np.bool_:
                data = data.astype(np.uint8)
            if data.dtype not in _DTYPE_CODES:
                data = data.astype(np.float32)
            path = os.path.join(out_dir, f"{key}.arps")
            # written under a per-process name, then renamed: another host converting the same
            # file, or a conversion that crashed, never leaves a truncated shard under the name
            # that ProcgenDataset checks for
            tmp = f"{path}.tmp.{os.getpid()}"
            write_arps(tmp, data, compress=compress)
            os.replace(tmp, path)
            written[key] = path
    return written
