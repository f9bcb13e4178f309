"""Where kernel K2's time goes: builds of csrc/int8_gemm.cu with parts compiled out, and one that notes the time.

    python3 -m arp_tpu_torch.ops.k2_ablate          # on a machine with an NVIDIA GPU and nvcc

Builds the kernel once as it is, once for each other entry of ``VARIANTS``
(``-DK2_ABLATE=<sum>``: 1 no products, 2 no conversion of x, 4 no epilogue,
8 no stores to global memory; any but 0 computes nothing useful) and once
with ``-DK2_TRACE``, in which the consumers note the time where each tile
begins, after its last product and after its last store.  Runs each at the
ViT-B/16 int8 sites at batch 256 on the same inputs, the variants in the
order given and back, and prints one JSON line: the card; for each site the
mean time of each variant in ms (what a part costs where it cannot hide
behind the others is the difference to the whole kernel); and from the
traced build, over all blocks and both consumer warpgroups, the mean of a
tile's products, of its epilogue and of the pause before the next tile in
microseconds, with the products' time tile by tile for block 0.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import _build
from .quantization import quantize_array

VARIANTS = {"whole": 0, "no_stores": 8, "no_epilogue": 4, "no_epilogue_no_conversion": 6,
            "no_products": 1, "loads_only": 7}
TRACE_SHAPE = (256, 2, 64, 3)  # k2_trace in int8_gemm.cu: block, consumer warpgroup, tile, note
# label -> (M, K, N, x dtype, act), as chip_smoke's K2_SITES at batch 256
SITES = {"qkv": (50432, 768, 2304, torch.bfloat16, 0), "attn_out": (50432, 768, 768, torch.bfloat16, 0),
         "fc": (50432, 768, 3072, torch.bfloat16, 1), "fc_no_gelu": (50432, 768, 3072, torch.bfloat16, 0),
         "proj": (50432, 3072, 768, torch.bfloat16, 0), "conv1": (50176, 768, 768, torch.float32, 0)}


def build(name: str, flag: str):
    lib = _build.BUILD_DIR / "ablate" / f"libint8_gemm_{name}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, flag, "-o", str(lib), str(_build.CSRC_DIR / "int8_gemm.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.arp_int8_gemm.argtypes, dll.arp_int8_gemm.restype = _build._ENTRY_POINTS["int8_gemm"][1], ctypes.c_int
    return dll


def cuda_ms(fn, iters: int = 20) -> float:
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phases(notes: np.ndarray) -> dict:
    """Means over blocks and warpgroups from one launch's time notes (ns), in microseconds."""
    notes = notes.astype(np.int64)
    begin, multiplied, stored = notes[..., 0], notes[..., 1], notes[..., 2]
    ran = stored > 0
    follows = ran[..., 1:] & ran[..., :-1]
    tiles0 = int(ran[0, 0].sum())
    return {"tiles_of_block_0": tiles0,
            "products_us": float((multiplied - begin)[ran].mean()) / 1e3,
            "epilogue_us": float((stored - multiplied)[ran].mean()) / 1e3,
            "pause_us": float((begin[..., 1:] - stored[..., :-1])[follows].mean()) / 1e3 if follows.any() else 0.0,
            "products_us_block_0": [round(float(v) / 1e3, 2) for v in (multiplied - begin)[0, 0, :tiles0]],
            "kernel_us_block_0": float(stored[0, 0, tiles0 - 1] - begin[ran].min()) / 1e3}


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_ablate: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    flags = {name: f"-DK2_ABLATE={ablate}" for name, ablate in VARIANTS.items()} | {"trace": "-DK2_TRACE"}
    with ThreadPoolExecutor(max_workers=len(flags)) as pool:
        builds = dict(zip(flags, pool.map(build, flags, flags.values())))
    traced = builds.pop("trace")
    traced.arp_int8_gemm_trace.argtypes, traced.arp_int8_gemm_trace.restype = [ctypes.c_void_p], ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    times, traces = {}, {}
    for label, (m, k, n, dtype, act) in SITES.items():
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        wq, ws = quantize_array(torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5)
        wq_t, ws = wq.t().contiguous(), ws.reshape(-1).contiguous()
        bias = 0.02 * torch.randn(n, generator=gen, device="cuda")
        a = (x.float().abs().amax() * 1.05).reshape(1)
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")

        def call(dll):
            err = dll.arp_int8_gemm(x.data_ptr(), a.data_ptr(), wq_t.data_ptr(), ws.data_ptr(), bias.data_ptr(),
                                    out.data_ptr(), 0 if dtype == torch.float32 else 1, m, n, k, x.stride(0), act,
                                    stream)
            if err != 0:
                raise RuntimeError(f"int8_gemm launch failed with cudaError_t {err}")

        runs = {name: [] for name in builds}
        for name in list(builds) + list(builds)[::-1]:
            runs[name].append(cuda_ms(lambda: call(builds[name])))
        times[label] = {"shape": [m, k, n], **{name: sum(t) / 2 for name, t in runs.items()}}

        for _ in range(3):  # the notes of the last launch stay
            call(traced)
        notes = np.zeros(TRACE_SHAPE, dtype=np.uint64)
        err = traced.arp_int8_gemm_trace(notes.ctypes.data)
        if err != 0:
            raise RuntimeError(f"reading the time notes failed with cudaError_t {err}")
        traces[label] = phases(notes)
    print(json.dumps({"device": smi, "variants": VARIANTS, "ms": times, "trace": traces}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
