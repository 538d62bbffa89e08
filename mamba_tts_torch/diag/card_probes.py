"""Two probes of the card for the decode megakernel (``card_probes.cu``
beside this file): what one grid barrier costs when every block arrives
together, and the rate at which the SMs read a buffer that sits in the L2.

    python -m mamba_tts_torch.diag.card_probes [--iters 20000] [--repeats 2]

Builds ``card_probes.cu`` with the kernels' nvcc flags into the kernels'
build directory and prints one JSON line per repeat: block 0's cycles per
barrier of each kind on a cooperative grid of as many clusters of 8 as the
card keeps resident, and the L2 read rate (bytes per second, by CUDA events)
for buffers of 8 to 40 MiB read 64 times after a warm-up read.  The last
line is the card's name and power limit.  Needs one NVIDIA card with the
CUDA toolkit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "card_probes.cu"
BARRIERS = {0: "fenced_first_version", 1: "release_acquire_per_block",
            2: "release_acquire_per_cluster"}
L2_MIB = (8, 16, 24, 32, 40)


def _library() -> ctypes.CDLL:
    from mamba_tts_torch.ops import _build

    h = hashlib.sha256((" ".join(_build.NVCC_FLAGS)).encode() + SOURCE.read_bytes())
    out = _build.BUILD_ROOT / "diag" / f"libcard_probes.{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.barrier_bench_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_void_p]
    lib.l2_read_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.barrier_bench_error_string.argtypes = [ctypes.c_int]
    lib.barrier_bench_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: {lib.barrier_bench_error_string(err).decode()}")


def barrier(lib, mode: int, iters: int) -> tuple:
    """(block 0's cycles per barrier, grid) of ``iters`` barriers of ``mode``."""
    import torch

    sync = torch.zeros((4,), dtype=torch.int64, device="cuda")
    out = torch.zeros((2,), dtype=torch.int64, device="cuda")
    _check(lib, lib.barrier_bench_launch(mode, iters, sync.data_ptr(), out.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream),
           "barrier benchmark")
    torch.cuda.synchronize()
    if int(sync[1]) or int(sync[3]):
        raise RuntimeError("barrier benchmark: a barrier timed out")
    cycles, grid = out.tolist()
    return cycles / iters, grid


def l2_read_rate(lib, mib: int, reps: int = 64) -> float:
    """Bytes per second read from an L2-resident buffer of ``mib`` MiB."""
    import torch

    n = mib * 2 ** 20
    buf = torch.randint(0, 256, (n,), dtype=torch.uint8, device="cuda")
    out = torch.zeros((1,), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _check(lib, lib.l2_read_launch(buf.data_ptr(), n, 2, out.data_ptr(), stream), "L2 read")
    start.record()
    _check(lib, lib.l2_read_launch(buf.data_ptr(), n, reps, out.data_ptr(), stream), "L2 read")
    end.record()
    torch.cuda.synchronize()
    return n * reps / (start.elapsed_time(end) / 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("card_probes: no CUDA device", file=sys.stderr)
        return 2
    lib = _library()
    for mode in BARRIERS:
        barrier(lib, mode, 100)  # warm-up
    for rep in range(args.repeats):
        row = {"repeat": rep, "barrier_iters": args.iters}
        for mode, name in BARRIERS.items():
            row[name], row["grid"] = barrier(lib, mode, args.iters)
        row["l2_read_bytes_per_s"] = {f"{m} MiB": l2_read_rate(lib, m) for m in L2_MIB}
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
