"""Readings that the limits of ``limits/<cell>.json`` are set from, taken
on the card at the cell's own size: the sound program's compared numbers
over many seeds (the lower readings), and beside them, on the same seeds,
the precision control and the faults (the upper readings).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 --out FILE

The control is the reference with both operands of every product of its
bfloat16 layers rounded to float8 (e4m3, one scale a tensor), put in the
system's place.  Serving: its numbers are the gaps, in the float32
reference's logits, of the token it puts first at each position along the
served tokens; beside it, the system's own int8 path (the decode
megakernel with int8 weights and K/V, teacher-forced on the system's own
conditioning), read the same way.  The waveform's control is the
reference's FACodec decode with TF32 on.  Training: the fault is the
system's step with half of each batch left out (the mean over the rest).
A step that leaves the state unchanged reads 1 by construction.  Each
traffic kind's driver (``drivers/<kind>.py``) gives its ``readings``.  One
JSON line per seed and reading goes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import generator, run as runner  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    runner._cache_dirs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = runner.benchmark()
    cell = runner.cell_entry(spec, args.workload)
    conf = generator.load_json("configs", cell["config"])
    traffic = generator.load_json("traffic", cell["traffic"])
    limits = generator.load_json("limits", args.workload)
    driver = runner.load_driver(traffic["kind"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for row in driver.readings(conf, traffic, limits, seed, args.seconds, "cuda"):
            line = json.dumps({"cell": args.workload, "seed": seed, **row,
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
