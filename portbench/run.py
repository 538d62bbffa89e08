"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, limits and per-layer metrics are files found
by name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``; the traffic's ``kind``
names the driver that runs it, ``drivers/<kind>.py``.  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
the compared numbers beside their limits); the compared numbers are also
the last lines of standard error.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mamba_tts_tpu")


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only the
    first run of a checkout compiles (the system's nvcc builds live in its
    own ``mamba_tts_torch/ops/_build``)."""
    os.environ["TRITON_CACHE_DIR"] = str(BENCH / "_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / "_cache" / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_entry(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_metric(name: str, root: Path = BENCH):
    """The reader ``metrics/<name>.py``: ``read(run) -> value or None``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(kind: str):
    """The driver ``drivers/<kind>.py`` of a traffic kind: ``run(conf,
    traffic, limits, seed, seconds, traced, device, fault=None)`` and
    ``readings(conf, traffic, limits, seed, seconds, device)`` (see
    ``drivers/__init__.py``)."""
    if not kind.isidentifier():
        raise ValueError(f"traffic kind {kind!r} is not a module name")
    return importlib.import_module(f"portbench.drivers.{kind}")


def metrics_for(spec: dict, cell: str, section: str) -> list:
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


def execute(name: str, seed: int, seconds: float, traced: bool, device, spec=None,
            fault=None, root: Path = BENCH) -> dict:
    """Run the cell ``name`` once on ``device``; the result line's object.
    ``root``: the folder whose configs, traffic, limits and metrics it reads;
    ``fault`` breaks the timed path (the benchmark's own tests)."""
    from portbench import generator

    spec = spec or benchmark()
    cell = cell_entry(spec, name)
    conf = generator.load_json("configs", cell["config"], root)
    traffic = generator.load_json("traffic", cell["traffic"], root)
    limits = generator.load_json("limits", name, root)
    driver = load_driver(traffic["kind"])
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # the configuration states float32 where
    torch.backends.cudnn.allow_tf32 = False        # it says float32, TF32 off
    kw = {"fault": fault} if fault is not None else {}
    out = driver.run(conf, traffic, limits, seed, seconds, traced, device, **kw)
    run = {"cell": cell, "config": conf, "traffic": traffic, "seconds": seconds, **out,
           "setup_s": out["window_start"] - T_PROCESS}
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in metrics_for(spec, name, section):
        value = load_metric(m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name() if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": bool(out["checks"]["pass"] and out["failed"] == 0),
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if traced and out.get("profile"):
        from portbench import trace, yardstick

        p = out["profile"]
        lo, hi = p["window"]
        device_info["busy_s"] = yardstick.union_seconds(((s, e) for _, s, e in p["kernels"]),
                                                        lo, hi)
        device_info["window_s"] = hi - lo
        result["breakdown"] = trace.breakdown(p["kernels"], p["window"], p["spans"])
    result["checks"] = {k: v for k, v in out["checks"].items() if k != "pass"}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    import torch

    spec = benchmark()
    cell = cell_entry(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", spec)
    bad = forbidden_modules()
    if bad:
        print(f"modules of the reference package or of JAX were loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        if isinstance(v, dict) and "limit" in v:
            print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
