"""One run of one cell of the port's benchmark.

    python3 -m bench_port.run --workload NAME --seed N --seconds S \\
        --trace 0|1

from the root of a checkout, on a machine with the cards the cell asks
for. Set-up builds the cell's weights on the card from the seed, warms up
every shape of a request and counts all of that, from process start, as
``setup_s``. The window then runs whole requests back to back (a closed
loop: one user waits for each result); a request starts only if the mean
request time so far fits in the time left, and the first always starts.
After the window the peak memory is read, the program's state is freed
and the plain reference checks what the timed path produced. The last
line of standard output is the result, one JSON object; the compared
numbers and their limits are also the last lines of standard error.

``--trace 1`` records the device with the profiler over the window and
reports the cell's per-layer metrics instead of its end-to-end ones.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_dirs(root: Path):
    """Fixed cache directories inside the checkout for every build or
    kernel cache a library might keep; the program's own kernel build
    lands in its package's ``_build/``, also inside the checkout."""
    base = root / "bench_port" / "_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def window(driver, seconds: float):
    """Requests back to back; returns the host seconds of each and
    whether one failed (its traceback goes to standard error)."""
    times, failed = [], 0
    start = time.perf_counter()
    while True:
        now = time.perf_counter()
        if times and (now - start) + sum(times) / len(times) > seconds:
            break
        try:
            driver.request(len(times) + failed)
        except Exception:                       # noqa: BLE001
            traceback.print_exc()
            failed += 1
            break
        times.append(time.perf_counter() - now)
    return times, failed


def run_cell(registry, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: float = _T0):
    """Set up, measure, check. Returns (result dict, checks dict)."""
    import torch

    from bench_port.lib import trace as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = registry.cell(workload)
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    spec = registry.cell_spec(workload)
    cuda = torch.device(device).type == "cuda"
    drv = registry.driver(traffic["kind"]).Driver(
        cfg, traffic, spec, seed, device, trace)
    drv.setup()
    drv.ranges = tr.Ranges(markers=trace and cuda)
    prof = None
    if trace and cuda:
        prof = tr.profiler()
        prof.__enter__()
        drv.entries.on = True
    setup_s = time.perf_counter() - t0
    times, failed = window(drv, seconds)
    drv.sync()
    host_end = time.perf_counter()
    summary = None
    if prof is not None:
        drv.entries.on = False
        prof.__exit__(None, None, None)
        summary = tr.reduce(tr.device_events(prof), drv.ranges, host_end)
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    drv.release()
    checks = {}
    if not failed:
        readings = drv.check()
        for name, value in readings.items():
            checks[name] = {"value": value, "limit": spec["limits"][name]}
    correct = (not failed and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    run = SimpleNamespace(
        setup_s=setup_s, request_s=times, peak_bytes=peak, trace=summary,
        driver=drv, traffic=traffic, cfg=cfg, seconds=seconds)
    metrics = {}
    for m in registry.metrics(workload, trace):
        value = registry.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(times) + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs(ROOT)

    import torch

    from bench_port.lib import guard
    from bench_port.registry import Registry

    registry = Registry(ROOT)
    chips = registry.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = run_cell(registry, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = guard.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
