"""The readings that the correctness limits are set from, many seeds in
one process (set-up of a process is long): for each seed, the cell's
weights and one request through the timed path, then the program's
readings against the reference; for the control seeds also the
control's, the reference in the lower precision in the program's place
(fp8 products for the bf16 models, TF32 for the fp32 decoder). One JSON
line a seed. Needs a card; the benchmark's own runs never run this.

    python3 -m bench_port.calibrate --workload NAME --seeds 1 2 3 \\
        --control-seeds 1 2 3
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from bench_port.run import ROOT, cache_dirs


def readings(registry, workload: str, seed: int, control: bool,
             device: str = "cuda"):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = registry.cell(workload)
    traffic = registry.traffic(cell["traffic"])
    drv = registry.driver(traffic["kind"]).Driver(
        registry.config(cell["config"]), traffic,
        registry.cell_spec(workload), seed, device, False)
    t0 = time.perf_counter()
    drv.setup()
    t1 = time.perf_counter()
    drv.request(0)
    drv.sync()
    t2 = time.perf_counter()
    drv.release()
    line = {"seed": seed, "setup_s": t1 - t0, "request_s": t2 - t1,
            "program": drv.check()}
    t3 = time.perf_counter()
    line["check_s"] = t3 - t2
    if control:
        line["control"] = {**drv.check(fp8=True), **drv.check(tf32=True)}
        line["control_s"] = time.perf_counter() - t3
    del drv
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    from bench_port.registry import Registry
    if not torch.cuda.is_available():
        print("calibration needs a card", file=sys.stderr)
        return 2
    registry = Registry(ROOT)
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        line = readings(registry, args.workload, seed,
                        seed in args.control_seeds)
        print(json.dumps({"workload": args.workload, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
