"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: "correct",
"attempted", "failed", "metrics" (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), "device", with --trace 1 "breakdown", and
last "check", each number compared beside its limit (also the last lines
of standard error).  The run fails, and prints no result, without a CUDA
card, without the program beside it, or if JAX or the JAX package was
loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build or kernel cache at a fixed path inside the checkout (the
# program's own nvcc and g++ builds go to its csrc/build and native/build)
CACHE = os.path.join(ROOT, "benchmark", ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def device_info(chips: int, peak: int) -> dict:
    import torch
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips, memory_peak_bytes=int(peak))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.core import guard
    from benchmark.core.spec import load_cell
    cell = load_cell(args.workload)
    try:
        import ac3acm_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is not beside the benchmark: {e}", 4)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark measures the card and does "
             "not fall back to the CPU", 3)
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{cell['name']} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} present", 3)

    from benchmark.core.runner import run_cell
    result, numbers, ctx = run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda:0", T_PROCESS)

    if args.trace:
        metrics = {}
        for m in cell["per_layer"]:
            reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        values = dict(xrt=result["xrt"], setup_s=result["setup_s"])
        metrics = {m["name"]: dict(value=float(values[m["name"]]),
                                   unit=m["unit"])
                   for m in cell["end_to_end"]}
    line = dict(correct=result["correct"], attempted=result["attempted"],
                failed=result["failed"], metrics=metrics,
                device=device_info(cell["chips"], result["peak"]))
    if args.trace:
        t = ctx.trace
        line["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = dict(device_ops=t["device_ops"],
                                 idle_gaps=t["idle_gaps"])
    line["run"] = dict(window_s=result["window_s"], chunks=result["chunks"],
                       checked_chunk=result["checked_chunk"],
                       lanes=ctx.lanes.count,
                       frames_per_chunk=ctx.lanes.frames_per_chunk,
                       dispatch_s=result["dispatch_s"],
                       finish_s=result["finish_s"], stages=ctx.stages)
    line["check"] = {k: dict(value=v, limit=lim)
                     for k, (v, lim) in numbers.items()}
    found = guard.forbidden_loaded()
    if found:
        fail(f"JAX or the JAX package was loaded: {found}", 5)
    print(json.dumps(line), flush=True)
    for k, (v, lim) in numbers.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()


if __name__ == "__main__":
    main()
