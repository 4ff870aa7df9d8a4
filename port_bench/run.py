"""Run one benchmark cell once and print its result.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); ``drivers.py`` builds the program's model, data
and step from them, warms every shape up, and drives the program's loop.
With ``--trace 0`` the loop runs for ``--seconds`` and the cell's
end-to-end metrics are printed; with ``--trace 1`` a shorter stretch of it
runs under ``torch.profiler`` and the per-layer metrics are printed.  Each
metric is read by ``metrics/<name>.py``.  After the window the reference
checks the program's first steps (``check.py``), each number with its
limit on the last lines of standard error and under ``checks``, the last
key of the result.  The result is the last line of standard output.

Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, and if JAX, flax, optax or the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import os
import time

PROCESS_START = time.perf_counter()
# one process with few threads: no thread pool of the host's math libraries
# spins beside the loop's own two threads
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse       # noqa: E402
import gc             # noqa: E402
import importlib.util  # noqa: E402
import json           # noqa: E402
import math           # noqa: E402
import pathlib        # noqa: E402
import subprocess     # noqa: E402
import sys            # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "scgib_tpu")


class Refused(Exception):
    """The run cannot give a result (exit code 3)."""


def load_json(path: pathlib.Path):
    return json.loads(path.read_text())


def cell_spec(workload: str):
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def metrics_of(bench: dict, cell: str, kind: str):
    """The cell's metrics of ``kind`` ("end_to_end" or "per_layer")."""
    reported = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "not read (nvidia-smi unavailable)"
    return f"card and power limit: {out}"


class Run:
    """What the metric readers read (``metrics/*.py``)."""

    def __init__(self, workload, config, traffic, driver, device):
        self.workload, self.config, self.traffic = workload, config, traffic
        self.cfg = config["model"]
        self.driver, self.device = driver, device
        self.setup_s = None
        self.window = None          # the timed window's record
        self.trace = None           # trace.Trace of a traced run
        self.pack_ms = None         # host packing, ms a batch
        self.peaks = load_json(HERE / "peaks.json")
        self.kernels = load_json(HERE / "kernels.json")


def _per_second(window: dict) -> str:
    """Steps begun in each second of the window: how steady it ran."""
    t0 = window["starts"][0]
    counts: dict = {}
    for t in window["starts"]:
        counts[int(t - t0)] = counts.get(int(t - t0), 0) + 1
    return "steps a second " + " ".join(str(counts[k])
                                        for k in sorted(counts))


def main(argv=None, device=None, traffic_overrides=None) -> int:
    """``device`` and ``traffic_overrides`` are for the CPU tests only: a
    run of the benchmark takes neither, and refuses a machine without the
    cell's CUDA devices."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        raise Refused("--seed must be a non-negative integer")
    bench, cell, config, traffic = cell_spec(args.workload)
    traffic = {**traffic, **(traffic_overrides or {})}

    import torch
    torch_imported = time.perf_counter()
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: this benchmark measures the card "
                          "and does not fall back to the CPU")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{cell['chips']} CUDA devices needed, "
                          f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
        torch.cuda.init()
    device = torch.device(device)
    cuda_ready = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32, as configured
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from port_bench import check, drivers

    stages = [("imports", time.perf_counter())]
    driver = drivers.make(config, traffic, args.seed, device)
    stages.append(("data, model and weights", time.perf_counter()))
    driver.warm_up()
    stages.append(("warm-up and capture", time.perf_counter()))
    parts = {"torch": torch_imported - PROCESS_START,
             "cuda": cuda_ready - torch_imported,
             "port": stages[0][1] - cuda_ready,
             **driver.seconds}
    parts["other"] = stages[1][1] - stages[0][1] - sum(driver.seconds.values())
    parts["warm-up"] = stages[2][1] - stages[1][1]
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
          file=sys.stderr, flush=True)
    run = Run(args.workload, config, traffic, driver, device)
    if args.trace:
        run.trace = driver.traced()
        attempted = len(getattr(driver, "traced_stats", [])) or len(
            driver.recorder.times)
        kind = "per_layer"
    else:
        run.window = driver.window(args.seconds)
        run.setup_s = run.window["starts"][0] - PROCESS_START
        attempted = (len(run.window["epoch_ends"]) if "epoch_ends" in
                     run.window else len(run.window["starts"]))
        kind = "end_to_end"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        memory_peak = torch.cuda.max_memory_allocated(device)
        print(power_line(), flush=True)
    else:
        memory_peak = 0
    if args.trace and hasattr(driver, "host_pack_ms"):
        run.pack_ms = driver.host_pack_ms()

    metrics = {}
    for m in metrics_of(bench, args.workload, kind):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.numbers(driver)
    limits = check.limits(args.workload)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if loaded:
        print(f"refused: the process has loaded {loaded}", file=sys.stderr)
        return 4

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    if run.window and "graphs" in run.window:
        print("window: " + _per_second(run.window), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        code = 3
    sys.exit(code)
