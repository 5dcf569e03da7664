"""The benchmark of ``mobgs_tpu_torch`` on one or more CUDA cards.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (at the checkout's root) from the seed
and prints, as its last line, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` the
trace's ``breakdown``, and last ``checks``, the numbers compared with their
limits. Everything specific to a cell is found by name: the configuration
``configs/<config>.json``, the traffic mix ``traffic/<traffic>.json`` (whose
``generator`` names the general generator in ``harness/``), the limits
``limits/<workload>.json`` and each per-layer metric's reader
``metrics/<metric>.py``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mobgs_tpu")


def cell_files(bench: dict, workload: str):
    """(workload entry, configuration, traffic mix, limits) of a cell, read
    from the files its names lead to."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def load(rel):
        with open(os.path.join(ROOT, rel)) as f:
            return json.load(f)
    return (cell, load(conf["file"]), load(f"portbench/traffic/{cell['traffic']}.json"),
            load(f"portbench/limits/{workload}.json"))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def read_metric(name: str, layer: dict):
    """The value of per-layer metric ``name`` from its reader, or None."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(layer)


def card_line(torch) -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return {"card": torch.cuda.get_device_name(0), "nvidia_smi": out.stdout.strip()}


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, cfg, mix, limits = cell_files(bench, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, ROOT]
    gen = importlib.import_module(f"harness.{mix['generator']}")
    dev = torch.device("cuda", 0)
    res = gen.run(cfg, mix, limits, args.seed, args.seconds, bool(args.trace), dev, T_START)

    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if applies(m, args.workload):
                v = read_metric(m["name"], res["layer"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, args.workload):
                metrics[m["name"]] = {"value": res["e2e"][m["name"]], "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    info = dict(card_line(torch), workload=args.workload, seed=args.seed,
                init_budgets=res["budgets"], final_budgets=res["final_budgets"],
                compositor_launches=res["launches"], error=res["error"],
                **{k: res[k] for k in ("loss_gap_by_step", "worst_leaves", "host", "host_trace") if k in res})
    print(json.dumps({"info": info}))
    out = {"correct": bool(res["correct"]), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace:
        out["breakdown"] = res["breakdown"]
    out["checks"] = res["checks"]
    sys.stdout.flush()
    for k, v in res["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
