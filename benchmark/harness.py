"""One run of one benchmark cell of neuralbody_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell, its configuration and its traffic are found by name:
BENCHMARK.json's `workloads` entry NAME names a configuration (its file,
benchmark/configs/<config>.json, names the port's YAML, the overrides and
the model family `reference`: the plain reference
benchmark/reference/<reference>.py and the family's files, geometry and
work count, benchmark/families/<reference>.py) and a traffic mix
(benchmark/traffic/<traffic>.json: the sequence to generate and the loop
that drives the port, benchmark/loops/<loop>.py). A family with no module
ends the run at set-up: exit 2 and no result. With --trace 1 each
per-layer metric of BENCHMARK.json that the cell reports is read by
benchmark/metrics/<name>.py from a traced stretch inside the window.

A run: set-up (the port and the card up, the seeded sequence written under
TMPDIR, weights from the seed on the card, the loop's own warm-up), then
the window of --seconds, then the program's state is freed and the plain
reference (benchmark/reference/) checks what the window produced. The last
line of standard output is the result (correct, attempted, failed, metrics,
device, with --trace 1 breakdown, and last the numbers compared with their
limits), which also end standard error. No card, or fewer than the cell
asks for: exit 2 and no result. JAX or the JAX package loaded in this
process: exit 3 and no result. On every way out, every process the run
started (the loader's workers, multiprocessing's resource tracker, and
any process that one of them left behind) is stopped and waited for.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "neuralbody_tpu")


class CellError(SystemExit):
    """A run that cannot be made: exit code and message."""

    def __init__(self, code, msg):
        super().__init__(code)
        self.msg = msg


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find_cell(name, bench=None):
    """(workload entry, configuration entry, configuration file's content,
    traffic file's content) of the cell `name`."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(2, f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[cell["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, conf, config, traffic


def cell_metrics(bench, cell):
    """(end-to-end metrics, per-layer metrics) this cell reports."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_reader(name):
    """benchmark/metrics/<name>.py's read(run)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package (whole names: neuralbody_tpu_torch is not neuralbody_tpu)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def adopt_orphans():
    """Make this process the reaper of its descendants (Linux's
    PR_SET_CHILD_SUBREAPER): a process whose parent ended before it is
    then still this run's child, to be stopped and waited for."""
    try:
        import ctypes
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def children():
    """{pid: state} of this process's children, from /proc."""
    me, out = os.getpid(), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        if int(ppid) == me:
            out[int(d)] = state
    return out


def command_of(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            raw = f.read().replace(b"\0", b" ")
    except OSError:
        return "?"
    return raw.decode(errors="replace")[:120]


def reap():
    """Wait for every child that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_children(grace=10.0):
    """Stop every process this run started and wait until each has ended:
    multiprocessing's children (the loader's workers, given `grace`
    seconds to finish), its resource tracker (which ignores SIGTERM and
    ends when its pipe closes), then any other child, SIGTERM and after
    5 s SIGKILL. What needed a signal is named on stderr."""
    import gc
    import multiprocessing
    from multiprocessing import resource_tracker
    for p in multiprocessing.active_children():
        p.join(grace)
        if p.is_alive():
            print(f"benchmark: terminating worker {p.pid} "
                  f"({command_of(p.pid)})", file=sys.stderr, flush=True)
            p.terminate()
            p.join()
    gc.collect()    # the workers' queues: their semaphores unregistered
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        if hasattr(tracker, "_stop"):
            tracker._stop()
        else:
            os.close(tracker._fd)
            tracker._fd = None
            os.waitpid(tracker._pid, 0)
            tracker._pid = None
    for sig in (signal.SIGTERM, signal.SIGKILL):
        reap()
        live = [pid for pid, st in children().items() if st != "Z"]
        if not live:
            break
        for pid in live:
            print(f"benchmark: sending {sig.name} to {pid} "
                  f"({command_of(pid)})", file=sys.stderr, flush=True)
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        t = time.perf_counter()
        while (time.perf_counter() - t < 5.0
               and any(st != "Z" for st in children().values())):
            reap()
            time.sleep(0.05)
    reap()


def card():
    """(name, power limit in W) of card 0 as nvidia-smi reads them."""
    import torch
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        limit = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        limit = None
    return name, limit


class Run:
    """What one run knows: its arguments, the cell, the device, its
    scratch directory, and what the loop and the check put here."""

    def __init__(self, args, cell, conf, config, traffic, device, tmp):
        self.args, self.cell, self.conf = args, cell, conf
        self.config, self.traffic = config, traffic
        self.seed, self.seconds = args.seed, args.seconds
        self.trace = bool(args.trace)
        self.device, self.tmp = device, tmp
        self.metrics = {}       # end-to-end metric -> value
        self.checks = {}        # compared number -> (value, limit)
        self.attempted = self.failed = 0
        self.traced = None      # trace.Trace of the traced stretch
        self.traced_info = {}   # what the loop noted about that stretch

    def phase(self, name):
        """Note on stderr how far into the run a step of set-up ended."""
        print(f"phase {name}: {time.perf_counter() - self.t_start:.2f} s",
              file=sys.stderr, flush=True)

    def check(self, name, value, limit):
        self.checks[name] = (float(value), float(limit))

    @property
    def correct(self):
        return bool(self.checks) and all(
            v == v and v <= lim for v, lim in self.checks.values())


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--control", type=int, default=0, choices=(0, 1),
                    help="also read the control (the reference in the "
                    "precision below the configuration's) on stderr; the "
                    "benchmark's own runs leave it off")
    return ap.parse_args(argv)


def cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port builds its CUDA libraries into build/neuralbody_tpu_torch."""
    base = os.path.join(ROOT, "build", "benchmark")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)


def main(t_start, argv=None, device=None):
    """A run; t_start is the process's perf_counter at its start. device:
    None for the card (the benchmark); a test passes "cpu" to drive the
    rest of a run without one."""
    args = parse(argv)
    try:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cell, conf, config, traffic = find_cell(args.workload, bench)
        e2e, layer = cell_metrics(bench, cell)
    except (OSError, KeyError, ValueError) as e:
        raise CellError(2, f"cannot read the benchmark: {e!r}") from e
    cache_dirs()
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise CellError(2, "no CUDA device: the benchmark runs on the "
                            "card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise CellError(2, f"{cell['chips']} cards needed, "
                            f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    loop = importlib.import_module("benchmark.loops." + traffic["loop"])
    tmp = tempfile.mkdtemp(prefix="nb_bench_")   # under TMPDIR
    run = Run(args, cell, conf, config, traffic, device, tmp)
    run.t_start = t_start
    body, freed = None, False
    try:
        body = loop.Cell(run)
        # the port prints status lines; the result line alone goes to stdout
        with contextlib.redirect_stdout(sys.stderr):
            body.setup()
            t_window = time.perf_counter()
            body.window()
        if device.type == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device)
        else:
            peak = 0
        layer_values = {}
        if run.trace:
            with contextlib.redirect_stdout(sys.stderr):
                body.after_window()
            for m in layer:
                v = load_reader(m["name"])(run)
                if v is not None:
                    layer_values[m["name"]] = {"value": float(v),
                                               "unit": m["unit"]}
        body.free()
        freed = True
        with contextlib.redirect_stdout(sys.stderr):
            body.compare(control=False)
            if args.control:
                body.compare(control=True)
    finally:
        if body is not None and not freed:
            try:     # the loader's pool down; the run's own error goes on
                body.free()
            except Exception as e:  # noqa: BLE001
                print(f"benchmark: freeing after an error: {e!r}",
                      file=sys.stderr)
        shutil.rmtree(tmp, ignore_errors=True)
        stop_children()
    run.metrics["setup_s"] = t_window - t_start
    bad = forbidden_modules()
    if bad:
        raise CellError(3, f"modules of JAX or the JAX package were loaded: "
                        f"{bad}")
    if run.trace:
        metrics = layer_values
    else:
        metrics = {m["name"]: {"value": float(run.metrics[m["name"]]),
                               "unit": m["unit"]} for m in e2e}
    if device.type == "cuda":
        name, limit = card()
        dev = {"platform": "gpu", "kind": name, "count": cell["chips"],
               "memory_peak_bytes": int(peak), "power_limit_w": limit}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0, "power_limit_w": None}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace and run.traced is not None:
        dev["busy_s"] = run.traced.busy_s
        dev["window_s"] = run.traced.window_s
        out["breakdown"] = {"device_ops": run.traced.top_ops(),
                            "idle_gaps": run.traced.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    for k, (v, lim) in run.checks.items():
        print(f"check {k}: {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return out


def entry(t_start):
    """The command line's entry: exit codes for what cannot be run."""
    adopt_orphans()
    try:
        main(t_start)
    except CellError as e:
        print(f"benchmark: {e.msg}", file=sys.stderr)
        return e.code
    finally:
        stop_children()
    return 0
