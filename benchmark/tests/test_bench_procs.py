"""A run stops every process it started and waits for each: the loader's
spawned workers, multiprocessing's resource tracker, and a process whose
parent ended before it."""
import json
import subprocess
import sys

from benchmark import harness

SCENARIO = r"""
import json, multiprocessing as mp, os, subprocess, time
from benchmark import harness
harness.adopt_orphans()
ctx = mp.get_context("spawn")
q = ctx.Queue()                      # starts the resource tracker
worker = ctx.Process(target=time.sleep, args=(600,), daemon=True)
worker.start()
sh = subprocess.Popen(["sh", "-c", "sleep 600 & echo $!"],
                      stdout=subprocess.PIPE, text=True)
orphan = int(sh.stdout.readline())
sh.wait()                            # the orphan's parent has ended
before = sorted(harness.children())
tracker = mp.resource_tracker._resource_tracker._pid
harness.stop_children(grace=0.5)
alive = []
for pid in (worker.pid, tracker, orphan):
    try:
        os.kill(pid, 0)
        alive.append(pid)
    except ProcessLookupError:
        pass
print(json.dumps({"before": before, "pids": [worker.pid, tracker, orphan],
                  "alive": alive, "after": harness.children()}))
"""


def test_stop_children_leaves_nothing():
    out = subprocess.run([sys.executable, "-c", SCENARIO],
                         capture_output=True, text=True, timeout=120,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # the worker, the tracker and the adopted orphan were all children
    assert set(res["pids"]) <= set(res["before"]), res
    assert res["alive"] == [] and res["after"] == {}, res
