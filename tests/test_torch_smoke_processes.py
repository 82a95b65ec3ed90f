"""chip_smoke.py stops every process it starts: its clean-up
(``stop_started_processes``) run on the CPU in a process of its own, with
multiprocessing's resource tracker, a detached grandchild and one that
ignores SIGTERM left behind."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LEAVE_AND_STOP = r"""
import json, os, subprocess
from multiprocessing import resource_tracker
import chip_smoke as cs

cs.STOP_GRACE_S = 0.5
cs.become_subreaper()
resource_tracker.ensure_running()
tracker = resource_tracker._resource_tracker._pid
subprocess.run(["sh", "-c", "setsid sleep 100 & sleep 0.2"], check=True)
subprocess.run(["sh", "-c", "(trap '' TERM; exec sleep 101) & sleep 0.2"],
               check=True)
before = cs.descendants(os.getpid())
left = cs.stop_started_processes()
print(json.dumps(dict(
    tracker=tracker, before=sorted(before.values()),
    left=sorted(left.values()), after=cs.descendants(os.getpid()),
    again=cs.stop_started_processes())))
"""


def test_stop_started_processes_leaves_none():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _LEAVE_AND_STOP], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert "sleep 100" in out["before"] and "sleep 101" in out["before"]
    assert any("resource_tracker" in c for c in out["before"])
    # The tracker is stopped through its pipe, not reported; the others
    # are reported and stopped.
    assert out["left"] == ["sleep 100", "sleep 101"]
    assert out["after"] == {} and out["again"] == {}
    assert not os.path.exists("/proc/{}".format(out["tracker"]))
    assert "left running: sleep 100" in proc.stderr
