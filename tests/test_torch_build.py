"""The kernel build of ``repro_torch.kernels._build`` under threads: the
streaming executor's pool can reach a kernel's first launch from several
threads at once.  ``load`` must build the library once and hand every
thread the same one, and each build must write a temporary file of its
own.  Runs on the CPU: ``nvcc`` is replaced by a fake compiler script
and ``ctypes.CDLL`` by a recorder."""
import os
import stat
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build

torch.set_num_threads(1)

FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({calls!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(0.3)                       # widen the window for a racing build
with open(out, "wb") as f:
    f.write(b"fake library")
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    kernels = tmp_path / "kernels"
    (kernels / "toy" / "csrc").mkdir(parents=True)
    (kernels / "toy" / "csrc" / "toy.cu").write_text("// toy kernel\n")
    calls = tmp_path / "nvcc-calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable,
                                     calls=str(calls)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    opened = []

    def fake_cdll(path):
        opened.append(path)
        return ("library", path)

    monkeypatch.setattr(_build, "KERNELS_DIR", kernels)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_LOADED", {})
    return calls, opened


def test_eight_threads_loading_one_kernel_build_it_once(fake_toolchain):
    calls, opened = fake_toolchain
    start = threading.Barrier(8)
    got, errors = [None] * 8, []

    def worker(i):
        try:
            start.wait()
            got[i] = _build.load("toy")
        except BaseException as e:        # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert len(calls.read_text().splitlines()) == 1      # one build
    assert len(opened) == 1 and all(g is got[0] for g in got)  # one library
    lib = _build.library_path("toy")
    assert lib.exists() and got[0] == ("library", str(lib))
    assert sorted(p.name for p in lib.parent.iterdir()) == \
        sorted([lib.name, lib.with_suffix(".log").name])  # no temporaries
    assert _build.load("toy") is got[0]                   # cached after


def test_concurrent_build_all_calls_use_their_own_temporaries(
        fake_toolchain):
    """``build_all`` without the lock (as two processes would run it):
    every build writes a temporary named for its process and thread,
    so all of them finish and one library stands."""
    calls, _ = fake_toolchain
    start = threading.Barrier(4)
    errors = []

    def worker():
        try:
            start.wait()
            _build.build_all(["toy"])
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    outs = calls.read_text().splitlines()
    assert len(outs) == 4 and len(set(outs)) == 4         # own temporaries
    assert all(f".{os.getpid()}." in o for o in outs)
    lib = _build.library_path("toy")
    assert lib.read_bytes() == b"fake library"
    assert not [p for p in lib.parent.iterdir() if p.suffix == ".tmp"]


def test_launch_counter_loses_no_update_under_threads():
    """The wrappers' launch counters are bumped from the streaming
    executor's threads: 16 threads of 5,000 bumps each, with the
    interpreter switching threads as often as it can, count every one."""
    def wrapper():
        pass
    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(5000):
                _build.count_launches(wrapper, 2)
        threads = [threading.Thread(target=bump) for _ in range(16)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert time.perf_counter() - t0 < 120
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 5000 * 2


FAKE_NVCC_LOUD = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
time.sleep(0.3)                       # both processes build at once
sys.stdout.write({log!r})
with open(out, "wb") as f:
    f.write(b"fake library")
"""

#: what the fake compiler prints: large enough that writing it takes
#: many system calls, so a reader could catch a half-written file
LOUD_LOG = "ptxas info    : Used 32 registers, 0 bytes spill stores\n" * 40000

BUILD_DRIVER = """
import json, sys
from pathlib import Path
from repro_torch.kernels import _build
kernels, build, nvcc, expected = sys.argv[1:5]
_build.KERNELS_DIR = Path(kernels)
_build.BUILD_DIR = Path(build)
_build._nvcc = lambda: nvcc
_build.ctypes.CDLL = lambda path: ("library", path)
lib = _build.load("toy")
print(json.dumps({"path": lib[1],
                  "log_whole": _build.build_log("toy")
                  == Path(expected).read_text()}))
"""


def test_two_processes_building_one_kernel_both_load_and_the_log_is_whole(
        tmp_path):
    """Two processes reach one kernel's first build together (the fleet's
    workers can): both load the same library, and the ``.log`` beside
    it is never seen torn — a reader polling it all along finds either
    no file or the whole log."""
    import json
    import subprocess
    kernels = tmp_path / "kernels"
    (kernels / "toy" / "csrc").mkdir(parents=True)
    (kernels / "toy" / "csrc" / "toy.cu").write_text("// toy kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC_LOUD.format(python=sys.executable,
                                          log=LOUD_LOG))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build = tmp_path / "build"
    driver = tmp_path / "driver.py"
    driver.write_text(BUILD_DRIVER)
    expected = tmp_path / "expected.log"
    expected.write_text(LOUD_LOG)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(driver), str(kernels), str(build), str(nvcc),
         str(expected)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for _ in range(2)]
    seen, stop = [], threading.Event()

    def watch():
        while not stop.is_set():
            for log in build.glob("*.log") if build.is_dir() else ():
                if ".so." in log.name:
                    continue              # a build's own temporary
                try:
                    seen.append(log.read_text() == LOUD_LOG)
                except FileNotFoundError:
                    pass

    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        stop.set()
        watcher.join()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert got[0]["path"] == got[1]["path"]
    assert got[0]["log_whole"] and got[1]["log_whole"]
    assert seen and all(seen)
    lib = Path(got[0]["path"])
    assert lib.read_bytes() == b"fake library"
    assert sorted(p.name for p in build.iterdir()) == \
        sorted([lib.name, lib.with_suffix(".log").name])  # no temporaries
