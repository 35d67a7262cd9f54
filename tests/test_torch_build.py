"""The kernels' build (ops/cuda/_build.py) under concurrent first builds, as
the ranks of a data-parallel job start: two processes build against a fake
`nvcc` on PATH (a script that logs its calls and writes its -o file) into a
build directory under tmp_path; one library results, each source compiled
once and linked once, and both processes get its path."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
sleep 0.5
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo built > "$2"; fi
  shift
done
"""

BUILD_SCRIPT = """
import sys
from pathlib import Path
from sparse_matrix_tuning_tpu_torch.ops.cuda import _build
_build.BUILD_DIR = Path(sys.argv[1])
print(_build.build())
"""


def test_concurrent_first_builds_compile_once(tmp_path):
    from sparse_matrix_tuning_tpu_torch.ops.cuda import _build
    bin_dir, build_dir, log = tmp_path / "bin", tmp_path / "build", tmp_path / "nvcc.log"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(build_dir)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip() for o in outs}
    libs = sorted(build_dir.glob("libsmt_kernels_*.so"))
    assert len(libs) == 1 and paths == {str(libs[0])}
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(compiles) == len(_build.sources()) and len(calls) == len(compiles) + 1
    assert not list(build_dir.glob("*.o")) and not list(build_dir.glob("*.tmp"))
