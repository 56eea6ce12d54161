"""Build-at-first-use of compiled artifacts, shared by the CUDA kernels
(ops/kernels.py, nvcc) and the native tables (utils/native.py, g++).

Each artifact that its build directory lacks is compiled by one compiler
process, all started together, while the directory's file lock is held,
so concurrent first uses (test workers, several processes) build once.
Each process writes to a temporary name that is moved into place with
os.replace; a failure removes it and raises, naming every failed
artifact with the compiler's output.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from pathlib import Path


def build_artifacts(out_dir: Path, cmds: dict, what: str) -> dict:
    """Compile each artifact of `cmds` (file name -> compiler argv without
    its output; "-o <temporary name>" is appended) that `out_dir` does not
    hold yet.  -> file name -> compiler output, for the artifacts built
    by this call.  Raises RuntimeError("<what> failed: ...")."""
    out_dir.mkdir(parents=True, exist_ok=True)
    logs = {}
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for name, cmd in cmds.items():
            if (out_dir / name).exists():
                continue
            tmp = out_dir / f"{name}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for name, (p, tmp) in procs.items():
            out, _ = p.communicate()
            logs[name] = out
            if p.returncode != 0:
                failed.append(f"{name} ({Path(cmds[name][0]).name} exit "
                              f"{p.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out_dir / name)
        if failed:
            raise RuntimeError(f"{what} failed: " + "\n".join(failed))
    return logs
