"""Build helper for the native host kernels (g++ -> shared object).

No pybind11 in this environment; we compile a plain C-ABI shared library and
load it with ctypes.  The library is built next to the source at first use
(~1 s of g++) and its file name carries a hash of ``host_kernels.cpp``, so a
library built from any other source — say one copied along with a working
tree from another machine — is never loaded; an mtime older than the
source's also forces a rebuild.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "host_kernels.cpp")


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_DIR, f"_host_kernels-{digest}.so")


def shared_object_path(build: bool = True) -> str | None:
    """Return the path of the compiled library, building it if needed."""
    so = _so_path()
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    if not build:
        return None
    cmd = [
        "g++",
        "-O3",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-fvisibility=default",
        _SRC,
        "-o",
        so,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as exc:  # pragma: no cover
        msg = getattr(exc, "stderr", str(exc))
        print(f"lanczos_tpu.native: build failed, falling back to python: {msg}", file=sys.stderr)
        return None
    return so
