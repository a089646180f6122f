"""Build the shared native runtime (``native/libdgcore.so``) where its
Makefile alone cannot.

``dipgenie_tpu.native`` runs ``make -C native`` at first use. A compiler
wrapper named by ``$CXX`` may lack OpenMP's ``libgomp.spec`` (the Makefile
links with ``-fopenmp``), while another g++ on the host has it; then the
make is retried with ``CXX`` set to that compiler. The library and its
flags are the Makefile's own.
"""

from __future__ import annotations

import os
import shutil
import subprocess

from dipgenie_tpu import native


def _has_libgomp_spec(cxx: str) -> bool:
    try:
        out = subprocess.run(
            [cxx, "-print-file-name=libgomp.spec"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return False
    return os.path.isabs(out) and os.path.exists(out)


def ensure_native() -> bool:
    """True once ``native/libdgcore.so`` is built and loads."""
    lib_dir = os.path.dirname(native._LIB_PATH)
    if not os.path.exists(native._LIB_PATH) or os.path.getmtime(
        os.path.join(lib_dir, "dgcore.cpp")
    ) > os.path.getmtime(native._LIB_PATH):
        make = ["make", "-s", "-C", lib_dir]
        if subprocess.run(make, capture_output=True).returncode != 0:
            for cxx in (shutil.which("g++"), "/usr/bin/g++"):
                if cxx and _has_libgomp_spec(cxx):
                    env = dict(os.environ, CXX=cxx)
                    subprocess.run(make, capture_output=True, env=env)
                    break
    return native.available()
