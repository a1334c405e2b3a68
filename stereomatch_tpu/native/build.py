"""Build the native host-side library: `python -m stereomatch_tpu.native.build`.

Compiles the tracked C++ sources into `_build/` next to this file (a
directory `.gitignore` lists). The library's file name carries the host's
architecture and a hash of the sources and compiler flags, so a changed
source, a changed flag or another architecture always rebuilds, and a
library built elsewhere under another key is never loaded. The flags name
no host-specific instruction set, so the build is portable across hosts
of one architecture. Safe to re-run; skips compilation when the keyed
library exists.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ["treebuild.cpp"]
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
BUILD_DIR = os.path.join(HERE, "_build")


def lib_path() -> str:
    """Path of the library for this host and these sources."""
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode())
    for s in SOURCES:
        with open(os.path.join(HERE, s), "rb") as f:
            h.update(f.read())
    key = f"{platform.machine()}-{h.hexdigest()[:16]}"
    return os.path.join(BUILD_DIR, f"libsmtpu_native-{key}.so")


def build(force: bool = False, verbose: bool = True) -> str:
    lib = lib_path()
    if not force and os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # concurrent builders (test workers) each write their own file and
    # rename it into place, so a reader never sees a partial library
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *FLAGS, "-o", tmp, *(os.path.join(HERE, s) for s in SOURCES)]
    if verbose:
        print("+", " ".join(cmd), file=sys.stderr)
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
