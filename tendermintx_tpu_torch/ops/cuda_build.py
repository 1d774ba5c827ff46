"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use with ``nvcc`` for Hopper (``sm_90a``) into
``build/torch_kernels/lib<name>_<hash>.so`` beside the package, then loaded
with ctypes. The hash is over the source and every ``csrc/`` header it
includes, so an edited source or header never loads a stale library. A
failed build raises with nvcc's stderr; nothing falls back. The build keeps
ptxas's resource report (``-Xptxas -v``) beside the library;
``ptxas_report`` reads each kernel's registers and spill bytes from it.
``operand`` checks a tensor a kernel entry takes and gives its pointer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from functools import cache

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source")


def source_files(name: str) -> list[str]:
    """csrc/<name>.cu and every file under csrc/ it includes, directly or
    through another include, in the order first reached."""
    order: list[str] = []
    todo = [os.path.join(CSRC_DIR, f"{name}.cu")]
    while todo:
        path = todo.pop(0)
        if path in order:
            continue
        order.append(path)
        with open(path) as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            dep = os.path.normpath(os.path.join(os.path.dirname(path), inc))
            if os.path.exists(dep):
                todo.append(dep)
    return order


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(os.path.relpath(path, CSRC_DIR).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _report_path(library: str) -> str:
    return library[: -len(".so")] + ".ptxas.txt"


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless the library for its current source
    exists. Returns the library path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (rc {proc.returncode}):\n{proc.stderr}"
        )
    with open(f"{tmp}.ptxas", "w") as f:
        f.write(proc.stderr)
    os.replace(f"{tmp}.ptxas", _report_path(out))
    os.replace(tmp, out)  # atomic: concurrent builds never see half a file
    return out


def parse_ptxas(text: str) -> dict[str, dict]:
    """{kernel: {"registers", "spill_stores", "spill_loads", "stack"}} from
    ptxas's -v report (entry functions only)."""
    out: dict[str, dict] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def ptxas_report(name: str) -> dict[str, dict]:
    """Registers and spill bytes of each kernel of csrc/<name>.cu, from the
    report its build kept (builds the library if needed)."""
    with open(_report_path(build(name))) as f:
        return parse_ptxas(f.read())


@cache
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name))


def operand(t, dev, dtype, shape: tuple, what: str) -> int:
    """The pointer of a kernel operand: a contiguous `dtype` tensor of
    `shape` on `dev`, else raise ValueError."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} {shape} tensor on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    return t.data_ptr()
