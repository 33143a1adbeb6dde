"""Build-at-first-use for the port's native code.

Two kinds of library, both built from the checkout's own sources:

- the CUDA kernels under ``ops/csrc/*.cu``: ``nvcc`` compiles each source
  into its own shared library with a plain C interface
  (``-O3 -gencode=arch=compute_90a,code=sm_90a``), loaded with ctypes.
  ``ptxas``'s resource report (registers, stack, spills per kernel) is
  kept beside each library and read by :func:`ptxas_usage`.
  The sources include only the CUDA runtime headers, never PyTorch's, so
  a build takes seconds rather than the minutes a
  ``torch.utils.cpp_extension`` binding costs. :func:`build_kernels`
  starts one ``nvcc`` per source, all at once. Outputs go to ``_build/``
  inside the package (listed in ``.gitignore``), named by a hash of the
  source and flags, so an edited source is rebuilt and an unchanged one is
  reused;
- ``native/libpdtn_codec.so`` (the host codec the artifact reader needs),
  built from ``native/codec.cpp`` through ``native/Makefile``.

An exclusive file lock around check-and-build keeps concurrent processes
from racing a compiler into the same half-written file. A failed build
raises: the port has no fallback for a kernel that will not build.

:func:`build_events` counts the compiles and library loads this process
has done; the generative engine reads it before and after serving, and
any increase after warmup is a retrace.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(_PKG_DIR)
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NATIVE_DIR = os.path.join(REPO_DIR, "native")

NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_events = 0


def build_events() -> int:
    """Compiles plus library loads done by this process so far."""
    return _events


def _count_event() -> None:
    global _events
    _events += 1


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "built from source at first use"
    )


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _so_path(name: str) -> str:
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpdtn_{name}-{h.hexdigest()[:12]}.so")


def build_kernels(names: Iterable[str], timeout: float = 600.0) -> None:
    """Compile every missing kernel library among ``names``, one ``nvcc``
    process per source, all started together. Raises on any failure with
    the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock, open(os.path.join(BUILD_DIR, ".lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            procs = {}
            for name in names:
                out = _so_path(name)
                if os.path.exists(out):
                    continue
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", out + ".tmp",
                       _source(name)]
                procs[name] = (out, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                ))
            errors = []
            for name, (out, proc) in procs.items():
                log, _ = proc.communicate(timeout=timeout)
                if proc.returncode != 0:
                    errors.append(f"{name}: nvcc exit {proc.returncode}\n"
                                  + log.decode(errors="replace"))
                    continue
                with open(out + ".log", "wb") as f:
                    f.write(log)
                os.replace(out + ".tmp", out)
                _count_event()
            if errors:
                raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_TEMPLATE_ARG = re.compile(r"f|13__nv_bfloat16|S([0-9A-Z]*)_|Li(\d+)E")


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled (template) kernel in a namespace, the
    arguments read as ``float``, ``bf16`` and integers; anything else
    comes back as it is. A repeated class-type argument is mangled as a
    substitution (``S<seq>_``) that refers back to an earlier component:
    the namespace, the template or a class-type argument, in that order
    (``S_`` the first, ``S0_`` the second, ``S1_`` the third); it reads
    ``bf16`` when it refers to an earlier ``__nv_bfloat16``."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name, table = 3, None, []  # table: the substitution candidates
    while i < len(mangled) and mangled[i].isdigit():  # length-prefixed
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
        table.append(name)
    if name is None or not mangled.startswith("I", i):
        return name or mangled
    args, i = [], i + 1
    while (m := _TEMPLATE_ARG.match(mangled, i)):
        if m.group(0) == "13__nv_bfloat16":
            table.append("bf16")
        if m.group(1) is not None:  # a substitution
            k = int(m.group(1), 36) + 1 if m.group(1) else 0
            if k >= len(table) or table[k] != "bf16":
                return mangled
            args.append("bf16")
        else:
            args.append(m.group(2) or ("float" if m.group(0) == "f"
                                       else "bf16"))
        i = m.end()
    if not mangled.startswith("E", i):
        return mangled
    return f"{name}<{','.join(args)}>"


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """kernel -> {registers, stack, spill_stores, spill_loads} from
    ``ptxas -v`` output (sm_90a entries)."""
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = _SPILLS.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def ptxas_usage(name: str) -> Dict[str, Dict[str, int]]:
    """:func:`parse_ptxas` of the build of kernel library ``name`` (built
    first if missing)."""
    path = _so_path(name)
    if not os.path.exists(path + ".log"):
        build_kernels([name])
    with open(path + ".log", encoding="utf-8", errors="replace") as f:
        return parse_ptxas(f.read())


def load_kernel(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, building it first if
    needed. Loaded once per process."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _so_path(name)
    if not os.path.exists(path):
        build_kernels([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(path)
            lib.pdtn_cuda_error_string.restype = ctypes.c_char_p
            lib.pdtn_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
            _count_event()
    return lib


def ensure_native(so_name: str, timeout: float = 120.0) -> str:
    """Path of ``native/<so_name>``, built with its ``make`` target when
    missing. Raises with make's output when the build fails."""
    path = os.path.join(NATIVE_DIR, so_name)
    if os.path.exists(path):
        return path
    with _lock, open(path + ".lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                proc = subprocess.run(
                    ["make", "-s", so_name], cwd=NATIVE_DIR,
                    capture_output=True, timeout=timeout,
                )
                if proc.returncode != 0 or not os.path.exists(path):
                    raise RuntimeError(
                        f"building native/{so_name} failed:\n"
                        + (proc.stdout + proc.stderr).decode(errors="replace")
                    )
                _count_event()
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)
    return path
