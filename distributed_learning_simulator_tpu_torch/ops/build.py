"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``_kernel_build/`` (listed in ``.gitignore``; nothing prebuilt is
committed).  The library's file name carries a hash of its source, of
every header in ``csrc/`` (``*.cuh``) and of the compiler flags, so an
edited kernel or header is never served by a stale build.
:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for them together; :func:`load` builds one library if needed and
returns it as a :class:`ctypes.CDLL`, noting the load in :data:`loads`
(the telemetry's ``compile`` events read it).  Each build's compiler
output (``ptxas``' registers, shared memory and spills per kernel) is kept
beside its library as ``lib<name>-<hash>.ptxas.txt``; :func:`report`
reads it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_kernel_build")

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: every library loaded in this process, in load order: its name, the
#: seconds the build (if any) and the load took, and whether ``nvcc`` ran
loads: list[dict] = []

#: held around every launch counter's increment: the threaded executor
#: launches kernels from several worker threads, and ``count += 1`` is a
#: read-modify-write that two threads can interleave
launch_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def headers() -> list[str]:
    """The shared headers of ``csrc/``, in a fixed order."""
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in (source_path(name), *headers()):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def report_path(name: str) -> str:
    """Where the build of :func:`library_path` keeps its compiler output."""
    return library_path(name)[: -len(".so")] + ".ptxas.txt"


def report(name: str) -> str:
    """The compiler output (``ptxas -v``) of the built library ``name``."""
    with open(report_path(name), encoding="utf8") as f:
        return f.read()


def build(names) -> None:
    """Compile every library in ``names`` that is not built yet (or has no
    report beside it), one ``nvcc`` process each, all started together;
    raises :class:`KernelBuildError` naming every source that failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    pending = {}
    for name in names:
        target = library_path(name)
        if os.path.isfile(target) and os.path.isfile(report_path(name)):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        pending[name] = (proc, tmp, target)
    failures = []
    for name, (proc, tmp, target) in pending.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{output}")
            continue
        with open(f"{tmp}.txt", "w", encoding="utf8") as f:
            f.write(output)
        os.replace(f"{tmp}.txt", report_path(name))
        os.replace(tmp, target)
    if failures:
        raise KernelBuildError("nvcc failed for " + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiled on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            t0 = time.monotonic()
            built = not os.path.isfile(library_path(name))
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
            loads.append({"library": name, "seconds": time.monotonic() - t0, "built": built})
        return lib
