"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Builds happen at first use,
into ``ops/_build/`` (git-ignored), keyed by a hash of the source, of
every shared header (``csrc/*.cuh``) and of the flags: an edited source
or header rebuilds, an unchanged one loads the library already there.
Each library keeps its ptxas report (registers, shared memory, spills)
beside it, so a cached build still answers :func:`ptxas_report`. A
missing ``nvcc`` or a failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_mu = threading.Lock()
_loaded = {}  # source name -> ctypes.CDLL


def find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = "/usr/local/cuda/bin/nvcc"
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's "
            "CUDA kernels are built from source at first use"
        )
    return nvcc


def headers():
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))


def _library_path(source):
    digest = hashlib.sha256()
    # the source, then every header it may include, each under its name
    for name in [source] + headers():
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(
        BUILD_DIR, "lib%s-%s.so" % (stem, digest.hexdigest()[:16])
    )


def _report_path(library):
    return library + ".ptxas"


def compile_source(source):
    """Compile ``csrc/<source>`` unless its library and that library's
    ptxas report both exist; returns the library path."""
    path = _library_path(source)
    report = _report_path(path)
    if os.path.exists(path) and os.path.exists(report):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed on %s (rc=%d):\n%s"
            % (source, proc.returncode, proc.stderr[-8000:])
        )
    # the report first: a library never stands without its report, and
    # concurrent builds converge on one file each
    with open(report + ".%d.tmp" % os.getpid(), "w") as f:
        f.write(proc.stderr)
    os.replace(report + ".%d.tmp" % os.getpid(), report)
    os.replace(tmp, path)
    return path


def ptxas_report(source):
    """The ptxas report of the library ``csrc/<source>`` loads now;
    ``FileNotFoundError`` when it has not been built."""
    with open(_report_path(_library_path(source))) as f:
        return f.read()


def sources():
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def build_all():
    """Compile every ``csrc/*.cu`` at once, one ``nvcc`` per source, all
    started together; returns {source: library path}. Raises the first
    build failure after every build has finished."""
    results = {}

    def one(source):
        try:
            results[source] = compile_source(source)
        except Exception as err:  # noqa: BLE001 — re-raised below
            results[source] = err

    threads = [threading.Thread(target=one, args=(s,)) for s in sources()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for source in sources():
        if isinstance(results[source], Exception):
            raise results[source]
    return results


def load_library(source):
    """The ctypes library for ``csrc/<source>``, built at first use."""
    with _mu:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(compile_source(source))
            _loaded[source] = lib
        return lib
