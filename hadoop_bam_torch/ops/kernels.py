"""Build and load the hand-written CUDA kernels of ``hadoop_bam_torch/csrc``.

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``hadoop_bam_torch/_build``
at first use, then loaded with ctypes; pointers and the CUDA stream pass
as ``c_void_p``.  ``build()`` starts one ``nvcc`` per source, all at once,
and waits for them together.  Nothing here runs at import time, so the
package imports where there is no ``nvcc`` and no card (its CPU tensors
take the kernels' plain PyTorch versions instead).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

from hadoop_bam_torch.utils.errors import BackendError

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_ROOT, "csrc")
BUILD_DIR = os.path.join(_PKG_ROOT, "_build")

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32

# kernel name -> (C entry point, argtypes[, source stem]); the source
# stem is the name unless given (one source may hold several entry
# points); every entry point returns the cudaGetLastError() code after
# its launch (a query, ``cohort_slice_slots``, its CUDA error code)
KERNELS: Dict[str, tuple] = {
    "unpack_bam": ("hbam_unpack_fixed_fields",
                   [_VP, _I64, _VP, _I64, _VP, _VP]),
    "seq_stats": ("hbam_seq_qual_stats",
                  [_VP, _I64, _VP, _I64, _VP, _I64, _VP, _VP, _VP, _VP,
                   _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _VP]),
    "lz77_resolve": ("hbam_lz77_resolve",
                     [_VP, _I64, _I64, _I64, _VP, _VP, _VP, _VP, _I64,
                      _I64, _I64, _I64, _I64, _VP, _VP]),
    "record_walk": ("hbam_record_walk",
                    [_VP, _I64, _VP, _I64, _I64, _I64, _VP, _VP, _VP, _I64,
                     _VP, _I64, _I64, _I64, _I64, _I64, _VP]),
    "payload_gather": ("hbam_payload_gather",
                       [_VP, _I64, _VP, _VP, _VP, _VP, _VP, _I64, _I64,
                        _I64, _I64, _VP, _VP, _I64, _I64, _VP]),
    "interval_cols": ("hbam_interval_cols",
                      [_VP, _I64, _VP, _VP, _I64, _I64, _VP, _VP, _VP, _VP,
                       _VP, _VP]),
    "variant_unpack": ("hbam_variant_unpack",
                       [_VP, _I64, _VP, _I64, _I64, _I64, _VP, _VP, _VP, _VP,
                        _VP], "variant_gt"),
    "markdup_cols": ("hbam_markdup_cols",
                     [_VP, _I64, _I64, _I64, _I64, _VP, _I64, _VP, _VP,
                      _VP]),
    "cohort_stats": ("hbam_cohort_stats",
                     [_VP, _I64, _I64, _VP, _VP, _I64, _VP, _VP]),
    "cohort_slice": ("hbam_cohort_slice",
                     [_VP, _VP, _VP, _I64, _I64, _VP, _VP, _VP, _VP, _VP,
                      _VP, _I64, _VP], "cohort_stats"),
    "cohort_slice_slots": ("hbam_cohort_slice_slots", [_VP],
                           "cohort_stats"),
}


def source_of(name: str) -> str:
    """The ``csrc`` source stem that holds kernel ``name``."""
    entry = KERNELS[name]
    return entry[2] if len(entry) > 2 else name

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}


class KernelBuildError(BackendError):
    """nvcc is missing or refused a kernel source."""


class KernelLaunchError(BackendError):
    """A kernel launch returned a CUDA error."""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def _paths(name: str) -> tuple:
    """(source, library, build log) of kernel ``name``'s source."""
    stem = source_of(name)
    return (os.path.join(CSRC, f"{stem}.cu"),
            os.path.join(BUILD_DIR, f"lib{stem}.so"),
            os.path.join(BUILD_DIR, f"{stem}.log"))


def _stale(name: str) -> bool:
    src, so, _ = _paths(name)
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def build(names: Optional[Iterable[str]] = None,
          force: bool = False) -> float:
    """Compile the named kernels (all by default) that are missing or
    older than their source, one nvcc process per source, all started
    together.  Returns the wall seconds; raises KernelBuildError with the
    compiler's output when a build fails.  nvcc's ptxas report of each
    source (registers, shared memory, spills) lands in ``<source>.log``."""
    names = list(KERNELS if names is None else names)
    # one build a source, however many of its entry points are named
    todo = list({source_of(n): n for n in names
                 if force or _stale(n)}.values())
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        src, so, log = _paths(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        out = open(log, "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=out,
            stderr=subprocess.STDOUT), out, tmp, so, log)
    failed = []
    for name, (proc, out, tmp, so, log) in procs.items():
        rc = proc.wait()
        out.close()
        if rc != 0:
            with open(log) as f:
                failed.append(f"{name} (rc {rc}):\n{f.read()[-4000:]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def kernel(name: str) -> ctypes._CFuncPtr:
    """The C entry point of one kernel library, built first if needed."""
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            build([name])
            symbol, argtypes = KERNELS[name][:2]
            lib = ctypes.CDLL(_paths(name)[1])
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            _fns[name] = fn
        return fn


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise KernelLaunchError(f"{name} launch failed: CUDA error {rc}")


def ptxas_report(name: str) -> str:
    """The ptxas lines of the last build of ``name``, spill counts
    included ("" when none)."""
    log = _paths(name)[2]
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return "".join(l for l in f if "ptxas" in l or "spill" in l)
