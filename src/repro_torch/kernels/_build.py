"""nvcc-and-ctypes builder shared by the port's CUDA kernels.

Each kernel module names its source with a ``Source`` (the ``.cu`` file and
a ``bind`` function that sets the C entry points' ``argtypes``) and calls
``build(SOURCE)`` at its first CUDA launch, never at import. ``build``
compiles every source it is given that is not built yet in parallel (one
``nvcc`` per source, or per part of a source built in ``parts``, all
started together; a source's parts are then linked), loads each shared
library with ``ctypes`` and caches it for the process. ``KERNEL_MODULES`` lists the
modules of all four sources and ``all_sources()`` their ``Source``s, so
that ``chip_smoke.py`` builds every kernel at once.

Libraries go into ``<repo>/build/repro_torch/`` (listed in .gitignore),
named by a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused. The write is atomic (temp file +
``os.replace``), so concurrent builders agree; a lock serialises builders
within one process. ``build_info[name]`` records the build's seconds, the
compiler's output (ptxas's register / spill report; kept beside the
library as ``.log``, so a reused library reports it too), the library's
path and the source's own ``nvcc`` seconds (None when it was reused).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

# <repo>/build/repro_torch
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the modules of the port's CUDA sources, one ``SOURCE`` each:
# csrc/pullpush.cu, swa_attention.cu, mamba_scan.cu and slstm_step.cu
KERNEL_MODULES = (
    "repro_torch.kernels.pullpush.pullpush",
    "repro_torch.kernels.swa_attention.swa_attention",
    "repro_torch.kernels.mamba_scan.mamba_scan",
    "repro_torch.kernels.slstm_step.slstm_step",
)

build_info: dict = {}          # name -> {seconds, log, path}
_libs: dict = {}               # name -> ctypes.CDLL
_lock = threading.Lock()


@dataclass(frozen=True)
class Source:
    name: str                              # library stem, e.g. "pullpush"
    path: Path                             # the .cu file
    bind: Callable[[ctypes.CDLL], None]    # sets argtypes / restype
    # > 1: the file is compiled this many times, with -DKERNEL_PART=k
    # (k = 0 .. parts - 1: each unit holds its share of the entry points),
    # all at once beside the other sources, then linked into one library
    parts: int = 1


# the flags of one part's ``-c`` (NVCC_FLAGS but ``-shared``)
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared")


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from their csrc/*.cu sources at first "
                           "CUDA use")
    return path


def _target(src: Source) -> Path:
    flags = " ".join(NVCC_FLAGS) + (f" parts={src.parts}" if src.parts > 1
                                     else "")
    tag = hashlib.sha256(src.path.read_bytes()
                         + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.name}-{tag}.so"


def all_sources():
    """The ``Source`` of every module in ``KERNEL_MODULES``."""
    import importlib
    return [importlib.import_module(m).SOURCE for m in KERNEL_MODULES]


def build(*sources: Source):
    """Compile (in parallel) and load every source; returns the list of
    ``ctypes.CDLL`` in the order given. Raises ``RuntimeError`` with the
    compiler's output if any build fails."""
    with _lock:
        todo = [s for s in sources if s.name not in _libs]
        t0 = time.perf_counter()
        procs = {}      # name -> (library, its temp file, objects, nvccs)
        for s in todo:
            so = _target(s)
            if so.exists():
                continue
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            if s.parts == 1:
                objs = []
                cmds = [[nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s.path)]]
            else:
                objs = [so.with_suffix(f".{os.getpid()}.{k}.o")
                        for k in range(s.parts)]
                cmds = [[nvcc, *COMPILE_FLAGS, "-c", f"-DKERNEL_PART={k}",
                         "-o", str(o), str(s.path)]
                        for k, o in enumerate(objs)]
            procs[s.name] = (so, tmp, objs, [subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for cmd in cmds])
        logs, failed, own = {}, [], {}

        def drain(name, k, proc):   # each source's own compile seconds
            logs[name, k] = proc.communicate()[0]
            own[name] = max(own.get(name, 0.0), time.perf_counter() - t0)
        waits = [threading.Thread(target=drain, args=(name, k, proc))
                 for name, (*_, nvccs) in procs.items()
                 for k, proc in enumerate(nvccs)]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        for name, (so, tmp, objs, nvccs) in procs.items():
            logs[name] = "".join(logs.pop((name, k))
                                 for k in range(len(nvccs)))
            bad = [p.returncode for p in nvccs if p.returncode != 0]
            if not bad and objs:
                link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                                       *map(str, objs)],
                                      capture_output=True, text=True)
                logs[name] += link.stdout + link.stderr
                bad = [link.returncode] if link.returncode != 0 else []
                own[name] = time.perf_counter() - t0
            for o in objs:
                if o.exists():
                    o.unlink()
            if bad:
                failed.append(f"nvcc failed for {name} ({bad[0]}):"
                              f"\n{logs[name]}")
            else:
                so.with_suffix(".log").write_text(logs[name])
                os.replace(tmp, so)          # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("\n".join(failed))
        seconds = time.perf_counter() - t0
        for s in todo:
            so = _target(s)
            lib = ctypes.CDLL(str(so))
            s.bind(lib)
            _libs[s.name] = lib
            log = so.with_suffix(".log")
            if s.name not in logs:
                logs[s.name] = log.read_text() if log.exists() else ""
            build_info[s.name] = dict(seconds=seconds, log=logs[s.name],
                                      path=str(so),
                                      nvcc_seconds=own.get(s.name))
        return [_libs[s.name] for s in sources]


def raise_if(lib, code, what):
    """Raise if a C entry point returned a CUDA error (``cudaGetLastError``
    after the launch). Each source's ``bind`` sets ``lib.error_string`` to
    its C function that names an error code."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def stream(t):
    """PyTorch's current stream on ``t``'s device, as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
