"""Build and load the port's CUDA kernels (`tts_tpu_torch/csrc/*.cu`).

Each source compiles on its own with nvcc into a shared library with a plain
C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The build runs at first use, into `tts_tpu_torch/_build/` (listed in
.gitignore). The file name carries a hash of the source and the headers it
includes, so an edited source is rebuilt and a stale library is never
loaded. `build()` starts one nvcc per source, all at once, and waits for all
of them. Nothing here runs at import time: the CPU tests import every module
of the package on a machine that has no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("quant_matmul", "decode_attention", "parler_megastep",
           "llama_megastep", "dia_megastep", "parler_flat",
           "dia_flat")  # K1; K3/K4; K2/K5; K6-K9; K11; K12; K10
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, in parallel.

    Returns {name: seconds} for the sources it compiled. Raises with nvcc's
    output if any compile fails. The compiler's register and spill report
    (-Xptxas -v) is kept beside each library as <name>-<hash>.log.
    """
    with _LOCK:
        return _build_locked(list(names))


def _build_locked(names) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC_DIR),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    times, errors = {}, []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        times[name] = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def ptxas_report(name: str) -> str:
    """nvcc's -Xptxas -v output from the build of `name` ('' if absent)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _build_locked([name])
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


class Kernel:
    """One kernel's C entry and its launch counter.

    `launches` is a plain integer: the wrapper adds one each time it
    launches the kernel, and nowhere else, so a run can show which kernels
    its path went through (under a lock: the server launches from several
    threads). `entry()` builds and loads the library on first use and
    declares the entry's ctypes signature.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._count_lock = threading.Lock()

    def entry(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        """Launch through the C entry; raise on a CUDA error."""
        check(self.entry()(*args), self.symbol)
        with self._count_lock:
            self.launches += 1


def slot_groups(n: int, cap: int) -> list:
    """n slots cut into consecutive groups of at most `cap`, as even as can
    be (20 slots at a cap of 16 are two groups of 10): the batched steps run
    one group after another, each within the rows one launch takes."""
    k = -(-n // cap)
    size = -(-n // k)
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def cat_groups(outs):
    """The batched steps' per-group (x_out (G, H), k_new (L, G, KV), v_new
    (L, G, KV)) joined along the slot axis."""
    import torch
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs], 1),
            torch.cat([o[2] for o in outs], 1))


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def addr(t, *idx) -> int:
    """Address of t[idx] (leading indices) for a contiguous tensor: integer
    arithmetic, cheaper on the host than a view per launch (the decode steps
    are host-bound, PERF.md)."""
    off = sum(i * s for i, s in zip(idx, t.stride()))
    return t.data_ptr() + off * t.element_size()


def require(t, name: str, *, device, dtypes, ndim: int | None = None,
            align: int = 16, outer: int = 0) -> None:
    """Validate a tensor handed to a kernel: device, dtype, rank,
    contiguity and base alignment (16 bytes for the vector loads). With
    `outer` > 0 the first `outer` dims may have any stride and only the
    rest must be dense: a group of slots of a (L, B, ...) cache,
    `kv[:, g]`, is such a view, and the kernels address each layer
    through its stride."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    dense = 1
    for size, stride in reversed(list(zip(t.shape, t.stride()))[outer:]):
        if size != 1 and stride != dense:
            raise ValueError(f"{name} must be contiguous"
                             + (f" past its first {outer} dims" if outer else ""))
        dense *= size
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
