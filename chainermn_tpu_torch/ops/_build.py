"""Build the package's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each source under ``chainermn_tpu_torch/csrc/`` compiles for ``sm_90a``
into its own shared library with a plain C interface.  Libraries land in
``build/chainermn_tpu_torch/`` at the root of the checkout, named by a
hash of the source, the ``csrc/`` headers it includes and the flags, so an
edited source or header rebuilds and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per source, all at once; :func:`library`
builds its one source on first use.  Nothing is built or imported at module
import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

SOURCES = ("flash_fwd", "flash_bwd", "decode_attention", "kv_cache",
           "fused_ce", "beam_attention", "conv_backward")

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "chainermn_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: (argtypes, restype) per exported function
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    "flash_fwd": {"flash_fwd": ([_P] * 5 + [_I] * 7 + [_F, _P], _I)},
    "flash_bwd": {"flash_bwd": ([_P] * 11 + [_I] * 7 + [_F, _P], _I)},
    "decode_attention": {"decode_attend": (
        [_P, _L, _L] * 3 + [_P] * 4 + [_I, _P, _P] + [_I] * 8 + [_F, _P],
        _I)},
    "kv_cache": {"cache_append": ([_P] * 5 + [_I] * 5 + [_P], _I)},
    "fused_ce": {"ce_stats": ([_P] * 7 + [_I] * 7 + [_P], _I),
                 **{fn: ([_P] * 7 + [_I] * 5 + [_P], _I)
                    for fn in ("ce_dh", "ce_dtable")},
                 "ce_grads": ([_P] * 8 + [_I] * 5 + [_P], _I)},
    "beam_attention": {"beam_attend": ([_P] * 9 + [_I] * 8 + [_L, _I, _I,
                                                              _F, _P], _I)},
    "conv_backward": {"conv_dgrad": ([_P] * 3 + [_I] * 11 + [_P], _I),
                      "conv_wgrad": ([_P] * 4 + [_I] * 12 + [_P], _I)},
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the chainermn_tpu_torch kernels")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str, csrc: Path) -> list:
    """``name``'s ``.cu`` and every local header it includes, directly or
    through another header, in a fixed order."""
    seen, todo = [], [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = csrc / inc.decode()
            if dep.exists():
                todo.append(dep)
    return seen


def _lib_path(name: str, csrc: Optional[Path] = None) -> Path:
    """The library's path, keyed by the source, the headers it includes
    and the flags: an edit to any of them builds a new library."""
    csrc = _CSRC if csrc is None else csrc
    h = hashlib.sha256()
    for path in _sources(name, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc; output goes to a temporary file that is renamed
    into place only when the build succeeds."""
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (default: all) in parallel, skipping
    those already built.  Returns ``{name: {"seconds", "log", "path"}}``
    (a library built before keeps the nvcc log saved beside it);
    raises ``RuntimeError`` naming every source that failed to compile."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    running, report = {}, {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            saved = path.with_suffix(".log")
            report[name] = {"seconds": 0.0, "path": str(path),
                            "log": saved.read_text() if saved.exists()
                            else "cached"}
            continue
        running[name] = _start(name, nvcc_path())
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.monotonic() - t0, "log": log,
                        "path": str(out)}
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built on first use, with
    every exported function's argtypes/restype declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


def dtype_code(dtype) -> int:
    """The C entry points' dtype code: 0 = float32, 1 = bfloat16."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"the kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def pos_argument(pos, b: int, device):
    """``(pointer, scalar)`` for a C entry point's position argument: an
    int32 ``(B,)`` tensor on ``device`` passes its pointer, a Python int
    passes a null pointer and the value."""
    import torch

    if not isinstance(pos, torch.Tensor):
        return None, int(pos)
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,) \
            or pos.device != device or not pos.is_contiguous():
        raise ValueError(f"per-row pos must be a contiguous int32 ({b},) "
                         f"tensor on {device}, got {pos.dtype} "
                         f"{tuple(pos.shape)} on {pos.device}")
    return pos.data_ptr(), 0


def tma_operand(x, width: Optional[int] = None):
    """``x`` as a TMA-fed kernel reads it: itself where its last dim is
    ``width`` (default: unchanged) and its base 16-byte aligned, else a
    copy, aligned, with zero columns up to ``width`` (TMA wants 16-byte
    row strides and bases; zero columns add nothing to a product, and the
    callers drop them from what they return)."""
    import torch

    width = x.shape[-1] if width is None else width
    if x.shape[-1] == width and x.data_ptr() % 16 == 0:
        return x
    out = torch.zeros(x.shape[:-1] + (width,), dtype=x.dtype, device=x.device)
    out[..., :x.shape[-1]] = x
    return out


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of the card that holds ``device``
    (132 on the H100 SXM), for the kernels' wave sizing; cached, as the
    wrappers ask on every launch."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_handle(t) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
