"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library under ``build/kernels/`` at the repository root
(listed in ``.gitignore``), on first use.  The library's file name carries a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads the existing library.  Nothing here runs at import: the
CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# No --use_fast_math; -fmad=false keeps every product and sum rounded on its
# own, as in the plain torch versions (see the note in csrc/warp.cu).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# (argtypes, restype) of every entry point, by source name.  Every pointer
# and the stream are c_void_p: a bare Python int would be cut to 32 bits.
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "warp": {
        # pixels, wcs, accept, gra, gdec, tile, cov, n, h, w, q, device, stream
        "warp_project_f32": ((_VP,) * 7 + (_I,) * 5 + (_VP,), _I),
        "warp_project_unculled_f32": ((_VP,) * 7 + (_I,) * 5 + (_VP,), _I),
        # kind, nbins, pixels, wcs, pack_idx, accept, gra, gdec, in0, in1,
        # out0, out1, out2, n_packs, cap, h, w, q, device, stream
        "pack_scan_unculled_f32": ((_I,) * 2 + (_VP,) * 11 + (_I,) * 6 + (_VP,), _I),
        # kind, nbins, pixels, wcs, pack_idx, accept, finite, gra, gdec, in0,
        # in1, out0, out1, out2, n_queries, n_packs, cap, h, w, q, device,
        # stream
        "pack_scan_f32": ((_I,) * 2 + (_VP,) * 12 + (_I,) * 7 + (_VP,), _I),
        "warp_error_string": ((_I,), ctypes.c_char_p),
    },
    "psf": {
        # pixels, pack_idx, bank, skip, out, n_img, cap, h, w, k, device, stream
        "psf_match_sep_f32": ((_VP,) * 5 + (_I,) * 6 + (_VP,), _I),
        # ..., n_img, cap, h, w, kh, kw, device, stream
        "psf_match_2d_f32": ((_VP,) * 5 + (_I,) * 7 + (_VP,), _I),
        "psf_match_2d_any_f32": ((_VP,) * 5 + (_I,) * 7 + (_VP,), _I),
        "psf_error_string": ((_I,), ctypes.c_char_p),
    },
    "flash": {
        # q, k, v, o, lse (or null), (b, h, s) element strides of q, k, v, o,
        # batch, hq, hkv, seq, d, causal, window, scale, device, stream
        "flash_attention_fwd_f32": (
            (_VP,) * 5 + (_LL,) * 12 + (_I,) * 7 + (ctypes.c_float, _I, _VP), _I),
        "flash_attention_fwd_bf16": (
            (_VP,) * 5 + (_LL,) * 12 + (_I,) * 7 + (ctypes.c_float, _I, _VP), _I),
        # o, dout, delta, strides of o and dout, batch, hq, seq, d, is_bf16,
        # device, stream
        "flash_attention_bwd_preprocess": ((_VP,) * 3 + (_LL,) * 6 + (_I,) * 6 + (_VP,), _I),
        # q, k, v, dout, lse, delta, dk, dv, part (or null), strides of q, k,
        # v, dout, dk, dv, batch, hq, hkv, seq, d, causal, window, scale,
        # is_bf16, device, stream
        "flash_attention_bwd_dkdv": (
            (_VP,) * 9 + (_LL,) * 18 + (_I,) * 7 + (ctypes.c_float, _I, _I, _VP), _I),
        # part, dk, dv, strides of dk, dv, batch, hq, hkv, seq, d, scale,
        # is_bf16, device, stream
        "flash_attention_bwd_dkdv_reduce": (
            (_VP,) * 3 + (_LL,) * 6 + (_I,) * 5 + (ctypes.c_float, _I, _I, _VP), _I),
        # q, k, v, dout, lse, delta, dq, strides of q, k, v, dout, dq, ...
        "flash_attention_bwd_dq": (
            (_VP,) * 7 + (_LL,) * 15 + (_I,) * 7 + (ctypes.c_float, _I, _I, _VP), _I),
        # d, is_bf16 -> keys a dkdv block owns (-1: no kernel for d)
        "flash_attention_bwd_key_tile": ((_I, _I), _I),
        "flash_error_string": ((_I,), ctypes.c_char_p),
    },
    "ssd": {
        # log_a, B, C, x, y, dS and cumsum scratch, state, strides (log_a
        # b, t; B b, t; C b, t; x b, t, h), batch, nheads, seq, n, chunk,
        # group, is_bf16, device, stream
        "ssd_scan_fwd": ((_VP,) * 8 + (_LL,) * 9 + (_I,) * 8 + (_VP,), _I),
        # C, dy, the decays' scratch, the final state's gradient (or null),
        # dS' scratch, C's strides (b, t), batch, nheads, seq, n, chunk,
        # is_bf16, device, stream
        "ssd_bwd_state_pass": ((_VP,) * 5 + (_LL,) * 2 + (_I,) * 7 + (_VP,), _I),
        # B, C, x, dy, the forward's dS scratch, dS', decays, d log_a, dx,
        # partials, strides (B b, t; C b, t; x b, t, h), batch, nheads, seq,
        # n, chunk, group, is_bf16, device, stream
        "ssd_bwd_chunk_scan": ((_VP,) * 10 + (_LL,) * 7 + (_I,) * 8 + (_VP,), _I),
        # partials, dB, dC, batch, seq, n, chunk, n_groups, is_bf16, device,
        # stream
        "ssd_bwd_reduce": ((_VP,) * 3 + (_I,) * 7 + (_VP,), _I),
        "ssd_error_string": ((_I,), ctypes.c_char_p),
    },
    "mosaic": {
        # tiles, covs, offsets, coadd, depth, b, bh, bw, npix, device, stream
        "mosaic_bricks_f32": ((_VP,) * 5 + (_I,) * 5 + (_VP,), _I),
        "mosaic_error_string": ((_I,), ctypes.c_char_p),
    },
}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current content."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no current library, all at once.

    One ``nvcc`` per source, started together.  Returns each source's
    compiler output (the ``-Xptxas -v`` register, shared-memory and spill
    lines); raises if any compile fails.
    """
    compiler = nvcc()
    if not os.path.exists(compiler):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {compiler})")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List[tuple] = []
    for src in sorted(CSRC.glob("*.cu")):
        out = library_path(src.stem)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src.stem, out, tmp, proc))
    logs: Dict[str, str] = {}
    failed = []
    for name, out, tmp, proc in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    lib.error_string = getattr(lib, f"{name}_error_string")
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
