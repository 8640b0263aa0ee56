"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object
(one ``nvcc`` process per source, all started together), and the objects
are linked into ONE shared library with a plain C interface, loaded with
``ctypes``. No PyTorch headers are compiled, so a build takes seconds.

The library lands in ``build/repro_torch/<hash>/`` at the repository root,
keyed by a hash of the sources and flags, and is built at first use — never
at import. ptxas' register/shared-memory report of the last build is kept in
``ptxas.log`` beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    # q, k, v, k_scale, v_scale, cur_len, workspace, counters, out, B, S, KV, G, D, window,
    # span, qdtype, sdtype, stream
    "repro_decode_attention": [_P] * 9 + [_I] * 9 + [_P],
    # q, k, v, k_scale, v_scale, tok_slot, tok_pos, out, T, S, KV, G, D, window, qdtype,
    # sdtype, stream
    "repro_ragged_attention": [_P] * 8 + [_I] * 8 + [_P],
    # q, k, v, k_scale, v_scale, tok_seq, tok_pos, tables, out, T, NB, bs, max_blocks, KV,
    # G, D, window, qdtype, sdtype, stream
    "repro_paged_attention": [_P] * 9 + [_I] * 10 + [_P],
    # q, k, v, out, BKV, G, Sq, Sk, D, causal, block_q, block_k, dtype, stream
    "repro_flash_attention": [_P] * 4 + [_I] * 9 + [_P],
    # a, b, scale, workspace, counters, out, M, K, N, adtype, bdtype, route, split_k,
    # block_m, block_n, stream
    "repro_matmul": [_P] * 6 + [_I] * 9 + [_P],
    # M, K, N, route, split_k, block_n, bdtype -> f32 elements of workspace repro_matmul needs
    "repro_matmul_workspace": [_I] * 7,
    # x, w, out, R, C, eps, rows, xdtype, wdtype, stream
    "repro_rmsnorm": [_P] * 3 + [_I] * 2 + [ctypes.c_float] + [_I] * 3 + [_P],
    # x, out, R, C, rows, dtype, route, stream
    "repro_softmax": [_P] * 2 + [_I] * 5 + [_P],
    # x, y, out, alpha, R, C, block, dtype, stream
    "repro_axpy": [_P] * 3 + [ctypes.c_float] + [_I] * 4 + [_P],
    # x, y, out, R, C, block, dtype, stream
    "repro_dotp": [_P] * 3 + [_I] * 4 + [_P],
    # re, im, tw, out_re, out_im, B, N, rows, dtype, stream
    "repro_fft": [_P] * 5 + [_I] * 4 + [_P],
    # re, im, out_re, out_im, B, R, C, tw_n, in_dtype, out_dtype, stream
    "repro_fft_transpose": [_P] * 4 + [_I] * 3 + [ctypes.c_longlong] + [_I] * 2 + [_P],
    # x, w, out, B, H, W, C, KH, KW, O, block_h, xdtype, wdtype, route, stream
    "repro_conv2d": [_P] * 3 + [_I] * 11 + [_P],
}
RESTYPES = {"repro_matmul_workspace": ctypes.c_longlong}  # every other entry: int

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda): the CUDA kernels of repro_torch need the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    """Compile every source in parallel, then link; raise with nvcc's output."""
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir.parent))
    try:
        procs = []
        for src in _sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, objs, failed = [], [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib_tmp = work / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib_tmp), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        (work / "ptxas.log").write_text("\n".join(logs))
        os.replace(work / "ptxas.log", out_dir / "ptxas.log")
        os.replace(lib_tmp, out_dir / LIB_NAME)  # atomic: concurrent builders agree
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def load() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises if it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        _compile(path.parent)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero return code of a C entry point."""
    if rc == 0:
        return
    if rc == -1:
        raise ValueError(f"{name}: no kernel instantiated for this head_dim, group size, "
                         "tile, rows per block, block, route or shape")
    if rc == -2:
        raise TypeError(f"{name}: unsupported combination of operand dtypes and scales")
    if rc == -3:
        raise RuntimeError(f"{name}: the split-K scratch is missing")
    raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
