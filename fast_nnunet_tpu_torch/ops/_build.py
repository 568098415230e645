"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` (Hopper), then linked into one shared library with a plain C
interface that ``ctypes`` loads. No PyTorch headers are included, so a build
takes seconds, not the minutes of ``torch.utils.cpp_extension.load``.

The library lands in ``fast_nnunet_tpu_torch/_build/<hash>/`` (git-ignored),
keyed by a hash of the sources, the flags and the nvcc version, so an edited
source rebuilds and an unchanged one is loaded as is. A failed build raises
with nvcc's stderr; nothing falls back to the plain versions.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libfnn_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
#: C signatures of csrc/*.cu (pointers, including the stream, as c_void_p)
SIGNATURES = {
    # x, dtype, rows, S, vec, sum, sumsq, stream
    "fnn_spatial_sum_sumsq": [_p, _i, _ll, _ll, _i, _p, _p, _p],
    # acc, dtype, p0h, Yh, Zh, c8p, K, n_rows, row_base, n_zero, out, stream
    "fnn_grouped_argmax": [_p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _p, _p],
    # acc, acc_dtype, feats, feat_dtype, g, w, bias, yh0*, zh0*, valid*, B,
    # p0h, pyh, pzh, F, K, Yh, Zh, c8p, row_base, y_lo, y_hi, stream
    "fnn_s2d_accumulate": [_p, _i, _p, _i, _p, _p, _p, _p, _p, _p, _i,
                           _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _p],
}

#: dtype codes shared with csrc/common.cuh
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from "
                       f"{CSRC} at first use")


def _source_key(nvcc: str) -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                       glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True, check=True).stdout.encode())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: str) -> str:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    procs = []
    for src in sources:
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, _, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- {os.path.basename(src)} "
                          f"(exit {proc.returncode})\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    lib = os.path.join(out_dir, LIB_NAME)
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
         *[obj for _, obj, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    nvcc = nvcc_path()
    final_dir = os.path.join(BUILD_ROOT, _source_key(nvcc))
    final_lib = os.path.join(final_dir, LIB_NAME)
    if not os.path.isfile(final_lib):
        os.makedirs(BUILD_ROOT, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT)
        try:
            built = _compile(nvcc, tmp)
            os.makedirs(final_dir, exist_ok=True)
            os.replace(built, final_lib)  # atomic: concurrent builds agree
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(final_lib)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fnn_error_string.argtypes = [ctypes.c_int]
    lib.fnn_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        name = library().fnn_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({name}) at launch")


def dtype_code(t) -> int:
    try:
        return DTYPE_CODES[str(t.dtype)]
    except KeyError:
        raise TypeError(f"unsupported dtype {t.dtype} "
                        "(kernels take float32 or bfloat16)") from None


def stream_ptr(t) -> int:
    """Current PyTorch stream of t's device, as an int for c_void_p."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
