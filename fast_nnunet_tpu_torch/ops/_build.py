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

nvcc runs with ``-Xptxas -v``: what ptxas reports per kernel (registers,
spills, stack) is kept beside the library as ``ptxas.txt`` and read back by
:func:`ptxas_report`.
"""
import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libfnn_kernels.so"
PTXAS_LOG = "ptxas.txt"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
#: C signatures of csrc/*.cu (pointers, including the stream, as c_void_p)
SIGNATURES = {
    # x, dtype, rows, S, chunk, k, vec, sum, sumsq, stream
    "fnn_spatial_sum_sumsq": [_p, _i, _ll, _ll, _ll, _i, _i, _p, _p, _p],
    # acc, dtype, p0h, Yh, Zh, c8p, K, n_rows, row_base, n_zero, run,
    # stride16, smem, vec16, out, stream
    "fnn_grouped_argmax": [_p] + [_i] * 13 + [_p, _p],
    # acc, acc_dtype, feats, feat_dtype, g, w, bias, yh0*, zh0*, valid*,
    # geometry* (FnnS2dGeometry), stream
    "fnn_s2d_accumulate": [_p, _i, _p, _i, _p, _p, _p, _p, _p, _p, _p, _p],
    # acc, dtype, logits, gauss, x0*, y0*, z0*, n_real, px, py, pz, Y, Z, C,
    # x_lo, x_hi, y_lo, y_hi, stream
    "fnn_scatter_accumulate": [_p, _i, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                               _i, _i, _i, _i, _i, _i, _i, _p],
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


def _source_key(nvcc: str, flags) -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                       glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    h.update(subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True, check=True).stdout.encode())
    return h.hexdigest()[:16]


def _compile(nvcc: str, flags, out_dir: str) -> str:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    procs = []
    for src in sources:
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *flags, "-I", CSRC, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors, log = [], []
    for src, _, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- {os.path.basename(src)} "
                          f"(exit {proc.returncode})\n{err}")
        log.append(err)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    with open(os.path.join(out_dir, PTXAS_LOG), "w") as f:
        f.write("".join(log))
    lib = os.path.join(out_dir, LIB_NAME)
    link = subprocess.run(
        [nvcc, *flags, "-shared", "-o", lib, *[obj for _, obj, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    return lib


@functools.lru_cache(maxsize=None)
def library(defines: tuple = ()) -> ctypes.CDLL:
    """Build (once per source hash and flags) and load the kernel library.
    ``defines``: extra ``NAME=VALUE`` macros for a build that switches part
    of a kernel off (tools/ablate_s2d_accumulate.py); every wrapper of the
    port loads the library built without them."""
    nvcc = nvcc_path()
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    final_dir = os.path.join(BUILD_ROOT, _source_key(nvcc, flags))
    final_lib = os.path.join(final_dir, LIB_NAME)
    if not os.path.isfile(final_lib):
        os.makedirs(BUILD_ROOT, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT)
        try:
            built = _compile(nvcc, flags, tmp)
            os.makedirs(final_dir, exist_ok=True)
            os.replace(os.path.join(tmp, PTXAS_LOG),
                       os.path.join(final_dir, PTXAS_LOG))
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


def _demangle(names):
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) \
        else list(names)


def parse_ptxas(text: str) -> dict:
    """ptxas -v output -> {function: {"registers", "static_smem",
    "spill_stores", "spill_loads", "stack"}} (byte counts), per entry
    function (dynamic shared memory is set at launch, not here)."""
    found, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            cur = found.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    names = [n for n, v in found.items() if "registers" in v]
    short = []
    for full in _demangle(names):
        m = re.search(r"(\w+<[^()]*>)\(", full)
        short.append(m.group(1) if m else full)
    return {s: found[n] for s, n in zip(short, names)}


def ptxas_report(match: str = "") -> dict:
    """What ptxas reported for the built library's entry functions whose
    name contains ``match`` (builds the library first if needed)."""
    lib = library()
    path = os.path.join(os.path.dirname(lib._name), PTXAS_LOG)
    with open(path) as f:
        return {k: v for k, v in parse_ptxas(f.read()).items() if match in k}


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
