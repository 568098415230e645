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

The host library (``csrc/host_ops.cpp``: the CT preprocess, the non-air
bounding box and the nearest mask revert of the turbo pipeline's host
route) is plain C++ for the host: :func:`host_library` builds it with the
host compiler (``$CXX``, else ``c++``), not nvcc, so it builds where there is
no CUDA toolkit, into ``_build/host-<hash>/`` keyed by the source, the flags
and the compiler's version. Its failed build raises with the compiler's
stderr too.

The native engine (``engine/``: the port's copy of the JAX package's C++
engine with an in-process AOTInductor backend, ``src/aoti_backend.cpp``) is
built by :func:`engine_binary` with the host compiler of :func:`torch_cxx`
against torch's own headers and libraries (``torch.utils.cpp_extension`` paths, torch's C++11 ABI
flag, an rpath to torch's ``lib/``), one compiler process per source, into
``_build/engine-<hash>/fast_nnunet_engine``; no CMake. Its failed build
raises with the compiler's stderr.

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
    # x, y, dtype, rows, S, C8, c, threads, chunks, vec, mean, rstd, scale,
    # bias, act, slope, stream
    "fnn_norm_apply": [_p, _p, _i, _ll, _ll, _i, _i, _i, _i, _i, _p, _p, _p,
                       _p, _i, ctypes.c_float, _p],
    # q, q_sb, q_st, q_sh, k (same), v (same), out, lse, B, T, H, stream
    "fnn_attention_fwd": [_p, _ll, _ll, _ll] * 3 + [_p, _p, _i, _i, _i, _p],
    # q, k, v (each with its strides), o, dout, lse, dq, dk, dv, ws (the
    # workspace), B, T, H, stream
    "fnn_attention_bwd": [_p, _ll, _ll, _ll] * 3 + [_p] * 7
                         + [_i, _i, _i, _p],
}

HOST_SOURCE = os.path.join(CSRC, "host_ops.cpp")
HOST_LIB_NAME = "libfnn_hostops.so"
#: engine/CMakeLists.txt's flags for the JAX package's copy, plus what a
#: shared library built by hand needs
HOST_FLAGS = ["-O3", "-march=native", "-fno-math-errno", "-fPIC", "-shared",
              "-std=c++17"]
_i16p = ctypes.POINTER(ctypes.c_int16)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
#: C signatures of csrc/host_ops.cpp
HOST_SIGNATURES = {
    # src, in_shape, n_ch, lb, ub, mean, std, out_shape, out
    "fnn_preprocess_ct_i16": [_i16p, _i64p, _ll, _f32p, _f32p, _f32p, _f32p,
                              _i64p, _u16p],
    # ... out_shape, box, out
    "fnn_preprocess_ct_i16_box": [_i16p, _i64p, _ll, _f32p, _f32p, _f32p,
                                  _f32p, _i64p, _i64p, _u16p],
    # src, in_shape, n_ch, lb, out_lo, out_hi
    "fnn_nonair_bbox_i16": [_i16p, _i64p, _ll, _f32p, _i64p, _i64p],
    # src, in_shape, out_shape, out
    "fnn_nearest_revert_u8": [_u8p, _i64p, _i64p, _u8p],
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


def host_compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` on PATH."""
    cxx = os.environ.get("CXX") or "c++"
    path = shutil.which(cxx)
    if not path:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found (set CXX); "
                           f"the port's host library is built from "
                           f"{HOST_SOURCE} at first use")
    return path


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    """Build (once per source hash, flags and compiler) and load the host
    library of csrc/host_ops.cpp. A failed build raises with the
    compiler's stderr; nothing falls back."""
    cxx = host_compiler()
    h = hashlib.sha256()
    with open(HOST_SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(HOST_FLAGS).encode())
    h.update(subprocess.run([cxx, "--version"], capture_output=True,
                            text=True, check=True).stdout.encode())
    final_dir = os.path.join(BUILD_ROOT, "host-" + h.hexdigest()[:16])
    final_lib = os.path.join(final_dir, HOST_LIB_NAME)
    if not os.path.isfile(final_lib):
        os.makedirs(BUILD_ROOT, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="build-host-", dir=BUILD_ROOT)
        try:
            built = os.path.join(tmp, HOST_LIB_NAME)
            res = subprocess.run([cxx, *HOST_FLAGS, HOST_SOURCE, "-o", built],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(cxx)} failed on {HOST_SOURCE} "
                    f"(exit {res.returncode}):\n{res.stderr}")
            os.makedirs(final_dir, exist_ok=True)
            os.replace(built, final_lib)  # atomic: concurrent builds agree
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(final_lib)
    for name, argtypes in HOST_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _links_openmp(cxx: str) -> bool:
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "probe.cpp")
        with open(src, "w") as f:
            f.write("int fnn_probe() { return 0; }\n")
        return subprocess.run(
            [cxx, "-fopenmp", "-shared", "-fPIC", src, "-o",
             os.path.join(d, "probe.so")], capture_output=True).returncode == 0


@functools.lru_cache(maxsize=None)
def torch_cxx() -> str:
    """The host compiler for code that links against torch's C++ libraries
    (AOTInductor packages, the native engine): the first of ``$CXX``,
    ``g++``, ``c++``, ``/usr/bin/g++``, ``/usr/bin/c++`` and ``clang++``
    that links ``-fopenmp`` (Inductor always passes it on Linux, and a GCC
    installed without its OpenMP files cannot). Raises when none does."""
    tried = []
    for cand in (os.environ.get("CXX"), "g++", "c++", "/usr/bin/g++",
                 "/usr/bin/c++", "clang++"):
        path = shutil.which(cand) if cand else None
        if not path or path in tried:
            continue
        tried.append(path)
        if _links_openmp(path):
            return path
    raise RuntimeError(f"no host C++ compiler links -fopenmp (tried "
                       f"{tried or 'none found'}); AOTInductor packages and "
                       "the native engine need one")


ENGINE_DIR = os.path.join(_PKG, "engine")
ENGINE_BIN = "fast_nnunet_engine"
ENGINE_FLAGS = ["-O3", "-std=c++17", "-fPIC"]


def _torch_build_paths():
    """(include dirs, library dir, ABI define, libraries) of the installed
    torch: the CUDA libraries where torch has them, linked even though no
    symbol of theirs is named (they register the CUDA package runner)."""
    import torch
    from torch.utils import cpp_extension
    lib_dir = cpp_extension.library_paths()[0]
    libs = ["torch", "torch_cpu", "c10"]
    for cuda_lib in ("torch_cuda", "c10_cuda"):
        if os.path.isfile(os.path.join(lib_dir, f"lib{cuda_lib}.so")):
            libs.append(cuda_lib)
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"
    return cpp_extension.include_paths(), lib_dir, abi, libs


@functools.lru_cache(maxsize=None)
def engine_binary() -> str:
    """Build (once per source hash, flags, compiler and torch) the port's
    native engine and return the path of its executable. One process of
    :func:`torch_cxx`'s compiler per ``engine/src/*.cpp``, all started together, then one link
    against torch's libraries with an rpath to them and zlib's shared
    library; into a temporary directory, moved into place with
    ``os.replace``. A failed build raises with the compiler's stderr."""
    import torch
    cxx = torch_cxx()
    includes, lib_dir, abi, libs = _torch_build_paths()
    sources = sorted(glob.glob(os.path.join(ENGINE_DIR, "src", "*.cpp")))
    headers = sorted(glob.glob(os.path.join(ENGINE_DIR, "include", "**",
                                            "*.h"), recursive=True))
    cflags = ENGINE_FLAGS + [abi, "-I", os.path.join(ENGINE_DIR, "include")] \
        + [f"-I{d}" for d in includes]
    ldflags = [f"-L{lib_dir}", f"-Wl,-rpath,{lib_dir}", "-Wl,--no-as-needed"] \
        + [f"-l{lib}" for lib in libs] \
        + ["-Wl,--as-needed", "-l:libz.so.1", "-lpthread", "-ldl"]
    h = hashlib.sha256()
    for path in sources + headers:
        h.update(os.path.relpath(path, ENGINE_DIR).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(cflags + ldflags).encode())
    h.update(torch.__version__.encode())
    h.update(subprocess.run([cxx, "--version"], capture_output=True,
                            text=True, check=True).stdout.encode())
    final_dir = os.path.join(BUILD_ROOT, "engine-" + h.hexdigest()[:16])
    final_bin = os.path.join(final_dir, ENGINE_BIN)
    if os.path.isfile(final_bin):
        return final_bin
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="build-engine-", dir=BUILD_ROOT)
    try:
        procs = []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            procs.append((src, obj, subprocess.Popen(
                [cxx, *cflags, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for src, _, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- {os.path.basename(src)} "
                              f"(exit {proc.returncode})\n{err}")
        if errors:
            raise RuntimeError(f"{os.path.basename(cxx)} failed on the "
                               "engine:\n" + "\n".join(errors))
        built = os.path.join(tmp, ENGINE_BIN)
        link = subprocess.run([cxx, *[obj for _, obj, _ in procs], "-o",
                               built, *ldflags], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"engine link failed:\n{link.stderr}")
        os.makedirs(final_dir, exist_ok=True)
        os.replace(built, final_bin)  # atomic: concurrent builds agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return final_bin


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
