"""Ahead-of-time compiled packages — the port of
fast_nnunet_tpu/inference/aot.py, the counterpart of TensorRT's saved engines.

The reference serves from a pre-compiled artifact (``trtexec --saveEngine``,
ref docs/Engine.md:91), so a fresh process never pays the build. The JAX
package does it with ``jax.experimental.serialize_executable``. The port
does it with an AOTInductor package: ``torch.export`` the module, compile it
with ``torch._inductor.aoti_compile_and_package`` into a ``.pt2`` (generated
kernels and a shared object), and have every later process load it with
``aoti_load_package`` instead of compiling. libtorch's C++
``AOTIModelPackageLoader`` loads the same format, which is what the
exporter's native artifact and the engine's in-process backend use
(export/export_model.py ``aoti=True``, engine/src/aoti_backend.cpp).

Keying: a package is valid only for its exact program, so the key hashes
the exported graph's text (every node's op, target, arguments, shape, dtype
and device; no source locations or stack traces, so comment-only edits,
line shifts and renamed functions keep the key), the torch version, the
card (name, capability, count), ``extra``, the Inductor settings, and a
digest of the exported constants. AOTInductor bakes the weights into the package, where JAX passes
them as arguments: without the digest another fold, or other weights, would
load a stale package.

Contract (JAX aot.py): ``cache_dir=None`` compiles nothing and returns the
module itself (eager; JAX's ``lowered.compile()`` path). A package on disk
under the key is loaded, and the log says ``loaded ... no compile``; one
that fails to load (stale, corrupt) is recompiled with a warning. A new
package is written to a temporary name with the pid and ``os.replace``d, so
ranks or processes that compile the same key agree. A failed compile
raises, as JAX's ``lowered.compile()`` does (JAX degrades silently only
where a backend cannot serialize; an AOTInductor package always
serializes). Compilation runs with Inductor's layout optimisation off, so
convolutions keep the eager NCDHW layout that kernels A and C read, with
its precision-cast emulation on, so fused bf16 work rounds where eager
rounds (without it a bf16 package's masks drift from eager's), and
with the host compiler of ``ops._build.torch_cxx`` (one that links
``-fopenmp``, which Inductor always passes on Linux).

Norms are dispatcher ops: the s2d network's InstanceNorm is
``fnn_torch::s2d_instance_norm`` (models/s2d.py, kernel A inside it) and the
plain networks' is ``fnn_torch::instance_norm`` (models/blocks.py). A
package's generated code calls them back through the dispatcher, so kernel
A is never replaced by an Inductor reduction and each norm rounds as in
eager. A package that holds them loads only in a process that registered
them: this module imports both modules, and the native engine registers
``fnn_torch::instance_norm`` in C++.

Trust model: the cache directory must be private and trusted (it is made
0o700). A ``.pt2`` holds a shared object, and loading it runs native code:
never point ``aot_cache`` / ``FNN_AOT_CACHE`` at a shared or
world-writable directory.
"""
import hashlib
import logging
import os
from typing import Optional, Sequence

import torch

from ..models import blocks as _blocks  # noqa: F401  (the norm ops)
from ..models import s2d as _s2d  # noqa: F401
from ..ops import _build

logger = logging.getLogger(__name__)

__all__ = ["aot_compile", "compile_package", "export_program", "load_package",
           "program_key"]

#: Inductor settings of every package (see the module docstring); the
#: last two only shorten the compile (no autotuning of pointwise kernels'
#: launch configurations, the host wrapper built without optimisation)
INDUCTOR_CONFIGS = {"layout_optimization": False,
                    "emulate_precision_casts": True,
                    "triton.autotune_pointwise": False,
                    "aot_inductor.compile_wrapper_opt_level": "O0"}


def _inductor_configs() -> dict:
    """:data:`INDUCTOR_CONFIGS` less the keys this torch's Inductor does
    not have, and the host compiler of ``ops._build.torch_cxx``."""
    from torch._inductor import config
    out = {}
    for key, value in INDUCTOR_CONFIGS.items():
        obj = config
        try:
            for part in key.split("."):
                obj = getattr(obj, part)
        except AttributeError:
            continue
        out[key] = value
    out["cpp.cxx"] = _build.torch_cxx()
    return out


def _describe(v) -> str:
    if isinstance(v, torch.Tensor):
        return f"{tuple(v.shape)}:{tuple(v.stride())}:{v.dtype}:{v.device}"
    if isinstance(v, (list, tuple)):
        return "(" + ",".join(_describe(x) for x in v) + ")"
    return repr(v) if isinstance(v, (int, float, bool, type(None))) \
        else type(v).__name__


def _graph_text(exported) -> str:
    """One line per node: its op, target and arguments, nodes named by
    their position (a renamed argument or function keeps the text), and
    the shape/stride/dtype/device of its value; no stack traces, no source
    locations. Inputs are named by position too: the weights' names and
    values enter the key through the constants digest."""
    pos = {}
    lines = []
    for i, n in enumerate(exported.graph.nodes):
        pos[n] = i
        args, kwargs = torch.fx.node.map_arg((n.args, n.kwargs),
                                             lambda m: f"%{pos[m]}")
        target = "" if n.op == "placeholder" else str(n.target)
        lines.append(f"{i} {n.op} {target} {args} {kwargs} :: "
                     f"{_describe(n.meta.get('val'))}")
    return "\n".join(lines)


def _constants_digest(exported) -> str:
    h = hashlib.sha256()
    tensors = dict(exported.state_dict)
    tensors.update({k: v for k, v in exported.constants.items()
                    if isinstance(v, torch.Tensor)})
    for name in sorted(tensors):
        t = tensors[name].detach()
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype}".encode())
        h.update(t.reshape(-1).contiguous().cpu().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _device_fingerprint() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return str((torch.cuda.get_device_name(0),
                torch.cuda.get_device_capability(0),
                torch.cuda.device_count()))


def program_key(exported, extra: str = "") -> str:
    """Stable content hash of an exported program, its constants and the
    runtime (torch version, card)."""
    h = hashlib.sha256()
    h.update(_graph_text(exported).encode())
    h.update(torch.__version__.encode())
    h.update(_device_fingerprint().encode())
    h.update(extra.encode())
    h.update(repr(sorted(INDUCTOR_CONFIGS.items())).encode())
    h.update(_constants_digest(exported).encode())
    return h.hexdigest()[:32]


def export_program(module: torch.nn.Module, example_args: Sequence):
    """``torch.export`` of ``module`` at ``example_args``, without grad."""
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args))


def load_package(path: str):
    from torch._inductor import aoti_load_package
    return aoti_load_package(path)


def compile_package(exported, path: str) -> str:
    """AOTInductor-compile ``exported`` into the package ``path`` through a
    temporary file with this process's pid; raises when the compile
    fails."""
    from torch._inductor import aoti_compile_and_package
    tmp = f"{os.path.splitext(path)[0]}.tmp{os.getpid()}.pt2"
    try:
        with torch.no_grad():
            aoti_compile_and_package(exported, package_path=tmp,
                                     inductor_configs=_inductor_configs())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def aot_compile(module: torch.nn.Module, example_args: Sequence,
                cache_dir: Optional[str], tag: str = "prog",
                extra: str = ""):
    """``module`` compiled for ``example_args`` through the package cache in
    ``cache_dir``; returns a callable taking the same positional tensors.
    ``cache_dir=None`` (or empty) returns ``module`` itself: eager, nothing
    compiled."""
    if not cache_dir:
        return module
    os.makedirs(cache_dir, mode=0o700, exist_ok=True)
    exported = export_program(module, example_args)
    key = program_key(exported, extra)
    path = os.path.join(cache_dir, f"{tag}-{key}.pt2")
    if os.path.exists(path):
        try:
            loaded = load_package(path)
            logger.info("aot: loaded %s (%d MB, no compile)", path,
                        os.path.getsize(path) >> 20)
            return loaded
        except Exception as e:  # noqa: BLE001 - stale or corrupt package
            logger.warning("aot: load of %s failed (%r); recompiling",
                           path, e)
    compile_package(exported, path)
    logger.info("aot: compiled %s (%d MB)", path, os.path.getsize(path) >> 20)
    return load_package(path)
