"""Reference PyTorch checkpoints (``.pth``) into the port's networks — the
counterpart of fast_nnunet_tpu/utils/torch_import.py.

The reference stores a torch ``state_dict`` under
``checkpoint['network_weights']`` with dynamic-network-architectures module
names, and its pretraining loader matches entries by name and shape,
skipping ``.seg_layers.`` for transfer learning
(nnunetv2/run/load_pretrained_weights.py). :func:`translate_torch_key` maps
those names onto the JAX package's tree paths with JAX's seven patterns
(``encoder.stages.{s}.convs.{b}.conv`` -> ``encoder/stage_{s}/block_{b}/
conv``, ``decoder.transpconvs.{s}`` -> ``decoder/transpconv_{s}``,
``decoder.seg_layers.{s}`` -> ``decoder/seg_head_{s}``, the residual
encoder's stem, blocks and skip projections); ``models/unet.jax_param_paths``
maps the same paths onto the port's parameters. The port's modules are
torch modules, so a tensor loads in its own layout: convs ``(O, I, *k)``,
transposed convs ``(I, O, *k)`` (the JAX package transposes and mirrors
these into flax's layout; the port's transposed conv applies the reference
tensor as torch does). InstanceNorm ``weight`` is the flax ``scale``.
"""
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.unet import jax_param_paths, to_flax_layout

__all__ = ["translate_torch_key", "import_torch_weights",
           "load_torch_network_weights"]

_PATTERNS = [
    # plain encoder/decoder conv blocks; an extra Sequential index is
    # tolerated (pooling variants wrap StackedConvBlocks in nn.Sequential)
    (re.compile(r"^(encoder|decoder)\.stages\.(\d+)\.(?:\d+\.)?convs\.(\d+)\."
                r"(conv|norm)\.(weight|bias)$"),
     lambda m: (m.group(1), f"stage_{m.group(2)}", f"block_{m.group(3)}",
                m.group(4), _wb(m.group(4), m.group(5)))),
    # residual encoder stem (StackedConvBlocks with a single conv)
    (re.compile(r"^encoder\.stem\.convs\.0\.(conv|norm)\.(weight|bias)$"),
     lambda m: ("encoder", "stem", m.group(1), _wb(m.group(1), m.group(2)))),
    # residual blocks: conv1/conv2 are ConvDropoutNormReLU submodules
    (re.compile(r"^encoder\.stages\.(\d+)\.(?:\d+\.)?blocks\.(\d+)\."
                r"conv(\d)\.(conv|norm)\.(weight|bias)$"),
     lambda m: ("encoder", f"stage_{m.group(1)}_block_{m.group(2)}",
                f"{m.group(4)}{m.group(3)}", _wb(m.group(4), m.group(5)))),
    # residual blocks: conv1/conv2 as raw convs + norm1/norm2
    (re.compile(r"^encoder\.stages\.(\d+)\.(?:\d+\.)?blocks\.(\d+)\."
                r"(conv|norm)(\d)\.(weight|bias)$"),
     lambda m: ("encoder", f"stage_{m.group(1)}_block_{m.group(2)}",
                f"{m.group(3)}{m.group(4)}", _wb(m.group(3), m.group(5)))),
    # residual skip projection: Sequential(conv 1x1, norm)
    (re.compile(r"^encoder\.stages\.(\d+)\.(?:\d+\.)?blocks\.(\d+)\."
                r"(?:skip|downsample_skip)\.(\d)\.(weight|bias)$"),
     lambda m: ("encoder", f"stage_{m.group(1)}_block_{m.group(2)}",
                "skip_conv" if m.group(3) == "0" else "skip_norm",
                _wb("conv" if m.group(3) == "0" else "norm", m.group(4)))),
    # decoder transposed convolutions
    (re.compile(r"^decoder\.transpconvs\.(\d+)\.(weight|bias)$"),
     lambda m: ("decoder", f"transpconv_{m.group(1)}",
                "kernel" if m.group(2) == "weight" else "bias")),
    # segmentation heads (1x1 convs)
    (re.compile(r"^decoder\.seg_layers\.(\d+)\.(weight|bias)$"),
     lambda m: ("decoder", f"seg_head_{m.group(1)}",
                "kernel" if m.group(2) == "weight" else "bias")),
]


def _wb(module: str, leaf: str) -> str:
    """torch leaf name -> flax leaf name for a conv or norm submodule."""
    if module == "conv":
        return "kernel" if leaf == "weight" else "bias"
    return "scale" if leaf == "weight" else "bias"


def translate_torch_key(key: str) -> Optional[Tuple[str, ...]]:
    """A reference state_dict key -> the JAX package's path under
    ``params`` (None if no pattern matches). DDP (``module.``) and
    torch.compile (``_orig_mod.``) prefixes are stripped."""
    for prefix in ("module.", "_orig_mod."):
        if key.startswith(prefix):
            key = key[len(prefix):]
    for pat, build in _PATTERNS:
        m = pat.match(key)
        if m:
            return build(m)
    return None


def load_torch_network_weights(fname: str) -> Dict[str, Any]:
    """A reference ``.pth`` file's ``network_weights`` (or the file itself
    when it is a bare state_dict). Read with ``weights_only=True``; a
    trainer checkpoint whose other entries need more (numpy scalars in its
    log, say) is read as the reference reads it, after a warning."""
    try:
        ckpt = torch.load(fname, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        print(f"{fname}: not loadable with weights_only=True "
              f"({str(e).splitlines()[0]}); loading it in full, as the "
              "reference does: load only checkpoints you trust")
        ckpt = torch.load(fname, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "network_weights" in ckpt:
        return ckpt["network_weights"]
    return ckpt


def import_torch_weights(net: nn.Module, state_dict,
                         skip_seg_layers: bool = False
                         ) -> Tuple[nn.Module, dict]:
    """Copy a reference state_dict into ``net`` in place. Matching is by
    translated name AND shape, like the reference's pretraining loader;
    ``skip_seg_layers=True`` leaves the seg heads as they are. Returns
    ``(net, report)``; the report has the JAX package's five lists
    (``converted``, ``skipped_seg``, ``unmatched``, ``shape_mismatch`` with
    flax-layout shapes, ``missing_in_template``). Norm running statistics
    are skipped, as there."""
    target = {path: (prm, kind) for path, prm, kind in jax_param_paths(net)}
    report = {"converted": [], "skipped_seg": [], "unmatched": [],
              "shape_mismatch": [], "missing_in_template": []}
    for key, tensor in state_dict.items():
        if skip_seg_layers and ".seg_layers." in key:
            report["skipped_seg"].append(key)
            continue
        path = translate_torch_key(key)
        if path is None:
            if key.endswith("num_batches_tracked") or ".running_" in key:
                continue
            report["unmatched"].append(key)
            continue
        if ("params",) + path not in target:
            report["missing_in_template"].append(key)
            continue
        prm, kind = target[("params",) + path]
        arr = np.asarray(tensor.detach().cpu().float().numpy()
                         if torch.is_tensor(tensor) else tensor, np.float32)
        if arr.shape != tuple(prm.shape):
            report["shape_mismatch"].append(
                (key, to_flax_layout(kind, arr).shape,
                 to_flax_layout(kind, np.empty(tuple(prm.shape),
                                               np.float32)).shape))
            continue
        with torch.no_grad():
            prm.copy_(torch.from_numpy(arr))
        report["converted"].append(key)
    return net, report
