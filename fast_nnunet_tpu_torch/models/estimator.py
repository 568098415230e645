"""Analytic feature-map-size estimator for the planner's memory budget — a
copy of fast_nnunet_tpu/models/estimator.py. The reference nnU-Net builds a
network per candidate patch size and calls
``compute_conv_feature_map_size``; this is a pure function of the
architecture with the same accounting, so the planner's shrink loop and
its plans come out the same.

Accounting (dynamic_network_architectures'):
- each conv block contributes prod(out_channels, *size_after_stride)
- residual BasicBlockD contributes 2 conv outputs + a skip-conv output when
  the block strides or changes channels
- decoder: transpconv output + conv stack + seg head (heads counted at every
  stage with deep supervision, else only at the last)
"""
from typing import Sequence

import numpy as np


def _div(size, stride):
    return [i // j for i, j in zip(size, stride)]


def _prod(channels, size) -> int:
    return int(np.prod([channels, *size], dtype=np.int64))


def stacked_conv_blocks_fmap(n_convs: int, features: int, input_size, initial_stride) -> int:
    out = _prod(features, _div(input_size, initial_stride))
    size_after = _div(input_size, initial_stride)
    for _ in range(n_convs - 1):
        out += _prod(features, size_after)
    return out


def plain_conv_encoder_fmap(input_size, features_per_stage, strides, n_conv_per_stage) -> int:
    out = 0
    size = list(input_size)
    for s in range(len(features_per_stage)):
        out += stacked_conv_blocks_fmap(n_conv_per_stage[s], features_per_stage[s],
                                        size, strides[s])
        size = _div(size, strides[s])
    return out


def residual_encoder_fmap(input_size, features_per_stage, strides, n_blocks_per_stage) -> int:
    # stem: one conv to features[0] at full res
    out = _prod(features_per_stage[0], input_size)
    size = list(input_size)
    prev_features = features_per_stage[0]
    for s in range(len(features_per_stage)):
        for b in range(n_blocks_per_stage[s]):
            stride = strides[s] if b == 0 else [1] * len(size)
            size_after = _div(size, stride)
            block = 2 * _prod(features_per_stage[s], size_after)
            needs_skip = (any(st != 1 for st in stride)
                          or prev_features != features_per_stage[s])
            if needs_skip:
                block += _prod(features_per_stage[s], size_after)
            out += block
            size = size_after
            prev_features = features_per_stage[s]
    return out


def unet_decoder_fmap(input_size, features_per_stage, strides, n_conv_per_stage_decoder,
                      num_classes, deep_supervision: bool = True) -> int:
    n_stages = len(features_per_stage)
    skip_sizes = []
    size = list(input_size)
    for s in range(n_stages - 1):
        skip_sizes.append(_div(size, strides[s]))
        size = skip_sizes[-1]
    out = 0
    n_dec = n_stages - 1
    for s in range(n_dec):
        stage_size = skip_sizes[-(s + 1)]
        features_skip = features_per_stage[-(s + 2)]
        # transpconv output
        out += _prod(features_skip, stage_size)
        # conv stack (stride 1)
        out += stacked_conv_blocks_fmap(n_conv_per_stage_decoder[s], features_skip,
                                        stage_size, [1] * len(stage_size))
        if deep_supervision or s == n_dec - 1:
            out += _prod(num_classes, stage_size)
    return out


def compute_conv_feature_map_size(arch_class_name: str, arch_kwargs: dict,
                                  patch_size: Sequence[int], num_classes: int,
                                  deep_supervision: bool = True) -> int:
    """Dispatch on architecture class (accepts the reference's
    dynamic_network_architectures dotted names and our own)."""
    dim = len(patch_size)
    strides = [list(s) if not np.isscalar(s) else [s] * dim
               for s in arch_kwargs["strides"]]
    features = list(arch_kwargs["features_per_stage"])
    short = arch_class_name.rsplit(".", 1)[-1]
    if short in ("PlainConvUNet", "LiteNNUNetStudent"):
        enc = plain_conv_encoder_fmap(patch_size, features, strides,
                                      arch_kwargs["n_conv_per_stage"])
    elif short in ("ResidualEncoderUNet", "LiteResEncStudent"):
        enc = residual_encoder_fmap(patch_size, features, strides,
                                    arch_kwargs["n_blocks_per_stage"])
    else:
        raise ValueError(f"No feature-map estimator for architecture {arch_class_name}")
    dec = unet_decoder_fmap(patch_size, features, strides,
                            arch_kwargs["n_conv_per_stage_decoder"], num_classes,
                            deep_supervision)
    return enc + dec
