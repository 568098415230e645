"""Network topology from spacing and patch size — a copy of
fast_nnunet_tpu/planning/topology.py, the reference nnU-Net's rule
(experiment_planning/experiment_planners/network_topology.py): an axis pools
while its current size is >= 2 * min_feature_map_size, its current spacing
is within 2x of the finest poolable spacing and it has pooled fewer than
max_numpool times; a lone poolable axis also needs >= 3 *
min_feature_map_size. Kernels start at 1 and open to 3 for good once the
axis spacing is within 2x of the finest."""
from typing import List, Sequence, Tuple

import numpy as np


def shape_divisible_by(num_pool_per_axis: Sequence[int]) -> np.ndarray:
    return 2 ** np.asarray(num_pool_per_axis)


def pad_shape_to_divisible(shape: Sequence[int], divisors: Sequence[int]) -> np.ndarray:
    """Round each axis UP to the next multiple of its divisor (no-op when already
    divisible)."""
    shape = np.asarray(shape)
    divisors = np.asarray(divisors)
    remainder = shape % divisors
    return (shape + np.where(remainder > 0, divisors - remainder, 0)).astype(int)


def get_pool_and_conv_props(spacing: Sequence[float], patch_size: Sequence[int],
                            min_feature_map_size: int, max_numpool: int
                            ) -> Tuple[List[int], Tuple, Tuple, Tuple, np.ndarray]:
    """Returns (num_pool_per_axis, pool_op_kernel_sizes (=strides per stage,
    leading [1]*dim), conv_kernel_sizes (one per stage incl. bottleneck),
    padded patch_size, shape_must_be_divisible_by)."""
    dim = len(spacing)
    cur_spacing = [float(s) for s in spacing]
    cur_size = [int(p) for p in patch_size]

    strides: List[List[int]] = [[1] * dim]
    kernels: List[List[int]] = []
    num_pool_per_axis = [0] * dim
    kernel_now = [1] * dim

    while True:
        big_enough = [a for a in range(dim) if cur_size[a] >= 2 * min_feature_map_size]
        if not big_enough:
            break
        finest = min(cur_spacing[a] for a in big_enough)
        poolable = [a for a in big_enough
                    if cur_spacing[a] / finest < 2 and num_pool_per_axis[a] < max_numpool]
        if len(poolable) == 1 and cur_size[poolable[0]] < 3 * min_feature_map_size:
            break
        if not poolable:
            break

        # kernels open to 3 (and stay 3) once the axis is near-isotropic
        overall_finest = min(cur_spacing)
        for a in range(dim):
            if kernel_now[a] == 1 and cur_spacing[a] / overall_finest < 2:
                kernel_now[a] = 3

        stride = [1] * dim
        for a in poolable:
            stride[a] = 2
            num_pool_per_axis[a] += 1
            cur_spacing[a] *= 2
            cur_size[a] = int(np.ceil(cur_size[a] / 2))
        strides.append(stride)
        kernels.append(list(kernel_now))

    divisors = shape_divisible_by(num_pool_per_axis)
    padded_patch = pad_shape_to_divisible(patch_size, divisors)
    kernels.append([3] * dim)  # bottleneck stage always 3

    to_tuple = lambda lst: tuple(tuple(x) for x in lst)  # noqa: E731
    return (num_pool_per_axis, to_tuple(strides), to_tuple(kernels),
            tuple(int(p) for p in padded_patch), divisors)
