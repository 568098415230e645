"""The plain reference of the serving path, in float32, and the judgement of
a served mask against it.

What the configuration states, worked out again from the raw CT and the
plain weights: the axes put in engine order (sorted by patch extent), the
CT window clipped and z-scored, a trilinear resize (half-pixel centres,
edges clamped) to the target spacing, the sweep's tile grid (tight even
extents, nnU-Net's starts rounded down to even, the in-plane pad filled
with the normalised air value), the air rule over the bfloat16 input, the
plain network on every tile that holds body, gaussian-weighted averaging
of the tiles' logits, and the nearest revert to the original grid.

The judgement: at every voxel of the original grid, the gap by which the
reference's logit of the served label lies below the reference's best
logit there (0 where the served label is the reference's argmax); the
widest gap over the CT is compared. Where no body tile covers a voxel,
the served label must be 0 (the program's argmax of an empty
accumulator), and every label must be a class: both counted exactly.
"""
import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter

from ..harness import grid
from .unet import PlainUNet

TILE_BATCH = 4


def gaussian(patch) -> np.ndarray:
    """nnU-Net's importance map: an impulse filtered with sigma = patch / 8,
    scaled to a maximum of 1, its zeros raised to the smallest value."""
    tmp = np.zeros(patch)
    tmp[tuple(p // 2 for p in patch)] = 1
    g = gaussian_filter(tmp, [p / 8 for p in patch], 0, mode="constant",
                        cval=0)
    g = (g / g.max()).astype(np.float32)
    g[g == 0] = g[g != 0].min()
    return g


def _bf16(v: float) -> float:
    return torch.tensor(v, dtype=torch.bfloat16).item()


def geometry(cfg: dict, ct_shape, spacing):
    """(tf, in_shape_e, new_shape_e, vol_shape, steps) in engine order."""
    sv = cfg["serving"]
    tf = grid.transpose_forward(sv["patch_size"])
    patch = [sv["patch_size"][a] for a in tf]
    in_e = tuple(int(ct_shape[a]) for a in tf)
    new_e = grid.target_shape(in_e, [spacing[a] for a in tf],
                              [sv["target_spacing"][a] for a in tf], patch)
    vol_shape, steps = grid.sweep_plan(new_e, patch, sv["step_size"])
    return tf, in_e, new_e, vol_shape, steps


def preprocess(cfg: dict, ct: np.ndarray, spacing, device):
    """(f32 padded sweep volume (X, Y, Z), geometry, fill, threshold)."""
    sv = cfg["serving"]
    nm = sv["normalization"]
    tf, in_e, new_e, vol_shape, steps = geometry(cfg, ct.shape, spacing)
    raw = torch.from_numpy(np.ascontiguousarray(ct)).to(device)
    x = raw.permute(*tf).float()
    x = (x.clamp(nm["lower_bound"], nm["upper_bound"]) - nm["mean"]) \
        / max(nm["std"], 1e-8)
    x = F.interpolate(x[None, None], size=tuple(new_e), mode="trilinear",
                      align_corners=False)[0, 0]
    fill = (nm["lower_bound"] - nm["mean"]) / max(nm["std"], 1e-8)
    vol = torch.full(vol_shape, fill, dtype=torch.float32, device=device)
    vol[:new_e[0], :new_e[1], :new_e[2]] = x
    thr = (min(nm["lower_bound"] + sv["air_margin_hu"], nm["upper_bound"])
           - nm["mean"]) / nm["std"]
    return vol, (tf, in_e, new_e, vol_shape, steps), fill, thr


def body_tiles(cfg: dict, vol: torch.Tensor, geo, fill: float, thr: float):
    """The air rule on the bfloat16 input: (flags (n_chunks, nb, B) bool,
    coords (nb, B, 2), valid (nb, B)); padding slots are never body."""
    sv = cfg["serving"]
    tf, _, _, vol_shape, steps = geo
    patch = [sv["patch_size"][a] for a in tf]
    vb = vol.to(torch.bfloat16).float()
    fb = _bf16(fill)
    X, Y, Z = vol_shape
    by, bz = grid.round_up(Y, 8), grid.round_up(Z, 8)
    p = F.pad(vb, (0, bz - Z, 0, by - Y), value=fb)
    rowmax = p.reshape(X, by // 8, 8, bz // 8, 8).amax(dim=(2, 4)) \
        .cpu().numpy()
    coords, valid = grid.plane_batches(steps, sv["tile_batch"])
    flags = grid.flags_from_rowmax(rowmax, steps[0], coords, patch, fb,
                                   _bf16(thr))
    if not sv.get("skip_air_tiles", True):
        flags[:] = True
    return flags & (valid[None] > 0), coords, valid


def logits(cfg: dict, ct: np.ndarray, spacing, tree: dict, device,
           quant: bool = False):
    """The reference's gaussian-averaged logits on the target grid (K,
    *new_e) float32, the mask of covered voxels, and the geometry."""
    sv = cfg["serving"]
    vol, geo, fill, thr = preprocess(cfg, ct, spacing, device)
    flags, coords, _ = body_tiles(cfg, vol, geo, fill, thr)
    tf, _, new_e, vol_shape, steps = geo
    p0, py, pz = [sv["patch_size"][a] for a in tf]
    K = cfg["num_classes"]
    net = PlainUNet(cfg["network"], tree, quant=quant)
    g = torch.from_numpy(gaussian((p0, py, pz))).to(device) \
        if sv.get("use_gaussian", True) else \
        torch.ones((p0, py, pz), device=device)
    acc = torch.zeros((K,) + tuple(vol_shape), dtype=torch.float32,
                      device=device)
    wsum = torch.zeros(vol_shape, dtype=torch.float32, device=device)
    tiles = [(x0, int(y), int(z))
             for k, x0 in enumerate(steps[0])
             for b in range(coords.shape[0]) for t in range(coords.shape[1])
             if flags[k, b, t]
             for y, z in [coords[b, t]]]
    tiles = sorted(set(tiles))
    with torch.no_grad():
        for i in range(0, len(tiles), TILE_BATCH):
            part = tiles[i:i + TILE_BATCH]
            x = torch.stack([vol[x0:x0 + p0, y:y + py, z:z + pz]
                             for x0, y, z in part])[:, None]
            out = net(x)
            for (x0, y, z), o in zip(part, out):
                sl = (slice(x0, x0 + p0), slice(y, y + py), slice(z, z + pz))
                acc[(slice(None),) + sl] += o * g
                wsum[sl] += g
    nx, ny, nz = new_e
    acc = acc[:, :nx, :ny, :nz]
    wsum = wsum[:nx, :ny, :nz]
    covered = wsum > 0
    acc /= torch.where(covered, wsum, torch.ones_like(wsum))
    return acc, covered, geo


def nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """Per axis, the target index of each original voxel: floor((i + 0.5)
    * n_target / n_original) in float32."""
    i = np.arange(n_out, dtype=np.float32)
    idx = np.floor((i + np.float32(0.5)) * np.float32(n_in)
                   / np.float32(n_out)).astype(np.int64)
    return torch.from_numpy(idx).to(device)


def judge(L: torch.Tensor, covered: torch.Tensor, geo, mask: np.ndarray,
          rows: int = 8) -> dict:
    """The served mask (original grid, image order) against the reference
    logits: {"gap": widest gap (logit units), "exact_mismatch": voxels
    with no body tile whose label is not 0 and voxels whose label is no
    class, "disagree": share of voxels whose label is not the reference's
    argmax}."""
    tf, in_e, new_e, _, _ = geo
    dev = L.device
    m = torch.from_numpy(np.ascontiguousarray(mask)).to(dev).permute(*tf)
    if tuple(m.shape) != tuple(in_e):
        raise ValueError(f"mask {tuple(mask.shape)} does not fit the CT")
    idx = [nearest_index(n, o, dev) for n, o in zip(new_e, in_e)]
    best = L.amax(0)
    arg = L.argmax(0)
    gap, air_bad, disagree = 0.0, 0, 0
    for r0 in range(0, in_e[0], rows):
        i0 = idx[0][r0:r0 + rows]
        mm = m[r0:r0 + rows].long()
        bad = mm >= L.shape[0]
        air_bad += int(bad.sum())
        mm = torch.where(bad, torch.zeros_like(mm), mm)
        sel = (i0[:, None, None], idx[1][None, :, None], idx[2][None, None, :])
        Lr = L[(slice(None),) + sel]                     # (K, r, Y, Z)
        cov = covered[sel]
        picked = Lr.gather(0, mm[None]).squeeze(0)
        g = torch.where(cov, best[sel] - picked, torch.zeros_like(picked))
        gap = max(gap, float(g.max()))
        air_bad += int(((~cov) & (mm != 0)).sum())
        disagree += int((cov & (mm != arg[sel])).sum())
    return {"gap": gap, "exact_mismatch": air_bad,
            "disagree": disagree / float(np.prod(in_e))}


def served_like(L: torch.Tensor, covered: torch.Tensor, geo) -> np.ndarray:
    """A mask from logits as the configuration serves it (argmax, 0 where
    nothing is covered, the nearest revert, image order): what the control
    hands to :func:`judge` in the program's place."""
    tf, in_e, new_e, _, _ = geo
    dev = L.device
    lab = torch.where(covered, L.argmax(0),
                      torch.zeros_like(covered, dtype=torch.long))
    idx = [nearest_index(n, o, dev) for n, o in zip(new_e, in_e)]
    out = lab[idx[0][:, None, None], idx[1][None, :, None],
              idx[2][None, None, :]].to(torch.uint8)
    inv = list(np.argsort(tf))
    return out.permute(*inv).contiguous().cpu().numpy()
