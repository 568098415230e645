"""TurboPipeline — end-to-end serving on the card (read -> preprocess ->
s2d sweep -> revert -> write): the port of
fast_nnunet_tpu/inference/turbo.py on its device-preprocess route.

Per call, on the device:

1. the raw volume is uploaded once, from a pinned staging buffer;
2. the plans transpose, the per-channel normalization (CT clip + z-score,
   z-score, rescale-to-01, rgb/255, none), a trilinear resize to the target
   spacing (half-pixel centres, edge samples clamped — the same map as
   ``jax.image.resize(..., "trilinear", antialias=False)``), the cast to the
   compute dtype and the pad to the sweep layout (with ``_fill_f64``);
3. the air flags of every chunk's tile batches in one pass (an exact
   x-extent 8^3 block-max test, the streamed JAX route's semantics), fetched
   with one copy, so whole-air batches are skipped without a sync per batch;
4. the s2d rolling sweep (inference/engine.py; kernels A, B and C);
5. the nearest revert to the original grid (the index map of
   ``jax.image.resize(method="nearest")``) and the inverse transpose,
   then one D2H copy of the uint8 mask.

Not ported yet: the C++ host preprocess and strip streaming
(``host_preprocess=True``), the host revert with 6-bit packing
(``host_revert=True``) and fold ensembles; each raises
``NotImplementedError``.
"""
import argparse
import configparser
import os
import re
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..imageio.nifti import NiftiIOWithReorient


def _parse_tuple(s: str) -> Tuple[float, ...]:
    return tuple(float(x) for x in re.split(r"[x,()\s]+", str(s).strip()) if x)


#: device-path normalization schemes (class name -> short scheme tag)
_SCHEME_TAGS = {
    "CTNormalization": "ct",
    "ZScoreNormalization": "zscore",
    "NoNormalization": "nonorm",
    "RescaleTo01Normalization": "rescale01",
    "RGBTo01Normalization": "rgb01",
}


class TurboConfig:
    """bone_turbo-style deployment point (the engine INI's schema), a copy
    of fast_nnunet_tpu.inference.turbo.TurboConfig.

    The INI patch order is image axis order; the engine's chunk axis (axis
    0) carries the smallest patch extent, so the patch and spacing are
    transposed with the largest extent last. Multi-channel inputs carry a
    per-channel ``channels`` list of scheme dicts
    (``{"scheme": "ct", "mean", "std", "lower_bound", "upper_bound"}`` or
    ``{"scheme": "zscore" | "rescale01" | "rgb01" | "nonorm"}``)."""

    def __init__(self, patch_size: Sequence[int],
                 target_spacing: Sequence[float],
                 mean: float = 0.0, std: float = 1.0,
                 lower_bound: float = -1024.0, upper_bound: float = 3071.0,
                 num_classes: int = 2,
                 step_size: float = 0.5, use_gaussian: bool = True,
                 channels: Optional[Sequence[dict]] = None):
        self.patch_size_image = tuple(int(p) for p in patch_size)
        self.transpose_forward = sorted(
            range(len(patch_size)), key=lambda a: self.patch_size_image[a])
        self.transpose_backward = list(np.argsort(self.transpose_forward))
        self.patch_size = tuple(self.patch_size_image[a]
                                for a in self.transpose_forward)
        self.target_spacing_image = tuple(float(s) for s in target_spacing)
        self.target_spacing = tuple(self.target_spacing_image[a]
                                    for a in self.transpose_forward)
        self.mean = float(mean)
        self.std = float(std)
        self.lower_bound = float(lower_bound)
        self.upper_bound = float(upper_bound)
        self.num_classes = int(num_classes)
        self.step_size = float(step_size)
        self.use_gaussian = bool(use_gaussian)
        if channels is None:
            channels = [{"scheme": "ct", "mean": self.mean, "std": self.std,
                         "lower_bound": self.lower_bound,
                         "upper_bound": self.upper_bound}]
        self.channels = [dict(c) for c in channels]
        for c in self.channels:
            if c.get("scheme") not in ("ct", "zscore", "rescale01", "rgb01",
                                       "nonorm"):
                raise ValueError(f"unknown normalization scheme in {c}")

    @property
    def num_input_channels(self) -> int:
        return len(self.channels)

    @classmethod
    def from_ini(cls, path: str) -> "TurboConfig":
        cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        if not cp.read(path):
            raise FileNotFoundError(path)
        pre = cp["preprocessing"]
        return cls(
            patch_size=[int(x) for x in _parse_tuple(cp["input"]["patch_size"])],
            target_spacing=_parse_tuple(cp["input"]["target_spacing"]),
            mean=float(pre["mean"]),
            std=float(pre.get("std", pre.get("std_dev", "1.0"))),
            lower_bound=float(pre["lower_bound"]),
            upper_bound=float(pre["upper_bound"]),
            num_classes=int(cp["model"]["num_class"]),
            step_size=float(cp["inference"].get("step_size", 0.5)),
            use_gaussian=cp["inference"].getboolean("use_gaussian", True))


def _fill_f64(spec) -> float:
    """Sweep-pad value in normalized units (python-float arithmetic): the
    HU clip floor for CT (air), 0 for the statistic-based schemes."""
    if spec["scheme"] == "ct":
        return (spec["lower_bound"] - spec["mean"]) / max(spec["std"], 1e-8)
    return 0.0


def _f32_to_bf16_bits(f: np.float32) -> int:
    """Round-to-nearest-even float32 -> bfloat16 bit pattern (finite input)."""
    bits = int(np.asarray(f, np.float32).view(np.uint32))
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) & 0xFFFF


def _fill_bf16_bits(spec) -> int:
    """The CT fill value's exact bfloat16 bit pattern: f32 arithmetic
    (lb - mean) * (1 / max(std, eps)), rounded to nearest-even bf16 — the
    host preprocess's fill (engine/src/host_ops.cpp), computed without
    ml_dtypes."""
    inv = np.float32(1.0) / np.maximum(np.float32(spec["std"]),
                                       np.float32(1e-8))
    f = (np.float32(spec["lower_bound"]) - np.float32(spec["mean"])) * inv
    return _f32_to_bf16_bits(np.float32(f))


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """jax.image.resize(method="nearest")'s per-axis source index:
    floor((i + 0.5) * in / out) in float32."""
    return np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                    * np.float32(n_in) / np.float32(n_out)).astype(np.int64)


def _nearest_revert_host(seg: np.ndarray, out_shape) -> np.ndarray:
    """Nearest-neighbor resize on the host, voxel-for-voxel equal to
    jax.image.resize(method="nearest")."""
    idx = [_nearest_index(m, n) for m, n in zip(seg.shape, out_shape)]
    return seg[np.ix_(*idx)]


def resize_nearest(x: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """Device nearest resize of the trailing len(out_shape) axes with the
    index map of :func:`_nearest_revert_host`."""
    lead = x.dim() - len(out_shape)
    for ax, n in enumerate(out_shape):
        m = x.shape[lead + ax]
        if m != n:
            idx = torch.as_tensor(_nearest_index(m, n), device=x.device)
            x = x.index_select(lead + ax, idx)
    return x


def resize_trilinear(x: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """(C, D, H, W) float -> (C, *out_shape): linear interpolation with
    half-pixel centres, edge samples clamped, no antialiasing — the sample
    map of jax.image.resize(..., "trilinear", antialias=False)."""
    return F.interpolate(x[None], size=tuple(int(s) for s in out_shape),
                         mode="trilinear", align_corners=False)[0]


def _normalize(xc: torch.Tensor, spec: dict) -> torch.Tensor:
    """One channel, float32 (mirrors the JAX device program)."""
    s = spec["scheme"]
    if s == "ct":
        xc = torch.clamp(xc, spec["lower_bound"], spec["upper_bound"])
        return (xc - spec["mean"]) / max(spec["std"], 1e-8)
    if s == "zscore":
        return (xc - xc.mean()) / torch.clamp(xc.std(correction=0), min=1e-8)
    if s == "rescale01":
        xc = xc - xc.min()
        return xc / torch.clamp(xc.max(), min=1e-8)
    if s == "rgb01":
        return xc / 255.0
    return xc  # nonorm


def air_flags(x: torch.Tensor, starts_x: Sequence[int], patch: Sequence[int],
              coords_b: np.ndarray, fill: float, threshold: float
              ) -> np.ndarray:
    """Per (chunk, batch, slot) "tile holds body" flags for the whole sweep,
    computed on the device in one pass and fetched with one copy.

    x: channel 0 of the padded sweep volume (X, Yp, Zp), compute dtype.
    A tile of chunk k is body when the maximum over its chunk's exact x
    extent [x0, x0 + p0) and the 8^3 blocks its in-plane window touches
    exceeds ``threshold`` (compared in x's dtype); partial blocks are padded
    with the air ``fill`` so they never hide body voxels. Returns
    (n_chunks, nb, B) float32 0/1."""
    p0, py, pz = (int(p) for p in patch)
    X, Yp, Zp = x.shape
    fill_t = torch.tensor(fill, dtype=x.dtype).item()
    thr_t = torch.tensor(threshold, dtype=x.dtype).item()
    by, bz = -(-Yp // 8) * 8, -(-Zp // 8) * 8
    xf = F.pad(x.float(), (0, bz - Zp, 0, by - Yp), value=fill_t)
    rowmax = xf.reshape(X, by // 8, 8, bz // 8, 8).amax(dim=(2, 4))
    blocks = torch.stack([rowmax[x0:x0 + p0].amax(0) for x0 in starts_x])
    if p0 % 8:
        blocks = torch.clamp(blocks, min=fill_t)  # the fill-padded x block
    wy, wz = py // 8 + 1, pz // 8 + 1
    boxmax = F.max_pool2d(
        F.pad(blocks[:, None], (0, wz - 1, 0, wy - 1), value=float("-inf")),
        (wy, wz), stride=1)[:, 0]
    flat = coords_b.reshape(-1, 3)
    yi = torch.as_tensor(flat[:, 1] // 8, device=x.device, dtype=torch.long)
    zi = torch.as_tensor(flat[:, 2] // 8, device=x.device, dtype=torch.long)
    flags = (boxmax[:, yi, zi] > thr_t).cpu().numpy()
    return flags.reshape(len(starts_x), *coords_b.shape[:2]).astype(np.float32)


class TurboPipeline:
    def __init__(self, engine, config: TurboConfig, air_skip: bool = False,
                 air_margin_hu: float = 200.0, host_revert: bool = False,
                 host_preprocess="auto"):
        """engine: a SlidingWindowEngine (inference/engine.py) wrapping an
        S2DPlainConvUNet whose patch/classes match ``config``.
        air_skip: drop tile batches whose voxels are all below
        lower_bound + air_margin_hu (HU; CT channel 0 only).
        host_revert / host_preprocess: the host-side routes of the JAX
        pipeline are not ported yet — True raises NotImplementedError
        ("auto" means False here)."""
        if host_revert:
            raise NotImplementedError(
                "host_revert (coarse-mask D2H with 6-bit packing and the host "
                "nearest revert) is not ported yet: the port reverts on the "
                "device")
        if host_preprocess not in (False, "auto"):
            raise NotImplementedError(
                "host_preprocess (the C++ hostops preprocess and strip "
                "streaming) is not ported yet: the port preprocesses on the "
                "device")
        self.engine = engine
        self.config = config
        ch0 = config.channels[0]
        if air_skip and ch0["scheme"] != "ct":
            print("[turbo] air skipping needs a CT (HU-calibrated) channel 0; "
                  f"disabled for scheme {ch0['scheme']!r}")
            air_skip = False
        self.air_skip = bool(air_skip)
        if ch0["scheme"] == "ct":
            self.air_threshold = (min(ch0["lower_bound"] + air_margin_hu,
                                      ch0["upper_bound"])
                                  - ch0["mean"]) / ch0["std"]
        else:
            self.air_threshold = float("-inf")
        self._staging = {}

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # ------------------------------------------------------------- helpers
    def _upload(self, volume: np.ndarray) -> torch.Tensor:
        """Raw volume -> device, once, through a reused pinned buffer. The
        buffer is refilled only after the previous copy out of it is done."""
        host = torch.from_numpy(np.ascontiguousarray(volume))
        if self.device.type == "cpu":
            return host
        key = (tuple(host.shape), host.dtype)
        buf, done = self._staging.get(key, (None, None))
        if buf is None:
            buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            done = torch.cuda.Event()
            done.record()
            self._staging = {key: (buf, done)}
        done.synchronize()
        buf.copy_(host)
        dev = buf.to(self.device, non_blocking=True)
        done.record()
        return dev

    # ---------------------------------------------------------- prediction
    def preprocess(self, volume: np.ndarray, spacing: Sequence[float]):
        """Raw (C, D, H, W) image-order volume -> the padded sweep volume on
        the device, in one upload: transpose, normalize, trilinear resize,
        cast, pad, and (with air skipping) the per-chunk batch validity.
        Returns (vol (C, *vol_shape), new_shape, in_shape, valid_chunks),
        shapes in engine order; valid_chunks is None without air skipping."""
        cfg, eng = self.config, self.engine
        tf = list(cfg.transpose_forward)
        in_shape = tuple(int(volume.shape[1 + a]) for a in tf)
        spacing_t = [float(spacing[a]) for a in tf]
        new_shape = tuple(int(round(s * sp / tsp)) for s, sp, tsp in zip(
            in_shape, spacing_t, cfg.target_spacing))
        new_shape = tuple(max(n, p) for n, p in zip(new_shape, eng.patch_size))
        vol_shape, steps = eng.s2d_sweep_plan(new_shape)
        dt = eng.compute_dtype
        with torch.no_grad():
            with eng.phase("upload"):
                raw = self._upload(volume)
            with eng.phase("preprocess"):
                raw_t = raw.permute(0, *(a + 1 for a in tf))
                chans = [_normalize(raw_t[c].float(), spec)
                         for c, spec in enumerate(cfg.channels)]
                xs = resize_trilinear(torch.stack(chans), new_shape).to(dt)
                del chans
                vol = torch.empty((len(cfg.channels), *vol_shape), dtype=dt,
                                  device=self.device)
                for c, spec in enumerate(cfg.channels):
                    vol[c].fill_(_fill_f64(spec))
                vol[(slice(None),) + tuple(slice(0, n) for n in new_shape)] = xs
                del xs
                valid_chunks = None
                if self.air_skip:
                    starts_x, coords_b, valid_b = eng.sweep_tiles(steps)
                    flags = air_flags(vol[0], starts_x, eng.patch_size,
                                      coords_b, _fill_f64(cfg.channels[0]),
                                      self.air_threshold)
                    valid_chunks = flags * valid_b[None]
        return vol, new_shape, in_shape, valid_chunks

    def predict_volume(self, params_list, volume: np.ndarray,
                       spacing: Sequence[float]) -> np.ndarray:
        """(D, H, W) — or (C, D, H, W) — raw volume in image axis order +
        its spacing -> uint8 segmentation on the ORIGINAL grid.
        ``params_list`` is the s2d parameter tree (or a one-element list),
        loaded into the network unless it is the one already loaded."""
        cfg, eng = self.config, self.engine
        if volume.ndim == len(cfg.patch_size):
            volume = volume[None]
        if volume.shape[0] != cfg.num_input_channels:
            raise ValueError(
                f"{volume.shape[0]} input channels but TurboConfig declares "
                f"{cfg.num_input_channels} normalization schemes")
        eng.load_params(params_list)
        vol, new_shape, in_shape, valid_chunks = self.preprocess(volume,
                                                                 spacing)
        seg = eng.run_s2d_sweep(vol, new_shape, valid_chunks)
        del vol
        with torch.no_grad():
            with eng.phase("revert"):
                s = seg[tuple(slice(0, n) for n in new_shape)]
                out = resize_nearest(s, in_shape).permute(
                    *cfg.transpose_backward).contiguous()
            with eng.phase("d2h"):
                mask = out.cpu().numpy()
        return mask

    @classmethod
    def from_model_folder(cls, model_folder: str, fold=0,
                          checkpoint_name: str = "checkpoint_final.fnnx",
                          air_skip: bool = True, tile_batch: int = 8,
                          compute_dtype=None, device=None,
                          **pipeline_kwargs):
        """Build (pipeline, params) from a trained model folder: reads the
        ``.fnnx`` checkpoint (numpy-only unpickler), re-parameterizes the
        PlainConvUNet into the s2d form and derives the TurboConfig from
        plans.json. ``params`` is the s2d parameter tree, as in the JAX
        package; ``predict_volume`` loads it into the network."""
        from ..core.labels import determine_num_input_channels
        from ..core.plans import PlansManager
        from ..models.s2d import make_s2d_engine_net
        from ..models.students import build_student_arch_kwargs
        from ..training.checkpoint import load_checkpoint
        from ..utils.io import join, load_json
        from .engine import SlidingWindowEngine

        device = resolve_device(device)
        compute_dtype = compute_dtype or torch.bfloat16
        dataset_json = load_json(join(model_folder, "dataset.json"))
        pm = PlansManager(join(model_folder, "plans.json"))
        ckpt = load_checkpoint(join(model_folder, f"fold_{fold}",
                                    checkpoint_name))
        init_args = ckpt.get("init_args") or {}
        cfg = pm.get_configuration(init_args.get("configuration",
                                                 "3d_fullres"))
        lm = pm.get_label_manager(dataset_json)
        num_in = determine_num_input_channels(pm, cfg, dataset_json)
        num_out = lm.num_segmentation_heads
        arch = cfg.configuration["architecture"]
        kwargs = arch["arch_kwargs"]
        if "Distillation" in ckpt.get("trainer_name", ""):
            kwargs = build_student_arch_kwargs(
                kwargs, init_args.get("feature_reduction_factor", 2),
                init_args.get("block_reduction_strategy", "reduce"))
        s2d = None
        if arch["network_class_name"].split(".")[-1] == "PlainConvUNet":
            s2d = make_s2d_engine_net(kwargs, num_out, num_in,
                                      compute_dtype=compute_dtype)
        if s2d is None:
            raise ValueError(
                "turbo pipeline needs the standard PlainConvUNet outer "
                "octave (3^3 stride-1 then 3^3 stride-2); use the regular "
                "predictor for this architecture")
        params = s2d.convert_params(ckpt["network_weights"])
        s2d.to(device)

        schemes = cfg.normalization_schemes
        if num_in != len(schemes):
            raise ValueError(
                f"turbo serves plain multi-channel input ({len(schemes)} "
                f"image channels) but the model wants {num_in} input "
                f"channels (cascade prev-stage one-hot?)")
        channels = []
        for c, scheme in enumerate(schemes):
            tag = _SCHEME_TAGS.get(scheme, "zscore")
            spec = {"scheme": tag}
            if tag == "ct":
                ip = pm.foreground_intensity_properties_per_channel[str(c)]
                spec.update(mean=ip["mean"], std=ip["std"],
                            lower_bound=ip["percentile_00_5"],
                            upper_bound=ip["percentile_99_5"])
            channels.append(spec)
        patch = tuple(cfg.patch_size)
        config = TurboConfig(patch_size=patch, target_spacing=cfg.spacing,
                             num_classes=num_out, channels=channels)
        if channels[0]["scheme"] == "ct":
            ip0 = channels[0]
            config.mean, config.std = ip0["mean"], ip0["std"]
            config.lower_bound = ip0["lower_bound"]
            config.upper_bound = ip0["upper_bound"]
        # plans patch/spacing are already in the engine's (transposed) order
        config.transpose_forward = list(range(len(patch)))
        config.transpose_backward = list(range(len(patch)))
        config.patch_size = patch
        config.target_spacing = tuple(float(s) for s in cfg.spacing)

        engine = SlidingWindowEngine(
            s2d, config.patch_size, num_out, tile_step_size=0.5,
            use_gaussian=True, compute_dtype=compute_dtype,
            sweep_acc_dtype=compute_dtype, shape_bucket=32,
            tile_batch=tile_batch, device=device)
        return cls(engine, config, air_skip=air_skip, **pipeline_kwargs), params

    def predict_file(self, params_list, input_file, output_file: str) -> dict:
        """read -> predict -> write; returns a timing breakdown.
        input_file: one path, or a list of per-channel paths."""
        t0 = time.perf_counter()
        rw = NiftiIOWithReorient()
        files = [input_file] if isinstance(input_file, str) \
            else list(input_file)
        data, props = rw.read_images(files, dtype=None)
        t_read = time.perf_counter()
        seg = self.predict_volume(params_list, data, props["spacing"])
        t_pred = time.perf_counter()
        rw.write_seg(seg, output_file, props)
        t_write = time.perf_counter()
        return {"seconds_total": round(t_write - t0, 3),
                "seconds_read": round(t_read - t0, 3),
                "seconds_predict": round(t_pred - t_read, 3),
                "seconds_write": round(t_write - t_pred, 3),
                "labels_present": sorted(int(x) for x in np.unique(seg))}


def turbo_predict_entry():
    """``fast_nnunet_turbo_torch`` — end-to-end CT serving on the card from
    a trained model folder."""
    ap = argparse.ArgumentParser(
        description="TurboPipeline (PyTorch/CUDA): read -> on-device "
                    "preprocess + s2d sweep -> write")
    ap.add_argument("-i", required=True, help="input NIfTI (or a folder)")
    ap.add_argument("-o", required=True, help="output NIfTI (or a folder)")
    ap.add_argument("-m", required=True, help="trained model folder "
                    "(contains plans.json + fold_X/)")
    ap.add_argument("-f", default=0, help="fold")
    ap.add_argument("-chk", default="checkpoint_final.fnnx")
    ap.add_argument("--no_air_skip", action="store_true",
                    help="disable empty-tile (air) skipping")
    ap.add_argument("--tile_batch", type=int, default=8)
    ap.add_argument("--host_revert", action="store_true",
                    help="not ported yet (raises)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain kernel versions)")
    args = ap.parse_args()

    pipe, params = TurboPipeline.from_model_folder(
        args.m, args.f, args.chk, air_skip=not args.no_air_skip,
        tile_batch=args.tile_batch, device=args.device,
        host_revert=args.host_revert or os.environ.get(
            "FNN_HOST_REVERT", "0") == "1")
    if os.path.isdir(args.i):
        from ..utils.io import subfiles
        os.makedirs(args.o, exist_ok=True)
        names = subfiles(args.i, suffix=".nii.gz", join_path=False)
        n_ch = pipe.config.num_input_channels
        if n_ch > 1:
            cases = {}
            for name in names:
                cases.setdefault(re.sub(r"_\d{4}\.nii\.gz$", "", name),
                                 []).append(name)
            for case, files in sorted(cases.items()):
                if len(files) != n_ch:
                    raise ValueError(f"{case}: {len(files)} channel files, "
                                     f"model wants {n_ch}")
                stats = pipe.predict_file(
                    params, [os.path.join(args.i, f) for f in sorted(files)],
                    os.path.join(args.o, case + ".nii.gz"))
                print(case, stats)
        else:
            for name in names:
                stats = pipe.predict_file(params, os.path.join(args.i, name),
                                          os.path.join(args.o, name))
                print(name, stats)
    else:
        print(pipe.predict_file(params, args.i, args.o))


if __name__ == "__main__":
    turbo_predict_entry()
