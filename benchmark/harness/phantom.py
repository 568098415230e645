"""HU phantoms made on the card from a seed: a frozen torch copy of the
synthetic CT of ``utils/synthetic_ct.py`` (air, an elliptic body of soft
tissue tapering to both ends, two lungs, a spine with vertebral texture,
ribs, three organ blobs, quantum mottle), returned in the image order
(z, y, x) that the configuration's patch and spacing use."""
import torch


def make_ct(shape_xyz, generator: torch.Generator, device) -> torch.Tensor:
    """(nz, ny, nx) int16 HU on ``device`` for a (nx, ny, nz) grid."""
    nx, ny, nz = (int(v) for v in shape_xyz)
    f32 = dict(dtype=torch.float32, device=device)
    x = torch.linspace(-1, 1, nx, **f32)[:, None, None]
    y = torch.linspace(-1, 1, ny, **f32)[None, :, None]
    z = torch.linspace(0, 1, nz, **f32)[None, None, :]
    full = (nx, ny, nz)

    vol = torch.full(full, -1000.0, **f32)
    rx = 0.72 - 0.15 * (z - 0.5).abs() * 2
    ry = 0.55 - 0.12 * (z - 0.5).abs() * 2
    body = (x / rx) ** 2 + (y / ry) ** 2 <= 1.0
    vol = torch.where(body, torch.full_like(vol, 40.0), vol)

    lung_z = z > 0.55
    for sx in (-0.3, 0.3):
        lung = (((x - sx) / 0.25) ** 2 + (y / 0.3) ** 2
                + ((z - 0.78) / 0.25) ** 2 <= 1.0) & body & lung_z
        vol = torch.where(lung, torch.full_like(vol, -800.0), vol)

    spine = ((x / 0.08) ** 2 + ((y - 0.35) / 0.09) ** 2 <= 1.0) & body
    vol = torch.where(spine, (700.0 + 400.0 * torch.sin(z * 60.0)).expand(
        full), vol)

    shell = (((x / (rx * 0.92)) ** 2 + (y / (ry * 0.92)) ** 2 - 1.0).abs()
             < 0.08) & body & (z > 0.45)
    ribs = shell & (torch.sin(z * 90.0) > 0.3)
    vol = torch.where(ribs, torch.full_like(vol, 600.0), vol)

    for cx, cy, cz, r, hu in ((-0.25, -0.05, 0.45, 0.3, 60.0),
                              (0.22, 0.1, 0.35, 0.12, 35.0),
                              (-0.22, 0.12, 0.35, 0.12, 35.0)):
        blob = (((x - cx) / r) ** 2 + ((y - cy) / (r * 0.8)) ** 2
                + ((z - cz) / (r * 0.7)) ** 2 <= 1.0) & body
        vol = torch.where(blob, torch.full_like(vol, hu), vol)

    noise = torch.randn(full, generator=generator, **f32) * 12.0
    vol = torch.where(body, vol + noise, vol)
    return vol.clamp_(-1024, 3071).to(torch.int16).permute(2, 1, 0) \
        .contiguous()
