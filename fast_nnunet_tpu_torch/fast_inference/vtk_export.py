"""3D surface model export to legacy VTK PolyData — the port's copy of
fast_nnunet_tpu/fast_inference/vtk_export.py (numpy only, host work), same
algorithm and same bytes out. Per-label surface with anatomy colors,
smoothing and decimation (the reference's VTKModelGenerator, which uses the
VTK library; here the mesh is generated directly and written in the open
VTK file format).

Pipeline per label: binary mask -> boundary-face quad mesh ("cuberille", exact
voxel surface) -> Laplacian vertex smoothing (smoothing_factor in [0,1]) ->
vertex-clustering decimation (decimation_factor in [0,1)) -> colored polydata.
"""
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# face definitions: (axis, direction) -> 4 corner offsets of the exposed face
_FACE_CORNERS = {
    (0, -1): [(0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1)],
    (0, +1): [(1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0)],
    (1, -1): [(0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0)],
    (1, +1): [(0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)],
    (2, -1): [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)],
    (2, +1): [(0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)],
}


def extract_boundary_quads(mask: np.ndarray, spacing: Sequence[float]
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """mask (X,Y,Z) bool -> (vertices (V,3) float32 in mm, quads (Q,4) int32)."""
    padded = np.pad(mask, 1)
    verts: Dict[Tuple[int, int, int], int] = {}
    quads: List[Tuple[int, int, int, int]] = []

    def vid(p):
        if p not in verts:
            verts[p] = len(verts)
        return verts[p]

    for (axis, direction), corners in _FACE_CORNERS.items():
        shifted = np.roll(padded, -direction, axis=axis)
        faces = padded & ~shifted
        coords = np.argwhere(faces) - 1  # unpad
        for x, y, z in coords:
            quad = tuple(vid((int(x) + dx, int(y) + dy, int(z) + dz))
                         for dx, dy, dz in corners)
            quads.append(quad)

    v = np.zeros((len(verts), 3), np.float32)
    for (x, y, z), i in verts.items():
        v[i] = (x * spacing[0], y * spacing[1], z * spacing[2])
    return v, np.asarray(quads, np.int32).reshape(-1, 4)


def laplacian_smooth(vertices: np.ndarray, quads: np.ndarray,
                     factor: float = 0.5, iterations: int = 10) -> np.ndarray:
    """Move each vertex toward the mean of its neighbors by `factor` per pass."""
    if factor <= 0 or len(vertices) == 0:
        return vertices
    n = len(vertices)
    # neighbor accumulation via quad edges
    edges = np.concatenate([quads[:, [0, 1]], quads[:, [1, 2]],
                            quads[:, [2, 3]], quads[:, [3, 0]]])
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    v = vertices.copy()
    deg = np.bincount(src, minlength=n).astype(np.float32)[:, None]
    deg = np.maximum(deg, 1)
    for _ in range(iterations):
        acc = np.zeros_like(v)
        np.add.at(acc, src, v[dst])
        v = v + factor * (acc / deg - v)
    return v


def decimate_vertex_clustering(vertices: np.ndarray, quads: np.ndarray,
                               factor: float, spacing: Sequence[float]
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster vertices on a grid whose pitch grows with `factor`; degenerate
    faces collapse away. factor 0 = no decimation."""
    if factor <= 0 or len(vertices) == 0:
        return vertices, quads
    pitch = max(min(spacing), 1e-3) * (1.0 + 4.0 * factor)
    keys = np.floor(vertices / pitch).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    new_v = np.zeros((len(uniq), 3), np.float32)
    counts = np.bincount(inverse).astype(np.float32)[:, None]
    np.add.at(new_v, inverse, vertices)
    new_v /= counts
    new_q = inverse[quads]
    keep = np.array([len(set(q.tolist())) == 4 for q in new_q])
    return new_v, new_q[keep]


def parse_color_file(color_file: str) -> Dict[int, Tuple[str, Tuple[int, int, int, int]]]:
    """Slicer GenericAnatomyColors format: 'label name R G B A' per line
    (ref inference/config/vtk_colors/GenericAnatomyColors.txt)."""
    table = {}
    with open(color_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 5:
                continue
            rgba = tuple(int(x) for x in parts[-4:])
            label = int(parts[0])
            name = "_".join(parts[1:-4])
            table[label] = (name, rgba)
    return table


def default_color(label: int) -> Tuple[str, Tuple[int, int, int, int]]:
    rng = np.random.RandomState(label * 7919 + 13)
    return (f"label_{label}", tuple(int(x) for x in rng.randint(40, 255, 3)) + (255,))


def write_vtk_polydata(fname: str, vertices: np.ndarray, quads: np.ndarray,
                       colors_per_quad: Optional[np.ndarray] = None) -> None:
    """Legacy VTK ASCII PolyData with optional per-cell RGB."""
    with open(fname, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("fast-nnunet-tpu surface model\nASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {len(vertices)} float\n")
        for v in vertices:
            f.write(f"{v[0]:.3f} {v[1]:.3f} {v[2]:.3f}\n")
        f.write(f"POLYGONS {len(quads)} {len(quads) * 5}\n")
        for q in quads:
            f.write(f"4 {q[0]} {q[1]} {q[2]} {q[3]}\n")
        if colors_per_quad is not None and len(colors_per_quad) == len(quads):
            f.write(f"CELL_DATA {len(quads)}\n")
            f.write("COLOR_SCALARS rgb 3\n")
            for c in colors_per_quad:
                f.write(f"{c[0] / 255:.3f} {c[1] / 255:.3f} {c[2] / 255:.3f}\n")


class VTKModelGenerator:
    def __init__(self, color_file: Optional[str] = None):
        self.color_table = parse_color_file(color_file) if color_file else {}

    def generate_vtk_model(self, segmentation: np.ndarray,
                           spacing: Sequence[float], output_file: str,
                           labels: Optional[Sequence[int]] = None,
                           smoothing_factor: float = 0.5,
                           decimation_factor: float = 0.2,
                           smoothing_iterations: int = 10) -> dict:
        if labels is None:
            labels = sorted(set(np.unique(segmentation).tolist()) - {0})
        all_v, all_q, all_c = [], [], []
        offset = 0
        stats = {}
        for lbl in labels:
            mask = segmentation == lbl
            if not mask.any():
                continue
            v, q = extract_boundary_quads(mask, spacing)
            v = laplacian_smooth(v, q, smoothing_factor, smoothing_iterations)
            v, q = decimate_vertex_clustering(v, q, decimation_factor, spacing)
            if len(q) == 0:
                continue
            name, rgba = self.color_table.get(int(lbl), default_color(int(lbl)))
            all_v.append(v)
            all_q.append(q + offset)
            all_c.append(np.tile(np.asarray(rgba[:3], np.int32), (len(q), 1)))
            offset += len(v)
            stats[int(lbl)] = {"name": name, "vertices": len(v), "faces": len(q)}
        if all_v:
            write_vtk_polydata(output_file, np.concatenate(all_v),
                               np.concatenate(all_q), np.concatenate(all_c))
        else:
            write_vtk_polydata(output_file, np.zeros((0, 3), np.float32),
                               np.zeros((0, 4), np.int32))
        return stats
