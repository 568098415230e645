"""The port's fast-inference module (fast_nnunet_tpu_torch/fast_inference/)
against the JAX package's: the VTK mesh functions and ``.vtk`` bytes, the
color-file parser and ``ConfigManager`` equal; the REST API's codes, bodies
and headers against the JAX API's on the golden model folder (f32 networks
on both sides, logits within 1e-5 of the largest); the CLI's JSON against
JAX's; the golden mask through the model-folder route; the engine's
``pad_to_tile_batch`` (fixed batches, logits unchanged); the inference data
iterators item for item; and the examples' imports."""
import ast
import http.client
import json
import os
import shutil
import socket

import numpy as np
import pytest
import torch

from fast_nnunet_tpu.fast_inference import config_manager as jcm
from fast_nnunet_tpu.fast_inference import vtk_export as jvtk
from fast_nnunet_tpu_torch.fast_inference import config_manager as pcm
from fast_nnunet_tpu_torch.fast_inference import vtk_export as pvtk
from fast_nnunet_tpu_torch.fast_inference.inferencer import \
    FastnnUNetInferencer
from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO

from .torch_port_common import (ARCH, GOLDEN, K,  # noqa: F401  (fixture)
                                jax_predictor_f32,
                                no_persistent_compile_cache, plain_params)

MODEL = os.path.join(GOLDEN, "model")
INPUT = os.path.join(GOLDEN, "input_0000.nii.gz")
EXPECTED = os.path.join(GOLDEN, "expected_mask.nii.gz")


# ------------------------------------------------------------------- VTK
def _mask(kind: str) -> np.ndarray:
    m = np.zeros((8, 8, 8), bool)
    if kind == "cube":
        m[2:6, 2:6, 2:6] = True  # 4x4x4 cube: 6 faces x 16 quads
    elif kind == "blob":
        rng = np.random.RandomState(0)
        m[1:7, 1:7, 1:7] = rng.rand(6, 6, 6) > 0.4
    else:  # "slab": touches the border
        m[:, :3, :] = True
    return m


@pytest.mark.parametrize("kind", ["cube", "blob", "slab"])
@pytest.mark.parametrize("factors", [(0.0, 0.0), (0.5, 0.2), (0.3, 0.6)])
@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (2.5, 0.8, 0.8)])
def test_vtk_mesh_functions_equal_jax(kind, factors, spacing):
    smooth, decim = factors
    m = _mask(kind)
    v, q = pvtk.extract_boundary_quads(m, spacing)
    jv, jq = jvtk.extract_boundary_quads(m, spacing)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(q, jq)
    if kind == "cube":
        assert len(q) == 6 * 16
        assert len(v) == 98  # surface lattice of a 4^3 cube
    s = pvtk.laplacian_smooth(v, q, smooth, 5)
    np.testing.assert_array_equal(s, jvtk.laplacian_smooth(jv, jq, smooth, 5))
    if smooth > 0 and kind == "cube":
        assert s.std(0).sum() < v.std(0).sum()  # smoothing shrinks it
    d = pvtk.decimate_vertex_clustering(s, q, decim, spacing)
    jd = jvtk.decimate_vertex_clustering(s, q, decim, spacing)
    for a, b in zip(d, jd):
        np.testing.assert_array_equal(a, b)
    if decim > 0 and kind == "cube":
        assert len(d[0]) < len(v)


@pytest.mark.parametrize("factors", [(0.5, 0.2), (0.0, 0.0), (0.8, 0.5)])
def test_vtk_file_bytes_equal_jax(tmp_path, factors):
    seg = np.zeros((10, 9, 8), np.uint8)
    seg[2:6, 2:6, 2:6] = 1
    seg[0:2, 0:2, 0:2] = 2
    seg[6:9, 1:8, 3:7] = 5
    colors = str(tmp_path / "colors.txt")
    with open(colors, "w") as f:
        f.write("# comment\n1 liver 221 130 101 255\n5 left kidney 185 102 "
                "83 255\n")
    for color_file in (None, colors):
        out_p, out_j = str(tmp_path / "p.vtk"), str(tmp_path / "j.vtk")
        kw = dict(smoothing_factor=factors[0], decimation_factor=factors[1])
        sp = pvtk.VTKModelGenerator(color_file).generate_vtk_model(
            seg, (1.5, 1.0, 0.8), out_p, **kw)
        sj = jvtk.VTKModelGenerator(color_file).generate_vtk_model(
            seg, (1.5, 1.0, 0.8), out_j, **kw)
        assert sp == sj and {1, 5} <= set(sp) <= {1, 2, 5}
        with open(out_p, "rb") as a, open(out_j, "rb") as b:
            body = a.read()
            assert body == b.read()
        assert body.startswith(b"# vtk DataFile")
        assert b"POLYGONS" in body and b"COLOR_SCALARS" in body
    empty_p, empty_j = str(tmp_path / "e.vtk"), str(tmp_path / "ej.vtk")
    pvtk.VTKModelGenerator().generate_vtk_model(np.zeros_like(seg), (1,) * 3,
                                                empty_p)
    jvtk.VTKModelGenerator().generate_vtk_model(np.zeros_like(seg), (1,) * 3,
                                                empty_j)
    with open(empty_p, "rb") as a, open(empty_j, "rb") as b:
        assert a.read() == b.read()


def test_color_file_parsing(tmp_path):
    f = str(tmp_path / "colors.txt")
    with open(f, "w") as fh:
        fh.write("# comment\n0 background 0 0 0 0\n1 liver 221 130 101 255\n"
                 "2 left kidney 185 102 83 255\n\nshort line\n")
    table = pvtk.parse_color_file(f)
    assert table == jvtk.parse_color_file(f)
    assert table[1] == ("liver", (221, 130, 101, 255))
    assert table[2][0] == "left_kidney"
    assert pvtk.default_color(7) == jvtk.default_color(7)


@pytest.mark.parametrize("layout", ["flat", "per_channel"])
def test_config_manager_equals_jax(tmp_path, layout):
    ip = {"mean": 418.68, "std": 412.19, "percentile_00_5": -60.0,
          "percentile_99_5": 3068.0}
    cfg = {"patch_size": [160, 96, 96],
           "target_spacing": [2.0, 0.9765625, 0.9765625],
           "intensity_properties": ip if layout == "flat" else {"0": ip},
           "model_path": "model.pt2", "num_classes": 61}
    if layout == "per_channel":
        cfg = dict(cfg, input_shape=[8, 1, 160, 96, 96],
                   compute_dtype="float32", use_mirroring=True,
                   mirroring_baked_into_artifact=True,
                   inference_allowed_mirroring_axes=[0, 2],
                   transpose_forward=[2, 0, 1], transpose_backward=[1, 2, 0])
    path = str(tmp_path / "model_config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    props = ("patch_size", "target_spacing", "intensity_properties",
             "model_path", "num_classes", "tile_batch", "labels",
             "compute_dtype", "tile_step_size", "use_gaussian",
             "use_mirroring", "mirroring_baked_into_artifact", "mirror_axes",
             "normalization_schemes", "transpose_forward",
             "transpose_backward")
    for src in (path, cfg):
        p, j = pcm.ConfigManager(src), jcm.ConfigManager(src)
        for name in props:
            assert getattr(p, name) == getattr(j, name), name
    assert pcm.ConfigManager(path).intensity_properties == {"0": ip}
    assert pcm.ConfigManager(path).model_path == str(tmp_path / "model.pt2")
    with pytest.raises(ValueError, match="missing keys"):
        pcm.ConfigManager({"patch_size": [8, 8, 8]})


# ---------------------------------------------------------- engine padding
@pytest.mark.parametrize("spatial", [(8, 8, 16), (12, 20, 16)])
def test_pad_to_tile_batch_keeps_logits(spatial):
    """Every forward gets exactly tile_batch tiles (zero-valid repeats of
    the last tile), and the logits are the unpadded engine's within f32's
    1e-5 relative (the convolutions' algorithm may follow the batch)."""
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
    net = get_network_from_plans("PlainConvUNet", ARCH, (), 1, K,
                                 compute_dtype=torch.float32)
    tree = plain_params(0)
    vol = np.random.RandomState(0).randn(1, *spatial).astype(np.float32)
    out, batches = {}, {}
    for pad in (False, True):
        eng = SlidingWindowEngine(net, (8, 8, 16), K, tile_batch=4,
                                  compute_dtype=torch.float32,
                                  pad_to_tile_batch=pad, device="cpu")
        seen = batches[pad] = []
        hook = net.register_forward_pre_hook(
            lambda m, a: seen.append(a[0].shape[0]))
        try:
            out[pad] = eng.predict_logits([tree], vol)
        finally:
            hook.remove()
    assert np.abs(out[True] - out[False]).max() <= \
        1e-5 * np.abs(out[False]).max()
    assert set(batches[True]) == {4}
    n_tiles = sum(batches[False])
    assert len(batches[True]) == -(-n_tiles // 4)
    if n_tiles < 4:
        assert batches[False] == [n_tiles]


# -------------------------------------------------------- golden, folder
def test_model_folder_route_reproduces_golden_mask(tmp_path):
    """tests/test_golden_checkpoint.py's inferencer pin, in the port: the
    model folder through the predictor (f32 tiles), the frozen mask."""
    inf = FastnnUNetInferencer(model_folder=MODEL, folds=(0,), device="cpu")
    assert inf.predictor.engine.pad_to_tile_batch
    inf.predictor.engine.compute_dtype = torch.float32
    out = str(tmp_path / "seg.nii.gz")
    res = inf.predict_single_image(INPUT, out,
                                   largest_component_postprocessing=True)
    expected = NiftiIO().read_seg(EXPECTED)[0][0]
    got = NiftiIO().read_seg(out)[0][0]
    assert res["labels_present"] == [0, 1, 2]
    assert "postprocess_s" in inf.timings
    from fast_nnunet_tpu_torch.postprocessing.connected_components import \
        remove_all_but_largest_component_from_segmentation as pp
    np.testing.assert_array_equal(got, pp(expected, [1, 2]))


# ---------------------------------------------------------------- REST API
def _f32_inferencers():
    """(port, JAX) inferencers on the golden model folder with f32
    networks and f32 tiles, mirroring off."""
    from fast_nnunet_tpu.fast_inference.inferencer import \
        FastnnUNetInferencer as JaxInferencer
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
    port = FastnnUNetInferencer(model_folder=MODEL, folds=(0,), device="cpu")
    p = NNUNetPredictor(use_mirroring=False, device="cpu",
                        compute_dtype=torch.float32)
    p.initialize_from_trained_model_folder(MODEL, use_folds=[0])
    port.predictor = p
    jax_inf = JaxInferencer()
    jax_inf.predictor = jax_predictor_f32(MODEL, [0], 1, 3)
    jax_inf._model_info = dict(port.get_model_info())
    return port, jax_inf


def _serve(inferencer):
    from fast_nnunet_tpu.fast_inference.rest_api import FastnnUNetAPI as JAPI
    from fast_nnunet_tpu_torch.fast_inference.rest_api import FastnnUNetAPI
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    cls = FastnnUNetAPI if isinstance(inferencer, FastnnUNetInferencer) \
        else JAPI
    api = cls(inferencer, "127.0.0.1", port)
    thread = api.run(blocking=False)
    return api, thread, port


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def servers():
    port_inf, jax_inf = _f32_inferencers()
    running = [_serve(port_inf), _serve(jax_inf)]
    yield {"port": running[0][2], "jax": running[1][2]}
    for api, thread, _ in running:
        api.shutdown()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _both(servers, *args, **kw):
    return [_request(servers[k], *args, **kw) for k in ("port", "jax")]


def _strip(body: dict, root) -> dict:
    """A response without its timing, and its paths made relative."""
    out = {k: v for k, v in body.items() if k != "seconds"}
    for k in ("output", "vtk_model", "input"):
        if k in out:
            out[k] = os.path.relpath(out[k], str(root))
    return out


def test_rest_get_endpoints_equal_jax(servers):
    (pc, ph, pb), (jc, jh, jb) = _both(servers, "GET", "/health")
    assert pc == jc == 200 and pb == jb == b'{"status": "ok"}'
    assert ph["content-type"] == jh["content-type"] == "application/json"
    (pc, _, pb), (jc, _, jb) = _both(servers, "GET", "/model_info")
    assert pc == jc == 200 and json.loads(pb) == json.loads(jb)
    assert json.loads(pb)["source"] == "model_folder"
    for method in ("GET", "POST"):
        (pc, _, pb), (jc, _, jb) = _both(servers, method, "/nope")
        assert pc == jc == 404 and pb == jb


@pytest.mark.parametrize("body,code", [
    (b"{not json", 400),
    (b'{"output_file": "x.nii.gz"}', 400),
    (b'{"input_file": "/no/such/ct.nii.gz", "output_file": "/tmp/x.nii.gz"}',
     500),
])
def test_rest_errors_equal_jax(servers, body, code):
    (pc, _, pb), (jc, _, jb) = _both(servers, "POST", "/predict", body)
    assert pc == jc == code
    p, j = json.loads(pb), json.loads(jb)
    if code == 500:  # the exception's type, raised in each package's code
        assert p["error"].split(":")[0] == j["error"].split(":")[0]
    else:
        assert p == j


def test_rest_predict_and_batch_equal_jax(servers, tmp_path):
    for k in ("port", "jax"):
        (tmp_path / k / "in").mkdir(parents=True)
        shutil.copy(INPUT, tmp_path / k / "in" / "case_a.nii.gz")
        shutil.copy(INPUT, tmp_path / k / "in" / "case_b.nii.gz")
    res = {}
    for k in ("port", "jax"):
        root = tmp_path / k
        c1, _, b1 = _request(servers[k], "POST", "/predict", json.dumps({
            "input_file": str(root / "in" / "case_a.nii.gz"),
            "output_file": str(root / "single.nii.gz"),
            "postprocessing": True}).encode())
        c2, _, b2 = _request(servers[k], "POST", "/predict_batch", json.dumps(
            {"input_folder": str(root / "in"),
             "output_folder": str(root / "batch")}).encode())
        assert c1 == c2 == 200
        res[k] = (_strip(json.loads(b1), root),
                  [_strip(r, root) for r in json.loads(b2)["results"]])
    assert res["port"] == res["jax"]
    for name in ("single.nii.gz", "batch/case_a.nii.gz",
                 "batch/case_b.nii.gz"):
        np.testing.assert_array_equal(
            NiftiIO().read_seg(str(tmp_path / "port" / name))[0],
            NiftiIO().read_seg(str(tmp_path / "jax" / name))[0])


def test_rest_predict_array_equal_jax(servers):
    vol = np.random.RandomState(3).randn(20, 18, 16).astype(np.float32)
    hdr = {"X-Shape": "20,18,16", "Content-Type": "application/octet-stream"}
    (pc, ph, pb), (jc, jh, jb) = _both(servers, "POST", "/predict_array",
                                       vol.tobytes(), hdr)
    assert pc == jc == 200
    for h in ("content-type", "x-num-class", "content-length"):
        assert ph[h] == jh[h], h
    p = np.frombuffer(pb, np.float32).reshape(3, 20, 18, 16)
    j = np.frombuffer(jb, np.float32).reshape(3, 20, 18, 16)
    assert np.abs(p - j).max() <= 1e-5 * np.abs(j).max()
    bad = _both(servers, "POST", "/predict_array", vol.tobytes(),
                {"X-Shape": "7,7,7"})
    assert [b[0] for b in bad] == [400, 400]
    assert json.loads(bad[0][2]) == json.loads(bad[1][2])
    # a missing X-Shape: 400 in the port (the JAX handler drops the
    # connection, ROADMAP §3)
    code, _, body = _request(servers["port"], "POST", "/predict_array",
                             vol.tobytes())
    assert code == 400 and "bad array request" in json.loads(body)["error"]


# ---------------------------------------------------------------------- CLI
def test_cli_json_equals_jax(tmp_path, capsys):
    from fast_nnunet_tpu.fast_inference.main import main as jmain
    from fast_nnunet_tpu_torch.fast_inference.main import main as pmain
    (tmp_path / "in").mkdir()
    shutil.copy(INPUT, tmp_path / "in" / "ct.nii.gz")
    shutil.copy(INPUT, tmp_path / "in" / "ct2.nii.gz")
    out = {}
    for k, fn, extra in (("port", pmain, ["--device", "cpu"]),
                         ("jax", jmain, [])):
        fn(["predict-single", "--model-folder", MODEL, "--folds", "0",
            "-i", str(tmp_path / "in" / "ct.nii.gz"),
            "-o", str(tmp_path / f"{k}.nii.gz")] + extra)
        single = json.loads(capsys.readouterr().out)
        fn(["predict-batch", "--model-folder", MODEL, "--folds", "0",
            "-i", str(tmp_path / "in"), "-o", str(tmp_path / f"{k}_batch")]
           + extra)
        batch = json.loads(capsys.readouterr().out)
        assert single["output"] == str(tmp_path / f"{k}.nii.gz")
        single["output"] = "out.nii.gz"
        out[k] = (_strip(single, tmp_path), batch["n_cases"],
                  sorted(r["labels_present"] for r in batch["results"]))
    assert out["port"] == out["jax"]
    assert set(json.loads(json.dumps(out["port"][0]))) == {
        "input", "output", "labels_present"}


# --------------------------------------------------------------- iterators
def test_data_iterators_items_equal_jax(tmp_path):
    from fast_nnunet_tpu.core.plans import PlansManager as JPM
    from fast_nnunet_tpu.inference import data_iterators as jdi
    from fast_nnunet_tpu.preprocessing.preprocessor import \
        DefaultPreprocessor as JPre
    from fast_nnunet_tpu_torch.core.plans import PlansManager
    from fast_nnunet_tpu_torch.inference import data_iterators as pdi
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.utils.io import load_json
    img, hdr = NiftiIO().read_images([INPUT])
    second = str(tmp_path / "b_0000.nii.gz")
    NiftiIO().write_seg((img[0] * 0.5 + 3).astype(np.float32), second,
                        dict(hdr))
    cases = [[INPUT], [second], [INPUT]]
    ofiles = ["a", "b", "c"]
    dj = load_json(os.path.join(MODEL, "dataset.json"))
    pm, jpm = (PlansManager(os.path.join(MODEL, "plans.json")),
               JPM(os.path.join(MODEL, "plans.json")))
    cm, jcm_ = pm.get_configuration("3d_fullres"), \
        jpm.get_configuration("3d_fullres")

    def same(p_items, j_items):
        p_items, j_items = list(p_items), list(j_items)
        assert len(p_items) == len(j_items) == 3
        for p, j in zip(p_items, j_items):
            assert p["ofile"] == j["ofile"]
            np.testing.assert_array_equal(p["data"], j["data"])
            for key in ("shape_before_cropping", "bbox_used_for_cropping",
                        "shape_after_cropping_and_before_resampling",
                        "spacing"):
                assert np.array_equal(p["data_properties"][key],
                                      j["data_properties"][key]), key
        return p_items

    items = same(pdi.preprocessing_iterator_fromfiles(
        cases, None, ofiles, pm, dj, cm, num_processes=2),
        jdi.preprocessing_iterator_fromfiles(cases, None, ofiles, jpm, dj,
                                             jcm_, num_processes=2))
    assert [i["ofile"] for i in items] == ofiles
    np.testing.assert_array_equal(items[0]["data"], items[2]["data"])
    imgs = [NiftiIO().read_images(c) for c in cases]
    same(pdi.preprocessing_iterator_fromnpy(
        [i for i, _ in imgs], None, [h for _, h in imgs], ofiles, pm, dj,
        cm), jdi.preprocessing_iterator_fromnpy(
        [i for i, _ in imgs], None, [h for _, h in imgs], ofiles, jpm, dj,
        jcm_))
    same(pdi.PreprocessAdapter(cases, None, DefaultPreprocessor(), ofiles,
                               pm, dj, cm, 2),
         jdi.PreprocessAdapter(cases, None, JPre(), ofiles, jpm, dj, jcm_,
                               2))


def test_examples_name_the_ports_modules():
    """inference/examples.py is documentation that executes: every name it
    imports exists in the port, and it names nothing of the JAX package."""
    import importlib
    from fast_nnunet_tpu_torch.inference import examples
    tree = ast.parse(open(examples.__file__).read())
    froms = [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert len(froms) >= 6
    for node in froms:
        assert node.module.startswith("fast_nnunet_tpu_torch."), node.module
        mod = importlib.import_module(node.module)
        for alias in node.names:
            assert hasattr(mod, alias.name), (node.module, alias.name)
    assert [n for n in dir(examples) if n.startswith("example_")] == [
        "example_custom_iterator", "example_fast_inference_from_artifact",
        "example_predict_from_files", "example_predict_single_npy_array"]
