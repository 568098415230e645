"""Fast-inference CLI, ``fast_nnunet_inference_torch`` — the port of
fast_nnunet_tpu/fast_inference/main.py (the reference's inference/main.py
flags: predict-single | predict-batch | serve-api), plus ``--device``
(``cuda`` unless ``--device cpu``)."""
import argparse
import json


def _add_model_args(p):
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--config", help="per-model JSON config (exported artifact)")
    g.add_argument("--model-folder", help="trained results folder")
    p.add_argument("--folds", nargs="+", default=None)
    p.add_argument("--step-size", type=float, default=None)
    p.add_argument("--use-mirroring", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; an artifact serves on the "
                        "device it was exported on")


def _make_inferencer(args):
    from .inferencer import FastnnUNetInferencer
    return FastnnUNetInferencer(
        config_file=args.config, model_folder=args.model_folder,
        folds=args.folds, tile_step_size=args.step_size,
        use_mirroring=args.use_mirroring or None, device=args.device)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="fast_nnunet_inference_torch",
                                     description="Fast-nnUNet inference module "
                                                 "(PyTorch port)")
    sub = parser.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("predict-single", help="segment one volume")
    _add_model_args(ps)
    ps.add_argument("-i", "--input", required=True)
    ps.add_argument("-o", "--output", required=True)
    ps.add_argument("--save-probabilities", action="store_true")
    ps.add_argument("--postprocessing", action="store_true",
                    help="largest-component postprocessing")
    ps.add_argument("--generate-vtk", action="store_true")
    ps.add_argument("--vtk-output", default=None)
    ps.add_argument("--color-file", default=None)
    ps.add_argument("--smoothing-factor", type=float, default=0.5)
    ps.add_argument("--decimation-factor", type=float, default=0.2)

    pb = sub.add_parser("predict-batch", help="segment a folder")
    _add_model_args(pb)
    pb.add_argument("-i", "--input-folder", required=True)
    pb.add_argument("-o", "--output-folder", required=True)
    pb.add_argument("--generate-vtk", action="store_true")
    pb.add_argument("--color-file", default=None)

    pa = sub.add_parser("serve-api", help="REST API server")
    _add_model_args(pa)
    pa.add_argument("--host", default="0.0.0.0")
    pa.add_argument("--port", type=int, default=8000)
    pa.add_argument("--debug", action="store_true")

    args = parser.parse_args(argv)
    inferencer = _make_inferencer(args)

    if args.command == "predict-single":
        result = inferencer.predict_single_image(
            args.input, args.output,
            save_probabilities=args.save_probabilities,
            largest_component_postprocessing=args.postprocessing,
            generate_vtk=args.generate_vtk, vtk_output_file=args.vtk_output,
            color_file=args.color_file, smoothing_factor=args.smoothing_factor,
            decimation_factor=args.decimation_factor)
        print(json.dumps(result, indent=2))
    elif args.command == "predict-batch":
        results = inferencer.predict_batch(
            args.input_folder, args.output_folder,
            generate_vtk=args.generate_vtk, color_file=args.color_file)
        print(json.dumps({"n_cases": len(results), "results": results}, indent=2))
    elif args.command == "serve-api":
        from .rest_api import FastnnUNetAPI
        FastnnUNetAPI(inferencer, args.host, args.port, args.debug).run()


if __name__ == "__main__":
    main()
