"""Canonical predictor API usage of the PyTorch port (the port of
fast_nnunet_tpu/inference/examples.py; ref distillation/nnunetv2/inference/
examples.py and inference/readme.md). Run pieces of this interactively — it
is documentation that executes. Everything runs on ``cuda``; pass
``device="cpu"`` to the predictor or inferencer to run on the CPU."""


def example_predict_from_files():
    """Folder in -> folder out, the common case."""
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
    predictor = NNUNetPredictor(tile_step_size=0.5, use_gaussian=True,
                                use_mirroring=True)
    predictor.initialize_from_trained_model_folder(
        "/path/to/nnUNet_results/Dataset003_Liver/"
        "NNUNetTrainer__nnUNetPlans__3d_fullres",
        use_folds=(0, 1, 2, 3, 4),
        checkpoint_name="checkpoint_final.fnnx")
    predictor.predict_from_files(
        "/path/to/imagesTs", "/path/to/output",
        save_probabilities=False, overwrite=False,
        num_processes_preprocessing=2, num_processes_segmentation_export=2)


def example_predict_single_npy_array():
    """In-memory array in -> segmentation out (no files)."""
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
    predictor = NNUNetPredictor()
    predictor.initialize_from_trained_model_folder(
        "/path/to/model_folder", use_folds=(0,),
        checkpoint_name="checkpoint_best.fnnx")
    img, props = NiftiIO().read_images(["/path/to/case_0000.nii.gz"])
    seg = predictor.predict_single_npy_array(img, props)
    return seg


def example_custom_iterator():
    """The custom-iterator protocol: anything yielding
    {'data', 'data_properties', 'ofile'} dicts can feed the predictor."""
    from fast_nnunet_tpu_torch.inference.data_iterators import (
        preprocessing_iterator_fromfiles)
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor

    predictor = NNUNetPredictor()
    predictor.initialize_from_trained_model_folder("/path/to/model_folder")
    iterator = preprocessing_iterator_fromfiles(
        [["/path/case1_0000.nii.gz"], ["/path/case2_0000.nii.gz"]],
        None, ["/out/case1", "/out/case2"],
        predictor.plans_manager, predictor.dataset_json,
        predictor.configuration_manager, num_processes=2)
    from fast_nnunet_tpu_torch.inference.export import export_prediction_from_logits
    for item in iterator:
        logits = predictor.predict_logits_from_preprocessed_data(item["data"])
        export_prediction_from_logits(
            logits, item["data_properties"], predictor.configuration_manager,
            predictor.plans_manager, predictor.dataset_json, item["ofile"])


def example_fast_inference_from_artifact():
    """Serving path: exported torch.export artifact (fast_nnunet_export_model_
    torch), no training code needed."""
    from fast_nnunet_tpu_torch.fast_inference.inferencer import FastnnUNetInferencer
    inferencer = FastnnUNetInferencer(config_file="/path/export/model_config.json")
    inferencer.predict_single_image("/path/ct.nii.gz", "/path/seg.nii.gz",
                                    generate_vtk=True, smoothing_factor=0.5,
                                    decimation_factor=0.2)
