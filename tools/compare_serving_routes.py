#!/usr/bin/env python3
"""The fast-inference module's two routes on the card, logits against
logits: the exported artifact (``model.pt2``, fixed batches of 8 tiles)
and the model folder (``NNUNetPredictor``), on the bone_turbo r = 2 student
with seeded random weights (``chip_smoke.write_student_model_folder``) over
one random preprocessed volume of 48 x 419 x 419 (a 512 x 512 x 96 CT at
the student's spacing, which takes the chunked route in chunks of 4
tiles). Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/compare_serving_routes.py

Prints each route's seconds, the routes' max logit difference and argmax
agreement with the model folder's batches as they are and padded to the
tile batch, whether two artifact calls are bit-equal, and one batch of 8
tiles through the eager network against the artifact and its first 4
tiles alone against the same 4 in the batch of 8.
"""
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from fast_nnunet_tpu_torch.export.export_model import \
    export_model_folder_to_artifact  # noqa: E402
from fast_nnunet_tpu_torch.fast_inference.inferencer import \
    FastnnUNetInferencer  # noqa: E402


def main():
    root = tempfile.mkdtemp()
    cs.write_student_model_folder(root + "/model")
    export_model_folder_to_artifact(root + "/model", 0, root + "/export",
                                    device="cuda")
    a = FastnnUNetInferencer(config_file=root + "/export/model_config.json",
                             device="cuda")
    b = FastnnUNetInferencer(model_folder=root + "/model", folds=(0,),
                             device="cuda")
    b.predictor.engine.pad_to_tile_batch = False  # batches as the predictor's
    data = np.random.RandomState(0).randn(1, 48, 419, 419).astype(np.float32)
    t = time.time()
    la = a.predict_logits_from_preprocessed(data)
    print("artifact", time.time() - t)
    t = time.time()
    lb = b.predict_logits_from_preprocessed(data)
    print("folder", time.time() - t)
    print("artifact vs folder: max diff", np.abs(la - lb).max(),
          "argmax agree", (la.argmax(0) == lb.argmax(0)).mean())
    b.predictor.engine.pad_to_tile_batch = True
    lc = b.predict_logits_from_preprocessed(data)
    print("artifact vs folder padded: max diff", np.abs(la - lc).max(),
          "argmax agree", (la.argmax(0) == lc.argmax(0)).mean())
    print("artifact twice bit-equal",
          np.array_equal(la, a.predict_logits_from_preprocessed(data)))
    net = b.predictor.engine.load_params(b.predictor.list_of_parameters)[0]
    x = torch.randn(8, 1, 160, 96, 96, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        y1, y2, y3 = net(x), a.engine.network(x), net(x[:4])
    print("eager vs export B=8", (y1.float() - y2.float()).abs().max().item(),
          "B=4 vs B=8 first 4",
          (y3.float() - y1[:4].float()).abs().max().item())
    t = time.time()
    la.argmax(0)
    print("np argmax", time.time() - t)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
