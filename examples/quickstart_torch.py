"""Quickstart on the PyTorch port: the paper's 4-line usage, on the card.

The twin of ``examples/quickstart.py``.  The same four lines run against
``repro_torch``, whose marching-cubes and diameter stages are hand-written
CUDA kernels.  The extractor runs on the CUDA card by default and raises
when there is none; pass ``--cpu`` to run the plain PyTorch versions.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--cpu] [scan.nii mask.nii]
"""
import sys

import torch

from repro_torch.core.shape_features import ShapeFeatureExtractor
from repro_torch.data.synthetic import make_case


def main():
    args = sys.argv[1:]
    device = "cpu" if "--cpu" in args else "cuda"
    args = [a for a in args if a != "--cpu"]
    if len(args) == 2:  # real NIfTI inputs, as in the paper
        from repro_torch.data.nifti import read_nifti

        image, _ = read_nifti(args[0])
        mask, spacing = read_nifti(args[1])
    else:  # synthetic KITS19-like case
        image, mask, spacing = make_case((128, 96, 80), seed=7)

    ext = ShapeFeatureExtractor(device=device)
    res, times = ext.execute(image, mask, spacing, with_times=True)

    name = torch.cuda.get_device_name(ext.device) if ext.device.type == "cuda" else "cpu"
    print(f"device           : {ext.device} ({name})")
    print(f"MeshVolume       : {res['MeshVolume']:.2f}")
    print(f"SurfaceArea      : {res['SurfaceArea']:.2f}")
    print(f"Maximum3DDiameter: {res['Maximum3DDiameter']:.2f}")
    print(f"Sphericity       : {res['Sphericity']:.4f}")
    print(f"mesh vertices    : {int(res['_n_mesh_vertices'])}")
    print(
        "stage times (ms) : "
        f"prep={times.preprocess_ms:.1f} transfer={times.transfer_ms:.1f} "
        f"mc={times.mesh_ms:.1f} diam={times.diameter_ms:.1f}"
    )


if __name__ == "__main__":
    main()
