"""repro_torch: PyRadiomics-cuda's feature extraction on PyTorch and CUDA.

A port of the JAX package ``repro`` to an NVIDIA H100, laid out like it
(``core/``, ``kernels/``, ``data/``), that imports neither JAX nor ``repro``.
It runs single-case shape extraction (``ShapeFeatureExtractor``), the
batched two-pass cohort path (``BatchedExtractor``) with the shape,
first-order and GLCM feature families, its stream and the cost model's
auto knobs (``runtime/costmodel``), the multi-tenant service
(``BatchedExtractor.serve``, ``serve/``, ``launch/serve``), and out-of-core
tiled extraction (``TiledExtractor``, ``TiledCase``,
``BatchedExtractor(tiled=True)``) with shape and first-order, each with
every diameter variant of the reference and the autotuner that picks among
them (``runtime/autotune``).  The TPU
kernels on those paths (marching cubes and its per-window partials, the
diameter sweep in all seven variants, segmented compaction, the batched
forms of the first two, first-order stats and GLCM) are replaced by CUDA
C++ kernels written for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use;
beside each sits its plain PyTorch version.  Entry points run on the
card unless the caller passes ``device='cpu'``, and raise when there is no
card.

The radiomics path has no learned weights.  The state carried across from
the reference there is the marching-cubes tables, the case data and the
slab sources, and the port has its own copies of their numpy code
(``core/mc_tables.py``, ``data/synthetic.py``, ``data/tiles.py``,
``data/nifti.py``); tests hold every table, ``make_case`` array and slab
equal to the reference's.

The package also ports the LLM scaffold's serving path: the ten
architectures' configs (``configs/``), their models (``models/``:
``Decoder``, ``RWKV6``, ``EncDec`` as ``nn.Module``s, parameters drawn
from a seed) and the serve step (``serve/serve_step.py``).  Its weights
cross between the packages through ``models/convert.py``
(``params_from_reference``, ``params_to_reference``: the reference's
nested parameter dicts, exactly), which the tests use so both packages
compute with the same weights.  Its training path is ported too: AdamW
and the schedules, the train and eval steps over ``torch.autograd`` with
``cfg.remat`` as ``torch.utils.checkpoint`` (``train/``, exported there:
``OptState``, ``make_train_step``, ``Trainer``, ...), the atomic
checkpoint in the reference's layout (``runtime/checkpoint``), and
``launch/train``; training runs over a mesh of slots too (a data-parallel
``Trainer``, int8 gradient compression, GPipe, ``elastic_remesh``:
``parallel/``), and ``launch/dryrun`` lays every (arch x shape x mesh)
cell out on the ``meta`` device.  The scaffold runs no hand kernel: the
reference computes it outside any Pallas kernel.
"""
from repro_torch.core import (
    BatchedExtractor,
    ShapeFeatureExtractor,
    StageTimes,
    TiledCase,
    TiledExtractor,
    crop_to_roi,
    resolve_device,
)

__all__ = ["BatchedExtractor", "ShapeFeatureExtractor", "StageTimes", "TiledCase",
           "TiledExtractor", "crop_to_roi", "resolve_device"]
