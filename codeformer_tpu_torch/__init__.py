"""codeformer_tpu_torch — the PyTorch/CUDA port of codeformer_tpu.

Mirrors the JAX package's layout and names. Batched aligned 512x512 face
restoration (pipeline/restorer.py) runs on an NVIDIA H100 with
hand-written Hopper kernels for the ResBlock conv and the stride-2
Downsample (csrc/, ops/conv3x3.py); stage-II training (train/) adds one
for the VQ nearest-code search (ops/vq.py). Whole images and videos go
through the fused device pipeline (pipeline/device_pipeline.py:
RetinaFace detect, align, restore, ParseNet, paste back) or the classic
per-stage path (pipeline/face_helper.py, pipeline/video.py, with the
device compositor of pipeline/compositor.py); the colorization and
inpainting models have their CLIs (cli/). Imports torch and numpy,
never jax.
"""

__version__ = "0.1.0"
