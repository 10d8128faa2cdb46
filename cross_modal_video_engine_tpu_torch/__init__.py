"""Cross-Modal-Video-Engine ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX one (`cross_modal_video_engine_tpu`), with
the same layout and names, so each module's counterpart is easy to find.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package on
the ported path is a CUDA kernel written by hand for sm_90a (`csrc/`),
with a plain PyTorch version beside it that CPU tensors run.

Ported so far: the CLIP ViT-B/32 video-embedding and search path
(ops/preprocess, ops/pallas_preprocess, ops/similarity.l2norm,
ops/attention_sublayer, models/clip, retrieval/index, convert/from_jax).
"""

__version__ = "0.1.0"
