"""Cross-Modal-Video-Engine ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX one (`cross_modal_video_engine_tpu`), with
the same layout and names, so each module's counterpart is easy to find.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package on
the ported path is a CUDA kernel written by hand for sm_90a (`csrc/`),
with a plain PyTorch version beside it that CPU tensors run.

Ported so far: the CLIP ViT-B/32 video-embedding and search path
(ops/preprocess, ops/pallas_preprocess, ops/similarity.l2norm,
ops/attention_sublayer, models/clip, retrieval/index, convert/from_jax)
and the TimeSformer recognition and caption path (ops/flash_attention,
models/timesformer, models/decoder_head, models/recognizer,
utils/precision, api), and LINAS text->video retrieval served over HTTP
(models/layers, models/dual_encoding, io/flax_msgpack, io/bigfile,
train/checkpoint, data/provider, utils/vocab, utils/text2vec,
metrics/retrieval, retrieval/evaluation, service/batching, service/app,
cli/common, cli/retrieval_inference, cli/retrieval_tester, cli/serve,
bench/serve) with its trainer (losses/triplet, losses/distill,
train/optim, train/linas_trainer, train/resume, cli/retrieval_trainer),
and composed text+video retrieval (utils/bpe, ops/preprocess,
models/clip_resnet, models/combiner, io/video_decode,
data/composed_dataset, losses/contrastive, train/combiner_trainer,
cli/composed_inference, cli/combiner_trainer, cli/composed_validate, the
composed_retrieval route of cli/serve), and caption inference served over
HTTP (utils/registry, config, data/pipelines, data/datasets,
metrics/accuracy, the decode ops of io/video_decode,
api.inference_recognizer, cli/caption_inference, cli/caption_test, the
caption route of cli/serve), and explainable recognition served over
HTTP (explain/*, cli/explain_demo, the explain route of cli/serve, the
demo pages of service/demo).
"""

__version__ = "0.1.0"
