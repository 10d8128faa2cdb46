#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage: python3 chip_smoke.py [STEP ...]   (from the root of the repository)

With no argument every step runs (the whole smoke run).  A list of
step numbers ("19", "13 19" or "13,19") runs only those steps, always
after the build (2) and the kernel checks (3) and before the results
(26); 4-5 and 6-7 run as pairs.  A kernel's launch count on a path whose
step did not run is null in the `kernels` line; the last line names the
steps that ran and those skipped.

1. prints the card's name and power limit and the torch/CUDA versions;
2. builds the CUDA kernels from csrc/ with nvcc for sm_90a (one nvcc per
   source, in parallel);
3. checks each kernel against its plain PyTorch version on the card, in
   bf16 and f32, with times: one 64 x 64 x 64 tile through TMA and wgmma
   (both operand layouts, then the 3-D box and 80-key tile of the
   attention core, then the block kernel's 192-row box with an N = 32
   slice) against torch.matmul; the GEMM of gemm.cu by itself,
   each epilogue at the main-path shapes and at ragged ones, with
   TFLOP/s and `F.linear`'s time printed beside it as a yardstick; the
   attention core by itself at (6400 and 51200 rows, L=50, 12 heads),
   (616 rows, L=77, causal, 8 heads) and padded rank-3 rows (80 of which
   77 valid) with its bytes bound and the kernel `core_path` names; the
   sublayers at the CLIP ViT-B/32 main-path shapes with the host time of
   one call, the whole-block kernel at its main-path shape (51200, 768),
   at (6400, 768) (f32: (800, 768)) and at a small shape, also against
   the two-kernel chain, with the route `block_path` names for each and
   ptxas's registers and spills of both bf16 routes;
   flash attention at the TimeSformer shapes (joint 8x224 with 1569
   tokens, space-only 197, causal 1000 at head dim 128, causal 197
   queries against 1569 keys), at a head dim that stays on the mma.sync
   path and on the strided views an attention layer hands it, with
   `scaled_dot_product_attention` timed beside it as a yardstick; then
   one backward through each of the five kernel wrappers, gradients
   against the plain version's autograd;
4. CLIP path: builds ViT-B/32 (widths 768/512, 12+12 layers, bf16) with
   random weights from a numpy seed and drives it once with the launch
   counters zeroed: uint8 videos through `encode_video_u8`, a bf16
   `RetrievalIndex` of 65,536 rows, text queries through `encode_text`,
   `search`; then checks the kernel arm against the plain arm
   (fused_attn=fused_mlp=False), the search against brute force, and the
   counters;
5. times videos/s of both CLIP arms at B=32, and one query wave (text
   tower of each arm with its sublayer calls and kernel launches counted,
   then the search);
6. caption path: the joint space-time TimeSformer ViT-B/16 (8x224,
   patch 16, width 768, 12 heads, 12 layers, bf16, flash attention)
   with the RNN decoder of configs/seq_generate/timesformer_relseq.py,
   random weights from a numpy seed, loaded through
   `api.init_recognizer`; 16 normalised clips through `api.caption_clips`
   with the flash counter zeroed (12 launches per forward), checked
   against the plain arm (use_flash_attention=False, same weights):
   backbone CLS features by cosine, step-0 probabilities by the bf16
   tolerance, label flips of steps 1-4 counted; then the shipped divided
   space-time caption config (bf16, no kernel on its path) at 2 clips;
7. times videos/s of both TimeSformer arms at 16 clips;
8. bench path: `entry()` once; the 12-layer compact stack of
   bench/block_ab.py at (51200, 768) bf16 through the two-kernel chain
   and through the whole-block kernel with the launch counters zeroed (12
   block launches), outputs compared by cosine and, layer by layer on the
   chain's input, by the kernels' bf16 bound, both timed; the block
   kernel built with -DCMVE_BLK_NO_MMA (built beside the checks), its time
   at (51200, 768) and the rate at which L2 then hands every block all of
   a layer's weights; the headline bench at B=128 with few steps;
9. index: 1M x 512 rows drawn on the card, stored as bf16 and as int8,
   64 queries, top-10: bf16 equal to brute force, int8 recall@10 against
   the exact answer, search times and the peak memory of a search;
10. LINAS retrieval serving at the full width of the shipped
    DualEncodingConfig (1536-d common space, de+map student), everything
    from numpy seeds: (a) a seeded state dict written with the port's
    save_checkpoint (the JAX package's format) and read back through
    restore_dual_encoding, bit-equal; (b) a collection of 500 videos of
    3-64 frames x 2048 with 5 captions each written with write_bigfile,
    embedded by build_video_index at batch 64 (videos/s); (c) its first
    64 videos and 64 captions through the same model on the CPU,
    L2-normalized embeddings within 1e-3, and retrieval_tester.evaluate
    on both over those 64 videos and their 320 captions, error matrices
    within 1e-3; (c') cli.retrieval_inference, as a user runs it, over a
    collection of those 64 videos in a fresh process on the card and in
    one on the CPU, neither with this script's TF32 switch (the CLI turns
    TF32 off itself): 1 query, the same top-10 ids and scores within
    1e-3, the error printed; (d) the server's index filled to 1,000,000 x
    1536 f32 rows; (e) the HTTP server of cli/serve.py answering 16
    captions as index.search_ids(embed_query(...)) does; (f)
    bench/serve.py's batch-1 p50/p99 (also of the handler without
    HTTP), conc-64 p50/p99 (clients in their own process) and GET
    /metrics; (g)
    one wave of 1 and of 8 rows by CUDA events and by the wall clock,
    with the idle share; (h) a `serving` JSON line with those numbers;
11. LINAS training at the full width of the shipped DualEncodingConfig
    (dropout 0, de+map student, LinasTrainConfig(): Adam, clip 2.0),
    batch 128 with a support set of 8, on a seeded collection of 256
    videos x 5 captions (validation: 128 more): (a) one train step on the
    card and on the CPU from one seeded state dict and one batch: loss,
    every gradient and the parameters after the Adam step; (b) each
    similarity_type at B = 128, card against CPU (and how often cuSOLVER's
    singular vectors have LAPACK's sign: 'svd' factorizes on the host);
    (c) `retrieval_trainer.train()` for 2 epochs with an epoch state each:
    the step losses (finite, the last four below the first four), the
    loss and rsum an epoch, the validation time, then on the trained model
    the step time by CUDA events, samples/s, the optimizer's share, the
    host's batch assembly and the idle share of five steps
    (torch.profiler); (d) a resume from epoch_0 against the uninterrupted
    epoch 1; (e) model_best restored and served over HTTP, answers equal
    to a direct search_ids; (f) text+video with the 'adapt' mask, a few
    steps: pa moves, losses finite; (g) a `training` JSON line;
12. composed retrieval, everything from numpy seeds and no video decode
    (cv2 and h5py are not imported: the reference videos go to the route
    already decoded, through its `decode` seam): (a) clip_preprocess on
    the card against the CPU, a shrinking (360x480) and a growing
    (120x160) size, each pad mode, 288 and 224; (b) the RN50x4 tower at
    the full width of CLIPResNetConfig() (f32, TF32 off) restored from its
    JAX-format checkpoint, card against CPU on 1 frame (high, middle,
    encode_text), with its parameter and MAC counts; (c) the
    /composed_retrieval route with RN50x4 and the conv4x4 Combiner at
    CombinerConfig() widths over 250 candidates stored as npz feature
    caches, 8 HTTP requests of a 64-frame 360x480 reference video and a
    text, answers against a direct rank_index, batch-1 p50/p99, the
    extraction's and one wave's times; (d) the same route with a ViT-B/32
    checkpoint (fused sublayers) and CombinerConfig(clip_feature_dim=512)
    over a second collection at width 512, the compact, MLP and rank-3
    launch counters zeroed just before its requests and read just after,
    the kernel arm's combine_features against the plain arm's by cosine;
    (e) the combiner trainer on 128 triplets over that collection with
    the route's ViT-B/32 text tower frozen: one step card against CPU at
    dropout 0 (step 11a's bounds), 2 epochs with validation each epoch
    (the last four step losses below the first four), composed_validate
    on the card, model_best served by the route, the step's time by CUDA
    events; (f) a `composed` JSON line;
13. the /caption route at full width: the joint space-time TimeSformer
    ViT-B/16 of step 6 (bf16, flash on, 12 layers, 8x224²) with the
    shipped decoder (36 classes, 5 steps), its checkpoint written in the
    JAX package's format from a numpy seed, videos of 300 frames of
    360x480 drawn frame by frame from a seed and handed to the route
    through its `decode` seam (no cv2, no video file): (a) 8 batch-1
    requests over HTTP and (b) one burst of 8 concurrent ones, every
    launch counter zeroed just before each and read just after (12 flash
    launches a wave, no other kernel), p50/p99 of both; (c) each answer
    against `caption_clips` on the route's model and clips: step-0
    labels equal outside the bf16 tolerance band around the threshold,
    later-step flips counted; (d) the route's clips equal to those
    `inference_recognizer` runs (TEST_PIPELINE), and its outputs; (e)
    the host pipeline's ms a request beside a wave of 1 and of 8 (wall,
    CUDA events, busy, idle share); (f) the shipped divided config
    (timesformer_relseq.py, bf16) served once with no kernel launch;
14. the /explain route at full width: the joint TimeSformer ViT-B/16 of
    step 6 (bf16, flash on) with a 400-class head, its checkpoint written
    in the JAX package's format from a numpy seed, concept banks from a
    seed (`symbolic` 80 x 768, `cluster` 240 x 768), the gradient probe
    at block 10, videos as in step 13: (a) 8 batch-1 requests over HTTP
    and (b) one burst of 8, every launch counter zeroed just before each
    and read just after (13 flash launches a wave: 12 in the capture
    forward, 1 in the recomputation from block 10; no other kernel),
    p50/p99 of both; (c) each answer and each wave's probe against
    `grad_extract` + `concept_scores` on the route's model and clips
    (prediction, probe cosine, top-k where the gaps clear the bf16
    margin); (d) the card against the port on the CPU for 1 video; (e)
    the bf16 flash backward at (1 and 8, 12, 1569, 64), one launch each,
    gradients finite and against the plain version's autograd; (f) one
    request at target_layer 0 with its 23 launches and peak memory; (g)
    the handler's ms without HTTP, the host pipeline's ms, a wave of 1
    and of 8 (wall, CUDA events, busy, idle share, the capture forward
    and the gradient pass apart, flash launches, peak memory);
15. TimeSformer training at full width (ViT-B/16, 8x224², 12 layers),
    everything from numpy seeds and no video decode: 8 seeded videos of
    300 frames of 256x341 go to the trainers' pipelines through the
    `reader` seam: (a) one f32 step of the shipped caption config
    (timesformer_relseq.py, 36 classes x 5 steps, TF32 off, dropouts 0)
    at batch 1 on the card and on the CPU from one init: the loss, every
    gradient and the parameters after the SGD step (the clip engaged),
    step 11a's bounds; (b) `caption_train.train_from_config` on that
    config, batch 8, 2 epochs with validation each epoch (losses finite),
    a resume from epoch_0 against the uninterrupted epoch 1 (both on the
    card), a repeat-the-same-batch run whose loss falls, and model_best
    served by /caption, its answers equal to a direct `caption_clips`;
    (c) the config with joint attention through the flash kernel (f32,
    the fma path) at batch 8: the flash counter zeroed and read around
    each step (12 a step, 24 with remat), gradients finite and against
    the plain arm (flash off, same weights) and the remat arm by cosine;
    (d) one bf16 step of the recognition config
    (timesformer_divst_8x32_k400.py, 400 classes, f32 masters) at batch 1
    card against CPU within bf16 bounds, then
    `recognition_train.train_from_config` with bf16=True, batch 8, 1
    epoch, and its model_best served once by /explain, the prediction
    equal to a direct grad_extract; (e) each trainer's step by CUDA
    events, videos/s, TFLOP/s, the optimizer's share, the host's batch
    assembly, the idle share of two steps of the loop (torch.profiler),
    peak memory, and bench/extra.py's train-step row;
16. the concept detector and the concept-bank build at full width, from
    numpy seeds and no decode: the shipped configs/detection/yolov5
    yolov5s (depth 0.33, width 0.50, 80 classes, 640²), its segment
    variant (nm 32, npr 256) and the classifier (1000 classes, 224²),
    weights drawn in the ultralytics layout, two classes made to fire on
    every image (YOLO_FIRE): (a) f32 with TF32 off, batch 16 of
    letterboxed seeded 480x640 images, card against CPU: raw maps and
    decoded predictions within YOLO_F32_REL, the NMS outputs matched in
    the detect (conf 0.25) and val (conf 0.001, multi-label) protocols,
    the TTA arm, the segment arm's prototypes and masks, the classifier's
    logits; (b) `yolo_val.main` on the card over 8 seeded 480x640 .npy
    images whose labels are the CPU's own detections, the detector read
    from a `best/` directory in the JAX format: mAP@0.5 >= 0.99 and the
    report within the bound of the same CLI on the CPU; then --augment
    and the segment config; (c) `ctv_build.build_ctv_banks` with step
    14's joint ViT-B/16 (bf16, flash, 400 classes) and the firing
    detector over 4 seeded 300-frame 352x480 videos through the reader
    seam, the flash counter read around each video (12 a video, 0 in the
    detector), the banks against the CPU's build on 1 video, the npz
    served by /explain against a direct concept_scores, a 360x480 video
    refused; (d) `explain_video` with the detector, card against CPU;
    (e) the detector's forward at batch 16 (ms, images/s, TFLOP/s from
    the convolutions' shapes), the host's NMS and letterbox, yolo_val's
    images/s and idle share, ctv_build's seconds a video by phase, peak
    memory; (f) a `concept_detector` JSON line;
17. the word-level caption transformer and the detector's training at
    full width, from numpy seeds: (a) Recognizer3DCaption on step 13's
    joint ViT-B/16 (bf16, flash) with the default CaptionConfig (vocab
    10000, width 512, 8 heads, 4 layers, 24 tokens): teacher forcing,
    `generate("greedy")` and `generate("beam", 4)` on 4 seeded clips, the
    flash counter zeroed and read around each (12 a call), clip 0 against
    the CPU (the logits by CAPTION17_REL and CAPTION17_COS, token
    divergences counted), generate timed by CUDA events; (b)
    `yolo_train.train_from_config` on configs/detection/yolov5/
    yolov5s_coco_640.py as shipped (yolov5s, 640, batch 16, bf16, mosaic
    and HSV) over 32 seeded 480x640 `.npy` images, 2 epochs with
    AutoAnchor and validation on 8 more, every kernel counter zeroed and
    read around it (no launch), a resume from epoch_0 against the
    uninterrupted epoch 1, `best/` read by `yolo_val.main` (its mAP that
    epoch's) and by ctv_build's loader, one step at batch 2 card against
    CPU in f32 (YOLO17_F32) and in bf16 (YOLO17_BF16); (c) two steps each
    of the shipped segment and classify configs (32 masks; 1000 classes
    at batch 64) through their train_from_config, one f32 step of each
    card against CPU; (d) each trainer's step by CUDA events
    (the detector's and segmenter's through bench/extra.py's rows), images/s
    and each loop's idle share (the host augments in numpy);
18. the 3D-CNN recognizers at full width, from numpy seeds and no
    decode, every kernel counter zeroed before the step and read after
    it (none may launch: no 3D-CNN path reaches a kernel): (a) each
    shipped recipe (slowonly_r50_8x8, i3d_r50_32x2, i3d_nl_embedded,
    csn_r50 ir, slowfast_r50_4x16 with its s2d fast stem, x3d_m; 400
    classes, the training init) card against CPU at batch 1 in f32 (TF32
    off), logits within CNN18_REL and cosine CNN18_COS, then its forward
    at batch 8 in f32 and bf16 (ms, TFLOP/s of its products, peak
    memory), and the fast pathway's s2d stem timed against the plain
    stem conv (a finding; nothing switched); (b)
    `recognition_train.train_from_config` on the shipped
    slowfast_r50_4x16_k400.py (warmup 0: the recipe's 500 steps outlast a
    4-step run) at batch 8 over 8 seeded 300-frame 256x341 videos
    through the reader seam, 2 epochs with validation, a resume from
    epoch_0 against the uninterrupted epoch 1 (parameters and
    batch_stats), model_best with its batch_stats; one stats step at
    batch 1 (the clip's central 112²) card against CPU in f32 and in
    bf16, from epoch_1 (step 19b
    takes steps from the training init), held to float64 as closely as
    the CPU is,
    with planted faults the check must refuse; bench/extra.py's
    `train_step_slowfast` row at batch 8 and 16 (halved until it fits),
    the shipped recipe's step by CUDA
    events and its loop's idle share (torch.profiler), peak memory; (c)
    `caption_train.train_from_config` on the shipped i3d_relseq.py, one
    epoch, its model_best served over /caption (4 batch-1 requests and a
    burst of 8, p50/p99), every answer against a direct `caption_clips`;
    (d) the launch counters;
19. the 2D, TSM and pyramid recognizers at full width, the same way
    (none may launch a kernel): (a) each shipped recipe (tsm_r50_1x1x8,
    tsn_r50_1x1x3, tin_r50_1x1x8 (mmaction's ResNetTIN), trn_r50_1x1x8
    (TRNMultiScale), tanet_r50, tpn_slowonly_r50_8x8, c3d_16x1 at 16x112²
    with fc 4096, r2plus1d_r34_8x8; their own classes and clips, the
    training init) and tsm_relseq.py's pooled TSM feature, card against
    CPU at batch 1 in f32, logits within CNN18_REL and cosine CNN18_COS,
    then the forward at batch 8 in f32 and bf16; (b) one stats step at
    batch 1 card against CPU for TSM, TIN, TRN (one fixed draw of its
    tuples) and TPN (with loss_aux), each backbone at one block a stage
    (widths kept), f32, and bf16 for TSM, held to
    float64 as 18b holds SlowFast, with its planted faults; (c)
    `recognition_train.train_from_config` on the shipped TSM recipe over
    16 seeded videos at batch 8, one epoch with validation, then
    `recognition_test.test_from_config` on its model_best, the scores
    against a direct forward_test; (d) `caption_train` on the shipped
    tsm_relseq.py, one epoch, its model_best served over /caption as in
    18c; (e) the launch counters;
20. the transformer and CLIP recognizers at full width, the same way:
    (a) each shipped recipe (swin_tiny, mvit_small, videomae_b_16x4 at
    16x224², clip_mean_pooling_8x32, videoclip_ctv_extraction; 400
    classes, the training init) and the pooled features of
    mvit_relseq.py and videomae_relseq.py (MViT at one block a stage,
    VideoMAE at 4 layers), card against CPU at batch 1 in f32, then the forward at batch 8 in f32 and through the bf16=True
    copy, with TFLOP/s; (b) clip_mean_pooling_8x32 with
    fused_attn=fused_mlp=True against its plain arm on the same weights
    at batch 8 (64 frames), bf16 and f32: logits, exactly 12 compact and
    12 MLP launches a forward, one training step of each arm (gradients
    by group), both arms timed; (c) one make_cls_train_step at batch 1
    card against CPU for each recipe (Swin at two blocks a stage, MViT
    at one, VideoMAE and CLIP at 2 blocks: widths kept), f32, and bf16
    for Swin3D and
    VideoMAE, held to float64 as 18b holds SlowFast, with its planted
    faults; (d) `recognition_train` on swin_tiny_k400.py over 16 seeded
    videos at batch 8, one epoch, then `recognition_test` against a
    direct forward_test; `caption_train` on videomae_relseq.py, one
    epoch, its model_best served over /caption as in 18c; (e) the launch
    counters: none but 20b's kernel arm may launch a kernel;
21. the training recipes and the bf16-configured TimeSformer at full
    width: (a) the shipped slowfast_multigrid_k400.py (SlowFast-R50 4x16,
    400 classes): one stats step in each of its four buckets (64x4x112,
    32x8x112, 16x8x224, 8x8x224; CUDA events, videos/s, TFLOP/s, peak
    memory), the multigrid step at batch 1 card against CPU in the
    coarsest and the finest bucket (held to float64 as 18b; the SlowFast
    at one block a stage, widths kept), and
    `recognition_train` with the buckets at 1/8 of their batch over 8
    seeded videos until its history has switched buckets; (b) the
    shipped tsn_r50_1x1x8_minikinetics_omnisource.py (TSN-R50, 200
    classes, batch 8, two aux sources) through `recognition_train` for
    two epochs, a resume from epoch_0 against the uninterrupted epoch 1,
    and its step card against CPU at batch 1; (c) mixup and cutmix, their
    draws handed in, on the stats step of tsn_r50_1x1x3_k400.py at batch
    2 (its backbone at one block a stage, widths kept), card against CPU
    in f32 and bf16; (d) TS_JOINT configured
    bfloat16 on f32 masters, trained without bf16=True: one
    make_cls_train_step and one make_seq_train_step at batch 2, the three
    shuffle recognizers' forward_train and a step each, the flash
    counter read around each call (12 a backbone pass, 24 a shuffle
    step), block 0's f32 attention through the kernel against its plain
    version at (12, 1569, 64), and the cls step card against CPU at 2 of
    the 12 layers (widths kept); (e) hvu_loss over the 3142 HVU tags in
    each mode, card against CPU;
22. temporal localization at the shipped configs' widths, from numpy
    seeds, every kernel counter zeroed before the step and read after it
    (none may launch: no localization path reaches a kernel): (a) BMN of
    bmn_anet_400x100.py (T=100, F=400, N=32, D=100, hidden 256/128/512),
    the sampling matrix's build time and bytes, card against CPU at
    batch 2, its forward at batch 8 by CUDA events (ms, TFLOP/s of the
    counted products, peak memory); (b) one step of the config's AdamW
    at batch 1 card against CPU, held to float64 as 18b holds its steps,
    with the planted faults, then the step at batch 8 (ms, videos/s,
    TFLOP/s, peak memory); (c) `localization_train.train_from_config` on
    the card over 16 seeded videos of 100 x 400 features, 2 epochs each:
    BMN (AR@AN on 4 of them), TEM, `misc_tools bsn_pgm` over the trained
    TEM's curves, PEM on those artifacts (AR@AN), SSN (20 classes,
    sampler 1/6/1) over 8 seeded videos of a normalized_ proposal file
    put through `data_tools denormalize_proposals`: losses finite, each
    `*_final` checkpoint read back bit for bit by the port's loader,
    BMN's and PEM's AR@AN equal to their checkpoints' evaluated by the
    port on the CPU; (d) the launch counters and a `localization` JSON
    line;
23. spatio-temporal action detection (AVA) at the shipped configs'
    widths (SlowOnly, SlowFast, ACRN, LFB with FBO), from numpy seeds, no
    kernel on its path: (a) each config card against CPU and timed at
    batch 8 x 32 RoIs with its SGD step; (b) each step held to float64
    with planted faults; (c) `ava_proposals`, `detection_train`,
    `detection_test` and the LFB bank; (d) the launch counters;
24. the native host IO layer and the host tools: (a) both host libraries
    built from native/*.cc with g++ and the libav probe's verdict
    printed; NativeBigFile over a 50,000 x 2048 f32 frame-feature file,
    128-video gathers with 4 threads bit-equal to a numpy memmap, rows/s;
    (b) where libav was found, raw AVIs written on this machine (no cv2,
    no encoder): NativeVideoReader bit-equal at native size with
    repeated and unordered indices, decode_videos_batch's fused resize
    within a mean bound of resize_linear (no frame zeros, a missing file
    zeros), read_audio of a stereo 44.1 kHz WAV at 16 kHz against the
    analytic sine; (c) bench/extra.py's host-feed row (decode-only
    videos/s with 1, 2 and 4 workers, then DecodePrefetcher into the
    fused ViT-B/32's encode_video_u8 end to end) with the compact and
    MLP launches (12 + 12 a batch) and the idle share of the loop; where
    libav was not found but cv2 is installed, 8 clips of cv2-written
    mp4s through decode_videos_batch's cv2 fallback instead; (d)
    `dump_features.main` at full width (joint TimeSformer ViT-B/16,
    8x224², 12 layers, flash, f32, 400 classes, weights from a numpy seed
    in a checkpoint) over 4 videos in mode both at layers 0, 5 and 11,
    decoded by NativeVideoReader (or from memory without libav), its
    flash launches counted, and one video card against CPU at every
    layer and at two gradient layers; (e) PrefetchIterator's batches on
    the card equal to the host's and a step loop with and without it;
    (f) data_tools txt2bin, combine_features, build_tags and
    extract_audio with their outputs read back, the cv2 tools refused;
25. skeleton recognition, the checkpoint converter and the exports, at
    the shipped configs' widths, from numpy seeds, no kernel on the path:
    (a) the ST-GCN recipe (COCO-17, clip_len 100, 2 persons, batch 16,
    60 classes) through `skeleton_train.main` for one epoch of 2 steps and
    an eval on a seeded pickle, its checkpoints read back; one SGD step
    card vs CPU held to float64 with the planted faults; forward and step
    times, TFLOP/s and peak memory; (b) the 2s-AGCN joint recipe (NTU-25,
    10 blocks) the same way, its bone stream on a COCO-17 AGCN of the
    same widths, and the NTU-25 bone recipe's numpy refusal; (c) PoseC3D
    (SlowOnly stage blocks (4, 6, 3), base 32) over 48x56x56
    GeneratePoseTarget heatmaps of 17 keypoints made on the host: the
    heatmap ms a batch, one step with the dropout masks handed in held as
    in (a), times, and host-fed steps with the card's idle share; (d)
    `convert_checkpoint.main` on the card for stgcn, agcn (the state dicts
    of (a) and (b)), clip (ViT-B/32), yolov5 (v5s) and resnet3d
    (SlowOnly-R50): each directory read back gives a forward bit-equal to
    the .pth's, ST-GCN's msgpack byte-equal with --device cpu; (e)
    `export_model --preset vitb32` and `export_yolo` on the v5s detect and
    segment configs: each program loaded back and called with its state
    dict equals its module's outputs, with its bytes and export seconds;
26. prints the JSON lines of steps 10-25 that ran and of the kernel
    results (launches on the main paths, on the composed, caption and
    explain routes, in the training steps, in the bank build, in the
    caption transformer's generates, in the detector's training, in the
    3D-CNN step, in the 2D-CNN step, over step 20, in 20b's CLIP kernel
    arm, over 21d, over steps 22, 23 and 25 and in step 24's host feed
    and dump, error, time, plain time, bound, library time), each step's
    seconds and, last, a JSON line naming the device.

Nothing is cut: the models run at full width and depth (the 3D-CNN
trainers 2 and 1 epochs of 8 videos, the 2D ones 1 epoch each; the LINAS
training runs 2 epochs of a 1,280-caption collection, the TimeSformer
trainers 2 and 1 epochs of 8 videos, the multigrid and OmniSource CLIs 2
epochs of 8 and 16, the detector's trainers 2 and 1 epochs of 32 images
and the classifier's 1 epoch of 128; the composed
route's candidates and the Combiner's triplets are stored features, as
the route and the trainer read them).  Exits non-zero, printing no
result, when CUDA is unavailable or any check fails.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import runpy
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "cross_modal_video_engine_tpu_torch"

# max |kernel - plain|: f32 differs only in summation order; in bf16 the
# inputs below keep outputs under 4 in magnitude, where one bf16 step is
# 1.6e-2, and a one-step flip of an intermediate rounding may reach them
# (flash attention with q, k, v drawn N(0, 1): where a bf16 output
# reaches |x| >= 4, in causal first rows that average one or two rows of
# v, one bf16 step is 3.1e-2, and the bound there is that one step)
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
COSINE_MIN = 0.999                          # kernel arm vs plain arm
GRAD_TOL = 1e-4                             # f32 gradients, kernel vs plain
LAYER_OUTLIERS = 1e-6     # share of a layer's elements past the block bound
INT8_RECALL_MIN = 0.9                       # recall@10 of int8 rows
# the card's published peaks: dense bf16 tensor-core rate and memory rate
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
BIG_INDEX_ROWS, BIG_INDEX_QUERIES = 1_000_000, 64
HEADLINE_BATCH, HEADLINE_STEPS, STACK_STEPS = 128, 3, 3
SRC = "cross_modal_video_engine_tpu_torch/csrc/"
TPU_SRC = "cross_modal_video_engine_tpu/ops/attention_sublayer.py"
TPU_FLASH = "cross_modal_video_engine_tpu/ops/flash_attention.py:151"
VIDEOS, FRAMES, QUERIES, INDEX_ROWS, BENCH_VIDEOS = 16, 8, 8, 65536, 32
# flash attention checks: name -> ((B, H, Sq, Skv, D), causal); the
# first is the joint model's shape, the kernel's main-path case
FLASH_CASES = {
    "joint 8x224 (1569)": ((4, 12, 1569, 1569, 64), False),
    "space-only (197)": ((16 * 8, 12, 197, 197, 64), False),
    "causal 1000 hd128": ((2, 8, 1000, 1000, 128), True),
    "causal 197 vs 1569": ((4, 12, 197, 1569, 64), True),
}
# beside them: a head dim the mma.sync path serves, the joint shape as
# head-transposed views of one (B, S, 3·H·D) projection, read in place,
# and the caption route's waves of 1 and 8 rows (step 13; its bursts of 4
# are the first case)
FLASH_EXTRA = {
    "head dim 96 (mma.sync)": ((2, 8, 1000, 1000, 96), False),
    "strided views (1569)": ((4, 12, 1569, 1569, 64), False),
    "caption wave of 1": ((1, 12, 1569, 1569, 64), False),
    "caption wave of 8": ((8, 12, 1569, 1569, 64), False),
}
FLASH_STRIDED = "strided views (1569)"
# gemm.cu by itself: name -> (M, K, N, epilogue, products sharing A); the
# first three are the launches of the ViT-B/32 sublayers at 16 videos
GEMM_CASES = {
    "mlp up, gelu": (6400, 768, 3072, "gelu", 1),
    "mlp down, residual": (6400, 3072, 768, "residual", 1),
    "q|k|v, bias": (6400, 768, 768, "bias", 3),
    "text wave, gelu": (616, 512, 2048, "gelu", 1),
    "ragged M=300 K=2048": (300, 2048, 512, "residual", 1),
    "ragged N=40": (300, 768, 40, "bias", 1),
    "ragged M=616 N=512 x3": (616, 512, 512, "bias", 3),
}
# csrc/attention_core.cu by itself: name -> (sequences, seq_stride, rows,
# valid_len, heads, causal); what the vision tower gives it at 16 and at
# 128 videos, what the text tower gives it, and rank-3 rows with pad rows
CORE_CASES = {
    "vision 6400 rows": (128, 50, 50, 50, 12, False),
    "vision 51200 rows": (1024, 50, 50, 50, 12, False),
    "text 616 rows causal": (8, 77, 77, 77, 8, True),
    "rank-3 padded 80/77": (8, 80, 80, 77, 8, True),
}
CLIPS = 16                                  # TimeSformer clips per call
# the caption path's backbone: TimeSformer ViT-B/16, joint space-time
TS_JOINT = dict(num_frames=8, img_size=224, patch_size=16, embed_dims=768,
                num_heads=12, num_layers=12,
                attention_type="joint_space_time", dtype="bfloat16",
                use_flash_attention=True)
RELSEQ_CONFIG = ROOT / "configs" / "seq_generate" / "timesformer_relseq.py"
# the stack of bench/block_ab.py: sequences, tokens, width, heads, layers
BLOCK_MAIN_CASE = "block stack"
STACK = dict(nseq=1024, seq_len=50, width=768, heads=12, layers=12)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events after warm-up."""
    from cross_modal_video_engine_tpu_torch.utils.profiling import (
        device_time)
    return device_time(fn, steps=iters, warmup=warmup, device="cuda") * 1e3


def check_selfcheck(dev, kern):
    """One 64 x 64 x 64 tile through the TMA and wgmma helpers of
    common.cuh (csrc/wgmma_selfcheck.cu) against torch.matmul: a b^T with
    both operands K-major, then bf16(a b^T) v with v as the transposed
    operand and the first product's accumulators as the register
    operand."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(500)
    a, b, v = (torch.randn(64, 64, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    d1 = torch.empty(64, 64, device=dev)
    d2 = torch.empty(64, 64, device=dev)
    err = kern.lib.cmve_wgmma_selfcheck(
        a.data_ptr(), b.data_ptr(), v.data_ptr(), d1.data_ptr(),
        d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    want1 = a.float() @ b.float().t()
    want2 = want1.to(torch.bfloat16).float() @ v.float()
    e1 = float((d1 - want1).abs().max())
    e2 = float((d2 - want2).abs().max() / want2.abs().max())
    # fp32 sums of 64 exact bf16 products: the order of summation only
    ok = err == 0 and e1 <= 1e-4 and e2 <= 1e-5
    print(f"wgmma/TMA self-check, one 64x64x64 tile: return code {err}, "
          f"a b^T max_abs_err {e1:.3e} (tol 1e-4), bf16(a b^T) v max "
          f"relative err {e2:.3e} (tol 1e-5) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit("wgmma/TMA self-check failed")
    # what csrc/attention_core.cu adds: sequence 1 of (2, 80, 64) buffers
    # through 3-D maps bounded at 77 rows, everything behind the bound inf
    k, v = (torch.full((2, 80, 64), float("inf"), device=dev,
                       dtype=torch.bfloat16) for _ in range(2))
    k[1, :77], v[1, :77] = (torch.randn(77, 64, generator=gen, device=dev)
                            .to(torch.bfloat16) for _ in range(2))
    d1 = torch.empty(64, 80, device=dev)
    err = kern.lib.cmve_wgmma_selfcheck_keys(
        a.data_ptr(), k.data_ptr(), v.data_ptr(), d1.data_ptr(),
        d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    want1 = torch.zeros(64, 80, device=dev)
    want1[:, :77] = a.float() @ k[1, :77].float().t()
    want2 = want1[:, :77].to(torch.bfloat16).float() @ v[1, :77].float()
    finite = bool(torch.isfinite(d1).all() and torch.isfinite(d2).all())
    e1 = float((d1 - want1).abs().max())
    e2 = float((d2 - want2).abs().max() / want2.abs().max())
    ok = err == 0 and finite and e1 <= 1e-4 and e2 <= 1e-5
    print(f"wgmma/TMA self-check, one 64x80x64 tile through 3-D maps "
          f"bounded at 77 of 80 rows (inf behind the bound): return code "
          f"{err}, a k^T max_abs_err {e1:.3e} (tol 1e-4), bf16(a k^T) v max "
          f"relative err {e2:.3e} (tol 1e-5) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit("wgmma/TMA key-tile self-check failed")
    # what csrc/block_sublayer.cu adds: A written by the threads at swizzled
    # addresses, one 192-row box read whole and 32 rows into it
    b = torch.randn(192, 128, generator=gen, device=dev).to(torch.bfloat16)
    d1 = torch.empty(64, 192, device=dev)
    d2 = torch.empty(64, 32, device=dev)
    err = kern.lib.cmve_wgmma_selfcheck_block(
        a.data_ptr(), b.data_ptr(), d1.data_ptr(), d2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    e1 = float((d1 - a.float() @ b[:, 64:].float().t()).abs().max())
    e2 = float((d2 - a.float() @ b[32:64, 64:].float().t()).abs().max())
    ok = err == 0 and e1 <= 1e-4 and e2 <= 1e-4
    print(f"wgmma/TMA self-check, the block kernel's forms (A by st.shared "
          f"at swizzled addresses; a 192-row box, N = 192 and an N = 32 "
          f"slice 32 rows in): return code {err}, max_abs_err {e1:.3e} and "
          f"{e2:.3e} (tol 1e-4) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("wgmma/TMA block-form self-check failed")


def check_gemm(dev):
    """csrc/gemm.cu by itself against its plain version (`_gemm_ref`) at
    GEMM_CASES, bf16 (the wgmma kernel) and f32; prints ms and TFLOP/s,
    and beside the bf16 time that of `F.linear` per product: a yardstick
    only, the port never calls it."""
    import torch
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl
    epi = {"bias": asl._EPI_BIAS, "gelu": asl._EPI_GELU,
           "residual": asl._EPI_RESID}
    failures = []
    for i, (case, (m, k, n, e, nmat)) in enumerate(GEMM_CASES.items()):
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(3000 + i)

            def randn(*shape, std=1.0):
                return (torch.randn(*shape, generator=gen, device=dev)
                        * std).to(dtype)

            a = randn(m, k, std=0.5)
            mats = [(randn(n, k, std=k ** -0.5), randn(n, std=0.02))
                    for _ in range(nmat)]
            resid = randn(m, n, std=0.5) if e == "residual" else None
            name = str(dtype).removeprefix("torch.")
            with torch.no_grad():
                got = asl._gemm(a, epi[e], mats, resid)
                want = asl._gemm_ref(a, epi[e], mats, resid)
                torch.cuda.synchronize()
                err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, want))
                finite = all(bool(torch.isfinite(g.float()).all())
                             for g in got)
                del got, want
                ms = cuda_ms(lambda: asl._gemm(a, epi[e], mats, resid))
                line = ""
                if dtype == torch.bfloat16:
                    lin = cuda_ms(lambda: [torch.nn.functional.linear(a, w, b)
                                           for w, b in mats])
                    line = f", F.linear (bias only) {lin:.4f} ms"
            ok = finite and err <= TOL[name]
            print(f"kernel gemm {case:22s} {name:8s} (M,K,N)={(m, k, n)} "
                  f"x{nmat} {e}: max_abs_err {err:.3e} (tol {TOL[name]:g}) "
                  f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms = "
                  f"{2 * m * n * k * nmat / ms / 1e9:.1f} TFLOP/s{line}",
                  flush=True)
            if not ok:
                failures.append(f"gemm {case} {name}: err {err}")
    if failures:
        raise SystemExit("gemm checks failed: " + "; ".join(failures))


def host_us(fn, calls: int = 100) -> float:
    """Host time of one fn() in us, calls enqueued back to back."""
    from cross_modal_video_engine_tpu_torch.utils.profiling import host_time
    return host_time(fn, calls, warmup=5) * 1e6


def check_core(dev):
    """csrc/attention_core.cu by itself against the plain version of one
    core launch (`_attention_core_ref`) at CORE_CASES, bf16 (the wgmma
    kernel) and f32 (the CUDA-core kernel); prints the kernel `core_path`
    names, ms, the bytes bound (q, k, v read and the output written once)
    and `scaled_dot_product_attention` on the same rows as a yardstick.
    Returns the bf16 results by case."""
    import torch
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl
    out, failures = {}, []
    for i, (case, (nseq, stride, rows, valid, heads, causal)) in enumerate(
            CORE_CASES.items()):
        d = heads * 64
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(4000 + i)
            q, k, v = (torch.randn(nseq * stride, d, generator=gen,
                                   device=dev).to(dtype) for _ in range(3))
            kw = dict(heads=heads, seq_stride=stride, rows=rows,
                      valid_len=valid, causal=causal)
            name = str(dtype).removeprefix("torch.")
            path = asl.core_path(dtype, 64, valid)
            att = torch.zeros_like(q)
            got = asl._attention_core(q, k, v, att, **kw)
            want = asl._attention_core_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err, ok = flash_err(got, want, name)
            ms = cuda_ms(lambda: asl._attention_core(q, k, v, att, **kw))
            plain_ms = cuda_ms(lambda: asl._attention_core_ref(q, k, v, **kw),
                               iters=5, warmup=1)
            library_ms = None
            if rows == valid:            # one call computes the same function
                q4, k4, v4 = (t.view(nseq, stride, heads, 64).transpose(1, 2)
                              for t in (q, k, v))
                library_ms = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=causal))
            esize = 2 if dtype == torch.bfloat16 else 4
            bound_ms = (nseq * (2 * rows + 2 * valid) * d * esize
                        / PEAK_BYTES * 1e3)
            ok = ok and path == ("wgmma" if dtype == torch.bfloat16
                                 else "fma")
            print(f"kernel core {case:22s} {name:8s} path {path:5s} "
                  f"(seqs,rows,valid,heads)={(nseq, rows, valid, heads)} "
                  f"causal={causal}: max_abs_err {err:.3e} (tol "
                  f"{TOL[name]:g}) {'ok' if ok else 'FAIL'}; kernel "
                  f"{ms:.4f} ms, bytes bound {bound_ms:.4f} ms "
                  f"({bound_ms / ms:.1%}), plain {plain_ms:.4f} ms, "
                  f"scaled_dot_product_attention "
                  + ("not comparable" if library_ms is None
                     else f"{library_ms:.4f} ms"), flush=True)
            if dtype == torch.bfloat16:
                out[case] = dict(ms=ms, bound_ms=bound_ms, err=err,
                                 plain_ms=plain_ms, library_ms=library_ms)
            if not ok:
                failures.append(f"core {case} {name}: err {err} path {path}")
    if failures:
        raise SystemExit("attention core checks failed: "
                         + "; ".join(failures))
    return out


def sublayer_cases(dev):
    """The checks at the main-path shapes: each names the kernel, the
    input shape, how to make its parameters on the card from a generator
    (in the types the models store them in),
    the kernel call and the plain call, and (for padded rows) how many
    leading rows are compared."""
    import torch
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl

    def randn(gen, *shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    # lecun-normal scales, the output projections at half of it so that
    # the outputs (x at std 0.5 plus the sublayer) stay under 4
    # As the models store them: LayerNorm scale and bias in float32,
    # weights and biases in the compute dtype.
    def attn_params(gen, d, dtype):
        p = [1.0 + randn(gen, d, std=0.1), randn(gen, d, std=0.1)]
        for scale in (1.0, 1.0, 1.0, 0.5):
            p += [randn(gen, d, d, std=scale * d ** -0.5).to(dtype),
                  randn(gen, d, std=0.02).to(dtype)]
        return p

    def mlp_params(gen, d, dtype):
        return [1.0 + randn(gen, d, std=0.1), randn(gen, d, std=0.1),
                randn(gen, 4 * d, d, std=d ** -0.5).to(dtype),
                randn(gen, 4 * d, std=0.02).to(dtype),
                randn(gen, d, 4 * d, std=0.5 * (4 * d) ** -0.5).to(dtype),
                randn(gen, d, std=0.02).to(dtype)]

    n_vis = VIDEOS * FRAMES * 50
    cases = []

    def add(name, kernel, shape, make, run_kernel, run_ref, valid=None,
            shape_f32=None, run_chain=None, bound=None, f32=True,
            route=None):
        cases.append(dict(name=name, kernel=kernel, shape=shape, make=make,
                          run_kernel=run_kernel, run_ref=run_ref,
                          valid=valid, shape_f32=shape_f32,
                          run_chain=run_chain, bound=bound, f32=f32,
                          route=route))

    # the least a call must do, from its shapes: (flops, bytes) in bf16,
    # each input read once and the output written once
    def attn_work(rows, d, keys):
        return (8 * rows * d * d + 4 * rows * keys * d,
                2 * (2 * rows * d + 4 * d * d + 6 * d))

    def mlp_work(rows, d):
        return (16 * rows * d * d, 2 * (2 * rows * d + 8 * d * d + 7 * d))

    def block_work(rows, d, keys):
        fa, ba = attn_work(rows, d, keys)
        fm, bm = mlp_work(rows, d)
        return fa + fm, ba + bm - 2 * 2 * rows * d     # y1 stays on chip

    add("compact vision", "fused_attention_sublayer_compact", (n_vis, 768),
        lambda g, dt: attn_params(g, 768, dt),
        lambda x, p: asl.fused_attention_sublayer_compact(
            x, *p, heads=12, seq_len=50),
        lambda x, p: asl._attn_ref_flat(x, *p, heads=12, seq_len=50,
                                        causal=False),
        bound=attn_work(n_vis, 768, 50))
    add("rank-3 causal text", "fused_attention_sublayer", (8, 77, 512),
        lambda g, dt: attn_params(g, 512, dt),
        lambda x, p: asl.fused_attention_sublayer(
            x, *p, heads=8, valid_len=77, causal=True),
        lambda x, p: asl._attn_ref(x, *p, heads=8, valid_len=77,
                                   causal=True),
        bound=attn_work(8 * 77, 512, 77))
    add("rank-3 padded 80/77", "fused_attention_sublayer", (8, 80, 512),
        lambda g, dt: attn_params(g, 512, dt),
        lambda x, p: asl.fused_attention_sublayer(
            x, *p, heads=8, valid_len=77, causal=True),
        lambda x, p: asl._attn_ref(x, *p, heads=8, valid_len=77,
                                   causal=True), valid=77)
    add("mlp vision", "fused_mlp_sublayer", (n_vis, 768),
        lambda g, dt: mlp_params(g, 768, dt),
        lambda x, p: asl.fused_mlp_sublayer(x, *p),
        lambda x, p: asl._mlp_ref(x, *p), bound=mlp_work(n_vis, 768))
    add("mlp text", "fused_mlp_sublayer", (8, 77, 512),
        lambda g, dt: mlp_params(g, 512, dt),
        lambda x, p: asl.fused_mlp_sublayer(x, *p),
        lambda x, p: asl._mlp_ref(x, *p))

    def block_case(name, shape, d, heads, seq_len, causal, **kw):
        def chain(x, p):
            y1 = asl.fused_attention_sublayer_compact(
                x, *p[:10], heads=heads, seq_len=seq_len, causal=causal)
            return asl.fused_mlp_sublayer(y1, *p[10:])
        add(name, "fused_block_sublayer_compact", shape,
            lambda g, dt: attn_params(g, d, dt) + mlp_params(g, d, dt),
            lambda x, p: asl.fused_block_sublayer_compact(
                x, *p, heads=heads, seq_len=seq_len, causal=causal),
            lambda x, p: asl._block_ref_flat(
                x, *p, heads=heads, seq_len=seq_len, causal=causal),
            run_chain=chain,
            route=lambda dt: asl.block_path(dt, d, d // heads, 4 * d,
                                            seq_len), **kw)

    # the shape the 12-layer stack gives it: 1024 thread blocks
    n_stack = STACK["nseq"] * STACK["seq_len"]
    block_case(BLOCK_MAIN_CASE, (n_stack, STACK["width"]), STACK["width"],
               STACK["heads"], STACK["seq_len"], False, f32=False,
               bound=block_work(n_stack, STACK["width"], STACK["seq_len"]))
    block_case("block vision", (n_vis, 768), 768, 12, 50, False,
               shape_f32=(800, 768))
    block_case("block vision causal", (n_vis, 768), 768, 12, 50, True,
               shape_f32=(800, 768))
    block_case("block small L=10", (160, 64), 64, 4, 10, False)
    return cases


def check_kernels(dev):
    """Each kernel against its plain version; returns the per-case
    results and prints one line per case."""
    import torch
    results, failures = [], []
    for i, case in enumerate(sublayer_cases(dev)):
        for dtype in (torch.bfloat16, torch.float32)[:1 + case["f32"]]:
            gen = torch.Generator(device=dev).manual_seed(1000 + i)
            params = case["make"](gen, dtype)
            shape = case["shape"]
            if dtype == torch.float32 and case["shape_f32"]:
                shape = case["shape_f32"]
            x = (torch.randn(*shape, generator=gen, device=dev)
                 * 0.5).to(dtype)
            with torch.no_grad():
                got = case["run_kernel"](x, params)
                want = case["run_ref"](x, params)
                torch.cuda.synchronize()
                v = case["valid"]
                finite = bool(torch.isfinite(got.float()).all())
                if v is not None:        # pad rows: finite, not compared
                    got, want = got[:, :v], want[:, :v]
                err = float((got.float() - want.float()).abs().max())
                chain_err = chain_ms = None
                if case["run_chain"]:   # the two-kernel chain, same inputs
                    chain = case["run_chain"](x, params)
                    chain_err = float((got.float() - chain.float())
                                      .abs().max())
                    chain_ms = cuda_ms(
                        lambda: case["run_chain"](x, params))
                ms = cuda_ms(lambda: case["run_kernel"](x, params))
                plain_ms = cuda_ms(lambda: case["run_ref"](x, params))
                call_us = host_us(lambda: case["run_kernel"](x, params))
            name = str(dtype).removeprefix("torch.")
            ok = (finite and err <= TOL[name]
                  and (chain_err is None or chain_err <= TOL[name]))
            route = case["route"](dtype) if case["route"] else None
            print(f"kernel {case['name']:22s} {name:8s} shape "
                  f"{tuple(shape)}"
                  + ("" if route is None else f" route {route}")
                  + f": max_abs_err {err:.3e} "
                  f"(tol {TOL[name]:g}) {'ok' if ok else 'FAIL'}; "
                  f"kernel {ms:.4f} ms (host {call_us:.1f} us a call), "
                  f"plain {plain_ms:.4f} ms"
                  + ("" if chain_err is None else
                     f"; vs two-kernel chain {chain_err:.3e}, chain "
                     f"{chain_ms:.4f} ms"), flush=True)
            results.append(dict(case=case["name"], kernel=case["kernel"],
                                dtype=name, err=err, ms=ms,
                                plain_ms=plain_ms, bound=case["bound"],
                                library_ms=None, host_us=call_us,
                                route=route))
            if not ok:
                failures.append(f"{case['name']} {name}: err {err} "
                                f"chain {chain_err} finite {finite}")
    if failures:
        raise SystemExit("kernel checks failed: " + "; ".join(failures))
    return results


def check_backward(dev):
    """One backward through each of the five kernel wrappers at a small
    shape in f32: the forward launches the kernel, the backward recomputes
    the plain version; gradients against the plain version's own
    autograd."""
    import torch
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl
    from cross_modal_video_engine_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(77)

    def leaf(*shape, std=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std
                + shift).requires_grad_()

    def attn(d):
        p = [leaf(d, std=0.1, shift=1.0), leaf(d, std=0.1)]
        for _ in range(4):
            p += [leaf(d, d, std=d ** -0.5), leaf(d, std=0.02)]
        return p

    def mlp(d):
        return [leaf(d, std=0.1, shift=1.0), leaf(d, std=0.1),
                leaf(4 * d, d, std=d ** -0.5), leaf(4 * d, std=0.02),
                leaf(d, 4 * d, std=(4 * d) ** -0.5), leaf(d, std=0.02)]

    d, h, l = 64, 4, 10
    cases = [
        (asl.fused_attention_sublayer,
         lambda *a: asl.fused_attention_sublayer(*a, heads=h, valid_len=13,
                                                 causal=True),
         lambda *a: asl._attn_ref(*a, heads=h, valid_len=13, causal=True),
         [leaf(3, 16, d, std=0.5)] + attn(d), 13),
        (asl.fused_attention_sublayer_compact,
         lambda *a: asl.fused_attention_sublayer_compact(*a, heads=h,
                                                         seq_len=l),
         lambda *a: asl._attn_ref_flat(*a, heads=h, seq_len=l, causal=False),
         [leaf(4 * l, d, std=0.5)] + attn(d), None),
        (asl.fused_mlp_sublayer, asl.fused_mlp_sublayer, asl._mlp_ref,
         [leaf(37, d, std=0.5)] + mlp(d), None),
        (asl.fused_block_sublayer_compact,
         lambda *a: asl.fused_block_sublayer_compact(*a, heads=h, seq_len=l,
                                                     causal=True),
         lambda *a: asl._block_ref_flat(*a, heads=h, seq_len=l, causal=True),
         [leaf(4 * l, d, std=0.5)] + attn(d) + mlp(d), None),
        (fa.flash_attention,
         lambda *a: fa.flash_attention(*a, 0.25, True),
         lambda *a: fa._reference_attention(*a, 0.25, True),
         [leaf(2, 3, 70, 32), leaf(2, 3, 70, 32), leaf(2, 3, 70, 32)], None),
    ]
    failures = []
    for wrapper, kernel, plain, args, valid in cases:
        before = wrapper.launches
        out = kernel(*args)
        want = plain(*args)
        g = torch.randn(out.shape, generator=gen, device=dev)
        if valid is not None:        # pad rows carry no gradient contract
            g[:, valid:] = 0
        got_g = torch.autograd.grad(out, args, g)
        want_g = torch.autograd.grad(want, args, g)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got_g, want_g))
        ok = (err <= GRAD_TOL and wrapper.launches == before + 1
              and all(bool(torch.isfinite(a).all()) for a in got_g))
        print(f"backward {wrapper.__name__:34s} f32: max gradient err "
              f"{err:.3e} over {len(args)} inputs (tol {GRAD_TOL:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{wrapper.__name__}: {err}")
    if failures:
        raise SystemExit("backward checks failed: " + "; ".join(failures))


def flash_err(got, want, dtype_name: str):
    """max |kernel - plain| and whether every element is within TOL (or,
    in bf16, within one bf16 step of the plain output where that step is
    larger)."""
    import torch
    err = (got.float() - want.float()).abs()
    tol = torch.full_like(err, TOL[dtype_name])
    if dtype_name == "bfloat16":
        step = torch.ldexp(torch.ones_like(err),
                           torch.frexp(want.float())[1] - 8)
        tol = torch.maximum(tol, step)
    finite = bool(torch.isfinite(got.float()).all())
    return float(err.max()), finite and bool((err <= tol).all())


def check_flash(dev):
    """The flash kernel against its plain version at FLASH_CASES and
    FLASH_EXTRA; returns the per-case results and prints one line per
    case."""
    import torch
    from cross_modal_video_engine_tpu_torch.ops import flash_attention as fa
    results, failures = [], []
    for i, (case, ((b, h, sq, skv, d), causal)) in enumerate(
            {**FLASH_CASES, **FLASH_EXTRA}.items()):
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(2000 + i)
            if case == FLASH_STRIDED:   # what mha_flash hands the kernel
                x = torch.randn(b, sq, 3 * h * d, generator=gen,
                                device=dev).to(dtype)
                q, k, v = (t.reshape(b, sq, h, d).transpose(1, 2)
                           for t in x.split(h * d, -1))
            else:
                q, k, v = (torch.randn(*shape, generator=gen, device=dev)
                           .to(dtype) for shape in
                           ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d)))
            scale = d ** -0.5
            name = str(dtype).removeprefix("torch.")
            with torch.no_grad():
                got = fa.flash_attention(q, k, v, scale, causal)
                want = fa._reference_attention(q, k, v, scale, causal)
                torch.cuda.synchronize()
                err, ok = flash_err(got, want, name)
                del got, want
                ms = cuda_ms(lambda: fa.flash_attention(q, k, v, scale,
                                                        causal))
                plain_ms = cuda_ms(lambda: fa._reference_attention(
                    q, k, v, scale, causal), iters=5, warmup=1)
                # the one PyTorch call that computes the same function: a
                # yardstick, used nowhere in the port (its causal mask is
                # top-left aligned only when Sq == Skv)
                library_ms = None
                if sq == skv:
                    library_ms = cuda_ms(
                        lambda: torch.nn.functional
                        .scaled_dot_product_attention(
                            q, k, v, is_causal=causal, scale=scale))
            print(f"kernel flash {case:20s} {name:8s} (B,H,Sq,Skv,D)="
                  f"{(b, h, sq, skv, d)} causal={causal}: max_abs_err "
                  f"{err:.3e} (tol {TOL[name]:g}) {'ok' if ok else 'FAIL'};"
                  f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"scaled_dot_product_attention "
                  + ("not comparable" if library_ms is None
                     else f"{library_ms:.4f} ms"), flush=True)
            work = 4 * b * h * sq * skv * d // (2 if causal else 1)
            results.append(dict(
                case=case, kernel="flash_attention", dtype=name, err=err,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound=(work, 2 * b * h * d * (2 * sq + 2 * skv))))
            if not ok:
                failures.append(f"flash {case} {name}: err {err}")
    if failures:
        raise SystemExit("flash checks failed: " + "; ".join(failures))
    return results


def text_ids(rng, n: int, length: int = 77, vocab: int = 49408) -> np.ndarray:
    """Token ids shaped like BPE output: tokens, then EOT (the highest id),
    then zeros."""
    ids = np.zeros((n, length), np.int64)
    for r in range(n):
        eot = int(rng.integers(4, length))
        ids[r, :eot] = rng.integers(1, vocab - 2, eot)
        ids[r, eot] = vocab - 1
    return ids


def cosine_min(a, b) -> float:
    import torch
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


def drive_main_path(model, plain, cfg, dev, rng):
    """The main path once with the launch counters zeroed just before and
    read just after; then the checks of what came out.  Returns the
    counts, the index and the query ids."""
    import torch
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl
    from cross_modal_video_engine_tpu_torch.retrieval.index import (
        RetrievalIndex, _normalize_queries)

    res, grid = cfg.image_resolution, cfg.grid
    frames = torch.from_numpy(rng.integers(
        0, 256, (VIDEOS, FRAMES, res, res, 3), dtype=np.uint8)).to(dev)
    ids = torch.from_numpy(text_ids(rng, QUERIES, cfg.context_length,
                                    cfg.vocab_size)).to(dev)
    noise = rng.standard_normal(
        (INDEX_ROWS - VIDEOS, cfg.embed_dim)).astype(np.float32)

    counters = (asl.fused_attention_sublayer_compact,
                asl.fused_attention_sublayer, asl.fused_mlp_sublayer)
    with torch.no_grad():
        for fn in counters:
            fn.launches = 0
        high, middle = model.encode_video_u8(frames)
        video_emb = high.mean(1).cpu().numpy()       # frame-mean per video
        index = RetrievalIndex(np.concatenate([video_emb, noise]),
                               device=dev, dtype=torch.bfloat16)
        queries = model.encode_text(ids)
        vals, idx = index.search(queries.cpu().numpy(), k=10)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}

        high_p, middle_p = plain.encode_video_u8(frames)
        queries_p = plain.encode_text(ids)

    checks = {
        "video shapes": (
            tuple(high.shape) == (VIDEOS, FRAMES, cfg.embed_dim)
            and tuple(middle.shape) == (VIDEOS, FRAMES, grid ** 2,
                                        cfg.vision_width)),
        "text shape": tuple(queries.shape) == (QUERIES, cfg.embed_dim),
        "finite": bool(torch.isfinite(high).all()
                       and torch.isfinite(middle.float()).all()
                       and torch.isfinite(queries).all()),
    }
    cos = {"video high": cosine_min(high, high_p),
           "video middle": cosine_min(middle, middle_p),
           "text": cosine_min(queries, queries_p)}
    print("kernel arm vs plain arm, min cosine: " + ", ".join(
        f"{k} {v:.6f}" for k, v in cos.items()) + f" (need >= {COSINE_MIN})")
    checks["cosine vs plain arm"] = min(cos.values()) >= COSINE_MIN

    # brute force over the same stored bf16 rows, in float64 on the host
    stored = index.emb[: index.n].double().cpu().numpy()
    qb = _normalize_queries(queries.float()).to(torch.bfloat16)
    sims = qb.double().cpu().numpy() @ stored.T
    brute = np.argsort(-sims, axis=1, kind="stable")[:, :10]
    same = all(set(a) == set(b) for a, b in zip(idx, brute))
    val_err = float(np.abs(vals - np.take_along_axis(sims, idx, 1)).max())
    print(f"search top-10 of {index.n} bf16 rows vs brute force: "
          f"{'equal' if same else 'DIFFERENT'}, max score err {val_err:.2e}")
    checks["search == brute force"] = same and val_err < 1e-4

    print(f"launch counters over the main path: {json.dumps(launches)}")
    checks["launch counters"] = (
        launches["fused_attention_sublayer_compact"] >= cfg.vision_layers
        and launches["fused_attention_sublayer"] >= cfg.text_layers
        and launches["fused_mlp_sublayer"]
        >= cfg.vision_layers + cfg.text_layers)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"main-path checks failed: {failed}")
    return launches, index, ids


def query_latency(model, plain, index, ids, card):
    """ms per query wave of QUERIES texts: the text tower of each arm,
    then the index search (host queries in, host results out)."""
    import torch
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl
    with torch.no_grad():
        text = {arm: cuda_ms(lambda: m.encode_text(ids), iters=10)
                for arm, m in (("kernel", model), ("plain", plain))}
        asl.fused_attention_sublayer.launches = 0
        asl.fused_mlp_sublayer.launches = 0
        q = model.encode_text(ids).cpu().numpy()
        attn = asl.fused_attention_sublayer.launches
        mlp = asl.fused_mlp_sublayer.launches
        wave_us = host_us(lambda: model.encode_text(ids), calls=20)
    search = cuda_ms(lambda: index.search(q, k=10), iters=10)
    print(f"query wave of {QUERIES} (ms): text tower kernel arm "
          f"{text['kernel']:.3f}, plain arm {text['plain']:.3f}; search "
          f"top-10 of {index.n} bf16 rows {search:.3f} on {card}")
    # an attention sublayer call enqueues 4 kernels, an MLP call 3
    print(f"text wave of {QUERIES}: {attn} attention + {mlp} MLP sublayer "
          f"calls, one crossing into C each ({attn + mlp} crossings), "
          f"{4 * attn + 3 * mlp} sublayer kernel launches; host "
          f"{wave_us / 1e3:.3f} ms a wave")
    layers = model.cfg.text_layers
    if attn != layers or mlp != layers:
        raise SystemExit(f"text wave made {attn} attention and {mlp} MLP "
                         f"sublayer calls, not {layers} each")


def throughput(model, plain, cfg, dev, rng, card):
    """videos/s of both arms, in turns: plain, kernel, kernel, plain."""
    import torch
    res = cfg.image_resolution
    bench = torch.from_numpy(rng.integers(
        0, 256, (BENCH_VIDEOS, FRAMES, res, res, 3), dtype=np.uint8)).to(dev)
    rates = {"plain": [], "kernel": []}
    with torch.no_grad():
        for arm in ("plain", "kernel", "kernel", "plain"):
            m = model if arm == "kernel" else plain
            ms = cuda_ms(lambda: m.encode_video_u8(bench), iters=5,
                         warmup=2)
            rates[arm].append(BENCH_VIDEOS * 1000.0 / ms)
    for arm in ("kernel", "plain"):
        r = rates[arm]
        print(f"videos/s {arm} arm (ViT-B/32 bf16, {FRAMES}x{res}^2 uint8, "
              f"B={BENCH_VIDEOS}): {np.mean(r):.2f} (runs {r[0]:.2f}, "
              f"{r[1]:.2f}) on {card}")
    return rates


def relseq_model() -> dict:
    """The `model` dict of the shipped caption config, as the file says."""
    return runpy.run_path(str(RELSEQ_CONFIG))["model"]


def build_timesformer(dev):
    """The caption path's two arms, from one random state dict through
    api.init_recognizer: flash attention on (kernel arm) and off."""
    from cross_modal_video_engine_tpu_torch.api import init_recognizer
    from cross_modal_video_engine_tpu_torch.models.decoder_head import (
        RNNDecoderConfig)
    from cross_modal_video_engine_tpu_torch.models.recognizer import (
        random_state_dict)
    from cross_modal_video_engine_tpu_torch.models.timesformer import (
        TimeSformerConfig)
    decoder = relseq_model()["decoder"]
    t0 = time.perf_counter()
    sd = random_state_dict(TimeSformerConfig(**TS_JOINT), seed=2,
                           decoder_cfg=RNNDecoderConfig(**decoder))
    model, _ = init_recognizer({"backbone": TS_JOINT, "decoder": decoder},
                               sd, device=dev)
    plain, _ = init_recognizer(
        {"backbone": {**TS_JOINT, "use_flash_attention": False},
         "decoder": decoder}, sd, device=dev)
    print(f"TimeSformer ViT-B/16 joint bf16 + RNN decoder built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model, plain


def normalised_clips(rng, n: int, dev):
    """n uint8 clips of 8 x 224^2, normalised as the test pipeline does
    ((x - 127.5) / 127.5)."""
    import torch
    u8 = torch.from_numpy(rng.integers(0, 256, (n, FRAMES, 224, 224, 3),
                                       dtype=np.uint8)).to(dev)
    return (u8.float() - 127.5) / 127.5


def drive_caption_path(model, plain, clips):
    """The caption path once with the flash counter zeroed just before
    and read just after; then the checks against the plain arm.  Returns
    the path's flash launches."""
    import torch
    from cross_modal_video_engine_tpu_torch.api import caption_clips
    from cross_modal_video_engine_tpu_torch.ops import flash_attention as fa

    layers = model.backbone.cfg.num_layers
    fa.flash_attention.launches = 0
    steps, probs = caption_clips(model, clips, num_segs=1)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    fa.flash_attention.launches = 0
    with torch.no_grad():
        feat = model.extract_feat(clips)
    torch.cuda.synchronize()
    feat_launches = fa.flash_attention.launches
    steps_p, probs_p = caption_clips(plain, clips, num_segs=1)
    with torch.no_grad():
        feat_p = plain.extract_feat(clips)

    n, dec = clips.shape[0], model.cls_head.cfg
    step0 = float((probs[:, 0] - probs_p[:, 0]).abs().max())
    flips = sum(len(set(a) ^ set(b)) for va, vb in zip(steps, steps_p)
                for a, b in zip(va[1:], vb[1:]))
    cos = cosine_min(feat, feat_p)
    print(f"caption path, {n} clips: flash launches {launches} per "
          f"caption forward, {feat_launches} per feature forward (need "
          f"{layers}); kernel arm vs plain arm: backbone CLS min cosine "
          f"{cos:.6f} (need >= {COSINE_MIN}), step-0 probability max err "
          f"{step0:.3e} (tol {TOL['bfloat16']:g}); label flips in steps "
          f"1-{dec.max_len - 1}: {flips} of "
          f"{n * (dec.max_len - 1) * dec.num_classes} labels (reported, "
          f"not checked: greedy feedback at {dec.threshold})")
    print(f"  video 0 labels per step: kernel arm {steps[0]}, plain arm "
          f"{steps_p[0]}")
    checks = {
        "probs shape": tuple(probs.shape) == (n, dec.max_len,
                                              dec.num_classes),
        "finite": bool(torch.isfinite(probs).all()
                       and torch.isfinite(feat).all()),
        "flash launches": launches == layers and feat_launches == layers,
        "cosine vs plain arm": cos >= COSINE_MIN,
        "step-0 probabilities": step0 <= TOL["bfloat16"],
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"caption-path checks failed: {failed}")
    return launches


def divided_caption_config(dev, clips):
    """The shipped caption config (divided space-time, as written) in
    bf16, once at 2 clips: shapes, finiteness and time."""
    import torch
    from cross_modal_video_engine_tpu_torch.api import (caption_clips,
                                                        init_recognizer)
    from cross_modal_video_engine_tpu_torch.models.decoder_head import (
        RNNDecoderConfig)
    from cross_modal_video_engine_tpu_torch.models.recognizer import (
        random_state_dict)
    from cross_modal_video_engine_tpu_torch.models.timesformer import (
        TimeSformerConfig)
    from cross_modal_video_engine_tpu_torch.ops import flash_attention as fa
    model_cfg = relseq_model()
    cfg_d = {"backbone": {**model_cfg["backbone"], "dtype": "bfloat16"},
             "decoder": model_cfg["decoder"]}
    sd = random_state_dict(TimeSformerConfig(**cfg_d["backbone"]), seed=3,
                           decoder_cfg=RNNDecoderConfig(**cfg_d["decoder"]))
    model, _ = init_recognizer(cfg_d, sd, device=dev)
    fa.flash_attention.launches = 0
    caption_clips(model, clips[:2], num_segs=1)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps, probs = caption_clips(model, clips[:2], num_segs=1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    dec = model.cls_head.cfg
    ok = (tuple(probs.shape) == (2, dec.max_len, dec.num_classes)
          and bool(torch.isfinite(probs).all())
          and fa.flash_attention.launches == 0)
    print(f"divided space-time caption config (timesformer_relseq.py, "
          f"bf16), 2 clips: probs {tuple(probs.shape)}, "
          f"{'finite' if ok else 'FAIL'}, {ms:.1f} ms per call (host "
          f"clock); video 0 labels per step {steps[0]}")
    if not ok:
        raise SystemExit("divided caption config failed")


def caption_throughput(model, plain, clips, card):
    """videos/s of both TimeSformer arms, in turns: plain, kernel,
    kernel, plain."""
    import torch
    n = clips.shape[0]
    rates = {"plain": [], "kernel": []}
    with torch.no_grad():
        for arm in ("plain", "kernel", "kernel", "plain"):
            m = model if arm == "kernel" else plain
            ms = cuda_ms(lambda: m.forward_test(clips), iters=5, warmup=2)
            rates[arm].append(n * 1000.0 / ms)
    for arm in ("kernel", "plain"):
        r = rates[arm]
        print(f"videos/s {arm} arm (TimeSformer ViT-B/16 joint bf16 + RNN "
              f"decoder, {FRAMES}x224^2 normalised clips, B={n}): "
              f"{np.mean(r):.2f} (runs {r[0]:.2f}, {r[1]:.2f}) on {card}")
    return rates


def block_ptxas(log: str) -> dict:
    """Registers and bytes of spills of each bf16 route of the block
    kernel, from ptxas's report in the build log."""
    out, route = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            route = ("wgmma" if "block_kernel_bf16ILb1E" in line else
                     "mma" if "block_kernel_bf16ILb0E" in line else None)
        elif route and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            out.setdefault(route, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif route and "Used" in line and "registers" in line:
            out.setdefault(route, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            route = None
    return out


def block_ablation(dev, card, lib, chain_layer_ms) -> dict:
    """The block kernel built with -DCMVE_BLK_NO_MMA (the same launch,
    schedule and weight stream, every product of the weight stream
    skipped) at the stack's shape: its time is the load-side ceiling of
    64 rows a block, read as the rate at which L2 hands every block all of
    a layer's weights (bench/block_profile.py --variants does the same)."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import block_ab
    from cross_modal_video_engine_tpu_torch.bench import block_profile as bp
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl
    heads, seq_len, d = STACK["heads"], STACK["seq_len"], STACK["width"]
    x, params = block_ab.build_stack(STACK["nseq"], seq_len, d, 1, dev)
    flat = [*params[0][0], *params[0][1]]
    y = torch.empty_like(x)
    with torch.no_grad():
        ms = cuda_ms(lambda: bp.launch(lib, x, flat, y, heads=heads,
                                       seq_len=seq_len), iters=5, warmup=1)
        kernel_ms = cuda_ms(lambda: asl.fused_block_sublayer_compact(
            x, *flat, heads=heads, seq_len=seq_len), iters=5, warmup=1)
    l2_bytes = bp.weight_bytes_through_l2(x, flat, seq_len)
    rate = l2_bytes / (ms * 1e-3) / 1e12
    print(f"block ablation (-DCMVE_BLK_NO_MMA) at {tuple(x.shape)} bf16: "
          f"{ms:.4f} ms a layer, {l2_bytes / 1e9:.2f} GB of weights through "
          f"L2 = {rate:.2f} TB/s; the kernel {kernel_ms:.4f} ms, the "
          f"two-kernel chain {chain_layer_ms:.4f} ms a layer, on {card}",
          flush=True)
    return {"ablation_ms": ms, "ablation_l2_tb_s": rate}


def drive_bench_path(dev, card, ablation):
    """The bench entry points' path once with the launch counters zeroed
    just before and read just after: `entry()`, then the 12-layer compact
    stack at (51200, 768) through the two-kernel chain and through the
    whole-block kernel.  Then the checks, the times of both stacks, the
    block kernel's ablation (`ablation()` gives its library) and the
    headline bench.  Returns the block kernel's launches and the
    ablation's numbers."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import block_ab, headline
    from cross_modal_video_engine_tpu_torch.entry import entry
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl

    layers, heads, seq_len = (STACK[k] for k in ("layers", "heads", "seq_len"))
    x, params = block_ab.build_stack(STACK["nseq"], seq_len, STACK["width"],
                                     layers, dev)
    fn, (model, clip) = entry(dev)
    counters = (asl.fused_attention_sublayer_compact, asl.fused_mlp_sublayer,
                asl.fused_block_sublayer_compact)
    for c in counters:
        c.launches = 0
    high = fn(model, clip)
    two = block_ab.stack_two(x, params, heads=heads, seq_len=seq_len)
    blk = block_ab.stack_block(x, params, heads=heads, seq_len=seq_len)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}

    cos = cosine_min(blk, two)
    err = float((blk.float() - two.float()).abs().max())
    # Layer by layer on the chain's own input, so that no layer carries the
    # flips of the ones before it (the two routes round at the same points
    # but their products sum in different orders).  A layer rounds four
    # times: each sublayer's projection before its residual add, and each
    # sum (y1 = x + attention projection, y = y1 + MLP projection).  The
    # residuals carry a flip of any of them to y unchanged, so a layer may
    # differ by one bf16 step of each of the four values, which may lie in
    # higher binades than y itself.  Beyond that, flips of y1 elsewhere in
    # a row move the MLP's projection a little before it is rounded (the
    # plain version shows the same when it is fed either y1), which can
    # put it across a binade edge: up to one element in a million may pass
    # the bound, none by more than twice.
    def bf16_step(t):
        return torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - 8)

    layer_err, layers_ok, over, xi = 0.0, True, 0, x
    with torch.no_grad():
        for attn, mlp in params:
            y1 = asl.fused_attention_sublayer_compact(
                xi, *attn, heads=heads, seq_len=seq_len)
            nxt = asl.fused_mlp_sublayer(y1, *mlp)
            got = asl.fused_block_sublayer_compact(
                xi, *attn, *mlp, heads=heads, seq_len=seq_len)
            diff = (got.float() - nxt.float()).abs()
            xf, y1f, yf = xi.float(), y1.float(), nxt.float()
            tol = (bf16_step(y1f - xf) + bf16_step(y1f)
                   + bf16_step(yf - y1f) + bf16_step(yf))
            tol = torch.clamp(tol, min=TOL["bfloat16"])
            beyond = int((diff > tol).sum())
            layers_ok &= (beyond <= diff.numel() * LAYER_OUTLIERS
                          and bool((diff <= 2 * tol).all()))
            over += beyond
            layer_err = max(layer_err, float(diff.max()))
            xi = nxt
    del xi, y1, nxt, got, diff, tol, xf, y1f, yf
    torch.cuda.synchronize()
    print(f"bench path: entry() high {tuple(high.shape)}; stack of {layers} "
          f"layers at {tuple(x.shape)} bf16, whole-block vs two-kernel "
          f"chain: min cosine {cos:.6f} (need >= {COSINE_MIN}), max abs "
          f"diff after {layers} layers {err:.3e} (reported); layer by layer "
          f"on the chain's input: max abs diff {layer_err:.3e} (tol "
          f"{TOL['bfloat16']:g} or a bf16 step of each of a layer's four "
          f"roundings; {over} of {layers * x.numel()} elements beyond it, "
          f"none beyond twice) "
          f"{'ok' if layers_ok else 'FAIL'}; launches {json.dumps(launches)}")
    checks = {
        "entry shape": tuple(high.shape) == (2, 8, 512),
        "finite": bool(torch.isfinite(high).all()
                       and torch.isfinite(blk.float()).all()),
        "block launches": launches["fused_block_sublayer_compact"] == layers,
        "chain launches": (
            launches["fused_attention_sublayer_compact"] == 2 * layers
            and launches["fused_mlp_sublayer"] == 2 * layers),
        "block vs chain": cos >= COSINE_MIN and layers_ok,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"bench-path checks failed: {failed}")
    del two, blk, model, clip

    rows = block_ab.bench_op_level(steps=STACK_STEPS, device=dev)
    print(f"stack{layers} at {tuple(x.shape)} bf16: two kernels "
          f"{rows[0]['value']:.3f} ms, whole block {rows[1]['value']:.3f} ms "
          f"(speedup {rows[1]['speedup_vs_two_kernels']:.3f}) on {card}")
    extra = block_ablation(dev, card, ablation(), rows[0]["value"] / layers)
    extra.update(stack_ms=rows[1]["value"], chain_stack_ms=rows[0]["value"])
    row = headline.bench_headline(batch=HEADLINE_BATCH, steps=HEADLINE_STEPS,
                                  device=dev)
    print(f"headline B={HEADLINE_BATCH}: kernel arm {row['value']:.2f} "
          f"videos/s, plain arm {row['plain']:.2f} videos/s on {card}")
    return launches["fused_block_sublayer_compact"], extra


def check_big_index(dev, card):
    """1M x 512 rows drawn on the card, as bf16 and as int8: top-10 of 64
    queries against brute force in float64 over the stored rows (bf16:
    equal) and over the exact rows (int8: recall@10); search times; the
    peak memory a search adds."""
    import torch
    from cross_modal_video_engine_tpu_torch.retrieval.index import (
        RetrievalIndex, _normalize_queries)
    n, d, nq, k = BIG_INDEX_ROWS, 512, BIG_INDEX_QUERIES, 10
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = _normalize_queries(torch.randn((n, d), generator=gen, device=dev))
    qn = _normalize_queries(torch.randn((nq, d), generator=gen, device=dev))
    q_host = qn.cpu().numpy()

    def brute(stored, q):                 # float64, a chunk of rows at a time
        sims = torch.cat([q.double() @ c.double().t()
                          for c in stored.split(131072)], 1)
        return sims, sims.topk(k, dim=1).indices.cpu().numpy()

    _, exact_ids = brute(rows, qn)
    failures = []
    for dtype in (torch.bfloat16, torch.int8):
        name = str(dtype).removeprefix("torch.")
        index = RetrievalIndex(rows, normalize=False, capacity=n, dtype=dtype,
                               device=dev)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vals, ids = index.search(q_host, k)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        search = index.searcher()
        ms = cuda_ms(lambda: search(index.emb, index.scales, index.valid,
                                    qn, k), iters=10)
        recall = float(np.mean([len(set(a) & set(b)) / k
                                for a, b in zip(exact_ids, ids)]))
        line = (f"index {n} x {d} {name} rows ({index.emb.nbytes / 2**20:.0f} "
                f"MiB), {nq} queries, top-{k}: search {ms:.3f} ms on {card}; "
                f"a search adds {peak / 2**20:.0f} MiB at its peak (an fp32 "
                f"copy of the rows would be {n * d * 4 / 2**20:.0f} MiB); "
                f"recall@{k} vs exact f32 rows {recall:.4f}")
        if dtype == torch.bfloat16:
            sims, brute_ids = brute(index.emb, qn.to(dtype))
            same = all(set(a) == set(b) for a, b in zip(ids, brute_ids))
            val_err = float((torch.from_numpy(vals).to(dev).double()
                             - sims.gather(1, torch.from_numpy(ids).to(dev))
                             ).abs().max())
            line += (f"; vs brute force over the stored rows: "
                     f"{'equal' if same else 'DIFFERENT'}, max score err "
                     f"{val_err:.2e}")
            if not (same and val_err < 1e-4):
                failures.append("bf16 search != brute force")
        elif recall < INT8_RECALL_MIN:
            failures.append(f"int8 recall@{k} {recall} < {INT8_RECALL_MIN}")
        if peak >= n * d * 4:
            failures.append(f"{name} search peaked at {peak} bytes")
        print(line, flush=True)
        del index
    if failures:
        raise SystemExit("index checks failed: " + "; ".join(failures))


# LINAS serving step: collection, card-against-CPU sample, index rows, HTTP
# checks, bench arms and timed waves (the collection, request and wave
# counts kept small for the script's time)
LINAS_VIDEOS, LINAS_CAPTIONS, LINAS_SAMPLE = 500, 5, 64
LINAS_ROWS, LINAS_HTTP_CHECKS = 1_000_000, 16
LINAS_SINGLE, LINAS_CLIENTS, LINAS_PER_CLIENT, LINAS_WAVE_CALLS = 50, 64, 5, 10
# card vs CPU: cuDNN's GRU and the convolutions sum in another order
LINAS_TOL = 1e-3
# HTTP answers vs index.search_ids on the same card: the same f32 products
SERVE_SCORE_TOL = 1e-5


# 10c': cli.retrieval_inference in fresh processes (no TF32 switch of this
# script), card against CPU, over the sample's 64 videos
LINAS_CLI_QUERIES = 1
LINAS_CLI_SAMPLE = "linassample"
LINAS_CLI_RUNS = (("card", []), ("cpu", ["--device", "cpu"]))
# run in a fresh interpreter: the CLI's main once a query, every search's
# scores kept at full precision, and the TF32 flags before and after
LINAS_CLI_CODE = r"""
import json, sys
import torch
from cross_modal_video_engine_tpu_torch.cli import retrieval_inference as ri
from cross_modal_video_engine_tpu_torch.retrieval.index import RetrievalIndex
before = [torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32]
searches, search = [], RetrievalIndex.search_ids
def kept(self, q, k=10):
    scores, ids = search(self, q, k=k)
    searches.append([[float(x) for x in scores[0]], [str(i) for i in ids[0]]])
    return scores, ids
RetrievalIndex.search_ids = kept
argv, queries = json.loads(sys.argv[1])
for q in queries:
    ri.main(argv + ["--input", q])
print("RESULT " + json.dumps({"searches": searches, "tf32_before": before,
                              "tf32_after": [
                                  torch.backends.cuda.matmul.allow_tf32,
                                  torch.backends.cudnn.allow_tf32]}))
"""


def linas_cli_card_vs_cpu(root, ckpt, sample_lines, queries, card) -> dict:
    """Step 10c': the LINAS CLI a user runs (`cli.retrieval_inference`,
    its top-10 of each query over a collection of the sample's 64 videos)
    in a fresh process on the card and in one on the CPU, neither with
    this script's TF32 switch: the same ids, scores within LINAS_TOL."""
    import subprocess
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli.common import (
        collection_paths)

    main = collection_paths(root, bserve.COLLECTION, bserve.FEATURE)
    sample = os.path.join(root, LINAS_CLI_SAMPLE)
    os.makedirs(os.path.join(sample, "TextData"))
    os.symlink(os.path.dirname(main["feat_dir"]),
               os.path.join(sample, "FeatureData"))
    os.symlink(os.path.dirname(os.path.dirname(main["rnn_vocab"])),
               os.path.join(sample, "TextData", "vocabulary"))
    with open(collection_paths(root, LINAS_CLI_SAMPLE, bserve.FEATURE)
              ["cap_file"], "w") as f:
        f.write("\n".join(sample_lines))
    # both processes side by side, each writing to its own files
    procs, ended = {}, {}
    try:
        for name, device in LINAS_CLI_RUNS:
            argv = ["--checkpoint", ckpt, "--rootpath", root,
                    "--collection", LINAS_CLI_SAMPLE, "--visual_feature",
                    bserve.FEATURE, "--topK", "10", "--index_cache",
                    os.path.join(root, f"cli_index_{name}.npz")] + device
            files = [open(os.path.join(root, f"cli_{name}.{ext}"), "w+")
                     for ext in ("out", "err")]
            procs[name] = (subprocess.Popen(
                [sys.executable, "-c", LINAS_CLI_CODE,
                 json.dumps([argv, list(queries)])],
                stdout=files[0], stderr=files[1], text=True, cwd=str(ROOT),
                env=dict(os.environ, PYTHONPATH=str(ROOT))), files,
                time.perf_counter())
        deadline = time.perf_counter() + 900
        while len(ended) < len(procs) and time.perf_counter() < deadline:
            for name, (proc, _, t0) in procs.items():
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for proc, files, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    runs = {}
    for name, (proc, files, _) in procs.items():
        for f in files:
            f.seek(0)
        stdout, stderr = (f.read() for f in files)
        for f in files:
            f.close()
        if name not in ended or proc.returncode:
            raise SystemExit(f"10c' the {name} CLI failed (exit "
                             f"{proc.returncode}): {stderr[-3000:]}")
        result = next(json.loads(x[len("RESULT "):])
                      for x in stdout.splitlines()
                      if x.startswith("RESULT "))
        result["seconds"] = ended[name]
        runs[name] = result
    card_s, cpu_s = runs["card"]["searches"], runs["cpu"]["searches"]
    same_ids = sum(a[1] == b[1] for a, b in zip(card_s, cpu_s))
    err = max(float(np.abs(np.subtract(a[0], b[0])).max())
              for a, b in zip(card_s, cpu_s))
    line = {"queries": len(queries), "same_top10": same_ids,
            "max_abs_score": err,
            "card_tf32_before": runs["card"]["tf32_before"],
            "card_tf32_after": runs["card"]["tf32_after"],
            "card_s": runs["card"]["seconds"],
            "cpu_s": runs["cpu"]["seconds"]}
    print(f"10c' cli.retrieval_inference in a fresh process (no TF32 switch "
          f"here; the card's process read matmul/cuDNN TF32 "
          f"{line['card_tf32_before']} at start, "
          f"{line['card_tf32_after']} after the CLI) on the card and on the "
          f"CPU, {len(queries)} queries over {LINAS_SAMPLE} videos: "
          f"{same_ids}/{len(queries)} with the same top-10 ids, max "
          f"|score difference| {err:.3e} (need < {LINAS_TOL}); "
          f"{line['card_s']:.1f} s and {line['cpu_s']:.1f} s side by side "
          f"on {card}",
          flush=True)
    if (same_ids != len(queries) or len(card_s) != len(queries)
            or not err < LINAS_TOL or any(runs["card"]["tf32_after"])):
        raise SystemExit("10c' the LINAS CLI on the card disagrees with the "
                         "CPU")
    return line


def check_linas_serving(dev, card) -> dict:
    """Step 10 (items a-h of the docstring).  Every failed check raises.
    Returns the `serving` JSON object."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli.common import (
        collection_paths, load_dataset, restore_dual_encoding)
    from cross_modal_video_engine_tpu_torch.cli.retrieval_inference import (
        build_video_index, embed_query)
    from cross_modal_video_engine_tpu_torch.cli.retrieval_tester import (
        evaluate)
    from cross_modal_video_engine_tpu_torch.data.provider import LinasDataset
    from cross_modal_video_engine_tpu_torch.models.dual_encoding import (
        DualEncoding, DualEncodingConfig)

    t_step = time.perf_counter()
    cfg = DualEncodingConfig()
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    line = {"card": card, "rows": LINAS_ROWS, "dim": cfg.common_dim,
            "index_dtype": "float32", "config": "DualEncodingConfig()"}
    with torch.no_grad(), tempfile.TemporaryDirectory(dir=scratch) as tmp:
        # a. the model, through the checkpoint format
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        sd = bserve.write_checkpoint(ckpt, cfg, seed=3)
        t1 = time.perf_counter()
        model, _ = restore_dual_encoding(ckpt, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got = model.state_dict()
        unequal = sorted(set(got) ^ set(sd)) + [
            k for k in sd if k in got and not torch.equal(got[k].cpu(), sd[k])]
        n_params = sum(v.numel() for k, v in sd.items()
                       if "running" not in k and "num_batches" not in k)
        size = os.path.getsize(os.path.join(ckpt, "params.msgpack"))
        print(f"LINAS DualEncoding at full width: {n_params} parameters, "
              f"params.msgpack {size / 2**20:.1f} MiB (state dict drawn "
              f"from the seed and written in {t1 - t0:.2f} s), restored to "
              f"the card in {t2 - t1:.2f} s; "
              f"{len(sd) - len(unequal)}/{len(sd)} tensors bit-equal",
              flush=True)
        if unequal:
            raise SystemExit(f"restored LINAS tensors differ: {unequal[:5]}")
        line.update(parameters=n_params, checkpoint_mib=size / 2**20,
                    checkpoint_draw_write_s=t1 - t0,
                    checkpoint_read_s=t2 - t1)

        # b. a collection on disk, embedded by build_video_index
        info = bserve.write_collection(tmp, cfg, LINAS_VIDEOS,
                                       LINAS_CAPTIONS, seed=4)
        dataset = load_dataset(tmp, bserve.COLLECTION, bserve.FEATURE,
                               device=dev)
        warm, _ = next(dataset.video_batches(64))
        model.embed_vis_distill(warm)
        torch.cuda.synchronize()
        cache = os.path.join(tmp, "video_index.npz")
        t0 = time.perf_counter()
        index = build_video_index(model, dataset, 64, cache=cache)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        embed_ms = cuda_ms(lambda: model.embed_vis_distill(warm), iters=5,
                           warmup=1)
        line.update(embed_videos_per_s=LINAS_VIDEOS / build_s,
                    embed_device_videos_per_s=64e3 / embed_ms)
        print(f"build_video_index: {LINAS_VIDEOS} videos ({info['frames']} "
              f"frames x {cfg.visual_feat_dim}) at batch 64 in {build_s:.3f} "
              f"s = {LINAS_VIDEOS / build_s:.1f} videos/s with the feature "
              f"reads and batching; embed_vis_distill alone {embed_ms:.3f} "
              f"ms a batch of 64 = {64e3 / embed_ms:.1f} videos/s on {card}",
              flush=True)
        if index.n != LINAS_VIDEOS or not bool(
                torch.isfinite(index.emb[:index.n]).all()):
            raise SystemExit("the video index is not finite or short")
        del index

        # c. the card against the CPU on the collection's first 64 videos
        # and their captions (the first 64 of them embedded alone)
        cpu = DualEncoding(cfg, device="cpu")
        cpu.load_state_dict(sd)
        with open(collection_paths(tmp, bserve.COLLECTION, bserve.FEATURE)
                  ["cap_file"]) as f:
            lines = f.read().splitlines()[:LINAS_SAMPLE * LINAS_CAPTIONS]
        sample = os.path.join(tmp, "sample.caption.txt")
        with open(sample, "w") as f:
            f.write("\n".join(lines))
        sets = {name: LinasDataset(sample, dataset.visual_feat,
                                   dataset.video2frames, dataset.bow2vec,
                                   dataset.vocab, device=d)
                for name, d in (("card", dev), ("cpu", "cpu"))}
        diffs = {}
        for name, batches, embed in (
                ("videos", lambda ds: ds.video_batches(LINAS_SAMPLE),
                 "embed_vis_distill"),
                ("captions", lambda ds: ds.text_batches(LINAS_SAMPLE),
                 "embed_txt_distill")):
            b_card, _ = next(batches(sets["card"]))
            b_cpu, _ = next(batches(sets["cpu"]))
            e_card = getattr(model, embed)(b_card).cpu()
            e_cpu = getattr(cpu, embed)(b_cpu)
            if e_card.shape != (LINAS_SAMPLE, cfg.common_dim):
                raise SystemExit(f"{name} embeddings of shape {e_card.shape}")
            diffs[name] = float((e_card - e_cpu).abs().max())
        err_card, rep_card = evaluate(model, sets["card"], 64)
        err_cpu, rep_cpu = evaluate(cpu, sets["cpu"], 64)
        diffs["errors"] = float(np.abs(err_card - err_cpu).max())
        print(f"card vs CPU, max |difference| (need < {LINAS_TOL}): "
              + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
        print(f"retrieval_tester.evaluate on the card: {json.dumps(rep_card)}")
        print(f"retrieval_tester.evaluate on the CPU:  {json.dumps(rep_cpu)}",
              flush=True)
        if not all(v < LINAS_TOL for v in diffs.values()) or \
                not np.isfinite(err_card).all():
            raise SystemExit(f"LINAS card vs CPU checks failed: {diffs}")
        line["card_vs_cpu_max_abs"] = diffs
        del cpu, sets
        line["cli_fresh_process"] = linas_cli_card_vs_cpu(
            tmp, ckpt, lines, info["captions"][:LINAS_CLI_QUERIES
                                               * LINAS_CAPTIONS:
                                               LINAS_CAPTIONS], card)

        # d, e. the server, its index filled to LINAS_ROWS, over HTTP
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        server, handler = bserve.start_server(tmp, ckpt, dev, LINAS_ROWS,
                                              index_cache=cache, seed=6)
        torch.cuda.synchronize()
        line["server_build_s"] = time.perf_counter() - t0
        try:
            ix = handler.index
            print(f"server up in {line['server_build_s']:.2f} s: index "
                  f"{ix.n} x {ix.dim} {str(ix.dtype)[6:]} rows, capacity "
                  f"{ix.capacity}, {ix.emb.nbytes / 2**30:.2f} GiB on the "
                  f"card", flush=True)
            if (ix.n, ix.capacity, ix.dim, ix.dtype) != (
                    LINAS_ROWS, LINAS_ROWS, cfg.common_dim, torch.float32):
                raise SystemExit("the serving index is not 1M x 1536 f32")
            port = server.server_address[1]
            worst, same = 0.0, 0
            for cap in info["captions"][:LINAS_HTTP_CHECKS * LINAS_CAPTIONS:
                                        LINAS_CAPTIONS]:
                _, ans = bserve.request(port, "retrieval",
                                        {"query": cap, "topK": 10})
                want_s, want_ids = ix.search_ids(
                    embed_query(handler.model, handler.dataset, cap), k=10)
                got_ids = [r["video"] for r in ans["results"]]
                got_s = np.array([r["score"] for r in ans["results"]])
                same += got_ids == list(want_ids[0])
                worst = max(worst, float(np.abs(got_s - want_s[0]).max()))
            print(f"HTTP /retrieval vs index.search_ids(embed_query(...)) for "
                  f"{LINAS_HTTP_CHECKS} captions: {same} with the same top-10 "
                  f"ids, max score difference {worst:.2e} (need "
                  f"< {SERVE_SCORE_TOL})", flush=True)
            if same != LINAS_HTTP_CHECKS or worst >= SERVE_SCORE_TOL:
                raise SystemExit("HTTP answers differ from the direct search")

            # f. latency over HTTP
            caps = info["captions"]
            lat = bserve.batch1(port, caps, LINAS_SINGLE)
            line["batch1_ms"] = bserve.percentiles(lat)
            line["handler_batch1_ms"] = bserve.percentiles(
                bserve.direct(handler, caps, LINAS_SINGLE))
            w0, r0 = handler.batcher.batches_run, handler.batcher.rows_run
            lat = bserve.concurrent(port, caps, LINAS_CLIENTS,
                                    LINAS_PER_CLIENT)
            waves = handler.batcher.batches_run - w0
            line["conc64_ms"] = bserve.percentiles(lat)
            line["conc64_waves"] = waves
            line["conc64_rows_per_wave"] = (handler.batcher.rows_run - r0
                                            ) / waves
            line["metrics"] = bserve.request(port, "metrics")[1]
            print(f"HTTP retrieval at {LINAS_ROWS} x {cfg.common_dim} f32: "
                  f"batch-1 p50 {line['batch1_ms']['p50']:.3f} ms, p99 "
                  f"{line['batch1_ms']['p99']:.3f} ms ({LINAS_SINGLE} "
                  f"requests; the handler without HTTP p50 "
                  f"{line['handler_batch1_ms']['p50']:.3f}, p99 "
                  f"{line['handler_batch1_ms']['p99']:.3f}); "
                  f"conc-{LINAS_CLIENTS} (clients in their own process) p50 "
                  f"{line['conc64_ms']['p50']:.3f} ms, p99 "
                  f"{line['conc64_ms']['p99']:.3f} ms ({len(lat)} requests "
                  f"in {waves} waves, {line['conc64_rows_per_wave']:.2f} "
                  f"rows a wave) on {card}; /metrics "
                  f"{json.dumps(line['metrics'])}", flush=True)

            # g. one wave of 1 and of 8 rows, timed
            for n in (1, 8):
                t = bserve.wave_times(handler, bserve.wave_rows(
                    handler, caps, n), LINAS_WAVE_CALLS)
                line[f"wave{n}"] = t
                print(f"wave of {n} at {LINAS_ROWS} rows: wall "
                      f"{t['wall_ms']:.3f} ms, CUDA events "
                      f"{t['events_ms']:.3f} ms, kernels busy "
                      f"{t['busy_ms']:.3f} ms, idle share "
                      f"{t['idle_share']:.3f} on {card}; longest kernels "
                      f"(ms a wave): {json.dumps(t['top_kernels'])}",
                      flush=True)
        finally:
            bserve.stop_server(server, handler)
    line["step_s"] = time.perf_counter() - t_step
    print(f"LINAS serving step: {line['step_s']:.1f} s", flush=True)
    return line


# LINAS training step (tolerances stated before the first run on the card)
# (256 training videos: 20 steps in 2 epochs, for the script's time)
TRAIN_VIDEOS, TRAIN_VAL_VIDEOS, TRAIN_CAPTIONS = 256, 128, 5
TRAIN_BATCH, TRAIN_SUPPORT, TRAIN_EPOCHS = 128, 8, 2
TRAIN_VAL_COLLECTION = "linasval"
# (a) card vs CPU, one step: the loss; each gradient tensor within
# REL of its norm plus FLOOR of the whole gradient's norm (the mappings'
# fc1 biases have a gradient of exactly 0 in exact arithmetic: BatchNorm
# subtracts their shift, so theirs is rounding noise on both sides); the
# parameters after one Adam step, an update of lr * g / (|g| + 1e-8), within
# PARAM_TOL where the CPU's gradient is above NOISE of its largest
# element, and within 2 lr where it is below (there rounding noise picks
# the sign, and eps the size)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR, TRAIN_NOISE = 1e-4, 1e-6, 1e-4
TRAIN_PARAM_TOL = 1e-5
# (b) each similarity_type at B = 128, card vs CPU: values; gradients by
# relative L2 error ('svd': its backward divides by gaps between singular
# values, down to 1e-4 at this size)
SIM_VALUE_RTOL, SIM_GRAD_REL, SVD_GRAD_REL = 1e-4, 1e-4, 1e-3
# (d) resumed epoch 1 vs the uninterrupted run, both on the card: the
# epoch's mean loss; the share of parameters within PARAM_TOL (an element
# whose gradient is rounding noise takes a +-lr Adam step the noise picks)
# and every element within 2 lr a step
RESUME_LOSS_RTOL, RESUME_PARAM_TOL, RESUME_PARAM_SHARE = 1e-4, 1e-4, 0.999
TRAIN_HTTP_CHECKS, ADAPT_STEPS, TIMED_STEPS = 8, 2, 5


def _grad_errors(card_model, cpu_model) -> dict:
    """Per parameter: |card grad - CPU grad| and the CPU gradient's norm
    (a missing gradient is zero)."""
    import torch
    out = {}
    for (name, p), (_, q) in zip(card_model.named_parameters(),
                                 cpu_model.named_parameters()):
        g = torch.zeros_like(q) if p.grad is None else p.grad.cpu()
        h = torch.zeros_like(q) if q.grad is None else q.grad
        out[name] = (g, h)
    return out


def train_card_vs_cpu(dev, cfg, sd, batches) -> dict:
    """Step 11a: one de+map step of the full-width model (dropout 0) on
    the card and on the CPU from one state dict and one batch."""
    import torch
    from cross_modal_video_engine_tpu_torch.models.dual_encoding import (
        DualEncoding)
    from cross_modal_video_engine_tpu_torch.train.linas_trainer import (
        LinasTrainConfig, TrainState, make_optimizer, make_train_step)

    tcfg = LinasTrainConfig()
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = DualEncoding(cfg, device=d)
        model.load_state_dict(sd)
        state = TrainState(model, make_optimizer(tcfg)(
            list(model.named_parameters())))
        t0 = time.perf_counter()
        state, logs = make_train_step(model, tcfg, device=d)(
            state, *batches[name][:3])
        loss = float(logs["loss"])
        runs[name] = (model, loss, time.perf_counter() - t0)
    (card, card_loss, card_s), (cpu, cpu_loss, cpu_s) = (runs["card"],
                                                         runs["cpu"])
    line, bad, summary = step_agreement(card, cpu, card_loss, cpu_loss,
                                        tcfg.learning_rate)
    print(f"11a one de+map step at batch {TRAIN_BATCH}, card vs CPU: "
          f"{summary}; step {card_s:.2f} s on the card (first), "
          f"{cpu_s:.2f} s on the CPU", flush=True)
    if bad:
        raise SystemExit(f"11a card vs CPU failed: {bad[:5]}")
    return line


def step_agreement(card, cpu, card_loss: float, cpu_loss: float,
                   lr: float):
    """One train step of the same model from the same state on the card and
    on the CPU, held to the bounds of step 11a: the loss within
    TRAIN_LOSS_RTOL; each gradient tensor within TRAIN_GRAD_REL of its norm
    plus TRAIN_GRAD_FLOOR of the whole gradient's norm; the parameters
    after the Adam step within TRAIN_PARAM_TOL where the CPU's gradient is
    above TRAIN_NOISE of its largest element, within 2 lr below.  Returns
    (numbers, what failed, a summary for the log)."""
    import torch
    grads = _grad_errors(card, cpu)
    total = float(torch.sqrt(sum((h * h).sum() for _, h in grads.values())))
    gmax = max(float(h.abs().max()) for _, h in grads.values())
    worst, bad = 0.0, []
    for name, (g, h) in grads.items():
        err = float((g - h).norm())
        bound = TRAIN_GRAD_REL * float(h.norm()) + TRAIN_GRAD_FLOOR * total
        worst = max(worst, err / bound)
        if err > bound:
            bad.append(name)
    p_worst, n_noise, noise_worst = 0.0, 0, 0.0
    card_sd = card.state_dict()
    for name, q in cpu.named_parameters():
        _, h = grads[name]
        noise = h.abs() < TRAIN_NOISE * gmax
        diff = (card_sd[name].cpu() - q.detach()).abs()
        if bool((~noise).any()):
            p_worst = max(p_worst, float(diff[~noise].max()))
        if bool(noise.any()):
            noise_worst = max(noise_worst, float(diff[noise].max()))
        g, _ = grads[name]
        n_noise += int((noise & ((g != 0) | (h != 0))).sum())
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    summary = (
        f"loss {card_loss:.6f} vs {cpu_loss:.6f} (rel {loss_rel:.2e}, need "
        f"<= {TRAIN_LOSS_RTOL}); gradients: worst error / bound "
        f"{worst:.3f} (bound {TRAIN_GRAD_REL} of the tensor's norm + "
        f"{TRAIN_GRAD_FLOOR} of the whole gradient's {total:.4f}); "
        f"parameters after the step: max |difference| {p_worst:.2e} "
        f"where the CPU's gradient is above {TRAIN_NOISE} of its largest "
        f"element {gmax:.4f} (need <= {TRAIN_PARAM_TOL}), {noise_worst:.2e} "
        f"below it (need <= {2 * lr:.0e}; {n_noise} elements with a "
        f"nonzero gradient there)")
    if loss_rel > TRAIN_LOSS_RTOL or not np.isfinite(card_loss):
        bad.append("loss")
    if p_worst > TRAIN_PARAM_TOL or noise_worst > 2 * lr:
        bad.append("parameters")
    return ({"loss_card": card_loss, "loss_cpu": cpu_loss,
             "loss_rel": loss_rel, "grad_worst_over_bound": worst,
             "param_max_abs": p_worst, "noise_elements": n_noise,
             "noise_param_max_abs": noise_worst}, bad, summary)


def similarity_card_vs_cpu(dev) -> dict:
    """Step 11b: similarity_distill of each type at B = 128 (unit rows of
    1536 from a numpy seed) on the card and on the CPU: the value, and the
    gradient with respect to the student embeddings."""
    import torch
    from cross_modal_video_engine_tpu_torch.losses.distill import (
        similarity_distill)
    from cross_modal_video_engine_tpu_torch.train.linas_trainer import (
        mask_matrix)

    rng = np.random.default_rng(17)
    embs = []
    for _ in range(4):
        a = rng.standard_normal((TRAIN_BATCH, 1536)).astype(np.float32)
        embs.append(a / np.linalg.norm(a, axis=1, keepdims=True))
    # why 'svd' factorizes on the host: the card's own solver's signs
    s1 = torch.tensor(embs[0] @ embs[1].T)
    u_cpu = torch.linalg.svd(s1, full_matrices=False)[0]
    u_card = torch.linalg.svd(s1.to(dev), full_matrices=False)[0].cpu()
    agree = float((torch.sign((u_cpu * u_card).sum(0)) > 0).float().mean())
    print(f"11b torch.linalg.svd of a {TRAIN_BATCH} x {TRAIN_BATCH} "
          f"similarity matrix: the card's singular vectors have LAPACK's "
          f"sign in {agree:.3f} of the pairs (the port's 'svd' factorizes "
          f"on the host)", flush=True)
    out, bad = {"cusolver_sign_agreement": agree}, []
    for stype in (None, "diag", "maxdiag", "adapt", "svd", "eig"):
        res = {}
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            x = [torch.tensor(a, device=d, requires_grad=i >= 2)
                 for i, a in enumerate(embs)]
            w = (mask_matrix(torch.tensor([1.3, 0.7], device=d),
                             TRAIN_BATCH) if stype == "adapt" else None)
            loss = similarity_distill(*x, stype, adapt_weight=w)
            grads = (torch.autograd.grad(loss, x[2:]) if loss.requires_grad
                     else None)
            res[name] = (float(loss.detach()), None if grads is None else
                         [g.cpu() for g in grads])
        (v_card, g_card), (v_cpu, g_cpu) = res["card"], res["cpu"]
        rel = abs(v_card - v_cpu) / abs(v_cpu)
        g_rel = (None if g_cpu is None else
                 max(float((a - b).norm() / b.norm())
                     for a, b in zip(g_card, g_cpu)))
        limit = SVD_GRAD_REL if stype == "svd" else SIM_GRAD_REL
        key = stype or "plain"
        out[key] = {"value_card": v_card, "value_cpu": v_cpu,
                    "value_rel": rel, "grad_rel_l2": g_rel}
        ok = rel <= SIM_VALUE_RTOL and (g_rel is None or g_rel <= limit) \
            and (stype == "eig") == (g_rel is None)
        print(f"11b similarity_distill {key}: card {v_card:.6f} CPU "
              f"{v_cpu:.6f} (rel {rel:.2e}, need <= {SIM_VALUE_RTOL}); "
              f"gradient rel L2 "
              f"{'none (no gradient)' if g_rel is None else f'{g_rel:.2e}'}"
              f" (need <= {limit})", flush=True)
        if not ok:
            bad.append(key)
    if bad:
        raise SystemExit(f"11b similarity types differ on the card: {bad}")
    return out


def _parse_step_losses(log: str):
    """The per-step losses train() prints with log_every=1."""
    return [float(m.group(1)) for m in
            re.finditer(r"^epoch \d+ step \d+: loss=(\S+) ", log, re.M)]


def _train_quiet(*args, **kw):
    """train(...) with its printing kept: (state, history, best, log)."""
    import contextlib
    import io
    from cross_modal_video_engine_tpu_torch.cli.retrieval_trainer import (
        train)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, history, best = train(*args, **kw)
    return state, history, best, buf.getvalue()


def time_steps(dev, state, tcfg, train_set, card) -> dict:
    """Step 11c's timings on the trained model: a step over prebuilt
    batches by CUDA events (median of the steady steps), the optimizer's
    step alone, the host's batch assembly, and the idle share of five
    steps of the real loop (assembly included) from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cross_modal_video_engine_tpu_torch.train.linas_trainer import (
        make_train_step)

    step = make_train_step(state.model, tcfg, device=dev)
    batches = list(itertools.islice(
        train_set.train_batches(TRAIN_BATCH, 99), TIMED_STEPS))
    spans = []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, logs = step(state, *b[:3])
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    step_ms = float(np.median(spans[2:]))
    opt_ms = cuda_ms(state.optimizer.step, iters=5, warmup=1)
    it = train_set.train_batches(TRAIN_BATCH, 98)
    t0 = time.perf_counter()
    for _ in range(5):
        next(it)
    torch.cuda.synchronize()
    assembly_ms = (time.perf_counter() - t0) / 5 * 1e3
    it = train_set.train_batches(TRAIN_BATCH, 97)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            state, logs = step(state, *next(it)[:3])
        float(logs["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    # device entries only, without the optimizer's annotated range (its
    # kernels are counted as themselves)
    kernels = sorted(((e.self_device_time_total / 5 / 1e3, e.key)
                      for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")
                      and not getattr(e, "is_user_annotation", False)
                      and not e.key.startswith("Optimizer.")),
                     reverse=True)
    busy_ms = sum(ms for ms, _ in kernels)
    line = {"step_ms": step_ms, "step_ms_all": spans,
            "samples_per_s": TRAIN_BATCH * 1e3 / step_ms,
            "optimizer_ms": opt_ms, "optimizer_share": opt_ms / step_ms,
            "assembly_ms": assembly_ms, "loop_wall_ms": wall_ms,
            "loop_samples_per_s": TRAIN_BATCH * 1e3 / wall_ms,
            "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "top_kernels": [[k[:80], ms] for ms, k in kernels[:8]]}
    print(f"11c de+map step at batch {TRAIN_BATCH}, support "
          f"{TRAIN_SUPPORT}: {step_ms:.3f} ms by CUDA events (median of "
          f"steps 3-{TIMED_STEPS} over prebuilt batches) = "
          f"{line['samples_per_s']:.1f} samples/s; the optimizer's step "
          f"alone {opt_ms:.3f} ms = {line['optimizer_share']:.3f} of a "
          f"step; the host assembles a batch in {assembly_ms:.1f} ms; the "
          f"loop with its assembly {wall_ms:.1f} ms a step = "
          f"{line['loop_samples_per_s']:.1f} samples/s, kernels and copies "
          f"busy {busy_ms:.3f} ms of it, idle share "
          f"{line['idle_share']:.3f} on {card}; "
          f"longest kernels (ms a step): {json.dumps(line['top_kernels'])}",
          flush=True)
    return line


def check_linas_training(dev, card) -> dict:
    """Step 11 (items a-f of the docstring).  Every failed check raises.
    Returns the `training` JSON object."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli.common import load_dataset
    from cross_modal_video_engine_tpu_torch.cli.retrieval_inference import (
        embed_query)
    from cross_modal_video_engine_tpu_torch.cli.retrieval_tester import (
        evaluate)
    from cross_modal_video_engine_tpu_torch.models.dual_encoding import (
        DualEncoding, DualEncodingConfig, seeded_state_dict)
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer
    from cross_modal_video_engine_tpu_torch.ops import flash_attention
    from cross_modal_video_engine_tpu_torch.train.linas_trainer import (
        LinasTrainConfig, init_mask_state, init_train_state,
        make_mask_optimizer, make_mask_train_step, make_optimizer,
        make_train_step, mask_matrix)

    t_step = time.perf_counter()
    counted = [attention_sublayer.fused_attention_sublayer,
               attention_sublayer.fused_attention_sublayer_compact,
               attention_sublayer.fused_mlp_sublayer,
               attention_sublayer.fused_block_sublayer_compact,
               flash_attention.flash_attention]
    for fn in counted:
        fn.launches = 0
    # dropout 0: the card-vs-CPU step and the resume are compared element
    # for element, and a resumed run draws its dropout anew (as the JAX
    # trainer's does)
    cfg = DualEncodingConfig(dropout=0.0)
    tcfg = LinasTrainConfig()
    line = {"card": card, "config": "DualEncodingConfig(dropout=0.0)",
            "train_config": "LinasTrainConfig()", "batch": TRAIN_BATCH,
            "support": TRAIN_SUPPORT, "videos": TRAIN_VIDEOS,
            "captions": TRAIN_VIDEOS * TRAIN_CAPTIONS}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        info = bserve.write_collection(tmp, cfg, TRAIN_VIDEOS,
                                       TRAIN_CAPTIONS, seed=8)
        bserve.write_collection(tmp, cfg, TRAIN_VAL_VIDEOS, TRAIN_CAPTIONS,
                                collection=TRAIN_VAL_COLLECTION, seed=9)
        sets = {name: load_dataset(tmp, bserve.COLLECTION, bserve.FEATURE,
                                   support_set_number=TRAIN_SUPPORT,
                                   device=d)
                for name, d in (("card", dev), ("cpu", "cpu"))}
        val_set = load_dataset(tmp, TRAIN_VAL_COLLECTION, bserve.FEATURE,
                               device=dev)

        # a. one step, card against CPU
        sd = seeded_state_dict(cfg, seed=12)
        batches = {k: next(ds.train_batches(TRAIN_BATCH, 5))
                   for k, ds in sets.items()}
        line["card_vs_cpu"] = train_card_vs_cpu(dev, cfg, sd, batches)
        del batches

        # b. each similarity type, card against CPU
        line["similarity"] = similarity_card_vs_cpu(dev)

        # c. retrieval_trainer.train(), 2 epochs with a train state each
        out = os.path.join(tmp, "run")
        os.makedirs(out)
        t0 = time.perf_counter()
        state, history, best, log = _train_quiet(
            cfg, tcfg, sets["card"], val_set, out, TRAIN_BATCH,
            log_every=1, num_epochs=TRAIN_EPOCHS, checkpoint_interval=1,
            device=dev)
        train_s = time.perf_counter() - t0
        losses = _parse_step_losses(log)
        steps = len(losses)
        first4, last4 = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
        print(f"11c retrieval_trainer.train(): {steps} steps in "
              f"{TRAIN_EPOCHS} epochs, {train_s:.1f} s with validation and "
              f"checkpoints; per epoch "
              + "; ".join(f"epoch {h['epoch']} loss {h['loss']:.4f} rsum "
                          f"{h['rsum']:.2f} {h['time']:.2f} s"
                          for h in history)
              + f"; mean loss of the first four steps {first4:.4f}, of the "
              f"last four {last4:.4f}; model_best -> "
              f"{os.path.basename(os.readlink(best))}", flush=True)
        if (steps != TRAIN_EPOCHS * -(-TRAIN_VIDEOS * TRAIN_CAPTIONS
                                      // TRAIN_BATCH)
                or not np.isfinite(losses).all() or not last4 < first4):
            raise SystemExit(f"11c training failed: {steps} steps, losses "
                             f"{losses[:4]} ... {losses[-4:]}")
        model = state.model.eval()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate(model, val_set, TRAIN_BATCH)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        line.update(train_s=train_s, steps=steps, step_losses=losses,
                    epochs=history, validation_s=val_s,
                    first4_loss=first4, last4_loss=last4)
        print(f"11c validation (retrieval_tester.evaluate, "
              f"{TRAIN_VAL_VIDEOS} videos, "
              f"{TRAIN_VAL_VIDEOS * TRAIN_CAPTIONS} captions): "
              f"{val_s:.2f} s", flush=True)
        final = {k: v.detach().cpu().clone()
                 for k, v in state.model.state_dict().items()}

        # d. resume from epoch_0 for epoch 1
        out2 = os.path.join(tmp, "resumed")
        os.makedirs(out2)
        rstate, rhist, _, _ = _train_quiet(
            cfg, tcfg, sets["card"], val_set, out2, TRAIN_BATCH,
            log_every=0, num_epochs=TRAIN_EPOCHS,
            resume=os.path.join(out, "epoch_0"), device=dev)
        loss_rel = abs(rhist[0]["loss"] - history[1]["loss"]) / abs(
            history[1]["loss"])
        within, n, worst = 0, 0, 0.0
        bound = 2 * tcfg.learning_rate * (steps // TRAIN_EPOCHS)
        for k, v in rstate.model.state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue
            d = (v.detach().cpu() - final[k]).abs()
            within += int((d <= RESUME_PARAM_TOL).sum())
            n += d.numel()
            worst = max(worst, float(d.max()))
        share = within / n
        line["resume"] = {"epoch1_loss": rhist[0]["loss"],
                          "uninterrupted_loss": history[1]["loss"],
                          "loss_rel": loss_rel, "rsum": rhist[0]["rsum"],
                          "uninterrupted_rsum": history[1]["rsum"],
                          "params_within_share": share,
                          "param_max_abs": worst}
        print(f"11d resumed from epoch_0: epoch 1 loss "
              f"{rhist[0]['loss']:.6f} vs {history[1]['loss']:.6f} "
              f"uninterrupted (rel {loss_rel:.2e}, need <= "
              f"{RESUME_LOSS_RTOL}), rsum {rhist[0]['rsum']:.2f} vs "
              f"{history[1]['rsum']:.2f}; parameters within "
              f"{RESUME_PARAM_TOL}: {share:.6f} of {n} (need >= "
              f"{RESUME_PARAM_SHARE}), max |difference| {worst:.2e} (need "
              f"<= {bound:.1e})", flush=True)
        if (rhist[0]["epoch"] != 1 or loss_rel > RESUME_LOSS_RTOL
                or share < RESUME_PARAM_SHARE or worst > bound):
            raise SystemExit("11d the resumed run differs")
        del rstate, final

        # c (timings), on the trained model
        line["timing"] = time_steps(dev, state, tcfg, sets["card"], card)
        del state, model
        torch.cuda.empty_cache()

        # e. model_best restored and served over HTTP
        server, handler = bserve.start_server(tmp, best, dev, TRAIN_VIDEOS,
                                              seed=10)
        try:
            ix, port = handler.index, server.server_address[1]
            same, worst, own = 0, 0.0, 0
            # the first caption of each of the first videos
            caps = info["captions"][::TRAIN_CAPTIONS][:TRAIN_HTTP_CHECKS]
            for i, cap in enumerate(caps):
                _, ans = bserve.request(port, "retrieval",
                                        {"query": cap, "topK": 10})
                want_s, want_ids = ix.search_ids(
                    embed_query(handler.model, handler.dataset, cap), k=10)
                got_ids = [r["video"] for r in ans["results"]]
                got_s = np.array([r["score"] for r in ans["results"]])
                same += got_ids == list(want_ids[0])
                worst = max(worst, float(np.abs(got_s - want_s[0]).max()))
                own += got_ids[0] == f"video{i}"
        finally:
            bserve.stop_server(server, handler)
        line["serve"] = {"same_top10": same, "checks": TRAIN_HTTP_CHECKS,
                         "max_score_diff": worst, "own_video_top1": own}
        print(f"11e model_best served over HTTP: {same}/{TRAIN_HTTP_CHECKS} "
              f"answers with the top-10 ids of a direct search_ids, max "
              f"score difference {worst:.2e} (need < {SERVE_SCORE_TOL}); "
              f"{own} training captions find their own video first",
              flush=True)
        if same != TRAIN_HTTP_CHECKS or worst >= SERVE_SCORE_TOL:
            raise SystemExit("11e served answers differ from the search")

        # f. text+video with the 'adapt' mask, a few steps
        acfg = DualEncodingConfig(student_model="text+video")
        atcfg = LinasTrainConfig(distill_with_similarity=True,
                                 similarity_type="adapt")
        model = DualEncoding(acfg, device=dev)
        astate = init_train_state(model, make_optimizer(atcfg), seed=13)
        gen = torch.Generator(device=dev).manual_seed(14)
        step = make_train_step(model, atcfg, gen, device=dev)
        tx2 = make_mask_optimizer(atcfg)
        mask = init_mask_state(tx2, dev)
        mask_step = make_mask_train_step(model)
        pa0 = mask.pa.detach().cpu().numpy().copy()
        alosses, mlosses = [], []
        t0 = time.perf_counter()
        for b in itertools.islice(sets["card"].train_batches(TRAIN_BATCH, 6),
                                  ADAPT_STEPS):
            astate, logs = step(astate, *b[:3],
                                mask_matrix(mask.pa, TRAIN_BATCH))
            mask, mloss = mask_step(mask, astate, *b[:3])
            alosses.append(float(logs["loss"]))
            mlosses.append(mloss)
        adapt_s = time.perf_counter() - t0
        pa = mask.pa.detach().cpu().numpy()
        line["adapt"] = {"losses": alosses, "mask_losses": mlosses,
                         "pa": pa.tolist(), "s": adapt_s}
        print(f"11f text+video with the adapt mask, {ADAPT_STEPS} steps in "
              f"{adapt_s:.2f} s: losses {alosses}, mask losses {mlosses}, "
              f"pa {pa0.tolist()} -> {pa.tolist()}", flush=True)
        if (not np.isfinite(alosses + mlosses).all()
                or np.allclose(pa, pa0)):
            raise SystemExit("11f the adapt mask did not train")
        del astate, model
    launches = {fn.__name__: fn.launches for fn in counted}
    line["kernel_launches"] = launches
    line["step_s"] = time.perf_counter() - t_step
    print(f"LINAS training step: {line['step_s']:.1f} s; launches of the "
          f"five kernels during it (the LINAS model has none): "
          f"{json.dumps(launches)}", flush=True)
    return line


# -- 12. composed retrieval (tolerances stated before the first run) ---------
COMPOSED_VIDEOS, COMPOSED_REQUESTS, COMPOSED_REFS = 250, 8, 4
RN_CHECK_FRAMES, EXTRACT_CALLS, COMPOSED_TOPK = 1, 3, 10
COMBINER_TRIPLETS, COMBINER_BATCH, COMBINER_EPOCHS = 128, 32, 2
COMBINER_HTTP_CHECKS, COMBINER_TIMED_STEPS = 4, 5
# (a) clip_preprocess card vs CPU: the same f32 arithmetic rounded to bf16;
# where the two f32 values fall on two sides of a rounding boundary the
# outputs differ by one bf16 step (2^-6 for |x| < 4), in at most PRE_SHARE
# of the elements
PRE_STEP, PRE_SHARE = 2.0 ** -6, 1e-2
# (b) RN50x4 in f32 with TF32 off, card vs CPU on the same bf16 pixels: max
# |difference| within RN_REL of the output's largest |value| (26
# bottlenecks of f32 convolutions, whose algorithms cuDNN picks: Winograd
# and FFT transforms round otherwise than a direct sum)
RN_REL = 1e-3


def composed_preprocess(dev) -> dict:
    """Step 12a: clip_preprocess on the card against the CPU."""
    import torch
    from cross_modal_video_engine_tpu_torch.ops.preprocess import (
        clip_preprocess)
    rng = np.random.default_rng(21)
    worst_step, worst_share = 0.0, 0.0
    for shape in ((4, 360, 480, 3), (4, 120, 160, 3)):     # shrink, grow
        frames = torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
        for pad in ("targetpad", "squarepad", None):
            for dim in (288, 224):
                want = clip_preprocess(frames, dim, pad).float()
                got = clip_preprocess(frames.to(dev), dim, pad).float().cpu()
                diff = (got - want).abs()
                worst_step = max(worst_step, float(diff.max()))
                worst_share = max(worst_share, float((diff > 0).float()
                                                     .mean()))
    ok = worst_step <= PRE_STEP and worst_share <= PRE_SHARE
    print(f"12a clip_preprocess card vs CPU (360x480 and 120x160, targetpad/"
          f"squarepad/none, 288 and 224): max |difference| {worst_step:.4g} "
          f"(need <= {PRE_STEP}), share of differing elements "
          f"{worst_share:.2e} (need <= {PRE_SHARE})", flush=True)
    if not ok:
        raise SystemExit("12a clip_preprocess card vs CPU failed")
    return {"max_abs": worst_step, "share": worst_share}


def rn50x4_card_vs_cpu(card_model, clip_checkpoint, frames_u8) -> dict:
    """Step 12b: the RN50x4 tower restored from the checkpoint on the CPU
    against the route's model on the card: high, middle and encode_text."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import composed_inference as ci
    from cross_modal_video_engine_tpu_torch.models.clip_resnet import (
        CLIPResNetModel)
    from cross_modal_video_engine_tpu_torch.ops.preprocess import (
        clip_preprocess)

    cpu_model, cfg = ci.load_clip_tower(clip_checkpoint, "cpu")
    pixels = clip_preprocess(torch.from_numpy(frames_u8[:RN_CHECK_FRAMES]),
                             cfg.image_resolution)
    ids = torch.from_numpy(text_ids(np.random.default_rng(22), 4,
                                    cfg.context_length, cfg.vocab_size))
    dev = card_model.device
    with torch.no_grad():
        want = (*cpu_model.encode_image(pixels), cpu_model.encode_text(ids))
        got = (*card_model.encode_image(pixels.to(dev)),
               card_model.encode_text(ids.to(dev)))
    errs = {}
    for name, g, w in zip(("high", "middle", "text"), got, want):
        errs[name] = float((g.cpu() - w).abs().max() / w.abs().max())
    vis = sum(p.numel() for n, p in cpu_model.named_parameters()
              if n.startswith("visual."))
    txt = sum(p.numel() for n, p in cpu_model.named_parameters()
              if not n.startswith("visual.") and n != "logit_scale")
    macs = [0]

    def count(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            macs[0] += out.numel() * mod.in_channels * mod.kernel_size[0] \
                * mod.kernel_size[1] // mod.groups
        elif isinstance(mod, torch.nn.Linear):
            macs[0] += out.numel() * mod.in_features

    # one frame through a copy of the tower on the meta device: shapes only
    meta = CLIPResNetModel(cfg, device="meta").visual
    for m in meta.modules():
        m.register_forward_hook(count)
    with torch.no_grad():
        _, middle = meta(torch.empty(1, cfg.image_resolution,
                                     cfg.image_resolution, 3, device="meta"))
    line = {"rel_err": errs, "vision_params": vis, "text_params": txt,
            "gmac_per_frame": macs[0] / 1e9,
            "layer3_map": list(middle.shape[1:]),
            "high_shape": list(got[0].shape),
            "middle_shape": list(got[1].shape)}
    print(f"12b RN50x4 (f32, TF32 off) card vs CPU on {RN_CHECK_FRAMES} "
          f"frames at {cfg.image_resolution}: max |difference| / max "
          f"|value|: {json.dumps(errs)} (need <= {RN_REL}); "
          f"{vis / 1e6:.2f}M vision and {txt / 1e6:.2f}M text parameters, "
          f"{macs[0] / 1e9:.2f} GMAC a frame (convolutions and products), "
          f"layer3 map {tuple(middle.shape[1:])}", flush=True)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    if max(errs.values()) > RN_REL or not finite:
        raise SystemExit("12b RN50x4 card vs CPU failed")
    return line


def composed_requests(handler, port, refs, n: int, index_high) -> int:
    """n requests over HTTP, one after another; each answer against a
    direct rank_index on the route's models and the same features.
    Returns how many answers differed."""
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli import composed_inference as ci

    payloads = bserve.composed_payloads(sorted(refs), n, COMPOSED_TOPK)
    answers = [bserve.request(port, "composed_retrieval", p,
                              timeout=600.0)[1]["results"] for p in payloads]
    ctx = handler.clip_cfg.context_length
    differ = 0
    for p, got in zip(payloads, answers):
        h, m = handler.reference_features(refs[p["reference_video"]])
        text = ci.encode_text(handler.clip_model, handler.tokenizer,
                              p["text"], ctx)
        order = ci.rank_index(handler.combiner, h, m, text, index_high)
        differ += got != [handler.names[i] for i in order[:COMPOSED_TOPK]]
    return differ


def composed_route(dev, card, root, refs, clip_cfg, comb_cfg, counted=()):
    """Steps 12c/12d: the fixtures in the JAX format, the route as
    cli.serve builds it on the card, COMPOSED_REQUESTS requests over HTTP
    (launch counters of `counted` zeroed just before, read just after),
    answers against a direct rank, the batch-1 p50 and the extraction and
    wave times.  Returns (line, launches, args, handler, server)."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli import composed_inference as ci

    t0 = time.perf_counter()
    args = bserve.write_composed_fixtures(root, clip_cfg, comb_cfg,
                                          COMPOSED_VIDEOS, seed=0)
    args.device = str(dev)
    fixtures_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server, handler = bserve.start_composed_server(args, refs.__getitem__)
    start_s = time.perf_counter() - t0
    port = server.server_address[1]
    bserve.request(port, "composed_retrieval", bserve.composed_payloads(
        sorted(refs), 1, COMPOSED_TOPK)[0], timeout=600.0)     # warm-up
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    lat = [bserve.request(port, "composed_retrieval", p, timeout=600.0)[0]
           for p in bserve.composed_payloads(sorted(refs), COMPOSED_REQUESTS,
                                             COMPOSED_TOPK)]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    _, index_high = ci.candidate_index(
        handler.clip_model, handler.clip_cfg.image_resolution,
        args.videos_dir, args.feature_cache)
    differ = composed_requests(handler, port, refs, len(refs), index_high)
    ext = bserve.extraction_times(handler, refs[sorted(refs)[0]],
                                  EXTRACT_CALLS)
    wave = bserve.wave_times(handler, bserve.composed_wave_rows(
        handler, refs, 1), 10, device=dev)
    p = bserve.percentiles(lat)
    line = {"clip": type(clip_cfg).__name__, "clip_dim": clip_cfg.embed_dim,
            "middle_mix": comb_cfg.middle_mix, "videos": COMPOSED_VIDEOS,
            "requests": COMPOSED_REQUESTS, "ref_frames": bserve.REF_FRAMES,
            "ref_size": [bserve.REF_HEIGHT, bserve.REF_WIDTH],
            "batch1_p50_ms": p["p50"], "batch1_p99_ms": p["p99"],
            "extract_wall_ms": ext["wall_ms"],
            "extract_events_ms": ext["events_ms"],
            "extract_busy_ms": ext.get("busy_ms"),
            "extract_top_kernels": ext.get("top_kernels"),
            "wave1_wall_ms": wave["wall_ms"],
            "wave1_events_ms": wave["events_ms"],
            "wave1_busy_ms": wave["busy_ms"],
            "wave1_idle_share": wave["idle_share"],
            "answers_differing": differ, "fixtures_s": fixtures_s,
            "route_start_s": start_s, "card": card}
    return line, launches, args, handler, server


def vit_arms_agree(handler, clip_checkpoint, refs) -> float:
    """Step 12d: the route's kernel arm against the plain arm (fused off,
    same weights) through preprocess, the towers, pooling and
    combine_features: the smallest cosine over the reference videos."""
    import dataclasses
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli import composed_inference as ci
    from cross_modal_video_engine_tpu_torch.convert.from_jax import (
        clip_state_dict_from_jax)
    from cross_modal_video_engine_tpu_torch.models.clip import CLIPModel
    from cross_modal_video_engine_tpu_torch.train.checkpoint import (
        load_checkpoint)

    kernel = handler.clip_model
    cfg = dataclasses.replace(handler.clip_cfg, fused_attn=False,
                              fused_mlp=False)
    variables, _, _ = load_checkpoint(clip_checkpoint)
    plain = CLIPModel(cfg, device=kernel.logit_scale.device)
    plain.load_state_dict(clip_state_dict_from_jax(variables, cfg))
    plain.eval()
    comb, dim = handler.combiner, handler.combiner.cfg.clip_feature_dim
    cos = []
    for p in bserve.composed_payloads(sorted(refs), len(refs),
                                      COMPOSED_TOPK):
        frames = refs[p["reference_video"]]
        preds = []
        for model in (kernel, plain):
            h, m = ci.encode_video_frames(model, frames, cfg.image_resolution)
            h, m = ci.build_combiner_inputs(h, m, dim=dim)
            text = ci.encode_text(model, handler.tokenizer, p["text"],
                                  cfg.context_length)
            with torch.no_grad():
                preds.append(comb.combine_features((h[None], m[None]), text))
        cos.append(cosine_min(*preds))
    del plain
    return min(cos)


def write_composed_triplets(path: str, names, n: int, seed: int = 31):
    """n (reference, target, edit) triplets over the collection's names."""
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            a, b = rng.choice(len(names), 2, replace=False)
            f.write(f"{names[a]}\t{names[b]}\t"
                    f"{bserve.EDITS[i % len(bserve.EDITS)]}\n")


def composed_training(dev, card, root, vit_args, vit_handler) -> dict:
    """Step 12e: the combiner trainer at CombinerConfig(clip_feature_dim=
    512) on the 512-wide collection with the route's ViT-B/32 text tower
    (fused) frozen."""
    import argparse
    import contextlib
    import io
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli import composed_inference as ci
    from cross_modal_video_engine_tpu_torch.cli.combiner_trainer import (
        encode_texts, train_combiner)
    from cross_modal_video_engine_tpu_torch.cli.composed_validate import (
        validate)
    from cross_modal_video_engine_tpu_torch.data.composed_dataset import (
        ComposedVideoDataset, FeatureStore)
    from cross_modal_video_engine_tpu_torch.models.combiner import (
        Combiner, CombinerConfig)
    from cross_modal_video_engine_tpu_torch.train.combiner_trainer import (
        CombinerTrainConfig, init_combiner_state, make_combiner_optimizer,
        make_combiner_train_step)

    tsv = os.path.join(root, "triplets.tsv")
    write_composed_triplets(tsv, vit_handler.names, COMBINER_TRIPLETS)
    dataset = ComposedVideoDataset(tsv, FeatureStore(
        {"main": vit_args.feature_cache}))
    clip_model, tok = vit_handler.clip_model, vit_handler.tokenizer

    def text_fn(caps):
        return encode_texts(clip_model, tok, caps,
                            clip_model.cfg.context_length)

    # (1) one step, card against CPU, dropout 0
    cfg0 = CombinerConfig(clip_feature_dim=512, dropout=0.0)
    tcfg = CombinerTrainConfig()
    first = next(dataset.batches(COMBINER_BATCH))
    text = text_fn(first["captions"])
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = Combiner(cfg0, device="meta").to_empty(device=d)
        state = init_combiner_state(model, make_combiner_optimizer(tcfg), 7)
        feats = [torch.from_numpy(first[k]).to(d) for k in (
            "ref_high", "ref_middle", "target_high", "target_middle")]
        state, loss = make_combiner_train_step(model)(
            state, tuple(feats[:2]), text.to(d), tuple(feats[2:]))
        runs[name] = (model, float(loss))
    step_line, bad, summary = step_agreement(
        runs["card"][0], runs["cpu"][0], runs["card"][1], runs["cpu"][1],
        tcfg.learning_rate)
    print(f"12e one combiner step at batch {COMBINER_BATCH}, card vs CPU: "
          f"{summary}", flush=True)
    if bad:
        raise SystemExit(f"12e card vs CPU failed: {bad[:5]}")
    del runs

    # (2) two epochs with validation each epoch
    out_dir = os.path.join(root, "combiner_out")
    cfg = CombinerConfig(clip_feature_dim=512)
    model = Combiner(cfg, device="meta").to_empty(device=dev)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state, history = train_combiner(
            model, dataset, text_fn,
            CombinerTrainConfig(validation_frequency=1), out_dir,
            COMBINER_BATCH, num_epochs=COMBINER_EPOCHS)
    train_s = time.perf_counter() - t0
    losses = [v for r in history for v in r["step_losses"]]
    first4, last4 = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    print(f"12e train_combiner: {COMBINER_EPOCHS} epochs of "
          f"{COMBINER_TRIPLETS} triplets at batch {COMBINER_BATCH} in "
          f"{train_s:.1f} s with validation each epoch; epochs: "
          + "; ".join(json.dumps({k: v for k, v in r.items()
                                  if k != "step_losses"}) for r in history)
          + f"; mean of the first four step losses {first4:.4f}, of the "
          f"last four {last4:.4f}", flush=True)
    if not (all(np.isfinite(losses)) and last4 < first4):
        raise SystemExit("12e combiner training: losses not finite or not "
                         "falling")

    # (3) composed_validate on the card, from model_best
    best_path = os.path.join(out_dir, "model_best")
    best = ci.load_combiner(best_path, dev, require_config=True)
    t0 = time.perf_counter()
    order, report = validate(best, dataset, text_fn, 64)
    validate_s = time.perf_counter() - t0
    print(f"12e composed_validate of model_best on the card: "
          f"{json.dumps(report)} in {validate_s:.2f} s", flush=True)
    if (order.shape != (COMBINER_TRIPLETS, min(100, len(dataset.video_names)))
            or report["n_queries"] != COMBINER_TRIPLETS):
        raise SystemExit("12e composed_validate: wrong shape")

    # (4) model_best served by the route
    args = argparse.Namespace(**vars(vit_args))
    args.combiner_checkpoint = best_path
    refs = bserve.reference_videos(COMBINER_HTTP_CHECKS, seed=33)
    server, handler = bserve.start_composed_server(args, refs.__getitem__)
    try:
        _, index_high = ci.candidate_index(
            handler.clip_model, handler.clip_cfg.image_resolution,
            args.videos_dir, args.feature_cache)
        differ = composed_requests(handler, server.server_address[1],
                                   refs, COMBINER_HTTP_CHECKS, index_high)
    finally:
        bserve.stop_server(server, handler)
    print(f"12e model_best served over HTTP: {COMBINER_HTTP_CHECKS} answers, "
          f"{differ} differing from a direct rank_index", flush=True)
    if differ:
        raise SystemExit("12e model_best route answers differ")

    # (5) the step on the trained model by CUDA events
    step = make_combiner_train_step(model, torch.Generator(
        device=dev).manual_seed(1))
    batches = list(itertools.islice(dataset.batches(
        COMBINER_BATCH, shuffle=True, seed=9), COMBINER_TIMED_STEPS))
    spans = []
    for b in batches:
        feats = [torch.from_numpy(b[k]).to(dev) for k in (
            "ref_high", "ref_middle", "target_high", "target_middle")]
        text = text_fn(b["captions"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, tuple(feats[:2]), text, tuple(feats[2:]))
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    step_ms = float(np.median(spans[2:]))
    prof = bserve.device_kernels(lambda: step(state, tuple(feats[:2]), text,
                                              tuple(feats[2:])), 5)
    opt_ms = cuda_ms(state.optimizer.step, iters=5, warmup=1)
    print(f"12e combiner step at batch {COMBINER_BATCH} (Combiner only, "
          f"text encoded before): {step_ms:.3f} ms by CUDA events (median "
          f"of steps 3-{COMBINER_TIMED_STEPS}) = "
          f"{COMBINER_BATCH * 1e3 / step_ms:.1f} samples/s; kernels busy "
          f"{prof['busy_ms']:.3f} ms a step, the optimizer's step alone "
          f"{opt_ms:.3f} ms; longest kernels (ms a step): "
          f"{json.dumps(prof['top_kernels'])} on {card}", flush=True)
    return {"step_card_vs_cpu": step_line, "epochs": [
                {k: v for k, v in r.items() if k != "step_losses"}
                for r in history],
            "first4_loss": first4, "last4_loss": last4, "train_s": train_s,
            "validate": report, "validate_s": validate_s,
            "model_best_http_differing": differ, "step_ms": step_ms,
            "step_ms_all": spans, "step_busy_ms": prof["busy_ms"],
            "step_top_kernels": prof["top_kernels"], "optimizer_ms": opt_ms,
            "samples_per_s": COMBINER_BATCH * 1e3 / step_ms}


def check_composed(dev, card):
    """Step 12 (items a-f of the docstring).  Every failed check raises.
    Returns (the `composed` JSON object, the launches of the ViT-B/32
    route's requests by kernel)."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.models.clip import (
        flagship_config)
    from cross_modal_video_engine_tpu_torch.models.clip_resnet import (
        CLIPResNetConfig)
    from cross_modal_video_engine_tpu_torch.models.combiner import (
        CombinerConfig)
    from cross_modal_video_engine_tpu_torch.ops import (
        attention_sublayer as asl)

    t_step = time.perf_counter()
    line = {"card": card, "preprocess": composed_preprocess(dev)}
    refs = bserve.reference_videos(COMPOSED_REFS, seed=5)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        # (b), (c): RN50x4 + the conv4x4 Combiner at CombinerConfig()
        rn, _, rn_args, handler, server = composed_route(
            dev, card, os.path.join(tmp, "rn50x4"), refs, CLIPResNetConfig(),
            CombinerConfig(middle_mix="conv4x4"))
        try:
            line["rn50x4_tower"] = rn50x4_card_vs_cpu(
                handler.clip_model, rn_args.clip_checkpoint,
                refs[sorted(refs)[0]])
        finally:
            bserve.stop_server(server, handler)
        line["rn50x4_route"] = rn
        print(f"12c composed route, RN50x4 + conv4x4 Combiner, "
              f"{COMPOSED_VIDEOS} candidates: {COMPOSED_REQUESTS} requests "
              f"of a {bserve.REF_FRAMES}-frame {bserve.REF_HEIGHT}x"
              f"{bserve.REF_WIDTH} reference video over HTTP, batch-1 p50 "
              f"{rn['batch1_p50_ms']:.2f} ms, p99 {rn['batch1_p99_ms']:.2f} "
              f"ms; extraction {rn['extract_wall_ms']:.2f} ms host, "
              f"{rn['extract_events_ms']:.2f} ms device, kernels busy "
              f"{rn['extract_busy_ms']:.2f} ms, longest "
              f"{json.dumps(rn['extract_top_kernels'][:3])}; wave of 1 "
              f"{rn['wave1_wall_ms']:.3f} ms host, busy "
              f"{rn['wave1_busy_ms']:.3f} ms; {rn['answers_differing']} "
              f"answers differing from a direct rank; fixtures "
              f"{rn['fixtures_s']:.1f} s, route start "
              f"{rn['route_start_s']:.1f} s on {card}", flush=True)
        if rn["answers_differing"]:
            raise SystemExit("12c route answers differ from a direct rank")
        del handler, server
        torch.cuda.empty_cache()

        # (d): ViT-B/32 (fused) + CombinerConfig(clip_feature_dim=512)
        counted = (asl.fused_attention_sublayer_compact,
                   asl.fused_attention_sublayer, asl.fused_mlp_sublayer)
        vit, launches, vit_args, handler, server = composed_route(
            dev, card, os.path.join(tmp, "vit"), refs, flagship_config(),
            CombinerConfig(clip_feature_dim=512), counted)
        try:
            vit["arms_min_cosine"] = vit_arms_agree(
                handler, vit_args.clip_checkpoint, refs)
            vit["launches"] = launches
            print(f"12d composed route, ViT-B/32 (fused) + Combiner 512: "
                  f"batch-1 p50 {vit['batch1_p50_ms']:.2f} ms, extraction "
                  f"{vit['extract_events_ms']:.2f} ms device; launches over "
                  f"the {COMPOSED_REQUESTS} requests {json.dumps(launches)}; "
                  f"kernel arm vs plain arm combine_features min cosine "
                  f"{vit['arms_min_cosine']:.6f} (need >= {COSINE_MIN}); "
                  f"{vit['answers_differing']} answers differing from a "
                  f"direct rank", flush=True)
            if (vit["answers_differing"] or vit["arms_min_cosine"] < COSINE_MIN
                    or min(launches.values()) <= 0):
                raise SystemExit("12d ViT-B/32 composed route failed")
            line["vit_route"] = vit
            # (e): the combiner trainer
            line["training"] = composed_training(dev, card,
                                                 os.path.join(tmp, "vit"),
                                                 vit_args, handler)
        finally:
            bserve.stop_server(server, handler)
    line["seconds"] = time.perf_counter() - t_step
    print(f"12 composed retrieval checked in {line['seconds']:.1f} s",
          flush=True)
    return line, launches


# caption route step: videos (300 frames of 360x480, drawn on demand),
# batch-1 requests, one burst of concurrent ones, timed waves
CAPTION_VIDEOS, CAPTION_REQUESTS, CAPTION_BURST = 8, 8, 8
CAPTION_WAVE_CALLS, CAPTION_PIPELINE_CALLS = 5, 8
# the joint checkpoint's decoder output layer is scaled so that its step-0
# probabilities spread away from the threshold; at most this share of the
# step-0 labels may lie within the bf16 tolerance of it, unchecked
CAPTION_LOGIT_SCALE, CAPTION_BAND_SHARE = 16.0, 0.1


def caption_direct(handler, name):
    """The route's model on the route's clips of one video, called
    directly: (clips, steps, probs (max_len, C) on the host)."""
    import torch
    from cross_modal_video_engine_tpu_torch.api import caption_clips
    clips = np.asarray(handler.pipeline({"filename": name, "start_index": 0})
                       ["imgs"], np.float32)
    steps, probs = caption_clips(handler.model, torch.from_numpy(clips).to(
        next(handler.model.parameters()).device))
    return clips, steps[0], probs[0].float().cpu().numpy()


def caption_agreement(answers, direct, threshold: float = 0.5,
                      band: float = TOL["bfloat16"]) -> dict:
    """HTTP answers against the direct call on the same clips: step-0
    labels must agree wherever the direct probability lies farther than
    `band` (the bf16 tolerance) from the threshold (a label inside it may
    flip with the wave's shapes: counted, and the caller bounds the
    count); later steps follow greedy
    feedback, so their flips are counted, not checked."""
    band, step0_off, later, identical = 0, 0, 0, 0
    for name, steps in answers:
        _, want, probs = direct[name]
        identical += steps == want
        near = np.abs(probs[0] - threshold) <= band
        band += int(near.sum())
        got0 = np.zeros(probs.shape[1], bool)
        got0[steps[0]] = True
        step0_off += int(((got0 != (probs[0] > threshold)) & ~near).sum())
        later += sum(len(set(a) ^ set(b)) for a, b in zip(steps[1:],
                                                          want[1:]))
    return {"answers": len(answers), "identical": identical,
            "step0_disagree": step0_off, "step0_in_band": band,
            "step0_labels": len(answers) * len(direct[answers[0][0]][2][0]),
            "later_flips": later}


def check_caption_route(dev, card) -> Tuple[dict, dict]:
    """Step 13: the /caption route at full width (TS_JOINT, flash on, bf16,
    the shipped decoder) from a checkpoint written in the JAX format,
    videos through the `decode` seam; then the shipped divided config
    served once.  Every failed check raises.  Returns (the `caption` JSON
    object, the launches of the joint route's requests by kernel)."""
    import argparse
    import torch
    from cross_modal_video_engine_tpu_torch.api import (
        TEST_PIPELINE, inference_recognizer, run_pipeline)
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.data.pipelines import with_reader
    from cross_modal_video_engine_tpu_torch.ops import (
        attention_sublayer as asl, flash_attention as fa)

    counted = (asl.fused_attention_sublayer_compact,
               asl.fused_attention_sublayer, asl.fused_mlp_sublayer,
               asl.fused_block_sublayer_compact, fa.flash_attention)
    t_step = time.perf_counter()
    model_cfg = relseq_model()
    decoder = model_cfg["decoder"]
    layers = TS_JOINT["num_layers"]
    videos = bserve.seeded_videos(CAPTION_VIDEOS, seed=7)
    names = sorted(videos)
    line = {"card": card, "backbone": "TS_JOINT", "decoder": decoder,
            "videos": CAPTION_VIDEOS, "video_frames": bserve.VIDEO_FRAMES,
            "video_size": [bserve.VIDEO_HEIGHT, bserve.VIDEO_WIDTH]}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        args = argparse.Namespace(
            caption_checkpoint=os.path.join(tmp, "joint"), device=str(dev))
        t0 = time.perf_counter()
        bserve.write_caption_checkpoint(args.caption_checkpoint, TS_JOINT,
                                        decoder, seed=4,
                                        logit_scale=CAPTION_LOGIT_SCALE)
        line["checkpoint_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        server, handler = bserve.start_caption_server(args,
                                                      videos.__getitem__)
        torch.cuda.synchronize()
        line["route_start_s"] = time.perf_counter() - t0
        try:
            port = server.server_address[1]
            bserve.post_caption(port, {"video": names[0]})      # warm-up
            torch.cuda.synchronize()
            # (a) batch-1 requests, the counters zeroed just before
            for fn in counted:
                fn.launches = 0
            w0 = handler.batcher.batches_run
            single = [bserve.request(port, "caption",
                                     {"video": names[i % len(names)]},
                                     timeout=600.0)
                      for i in range(CAPTION_REQUESTS)]
            torch.cuda.synchronize()
            waves1 = handler.batcher.batches_run - w0
            launches = {fn.__name__: fn.launches for fn in counted}
            # (b) one burst of concurrent requests
            for fn in counted:
                fn.launches = 0
            w0, r0 = handler.batcher.batches_run, handler.batcher.rows_run
            burst = bserve.clients_in_threads(
                port, [{"video": names[i % len(names)]}
                       for i in range(CAPTION_BURST)], CAPTION_BURST,
                lambda port, p: bserve.request(port, "caption", p,
                                               timeout=600.0))
            torch.cuda.synchronize()
            waves8 = handler.batcher.batches_run - w0
            burst_launches = {fn.__name__: fn.launches for fn in counted}
            line.update(
                batch1_ms=bserve.percentiles([ms for ms, _ in single]),
                burst_ms=bserve.percentiles([ms for ms, _ in burst]),
                batch1_waves=waves1, burst_waves=waves8,
                burst_rows_per_wave=(handler.batcher.rows_run - r0) / waves8,
                launches=launches, burst_launches=burst_launches)
            print(f"13 caption route (TimeSformer ViT-B/16 joint bf16, flash "
                  f"on, {decoder['num_classes']} classes x "
                  f"{decoder['max_len']} steps; checkpoint written in "
                  f"{line['checkpoint_write_s']:.1f} s, route up in "
                  f"{line['route_start_s']:.1f} s): {CAPTION_REQUESTS} "
                  f"batch-1 requests of {bserve.VIDEO_FRAMES}-frame "
                  f"{bserve.VIDEO_HEIGHT}x{bserve.VIDEO_WIDTH} videos, p50 "
                  f"{line['batch1_ms']['p50']:.2f} ms, p99 "
                  f"{line['batch1_ms']['p99']:.2f} ms in {waves1} waves; "
                  f"burst of {CAPTION_BURST} (conc-{CAPTION_BURST}) p50 "
                  f"{line['burst_ms']['p50']:.2f} ms, p99 "
                  f"{line['burst_ms']['p99']:.2f} ms in {waves8} waves "
                  f"({line['burst_rows_per_wave']:.2f} rows a wave) on "
                  f"{card}; launches {json.dumps(launches)} then "
                  f"{json.dumps(burst_launches)} (need {layers} flash a "
                  f"wave, no other kernel)", flush=True)
            others = [k for k, v in {**launches, **burst_launches}.items()
                      if v and k != "flash_attention"]
            if (waves1 != CAPTION_REQUESTS or others
                    or launches["flash_attention"] != layers * waves1
                    or burst_launches["flash_attention"] != layers * waves8):
                raise SystemExit("13 caption route launches are wrong")

            # (c) answers against the route's model called directly
            direct = {n: caption_direct(handler, n) for n in names}
            asked = ([names[i % len(names)] for i in range(CAPTION_REQUESTS)]
                     + [names[i % len(names)] for i in range(CAPTION_BURST)])
            agree = caption_agreement(
                [(n, a["steps"]) for n, (_, a) in zip(asked, single + burst)],
                direct)
            line["agreement"] = agree
            # (d) the pipeline's clips and inference_recognizer's outputs
            api_pipe = with_reader(TEST_PIPELINE, videos.__getitem__)
            clips_equal, worst = 0, 0.0
            for n in names:
                clips, _, probs = direct[n]
                clips_equal += np.array_equal(run_pipeline(api_pipe, n),
                                              clips)
                scores, _ = inference_recognizer(handler.model, n,
                                                 pipeline=api_pipe)
                worst = max(worst, float(np.abs(scores[0] - probs).max()))
            line.update(pipeline_clips_equal=clips_equal,
                        inference_recognizer_max_abs=worst)
            band_limit = int(CAPTION_BAND_SHARE * agree["step0_labels"])
            print(f"13 answers vs caption_clips on the route's model and "
                  f"clips: {json.dumps(agree)} (step-0 labels within "
                  f"{TOL['bfloat16']:g} of the threshold may flip: "
                  f"{agree['step0_in_band']} of {agree['step0_labels']}, "
                  f"limit {band_limit}, output layer x"
                  f"{CAPTION_LOGIT_SCALE:g}); the "
                  f"route's pipeline equals inference_recognizer's "
                  f"(TEST_PIPELINE) on {clips_equal}/{len(names)} videos, "
                  f"its probabilities vs caption_clips max |difference| "
                  f"{worst:.3e}; video 0's steps "
                  f"{single[0][1]['steps']}", flush=True)
            if (agree["step0_disagree"] or clips_equal != len(names)
                    or agree["step0_in_band"] > band_limit
                    or worst > TOL["bfloat16"]):
                raise SystemExit("13 caption answers disagree with the "
                                 "direct call")

            # (e) the host pipeline, op by op, beside the waves
            line["pipeline"] = bserve.pipeline_times(handler, names,
                                                     CAPTION_PIPELINE_CALLS)
            for n in (1, CAPTION_BURST):
                t = bserve.wave_times(handler, bserve.caption_wave_rows(
                    handler, names, n), CAPTION_WAVE_CALLS, device=dev)
                line[f"wave{n}"] = t
                print(f"13 wave of {n}: wall {t['wall_ms']:.3f} ms, CUDA "
                      f"events {t['events_ms']:.3f} ms, kernels busy "
                      f"{t['busy_ms']:.3f} ms, idle share "
                      f"{t['idle_share']:.3f}; host pipeline "
                      f"{line['pipeline']['wall_ms']:.2f} ms a request, by "
                      f"op {json.dumps(line['pipeline']['ops_ms'])} "
                      f"(DecordDecode: the frame draw) on "
                      f"{card}; longest kernels (ms a wave): "
                      f"{json.dumps(t['top_kernels'])}", flush=True)
        finally:
            bserve.stop_server(server, handler)
        del handler, server
        torch.cuda.empty_cache()

        # (f) the shipped divided config, served once: no kernel
        div = argparse.Namespace(
            caption_checkpoint=os.path.join(tmp, "divided"), device=str(dev))
        bserve.write_caption_checkpoint(
            div.caption_checkpoint,
            {**model_cfg["backbone"], "dtype": "bfloat16"}, decoder, seed=5)
        server, handler = bserve.start_caption_server(div, videos.__getitem__)
        try:
            port = server.server_address[1]
            for fn in counted:
                fn.launches = 0
            ms, ans = bserve.request(port, "caption", {"video": names[0]},
                                     timeout=600.0)
            torch.cuda.synchronize()
            div_launches = sum(fn.launches for fn in counted)
        finally:
            bserve.stop_server(server, handler)
        line["divided"] = {"first_request_ms": ms, "launches": div_launches,
                           "steps": ans["steps"]}
        print(f"13 the shipped divided config (timesformer_relseq.py, bf16) "
              f"served once: {ms:.1f} ms (first request), kernel launches "
              f"{div_launches} (need 0), steps {ans['steps']}", flush=True)
        if div_launches or len(ans["steps"]) != decoder["max_len"]:
            raise SystemExit("13 the divided caption config failed")
    line["seconds"] = time.perf_counter() - t_step
    print(f"13 caption route checked in {line['seconds']:.1f} s", flush=True)
    return line, launches


# explain route step: the caption step's backbone with a 400-class head,
# seeded concept banks, batch-1 requests, a burst, timed waves
EXPLAIN_REQUESTS, EXPLAIN_BURST, EXPLAIN_CPU_VIDEOS = 8, 8, 1
EXPLAIN_WAVE_CALLS, EXPLAIN_PHASE_CALLS = 5, 3
# (a-c) route answers against a direct grad_extract + concept_scores on the
# card: the predicted class equal and the probes' cosine at least
# EXPLAIN_PROBE_COS wherever the direct top-2 class-score margin clears
# EXPLAIN_MARGIN (in bf16 a wave of another size may flip a near-tie:
# counted); a top-k position's concept equal wherever the direct concept
# scores around it are more than EXPLAIN_MARGIN apart, and every score
# within EXPLAIN_MARGIN of the direct one
EXPLAIN_PROBE_COS, EXPLAIN_MARGIN = 0.999, 3e-2
# (d) the card against the port on the CPU (bf16 on both, other
# summation orders): probes by cosine, predictions beyond the margin
EXPLAIN_CPU_COS = 0.99
# (e) the flash backward at the route's waves of 1 and 8 rows, bf16
EXPLAIN_FLASH_BWD = ((1, 12, 1569, 64), (8, 12, 1569, 64))


def explain_direct(handler, name, banks) -> dict:
    """The route's model on the route's clips of one video, called
    directly on its device: clips, clip 0's class scores and prediction,
    the probe and every level's concept scores (host numpy)."""
    import torch
    from cross_modal_video_engine_tpu_torch.explain.ctv import concept_scores
    from cross_modal_video_engine_tpu_torch.explain.grads import (
        grad_extract, normalized_cls_grad)
    clips = np.asarray(handler.pipeline({"filename": name, "start_index": 0})
                       ["imgs"], np.float32)
    layer = handler.target_layer
    g = grad_extract(handler.model, torch.from_numpy(clips).to(
        next(handler.model.parameters()).device), [layer])
    probe = normalized_cls_grad(g["gradients"][layer])
    return {"clips": clips, "pred": int(g["pred"][0]), "scores": g["scores"],
            "probe": probe,
            "concepts": {level: concept_scores(m, probe)
                         for level, (m, _) in banks.items()}}


def top2_margin(scores: np.ndarray) -> float:
    top = np.sort(scores)[-2:]
    return float(top[1] - top[0])


def explain_agreement(answers, direct, banks, recorded) -> dict:
    """HTTP answers (name, answer) and the route's own wave results
    (recorded (row, result) pairs, matched to a video by its clips)
    against the direct calls; see the bounds above.  Returns the counts
    and worst values; raises nothing."""
    out = {"answers": len(answers), "near_ties": 0, "pred_disagree": 0,
           "topk_checked": 0, "topk_disagree": 0, "score_err": 0.0,
           "class_score_err": 0.0, "probe_cos_min": 1.0, "waves_rows": 0}
    for name, ans in answers:
        d = direct[name]
        margin = top2_margin(d["scores"][0])
        out["class_score_err"] = max(out["class_score_err"], float(np.abs(
            np.asarray(ans["scores"]) - d["scores"][0]).max()))
        if margin <= EXPLAIN_MARGIN:
            out["near_ties"] += 1
            continue
        out["pred_disagree"] += ans["prediction"] != d["pred"]
        for level, (_, names) in banks.items():
            s = d["concepts"][level]
            order = np.argsort(-s)
            ranked = s[order]
            for i, item in enumerate(ans[f"{level}_top"]):
                out["score_err"] = max(out["score_err"], abs(
                    item["score"] - float(s[names.index(item["concept"])])))
                gaps = [ranked[i - 1] - ranked[i]] if i else []
                if i + 1 < len(ranked):
                    gaps.append(ranked[i] - ranked[i + 1])
                if min(gaps) > EXPLAIN_MARGIN:
                    out["topk_checked"] += 1
                    out["topk_disagree"] += item["concept"] != names[order[i]]
    for row, res in recorded:
        name = next(n for n, d in direct.items()
                    if np.array_equal(d["clips"], row))
        d = direct[name]
        out["waves_rows"] += 1
        if top2_margin(d["scores"][0]) > EXPLAIN_MARGIN:
            p, q = res["grad_probe"], d["probe"]
            out["probe_cos_min"] = min(out["probe_cos_min"], float(
                p @ q / (np.linalg.norm(p) * np.linalg.norm(q))))
    return out


def explain_flash_backward(dev) -> list:
    """The flash wrapper's backward in bf16 at the route's shapes: the
    forward launches the kernel once, the backward recomputes the plain
    version; gradients finite and against the plain version's own
    autograd, with the backward's time and peak memory."""
    import torch
    from cross_modal_video_engine_tpu_torch.ops import flash_attention as fa
    rows = []
    for i, (b, h, s, d) in enumerate(EXPLAIN_FLASH_BWD):
        gen = torch.Generator(device=dev).manual_seed(3000 + i)
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   .to(torch.bfloat16).requires_grad_() for _ in range(3))
        scale = d ** -0.5
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = fa.flash_attention.launches
        out = fa.flash_attention(q, k, v, scale)
        g = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = torch.autograd.grad(out, (q, k, v), g)
        end.record()
        end.synchronize()
        launches = fa.flash_attention.launches - before
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        want = torch.autograd.grad(
            fa._reference_attention(q, k, v, scale, False), (q, k, v), g)
        err = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        ok = finite and launches == 1 and err <= TOL["bfloat16"]
        rows.append({"shape": [b, h, s, d], "launches": launches,
                     "max_abs_err": err, "finite": finite,
                     "backward_ms": start.elapsed_time(end),
                     "peak_mb": peak})
        print(f"14 flash backward bf16 (B,H,S,D)={(b, h, s, d)}: "
              f"{launches} launch, gradients finite {finite}, against the "
              f"plain version's autograd max |err| {err:.3e} (tol "
              f"{TOL['bfloat16']:g}), backward {rows[-1]['backward_ms']:.3f}"
              f" ms, peak {peak:.0f} MiB {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit("14 the flash backward failed")
        del q, k, v, out, g, got, want
    return rows


def check_explain_route(dev, card) -> Tuple[dict, dict]:
    """Step 14: the /explain route at full width (TS_JOINT, flash on,
    bf16, 400 classes) from a checkpoint written in the JAX format, seeded
    concept banks, videos through the `decode` seam.  Every failed check
    raises.  Returns (the `explain` JSON object, the launches of the
    batch-1 requests by kernel)."""
    import argparse
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli.explain_demo import (
        load_explain_model)
    from cross_modal_video_engine_tpu_torch.explain.grads import (
        grad_extract, normalized_cls_grad)
    from cross_modal_video_engine_tpu_torch.explain.model_layers import (
        get_model_layers)
    from cross_modal_video_engine_tpu_torch.ops import (
        attention_sublayer as asl, flash_attention as fa)

    counted = (asl.fused_attention_sublayer_compact,
               asl.fused_attention_sublayer, asl.fused_mlp_sublayer,
               asl.fused_block_sublayer_compact, fa.flash_attention)
    t_step = time.perf_counter()
    layers = TS_JOINT["num_layers"]
    layer = get_model_layers("timesformer", layers)["target"]
    per_wave = layers + (layers - 1 - layer)
    videos = bserve.seeded_videos(CAPTION_VIDEOS, seed=9)
    names = sorted(videos)
    line = {"card": card, "backbone": "TS_JOINT",
            "classes": bserve.EXPLAIN_CLASSES, "target_layer": layer,
            "videos": CAPTION_VIDEOS, "video_frames": bserve.VIDEO_FRAMES,
            "video_size": [bserve.VIDEO_HEIGHT, bserve.VIDEO_WIDTH]}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)

    def zero():
        for fn in counted:
            fn.launches = 0

    def read():
        return {fn.__name__: fn.launches for fn in counted}

    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        args = argparse.Namespace(
            explain_checkpoint=os.path.join(tmp, "explain"),
            concept_banks=os.path.join(tmp, "banks.npz"),
            target_layer=layer, device=str(dev))
        t0 = time.perf_counter()
        bserve.write_explain_checkpoint(args.explain_checkpoint, TS_JOINT,
                                        seed=6)
        banks = bserve.write_concept_banks(args.concept_banks,
                                           TS_JOINT["embed_dims"], seed=8)
        line["checkpoint_write_s"] = time.perf_counter() - t0
        line["banks"] = {lvl: list(m.shape) for lvl, (m, _) in banks.items()}
        t0 = time.perf_counter()
        server, handler = bserve.start_route_server(
            args, "explain", explain_decode=videos.__getitem__)
        torch.cuda.synchronize()
        line["route_start_s"] = time.perf_counter() - t0
        recorded = []
        wave_fn = handler.batcher.fn

        def recording(rows):
            outs = wave_fn(rows)
            recorded.extend(zip(rows, outs))
            return outs

        try:
            port = server.server_address[1]
            bserve.post_explain(port, {"video": names[0]})      # warm-up
            torch.cuda.synchronize()
            handler.batcher.fn = recording
            # (a) batch-1 requests, the counters zeroed just before
            zero()
            w0 = handler.batcher.batches_run
            single = [bserve.request(port, "explain",
                                     {"video": names[i % len(names)]},
                                     timeout=600.0)
                      for i in range(EXPLAIN_REQUESTS)]
            torch.cuda.synchronize()
            waves1 = handler.batcher.batches_run - w0
            launches = read()
            # (b) one burst of concurrent requests
            zero()
            w0, r0 = handler.batcher.batches_run, handler.batcher.rows_run
            burst = bserve.clients_in_threads(
                port, [{"video": names[i % len(names)]}
                       for i in range(EXPLAIN_BURST)], EXPLAIN_BURST,
                lambda port, p: bserve.request(port, "explain", p,
                                               timeout=600.0))
            torch.cuda.synchronize()
            waves8 = handler.batcher.batches_run - w0
            burst_launches = read()
            handler.batcher.fn = wave_fn
            line.update(
                batch1_ms=bserve.percentiles([ms for ms, _ in single]),
                burst_ms=bserve.percentiles([ms for ms, _ in burst]),
                batch1_waves=waves1, burst_waves=waves8,
                burst_rows_per_wave=(handler.batcher.rows_run - r0) / waves8,
                launches=launches, burst_launches=burst_launches)
            print(f"14 explain route (TimeSformer ViT-B/16 joint bf16, "
                  f"flash on, {bserve.EXPLAIN_CLASSES} classes, probe at "
                  f"block {layer}, banks {json.dumps(line['banks'])}; "
                  f"checkpoint written in {line['checkpoint_write_s']:.1f} "
                  f"s, route up in {line['route_start_s']:.1f} s): "
                  f"{EXPLAIN_REQUESTS} batch-1 requests of "
                  f"{bserve.VIDEO_FRAMES}-frame {bserve.VIDEO_HEIGHT}x"
                  f"{bserve.VIDEO_WIDTH} videos, p50 "
                  f"{line['batch1_ms']['p50']:.2f} ms, p99 "
                  f"{line['batch1_ms']['p99']:.2f} ms in {waves1} waves; "
                  f"burst of {EXPLAIN_BURST} p50 "
                  f"{line['burst_ms']['p50']:.2f} ms, p99 "
                  f"{line['burst_ms']['p99']:.2f} ms in {waves8} waves "
                  f"({line['burst_rows_per_wave']:.2f} rows a wave) on "
                  f"{card}; launches {json.dumps(launches)} then "
                  f"{json.dumps(burst_launches)} (need {per_wave} flash a "
                  f"wave, no other kernel)", flush=True)
            others = [k for k, v in {**launches, **burst_launches}.items()
                      if v and k != "flash_attention"]
            if (waves1 != EXPLAIN_REQUESTS or others
                    or launches["flash_attention"] != per_wave * waves1
                    or burst_launches["flash_attention"]
                    != per_wave * waves8):
                raise SystemExit("14 explain route launches are wrong")

            # (c) answers against the route's model called directly
            direct = {n: explain_direct(handler, n, banks) for n in names}
            asked = ([names[i % len(names)] for i in range(EXPLAIN_REQUESTS)]
                     + [names[i % len(names)] for i in range(EXPLAIN_BURST)])
            agree = explain_agreement(
                [(n, a) for n, (_, a) in zip(asked, single + burst)],
                direct, banks, recorded)
            line["agreement"] = agree
            print(f"14 answers vs grad_extract + concept_scores on the "
                  f"route's model and clips: {json.dumps(agree)} (bounds: "
                  f"prediction equal and probe cosine >= "
                  f"{EXPLAIN_PROBE_COS:g} where the top-2 margin clears "
                  f"{EXPLAIN_MARGIN:g}, top-k equal where the gaps clear "
                  f"it, scores within it); video 0's answer: prediction "
                  f"{single[0][1]['prediction']}, symbolic top "
                  f"{json.dumps(single[0][1]['symbolic_top'][:3])}",
                  flush=True)
            if (agree["pred_disagree"] or agree["topk_disagree"]
                    or agree["probe_cos_min"] < EXPLAIN_PROBE_COS
                    or agree["score_err"] > EXPLAIN_MARGIN
                    or agree["waves_rows"] != EXPLAIN_REQUESTS + EXPLAIN_BURST
                    or agree["near_ties"] == agree["answers"]):
                raise SystemExit("14 explain answers disagree with the "
                                 "direct call")

            # (d) the card against the port on the CPU, EXPLAIN_CPU_VIDEOS
            t0 = time.perf_counter()
            cpu_model, _ = load_explain_model(args.explain_checkpoint,
                                              device="cpu")
            cpu = []
            for n in names[:EXPLAIN_CPU_VIDEOS]:
                d = direct[n]
                g = grad_extract(cpu_model, torch.from_numpy(d["clips"]),
                                 [layer])
                p = normalized_cls_grad(g["gradients"][layer])
                margin = top2_margin(g["scores"][0])
                cpu.append({
                    "probe_cos": float(p @ d["probe"] / (
                        np.linalg.norm(p) * np.linalg.norm(d["probe"]))),
                    "class_score_err": float(np.abs(
                        g["scores"][0] - d["scores"][0]).max()),
                    "margin": margin, "pred_cpu": int(g["pred"][0]),
                    "pred_card": d["pred"]})
            del cpu_model
            line["card_vs_cpu"] = cpu
            line["card_vs_cpu_s"] = time.perf_counter() - t0
            print(f"14 card vs the port on the CPU (bf16 both, "
                  f"{EXPLAIN_CPU_VIDEOS} videos, "
                  f"{line['card_vs_cpu_s']:.1f} s): {json.dumps(cpu)} "
                  f"(probe cosine >= {EXPLAIN_CPU_COS:g}, prediction equal "
                  f"where the margin clears {EXPLAIN_MARGIN:g})", flush=True)
            if any(c["probe_cos"] < EXPLAIN_CPU_COS
                   or (c["margin"] > EXPLAIN_MARGIN
                       and c["pred_cpu"] != c["pred_card"]) for c in cpu):
                raise SystemExit("14 card and CPU disagree")

            # (e) the flash backward at the route's shapes
            line["flash_backward"] = explain_flash_backward(dev)

            # (f) one request at block 0: the un-batched path
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            zero()
            ms, ans0 = bserve.request(port, "explain", {"video": names[0],
                                                        "target_layer": 0},
                                      timeout=600.0)
            torch.cuda.synchronize()
            layer0 = {"ms": ms, "launches": read(),
                      "peak_mb": torch.cuda.max_memory_allocated(dev)
                      / 2 ** 20, "prediction": ans0["prediction"]}
            line["layer0"] = layer0
            need0 = layers + layers - 1
            print(f"14 one request at target_layer 0 (un-batched): "
                  f"{ms:.1f} ms, launches {json.dumps(layer0['launches'])} "
                  f"(need {need0} flash), peak memory "
                  f"{layer0['peak_mb']:.0f} MiB, prediction "
                  f"{ans0['prediction']} (batch-1: "
                  f"{single[0][1]['prediction']})", flush=True)
            if (layer0["launches"]["flash_attention"] != need0
                    or sum(layer0["launches"].values()) != need0
                    or ans0["prediction"] != single[0][1]["prediction"]
                    or not np.isfinite(ans0["scores"]).all()):
                raise SystemExit("14 the target_layer 0 request failed")

            # (g) the handler without HTTP, the host pipeline and the
            # waves, timed
            direct_ms = []
            for n in names:
                t0 = time.perf_counter()
                handler({"video": n})
                direct_ms.append((time.perf_counter() - t0) * 1e3)
            line["handler_ms"] = bserve.percentiles(direct_ms)
            line["pipeline"] = bserve.pipeline_times(handler, names,
                                                     CAPTION_PIPELINE_CALLS)
            print(f"14 the handler called without HTTP: p50 "
                  f"{line['handler_ms']['p50']:.2f} ms, p99 "
                  f"{line['handler_ms']['p99']:.2f} ms over {len(names)} "
                  f"requests; the host pipeline "
                  f"{line['pipeline']['wall_ms']:.2f} ms a request, by op "
                  f"{json.dumps(line['pipeline']['ops_ms'])}", flush=True)
            for n in (1, EXPLAIN_BURST):
                rows = bserve.caption_wave_rows(handler, names, n)
                t = bserve.wave_times(handler, rows, EXPLAIN_WAVE_CALLS,
                                      device=dev)
                t.update(bserve.explain_phase_times(
                    handler, rows, EXPLAIN_PHASE_CALLS, dev))
                line[f"wave{n}"] = t
                print(f"14 wave of {n}: wall {t['wall_ms']:.3f} ms, CUDA "
                      f"events {t['events_ms']:.3f} ms, kernels busy "
                      f"{t['busy_ms']:.3f} ms, idle share "
                      f"{t['idle_share']:.3f}; capture forward "
                      f"{t['capture_ms']:.3f} ms, gradient pass "
                      f"{t['grad_ms']:.3f} ms (CUDA events), flash "
                      f"{t['flash_launches']} launches, peak "
                      f"{t['peak_mb']:.0f} MiB on {card}; longest kernels "
                      f"(ms a wave): "
                      f"{json.dumps(t['top_kernels'])}", flush=True)
                if t["flash_launches"] != per_wave:
                    raise SystemExit("14 a timed wave's launches are wrong")
        finally:
            handler.batcher.fn = wave_fn
            bserve.stop_server(server, handler)
        del handler, server
        torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t_step
    print(f"14 explain route checked in {line['seconds']:.1f} s", flush=True)
    return line, launches


# -- step 15: TimeSformer training at full width ------------------------------
# the recognition config the /explain route's checkpoints come from
RECOGNITION_CONFIG = (ROOT / "configs" / "recognition"
                      / "timesformer_divst_8x32_k400.py")
# a seeded collection: TRAIN15_VIDEOS videos to train on, the first
# TRAIN15_VAL of them to validate on; batch 8 as the configs say; the
# card-vs-CPU steps at TRAIN15_CPU_BATCH (the CPU's time); 8 videos (a
# step an epoch, as the CLIs of steps 18-20) for the script's time
TRAIN15_VIDEOS, TRAIN15_VAL, TRAIN15_BATCH, TRAIN15_CPU_BATCH = 8, 8, 8, 1
# the seeded videos of the training CLIs (steps 15, 18-20): 256x341 frames,
# the short side the recipes' Resize((-1, 256)) asks for, as video sets
# pre-scaled to a 256 short side hold them (the routes of steps 13, 14 and
# 16 decode 360x480 ones and resize them).  Step 21 keeps 360x480: on
# 256x341 frames 21a's fine-bucket step from the training init failed 18b's
# BatchNorm group bound (the card's fast-path layer4 gradients 3% from
# float64, the CPU's 4e-6)
TRAIN_VIDEO_HW = dict(height=256, width=341)
# (a) one f32 caption step, card vs CPU, dropouts 0: step 11a's bounds
# (the loss, each gradient tensor, the parameters after the SGD step); the
# clip engaged by a max_norm below the gradient's norm
TRAIN15_CLIP = 1e-3
# (b) the repeat-the-same-batch run: AdamW at lr 1e-4, clip 1.0, REPEAT
# steps on one batch, the last loss below the first; (b) resumed epoch 1
# vs the uninterrupted one, both on the card: step 11d's bounds on the
# loss and the epoch-1 parameters, seq_mAP within RESUME_LOSS_RTOL too
TRAIN15_REPEAT = 4
# (c) the joint flash variant in f32: per-tensor gradient cosine to the
# plain arm >= COSINE_MIN, with remat too; flash launches a step
TRAIN15_FLASH_STEPS = 3
# (d) one bf16=True recognition step, card vs CPU (the recipe says
# float32, so the step computes in f32 on the bf16-rounded masters and
# videos, as JAX's does; other summation orders): the loss within
# BF16_LOSS_REL, each gradient's cosine >= BF16_GRAD_COS (the CPU tests'
# bounds against JAX)
BF16_LOSS_REL, BF16_GRAD_COS = 2e-2, 0.99
TRAIN15D_LAYERS = 4
# (e) steps timed by CUDA events (median of steps 3..), the loop profiled
# over 1 step
TRAIN15_TIMED, TRAIN15_PROFILED = 4, 1
# the bench rows' timed steps in 15e and 18b (the rows' defaults 10 and 8)
BENCH_ROW_STEPS = 3


def shipped_training_config(path, **options):
    """A shipped config as its file says, with `options` set (dotted
    keys)."""
    from cross_modal_video_engine_tpu_torch.config import Config
    cfg = Config.fromfile(str(path))
    for key, value in options.items():
        cfg.set(key, value)
    return cfg


def write_training_split(root: str, names, kind: str, seed: int):
    """A seeded split file over `names`: label sequences of 1-3 steps of
    1-2 relations among 35 (the 36th is the end token) for 'relseq',
    classes 0-399 for 'cls'."""
    rng = np.random.default_rng(seed)
    lines = []
    for n in names:
        if kind == "relseq":
            steps = ["," .join(str(int(c)) for c in rng.choice(
                35, int(rng.integers(1, 3)), replace=False))
                for _ in range(int(rng.integers(1, 4)))]
            lines.append(f"{n} {'->'.join(steps)}")
        else:
            lines.append(f"{n} {int(rng.integers(0, 400))}")
    path = os.path.join(root, f"{kind}_{len(names)}.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _grads_of(model) -> dict:
    """Per parameter: its gradient on the host (zeros where it has
    none)."""
    import torch
    return {n: (p.grad.detach().float().cpu() if p.grad is not None
                else torch.zeros(p.shape))
            for n, p in model.named_parameters()}


def grad_cosines(a: dict, b: dict) -> dict:
    """Per parameter: the cosine of a's gradient to b's (1 where both are
    zero)."""
    import torch
    out = {}
    for n in b:
        x, y = a[n].flatten().double(), b[n].flatten().double()
        nx, ny = float(x.norm()), float(y.norm())
        out[n] = 1.0 if nx == ny == 0 else float(x @ y / (nx * ny + 1e-300))
    return out


def caption_step_card_vs_cpu(dev, cfg, names, pipe, targets) -> dict:
    """15a: one f32 step of the shipped caption config (dropouts 0) on the
    card and on the CPU from one init and one batch, the clip engaged."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli.caption_train import (
        build_caption_model)
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_rec_optimizer,
        make_seq_train_step)
    clips = np.stack([pipe({"filename": n, "start_index": 0})["imgs"][0]
                      for n in names[:TRAIN15_CPU_BATCH]]).astype(np.float32)
    tg = [a[:TRAIN15_CPU_BATCH] for a in targets]
    tcfg = RecognitionTrainConfig(**dict(cfg.get("optimizer", {}),
                                         grad_clip=TRAIN15_CLIP))
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model, _, _ = build_caption_model(cfg, d)
        state = init_rec_state(model, make_rec_optimizer(tcfg, 10))
        step = make_seq_train_step(model, device=d)
        t0 = time.perf_counter()
        state, logs = step(state, torch.from_numpy(clips).to(d),
                           torch.from_numpy(tg[0]).to(d),
                           torch.from_numpy(tg[1]).to(d))
        loss = float(logs["loss"])
        norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                    for p in model.parameters())))
        runs[name] = (model, loss, time.perf_counter() - t0, norm)
    (card, card_loss, card_s, card_norm) = runs["card"]
    (cpu, cpu_loss, cpu_s, cpu_norm) = runs["cpu"]
    line, bad, summary = step_agreement(card, cpu, card_loss, cpu_loss,
                                        tcfg.learning_rate)
    line.update(grad_norm_card=card_norm, grad_norm_cpu=cpu_norm,
                clip=TRAIN15_CLIP, card_s=card_s, cpu_s=cpu_s)
    print(f"15a one f32 caption step (timesformer_relseq.py, divided "
          f"ViT-B/16, dropouts 0) at batch {TRAIN15_CPU_BATCH}, card vs CPU: "
          f"{summary}; gradient norm {card_norm:.4f} / {cpu_norm:.4f} above "
          f"the clip {TRAIN15_CLIP} (engaged); {card_s:.2f} s on the card "
          f"(first), {cpu_s:.2f} s on the CPU", flush=True)
    if min(card_norm, cpu_norm) <= TRAIN15_CLIP:
        bad.append("clip not engaged")
    if bad:
        raise SystemExit(f"15a card vs CPU failed: {bad[:5]}")
    return line


def _epoch_params(path: str) -> dict:
    """The parameters of an epoch state a trainer wrote (flat name ->
    tensor)."""
    from cross_modal_video_engine_tpu_torch.io import flax_msgpack

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}/")
            else:
                yield f"{pre}{k}", v

    with open(os.path.join(path, "train_state.msgpack"), "rb") as f:
        tree = flax_msgpack.restore(f.read())
    return dict(flat(tree["state"]["params"]))


def caption_cli(dev, card, tmp, videos, names, line) -> None:
    """15b: the caption CLI on the shipped config, its resume, the repeat
    run and model_best served by /caption."""
    import argparse
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli import caption_train
    from cross_modal_video_engine_tpu_torch.data.datasets import (
        VideoDatasetRelseq)
    from cross_modal_video_engine_tpu_torch.data.pipelines import (
        build_pipeline, with_reader)
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_rec_optimizer,
        make_seq_train_step)

    train_ann = write_training_split(tmp, names, "relseq", 51)
    val_ann = write_training_split(tmp, names[:TRAIN15_VAL], "relseq", 51)
    cfg = shipped_training_config(
        RELSEQ_CONFIG, **{"data.train.ann_file": train_ann,
                          "data.train.data_prefix": None,
                          "data.val.ann_file": val_ann,
                          "data.val.data_prefix": None,
                          "data.videos_per_gpu": TRAIN15_BATCH,
                          "total_epochs": 2, "eval_interval": 1})
    work = os.path.join(tmp, "caption")
    t0 = time.perf_counter()
    history = caption_train.train_from_config(cfg, work, device=dev,
                                              reader=videos.__getitem__)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    resumed_work = os.path.join(tmp, "caption_resumed")
    t0 = time.perf_counter()
    resumed = caption_train.train_from_config(
        cfg, resumed_work, resume=os.path.join(work, "epoch_0"), device=dev,
        reader=videos.__getitem__)
    resume_s = time.perf_counter() - t0
    a = _epoch_params(os.path.join(work, "epoch_1"))
    b = _epoch_params(os.path.join(resumed_work, "epoch_1"))
    diffs = torch.cat([(a[k].float() - b[k].float()).abs().flatten()
                       for k in a])
    lr = cfg["optimizer"]["learning_rate"]
    one, two = history[1], resumed[0]
    resume = {"loss_uninterrupted": one["loss"], "loss_resumed": two["loss"],
              "loss_rel": abs(one["loss"] - two["loss"]) / abs(one["loss"]),
              "seq_mAP": [one["seq_mAP"], two["seq_mAP"]],
              "param_share_within": float(
                  (diffs <= RESUME_PARAM_TOL).double().mean()),
              "param_max_abs": float(diffs.max())}
    losses = [h["loss"] for h in history]
    line["cli"] = {"history": history, "seconds": cli_s,
                   "resume_seconds": resume_s, "resume": resume}
    print(f"15b caption_train.train_from_config (timesformer_relseq.py, "
          f"divided f32, dropouts as shipped) over {len(names)} seeded "
          f"videos, batch {TRAIN15_BATCH}, 2 epochs with validation on "
          f"{TRAIN15_VAL}: {json.dumps(history)} in {cli_s:.1f} s; resumed "
          f"from epoch_0 ({resume_s:.1f} s): {json.dumps(resume)} (need loss "
          f"and seq_mAP within {RESUME_LOSS_RTOL}, {RESUME_PARAM_SHARE} of "
          f"the parameters within {RESUME_PARAM_TOL}, all within "
          f"{2 * lr:g})", flush=True)
    if (not all(np.isfinite(losses)) or len(history) != 2
            or [h["epoch"] for h in resumed] != [1]
            or resume["loss_rel"] > RESUME_LOSS_RTOL
            or abs(one["seq_mAP"] - two["seq_mAP"]) > RESUME_LOSS_RTOL
            or resume["param_share_within"] < RESUME_PARAM_SHARE
            or resume["param_max_abs"] > 2 * lr):
        raise SystemExit("15b the caption CLI or its resume failed")

    # the repeat-the-same-batch run lowers the loss
    pipe = build_pipeline(with_reader(cfg["data.pipeline"],
                                      videos.__getitem__))
    ds = VideoDatasetRelseq(train_ann, pipe, num_classes=36, max_len=5)
    clips, tg, mk, _, _ = next(caption_train._seq_batches(ds, TRAIN15_BATCH,
                                                          dev))
    model, _, _ = caption_train.build_caption_model(cfg, dev)
    state = init_rec_state(model, make_rec_optimizer(RecognitionTrainConfig(
        optimizer="adamw", learning_rate=1e-4, grad_clip=1.0)))
    step = make_seq_train_step(
        model, torch.Generator(device=dev).manual_seed(3), device=dev)
    repeat = []
    for _ in range(TRAIN15_REPEAT):
        state, logs = step(state, clips, tg, mk)
        repeat.append(float(logs["loss"]))
    line["repeat_losses"] = repeat
    print(f"15b {TRAIN15_REPEAT} AdamW steps (lr 1e-4, clip 1.0) on one "
          f"batch of {TRAIN15_BATCH}: losses {json.dumps(repeat)} (need "
          f"finite, the last below the first)", flush=True)
    if not all(np.isfinite(repeat)) or repeat[-1] >= repeat[0]:
        raise SystemExit("15b the repeat run did not lower the loss")
    del model, state, step
    torch.cuda.empty_cache()

    # model_best served by /caption: answers equal to caption_clips
    args = argparse.Namespace(
        caption_checkpoint=os.path.join(work, "model_best"), device=str(dev))
    server, handler = bserve.start_caption_server(args, videos.__getitem__)
    try:
        port = server.server_address[1]
        asked = names[:4]
        answers = [(n, bserve.request(port, "caption", {"video": n},
                                      timeout=600.0)[1]["steps"])
                   for n in asked]
        direct = {n: caption_direct(handler, n) for n in asked}
    finally:
        bserve.stop_server(server, handler)
    agree = caption_agreement(answers, direct)
    line["served"] = agree
    print(f"15b model_best served by /caption: {json.dumps(agree)} (need "
          f"every answer identical to caption_clips on the route's model)",
          flush=True)
    if agree["identical"] != len(answers):
        raise SystemExit("15b /caption answers differ from caption_clips")


def joint_flash_steps(dev, names, pipe, targets) -> dict:
    """15c: the caption config with joint attention through the flash
    kernel (f32, the fma path), dropouts 0, batch 8: the flash counter
    zeroed and read around each step (12 a step, 24 with remat); the
    first step's gradients against the plain arm's (flash off, same
    weights) and the remat arm's."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli.caption_train import (
        build_caption_model)
    from cross_modal_video_engine_tpu_torch.ops import flash_attention as fa
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_rec_optimizer,
        make_seq_train_step)

    clips = torch.from_numpy(np.stack([
        pipe({"filename": n, "start_index": 0})["imgs"][0]
        for n in names[:TRAIN15_BATCH]]).astype(np.float32)).to(dev)
    tg, mk = (torch.from_numpy(a[:TRAIN15_BATCH]).to(dev) for a in targets)
    base = {"model.backbone.attention_type": "joint_space_time",
            "model.backbone.drop_path_max": 0.0,
            "model.decoder.input_dropout_p": 0.0}
    layers = shipped_training_config(RELSEQ_CONFIG)[
        "model.backbone"]["num_layers"]
    arms, out = {}, {"launches": {}}
    for arm, extra in (("flash", {"model.backbone.use_flash_attention":
                                  True}),
                       ("plain", {}),
                       ("remat", {"model.backbone.use_flash_attention": True,
                                  "model.backbone.remat": True})):
        cfg = shipped_training_config(RELSEQ_CONFIG, **base, **extra)
        model, _, _ = build_caption_model(cfg, dev)
        tcfg = RecognitionTrainConfig(**cfg.get("optimizer", {}))
        state = init_rec_state(model, make_rec_optimizer(tcfg))
        step = make_seq_train_step(model, device=dev)
        counts, losses = [], []
        for i in range(TRAIN15_FLASH_STEPS if arm == "flash" else 1):
            torch.cuda.synchronize()
            fa.flash_attention.launches = 0
            state, logs = step(state, clips, tg, mk)
            losses.append(float(logs["loss"]))
            counts.append(fa.flash_attention.launches)
            if i == 0:
                arms[arm] = _grads_of(model)
        out["launches"][arm] = counts
        out[f"{arm}_losses"] = losses
        del model, state, step
        torch.cuda.empty_cache()
    flash_vs_plain = grad_cosines(arms["flash"], arms["plain"])
    remat_vs_flash = grad_cosines(arms["remat"], arms["flash"])
    finite = all(bool(torch.isfinite(g).all()) for a in arms.values()
                 for g in a.values())
    out.update(grad_cos_min_vs_plain=min(flash_vs_plain.values()),
               grad_cos_min_remat=min(remat_vs_flash.values()),
               finite=finite)
    print(f"15c joint ViT-B/16 caption steps in f32 with flash (fma path) at "
          f"batch {TRAIN15_BATCH}: flash launches a step "
          f"{json.dumps(out['launches'])} (need {layers} a step, "
          f"{2 * layers} with remat, 0 in the plain arm); losses "
          f"{json.dumps(out['flash_losses'])} (plain "
          f"{out['plain_losses'][0]:.6f}, remat {out['remat_losses'][0]:.6f})"
          f"; gradients finite {finite}, per-tensor cosine min "
          f"{out['grad_cos_min_vs_plain']:.7f} to the plain arm, "
          f"{out['grad_cos_min_remat']:.7f} remat to no remat (need >= "
          f"{COSINE_MIN})", flush=True)
    if (out["launches"]["flash"] != [layers] * TRAIN15_FLASH_STEPS
            or out["launches"]["remat"] != [2 * layers]
            or out["launches"]["plain"] != [0] or not finite
            or out["grad_cos_min_vs_plain"] < COSINE_MIN
            or out["grad_cos_min_remat"] < COSINE_MIN
            or not all(np.isfinite(out["flash_losses"]))):
        raise SystemExit("15c the joint flash caption steps failed")
    return out


def recognition_cli(dev, card, tmp, videos, names, line) -> None:
    """15d: one bf16 recognition step card vs CPU, then the recognition
    CLI's TimeSformer arm for an epoch with bf16=True, 400 classes, batch
    8, and its model_best served once by /explain."""
    import argparse
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli import recognition_train
    from cross_modal_video_engine_tpu_torch.data.pipelines import (
        build_pipeline, with_reader)
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_cls_train_step,
        make_rec_optimizer)

    train_ann = write_training_split(tmp, names, "cls", 52)
    val_ann = write_training_split(tmp, names[:TRAIN15_VAL], "cls", 52)
    cfg = shipped_training_config(
        RECOGNITION_CONFIG, **{"optimizer.bf16": True,
                               "data.train.ann_file": train_ann,
                               "data.train.data_prefix": None,
                               "data.val.ann_file": val_ann,
                               "data.val.data_prefix": None,
                               "data.videos_per_gpu": TRAIN15_BATCH,
                               "total_epochs": 1, "eval_interval": 1})
    pipe = build_pipeline(with_reader(cfg["data.pipeline"],
                                      videos.__getitem__))
    clips = np.stack([pipe({"filename": n, "start_index": 0})["imgs"][0]
                      for n in names[:TRAIN15_CPU_BATCH]]).astype(np.float32)
    labels = np.arange(TRAIN15_CPU_BATCH) * 7
    # the step at TRAIN15D_LAYERS of the recipe's 12 layers (its widths
    # kept): the CPU's bf16 step takes the script's time
    no_drop = shipped_training_config(
        RECOGNITION_CONFIG, **{"model.backbone.drop_path_max": 0.0,
                               "model.backbone.num_layers": TRAIN15D_LAYERS})
    tcfg = RecognitionTrainConfig(**dict(cfg["optimizer"]))
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = recognition_train.build_recognition_model(no_drop, d)
        state = init_rec_state(model, make_rec_optimizer(tcfg, 10))
        step = make_cls_train_step(model, bf16=True, device=d)
        t0 = time.perf_counter()
        state, logs = step(state, torch.from_numpy(clips).to(d),
                           torch.from_numpy(labels).to(d))
        runs[name] = (float(logs["loss"]), _grads_of(model),
                      time.perf_counter() - t0)
        del model, state, step
    (card_loss, card_g, card_s), (cpu_loss, cpu_g, cpu_s) = (runs["card"],
                                                             runs["cpu"])
    cos = grad_cosines(card_g, cpu_g)
    worst = min(cos, key=cos.get)
    step_line = {"num_layers": TRAIN15D_LAYERS,
                 "loss_card": card_loss, "loss_cpu": cpu_loss,
                 "loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss),
                 "grad_cos_min": cos[worst], "grad_cos_min_at": worst,
                 "card_s": card_s, "cpu_s": cpu_s}
    line["step_card_vs_cpu"] = step_line
    print(f"15d one bf16 recognition step (timesformer_divst_8x32_k400.py "
          f"at {TRAIN15D_LAYERS} layers, 400 classes, f32 masters, dropouts "
          f"0) at batch "
          f"{TRAIN15_CPU_BATCH}, card vs CPU: {json.dumps(step_line)} (need "
          f"loss within {BF16_LOSS_REL}, every gradient's cosine >= "
          f"{BF16_GRAD_COS})", flush=True)
    if (step_line["loss_rel"] > BF16_LOSS_REL or cos[worst] < BF16_GRAD_COS
            or not np.isfinite(card_loss)):
        raise SystemExit("15d the bf16 step differs between card and CPU")

    work = os.path.join(tmp, "recognition")
    t0 = time.perf_counter()
    _, history = recognition_train.train_from_config(
        cfg, work, device=dev, reader=videos.__getitem__)
    torch.cuda.synchronize()
    line["cli"] = {"history": history,
                   "seconds": time.perf_counter() - t0}
    print(f"15d recognition_train.train_from_config (bf16=True, divided "
          f"ViT-B/16, 400 classes) over {len(names)} seeded videos, batch "
          f"{TRAIN15_BATCH}, 1 epoch with validation on {TRAIN15_VAL}: "
          f"{json.dumps(history)} in {line['cli']['seconds']:.1f} s",
          flush=True)
    if len(history) != 1 or not np.isfinite(history[0]["loss"]):
        raise SystemExit("15d the recognition CLI failed")

    backbone = cfg["model.backbone"]
    args = argparse.Namespace(
        explain_checkpoint=os.path.join(work, "model_best"),
        concept_banks=os.path.join(tmp, "banks.npz"),
        target_layer=backbone["num_layers"] - 2, device=str(dev))
    banks = bserve.write_concept_banks(args.concept_banks,
                                       backbone["embed_dims"], seed=53)
    server, handler = bserve.start_route_server(
        args, "explain", explain_decode=videos.__getitem__)
    try:
        port = server.server_address[1]
        ms, ans = bserve.request(port, "explain", {"video": names[0]},
                                 timeout=600.0)
        direct = explain_direct(handler, names[0], banks)
    finally:
        bserve.stop_server(server, handler)
    line["served"] = {"ms": ms, "prediction": ans["prediction"],
                      "direct": direct["pred"],
                      "margin": top2_margin(direct["scores"][0])}
    print(f"15d model_best served once by /explain ({ms:.1f} ms): "
          f"{json.dumps(line['served'])} (need the prediction of a direct "
          f"grad_extract)", flush=True)
    if ans["prediction"] != direct["pred"]:
        raise SystemExit("15d /explain disagrees with grad_extract")


def training_times(dev, card, names, videos) -> dict:
    """15e: each trainer's step by CUDA events over prebuilt batches (the
    shipped caption config in f32, the recognition config in bf16), the
    optimizer's step alone, the host's batch assembly, the idle share of
    five steps of the real loop (torch.profiler), peak memory, and the
    bench row."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cross_modal_video_engine_tpu_torch.bench.extra import (
        bench_train_step_timesformer, timesformer_forward_flops)
    from cross_modal_video_engine_tpu_torch.cli import (caption_train,
                                                        recognition_train)
    from cross_modal_video_engine_tpu_torch.data.datasets import (
        VideoDataset, VideoDatasetRelseq)
    from cross_modal_video_engine_tpu_torch.data.pipelines import (
        build_pipeline, with_reader)
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_cls_train_step,
        make_rec_optimizer, make_seq_train_step)

    out = {"card": card}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        relseq = write_training_split(tmp, names, "relseq", 54)
        cls = write_training_split(tmp, names, "cls", 55)
        for name in ("caption", "recognition"):
            if name == "caption":
                cfg = shipped_training_config(RELSEQ_CONFIG)
                pipe = build_pipeline(with_reader(cfg["data.pipeline"],
                                                  videos.__getitem__))
                ds = VideoDatasetRelseq(relseq, pipe, num_classes=36,
                                        max_len=5)
                model, _, _ = caption_train.build_caption_model(cfg, dev)
                make = make_seq_train_step
                batches = caption_train._seq_batches
                extra = {}
            else:
                cfg = shipped_training_config(RECOGNITION_CONFIG)
                pipe = build_pipeline(with_reader(cfg["data.pipeline"],
                                                  videos.__getitem__))
                ds = VideoDataset(cls, pipe)
                model = recognition_train.build_recognition_model(cfg, dev)
                make = make_cls_train_step
                batches = recognition_train._label_batches
                extra = {"bf16": True}
            tcfg = RecognitionTrainConfig(**cfg.get("optimizer", {}))
            state = init_rec_state(model, make_rec_optimizer(tcfg))
            step = make(model,
                        generator=torch.Generator(device=dev).manual_seed(5),
                        device=dev, **extra)
            b = next(batches(ds, TRAIN15_BATCH, dev))
            args = b[:3] if name == "caption" else b[:2]
            spans = []
            torch.cuda.reset_peak_memory_stats(dev)
            for _ in range(TRAIN15_TIMED):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, logs = step(state, *args)
                end.record()
                end.synchronize()
                spans.append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated(dev)
            step_ms = float(np.median(spans[2:]))
            opt_ms = cuda_ms(state.optimizer.step, iters=5, warmup=1)
            it = batches(ds, TRAIN15_BATCH, dev, [
                i % len(ds) for i in range(TRAIN15_BATCH)])
            t0 = time.perf_counter()
            next(it)
            torch.cuda.synchronize()
            assembly_ms = (time.perf_counter() - t0) * 1e3
            it = batches(ds, TRAIN15_BATCH, dev, [
                i % len(ds) for i in range(TRAIN15_PROFILED * TRAIN15_BATCH)])
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(TRAIN15_PROFILED):
                    b = next(it)
                    state, logs = step(state, *(b[:3] if name == "caption"
                                                else b[:2]))
                float(logs["loss"])
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) / TRAIN15_PROFILED * 1e3
            kernels = sorted(
                ((e.self_device_time_total / TRAIN15_PROFILED / 1e3, e.key)
                 for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA")
                 and not getattr(e, "is_user_annotation", False)
                 and not e.key.startswith("Optimizer.")), reverse=True)
            busy_ms = sum(ms for ms, _ in kernels)
            flops = 3 * timesformer_forward_flops(
                model.backbone.cfg, TRAIN15_BATCH,
                36 if name == "caption" else 400)
            t = {"dtype": "bf16=True" if extra else "float32",
                 "step_ms": step_ms, "step_ms_all": spans,
                 "videos_per_s": TRAIN15_BATCH * 1e3 / step_ms,
                 "tflops_per_s": flops / step_ms / 1e9,
                 "optimizer_ms": opt_ms, "optimizer_share": opt_ms / step_ms,
                 "assembly_ms": assembly_ms, "loop_wall_ms": wall_ms,
                 "loop_videos_per_s": TRAIN15_BATCH * 1e3 / wall_ms,
                 "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
                 "peak_mib": peak / 2 ** 20,
                 "top_kernels": [[k[:80], ms] for ms, k in kernels[:8]]}
            out[name] = t
            print(f"15e {name} step ({t['dtype']}, batch {TRAIN15_BATCH}): "
                  f"{step_ms:.2f} ms by CUDA events (median of steps "
                  f"3-{TRAIN15_TIMED} over a prebuilt batch) = "
                  f"{t['videos_per_s']:.2f} videos/s, "
                  f"{t['tflops_per_s']:.1f} TFLOP/s of the model's products; "
                  f"the optimizer's step alone {opt_ms:.3f} ms = "
                  f"{t['optimizer_share']:.4f} of a step; the host assembles "
                  f"a batch in {assembly_ms:.1f} ms; the loop with its "
                  f"assembly {wall_ms:.1f} ms a step = "
                  f"{t['loop_videos_per_s']:.2f} videos/s, kernels busy "
                  f"{busy_ms:.2f} ms of it, idle share "
                  f"{t['idle_share']:.3f}; peak memory "
                  f"{t['peak_mib']:.0f} MiB on {card}; longest kernels (ms a "
                  f"step): {json.dumps(t['top_kernels'])}", flush=True)
            if not np.isfinite(float(logs["loss"])):
                raise SystemExit(f"15e the {name} loop's loss is not finite")
            del model, state, step, b, args, it, prof
            torch.cuda.empty_cache()
    out["bench_row"] = bench_train_step_timesformer(steps=BENCH_ROW_STEPS)
    return out


def check_timesformer_training(dev, card) -> Tuple[dict, dict]:
    """Step 15 (items a-f of the docstring).  Every failed check raises.
    Returns (the `timesformer_training` JSON object, flash launches over
    the joint steps of 15c)."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.data.datasets import (
        VideoDatasetRelseq)
    from cross_modal_video_engine_tpu_torch.data.pipelines import (
        build_pipeline, with_reader)

    t_step = time.perf_counter()
    videos = bserve.seeded_videos(TRAIN15_VIDEOS, seed=15, **TRAIN_VIDEO_HW)
    names = sorted(videos)
    line = {"card": card, "videos": TRAIN15_VIDEOS, "batch": TRAIN15_BATCH,
            "video_frames": bserve.VIDEO_FRAMES,
            "video_size": [TRAIN_VIDEO_HW["height"],
                           TRAIN_VIDEO_HW["width"]]}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        cfg = shipped_training_config(
            RELSEQ_CONFIG, **{"model.backbone.drop_path_max": 0.0,
                              "model.decoder.input_dropout_p": 0.0})
        pipe = build_pipeline(with_reader(cfg["data.pipeline"],
                                          videos.__getitem__))
        ann = write_training_split(tmp, names, "relseq", 50)
        ds = VideoDatasetRelseq(ann, pipe, num_classes=36, max_len=5)
        targets = (np.stack([it["label"] for it in ds.video_infos]),
                   np.stack([it["mask"] for it in ds.video_infos]))
        t0 = time.perf_counter()
        line["caption_step"] = caption_step_card_vs_cpu(dev, cfg, names,
                                                        pipe, targets)
        line["caption_step"]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        line["caption"] = {}
        caption_cli(dev, card, tmp, videos, names, line["caption"])
        line["caption"]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        line["joint_flash"] = joint_flash_steps(dev, names, pipe, targets)
        line["joint_flash"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        line["recognition"] = {}
        recognition_cli(dev, card, tmp, videos, names, line["recognition"])
        line["recognition"]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    line["times"] = training_times(dev, card, names, videos)
    line["times"]["seconds"] = time.perf_counter() - t0
    line["seconds"] = time.perf_counter() - t_step
    print(f"15 TimeSformer training checked in {line['seconds']:.1f} s",
          flush=True)
    launches = {"flash_attention": sum(
        sum(v) for v in line["joint_flash"]["launches"].values())}
    return line, launches


# -- step 16: the concept detector and the concept-bank build ----------------
YOLO_CONFIGS = ROOT / "configs" / "detection" / "yolov5"
YOLO_DETECT_CONFIG = YOLO_CONFIGS / "yolov5s_coco_640.py"
YOLO_SEGMENT_CONFIG = YOLO_CONFIGS / "yolov5s_seg_coco_640.py"
YOLO_CLASSIFY_CONFIG = YOLO_CONFIGS / "yolov5s_cls_224.py"
YOLO_BATCH, YOLO_IMAGE = 16, (480, 640)      # seeded images, letterboxed
# the firing arm: on anchor 0 the logit of COCO class 0 (person), on anchor
# 1 that of class 2 (car), is raised by 12 and every other class's lowered
# by 12, with those anchors' objectness at stride 32 raised by 12
# (models/yolo.random_state_dict(fire=...)): every image then holds both
# classes, alone in their boxes of about 116x90 and 156x198 pixels
YOLO_FIRE = (0, 2)
# f32, TF32 off, card (cuDNN) against CPU (oneDNN): raw maps, prototypes,
# logits and decoded xywh within YOLO_F32_REL of each group's largest
# magnitude; probabilities (and mask values) within YOLO_F32_REL.  NMS
# meets candidates in score order, and scores within the bound may come
# in another order on the card: the CPU's boxes with the card's scores
# must give the card's detections (nms_agreement)
YOLO_F32_REL = 1e-4
YOLO_CPU_TTA, YOLO_CPU_SEG = 4, 4            # images of the TTA and seg arms
YOLO_CPU_BATCH = 8      # images of 16a's card-vs-CPU heads and classifier
YOLO_VAL_IMAGES, YOLO_MAP_MIN = 8, 0.99
# the card's and the CPU's yolo_val rows: NMS meets scores within the f32
# bound in another order on each side (16a: a few percent of the
# detections differ until the CPU takes the card's scores), which moves
# mAP, precision and recall by up to this much
YOLO_VAL_AGREE = 0.01
# the segment config's run: its mask IoUs are (predictions x labels x
# 640²) float64 products on the host, so it reads the first images only
YOLO_SEG_VAL_IMAGES = 4
# the labels are written from batches of the CLI's own size, so the CPU's
# run reproduces them bit for bit
YOLO_VAL_BATCH = 8
YOLO_VAL_OPTIONS = [f"data.batch_size={YOLO_VAL_BATCH}",
                    "data.max_targets=512"]
YOLO_TIMED_CALLS = 20
# ctv_build: step 14's backbone, seeded videos at a size on the 32 grid; the
# CPU builds the first video's banks (one video for the script's time)
CTV_VIDEOS, CTV_CPU_VIDEOS, CTV_SIZE, CTV_REFUSED = 4, 1, (352, 480), \
    (360, 480)
# bf16 on both sides: an instance CTV (a difference of two CLS features)
# from the card against the CPU's, and explain_video's video CTVs
CTV_COS = 0.99


def rows_cosine_min(a: np.ndarray, b: np.ndarray) -> float:
    """Smallest cosine between matching rows of two numpy matrices."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    return float(cos.min())


def _group_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over the largest |want| (f32 group bound)."""
    scale = max(float(np.abs(want).max()), 1e-12)
    return float(np.abs(got - want).max()) / scale


def decoded_errors(got: np.ndarray, want: np.ndarray, nc: int) -> dict:
    """Decoded predictions (B, N, 5+nc[+nm]) by group: xywh relative to
    their largest magnitude, objectness and class probabilities absolute,
    mask coefficients relative."""
    out = {"xywh": _group_err(got[..., :4], want[..., :4]),
           "probs": float(np.abs(got[..., 4:5 + nc]
                                 - want[..., 4:5 + nc]).max())}
    if got.shape[-1] > 5 + nc:
        out["coefs"] = _group_err(got[..., 5 + nc:], want[..., 5 + nc:])
    return out


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=2)
    area = lambda x: np.prod(np.clip(x[:, 2:4] - x[:, :2], 0, None), axis=1)
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-9)


def match_detections(a: list, b: list) -> dict:
    """Per image, each detection of `a` matched to one of `b` of its class
    at IoU >= 0.99: the counts, the unmatched on each side, the worst
    matched score and corner differences."""
    out = {"a": 0, "b": 0, "matched": 0, "score_err": 0.0, "box_err": 0.0}
    for x, y in zip(a, b):
        out["a"] += len(x)
        out["b"] += len(y)
        if not len(x) or not len(y):
            continue
        ok = (_iou(x, y) >= 0.99) & (x[:, None, 5] == y[None, :, 5])
        used = set()
        for i in range(len(x)):
            for j in np.nonzero(ok[i])[0]:
                if j not in used:
                    used.add(j)
                    out["matched"] += 1
                    out["score_err"] = max(out["score_err"],
                                           float(abs(x[i, 4] - y[j, 4])))
                    out["box_err"] = max(out["box_err"], float(np.abs(
                        x[i, :4] - y[j, :4]).max()))
                    break
    out["unmatched"] = out["a"] + out["b"] - 2 * out["matched"]
    return out


def nms_agreement(card: np.ndarray, cpu: np.ndarray, nc: int, conf: float,
                  iou_thres: float, multi: bool, post=None) -> dict:
    """NMS of the card's and the CPU's decoded predictions (B, N, 5+nc..),
    matched (`direct`).  NMS meets the candidates in score order, and
    equal or near-equal scores (within YOLO_F32_REL) may come in another
    order on each side, so a direct difference may follow from a gap
    within the bound.  `reordered` runs the CPU's boxes with the card's
    scores (each within the bound of the CPU's): the same order, so the
    same detections unless an IoU lies at the threshold.  post: the
    postprocess taking (preds, conf, iou, multi_label) (default:
    models.yolo.postprocess)."""
    from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
    post = post or (lambda p, c, i, m: tyolo.postprocess(p, c, i,
                                                        multi_label=m))
    swapped = cpu.copy()
    swapped[..., 4:5 + nc] = card[..., 4:5 + nc]
    got = post(card, conf, iou_thres, multi)
    return {"score_gap_max": float(np.abs(card[..., 4:5 + nc]
                                          - cpu[..., 4:5 + nc]).max()),
            "direct": match_detections(got, post(cpu, conf, iou_thres,
                                                 multi)),
            "reordered": match_detections(got, post(swapped, conf,
                                                     iou_thres, multi))}


def _nms_ok(agree: dict) -> bool:
    return (agree["score_gap_max"] <= YOLO_F32_REL
            and agree["reordered"]["unmatched"] == 0)


def seeded_images(n: int, seed: int, hw=YOLO_IMAGE) -> np.ndarray:
    """(n, H, W, 3) uint8 frames drawn from a seed (bench/serve's seeded
    video frames: colour ramps plus noise)."""
    from cross_modal_video_engine_tpu_torch.bench.serve import SeededVideo
    video = SeededVideo(seed, frames=n, height=hw[0], width=hw[1])
    return np.stack([video.frame(i) for i in range(n)])


def segment_state_dict(det_sd: dict, seg_cfg, seed: int) -> dict:
    """The segment model's state dict: the detect model's trunk, neck and
    box/class head rows, with seeded mask-coefficient rows and
    prototypes, so its boxes are the detect model's."""
    from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
    sd = tyolo.random_state_dict(seg_cfg, seed)
    nc, nm = seg_cfg.num_classes, seg_cfg.masks
    for k, v in det_sd.items():
        if not k.startswith("model.24.m."):
            sd[k] = v.clone()
            continue
        rows = sd[k].view(3, 5 + nc + nm, *sd[k].shape[1:])
        rows[:, :5 + nc] = v.view(3, 5 + nc, *v.shape[1:])
    return sd


def yolo_models(dev):
    """The shipped configs at full width: (configs, seeded state dicts,
    card models, CPU models) for 'detect' (the firing arm), 'segment' and
    'classify'."""
    from cross_modal_video_engine_tpu_torch.cli.yolo_train import (
        yolo_config)
    from cross_modal_video_engine_tpu_torch.config import Config
    from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
    cfgs = {"detect": yolo_config(Config.fromfile(str(YOLO_DETECT_CONFIG))),
            "segment": yolo_config(Config.fromfile(
                str(YOLO_SEGMENT_CONFIG))),
            "classify": yolo_config(Config.fromfile(
                str(YOLO_CLASSIFY_CONFIG)))}
    sds = {"detect": tyolo.random_state_dict(cfgs["detect"], 16,
                                             fire=YOLO_FIRE)}
    sds["segment"] = segment_state_dict(sds["detect"], cfgs["segment"], 17)
    sds["classify"] = tyolo.random_state_dict(cfgs["classify"], 18,
                                              classifier=True)
    card, cpu = {}, {}
    for name, cfg in cfgs.items():
        cls = tyolo.YoloClassifier if name == "classify" else tyolo.YoloV5
        card[name], cpu[name] = cls(cfg, device=dev), cls(cfg, device="cpu")
        card[name].load_state_dict(sds[name])
        cpu[name].load_state_dict(sds[name])
    return cfgs, sds, card, cpu


def detector_card_vs_cpu(models, cfgs, x_u8) -> dict:
    """16a: the three heads, the decode, both NMS protocols, the TTA arm
    and the masks, card against CPU on the same letterboxed images."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import yolo_train as tyt
    from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
    card, cpu = models
    dev = next(card["detect"].parameters()).device
    x = torch.from_numpy(x_u8).float() / 255.0
    out = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        raw_card = [m.cpu().numpy() for m in card["detect"](x.to(dev))]
        raw_cpu = [m.numpy() for m in cpu["detect"](x)]
    out["raw_rel_err"] = max(_group_err(a, b)
                             for a, b in zip(raw_card, raw_cpu))
    cfg = cfgs["detect"]
    dec = {}
    for side, raw in (("card", raw_card), ("cpu", raw_cpu)):
        dec[side] = tyolo.decode_predictions(
            [torch.from_numpy(r) for r in raw], cfg).numpy()
    out["decoded_err"] = decoded_errors(dec["card"], dec["cpu"],
                                        cfg.num_classes)
    protocols = {"detect (conf 0.25, argmax, iou 0.45)": (0.25, 0.45, False),
                 "val (conf 0.001, multi-label, iou 0.6)": (0.001, 0.6,
                                                            True)}
    out["nms"] = {name: nms_agreement(dec["card"], dec["cpu"],
                                      cfg.num_classes, *args)
                  for name, args in protocols.items()}
    out["detections_per_image"] = out["nms"][next(iter(protocols))][
        "direct"]["a"] / len(x_u8)
    # TTA on the first images
    xt = x[:YOLO_CPU_TTA]
    tta_card = tyt._det_infer_tta(card["detect"])(xt).cpu().numpy()
    tta_cpu = tyt._det_infer_tta(cpu["detect"])(xt).numpy()
    out["tta"] = {"rows": int(tta_card.shape[1]),
                  "decoded_err": decoded_errors(tta_card, tta_cpu,
                                                cfg.num_classes),
                  "nms": nms_agreement(tta_card, tta_cpu, cfg.num_classes,
                                       0.001, 0.6, True)}
    # the segment head on the first images: prototypes, then the masks of
    # matched detections where the mask values clear the bound
    scfg = cfgs["segment"]
    xs = x[:YOLO_CPU_SEG]
    seg = {}
    for side, m, xx in (("card", card["segment"], xs.to(dev)),
                        ("cpu", cpu["segment"], xs)):
        with torch.no_grad():
            maps, proto = m(xx)
        seg[side] = (tyolo.decode_predictions(maps, scfg).cpu().numpy(),
                     proto.cpu().numpy())
    size = (x.shape[1], x.shape[2])
    out["segment"] = {
        "proto_rel_err": _group_err(seg["card"][1], seg["cpu"][1]),
        "decoded_err": decoded_errors(seg["card"][0], seg["cpu"][0],
                                      scfg.num_classes)}
    # the masks of the CPU's boxes with the card's scores (the same NMS
    # order): pixel by pixel where the mask values clear the bound
    nc = scfg.num_classes
    cpu_reordered = seg["cpu"][0].copy()
    cpu_reordered[..., 4:5 + nc] = seg["card"][0][..., 4:5 + nc]
    out["segment"]["nms"] = nms_agreement(
        seg["card"][0], seg["cpu"][0], nc, 0.25, 0.45, False,
        post=lambda p, c, i, m: [d for d, _ in tyolo.postprocess_seg(
            p, seg["cpu"][1], size, c, i, multi_label=m)])
    outs = {"card": tyolo.postprocess_seg(*seg["card"], size),
            "cpu": tyolo.postprocess_seg(cpu_reordered, seg["cpu"][1], size)}
    differ = near = masks = 0
    nm = scfg.masks
    for b in range(len(xs)):
        (dc, mc), (dp, mp) = outs["card"][b], outs["cpu"][b]
        if not len(dc) or not len(dp):
            continue
        # the CPU detections' coefficient rows, as postprocess_seg keeps them
        p = cpu_reordered[b]
        bi, cls, score = tyolo._candidates(p[:, 4:5] * p[:, 5:5 + nc], 0.25,
                                           False)
        rows = bi[tyolo.nms(p[bi, :4], score, cls, 0.45, 300)]
        iou = _iou(dc, dp)
        for i in range(len(dc)):
            j = int(iou[i].argmax())
            if iou[i, j] < 0.99 or dc[i, 5] != dp[j, 5]:
                continue
            masks += 1
            bad = mc[i] != mp[j]
            if bad.any():
                # the CPU's mask values before the threshold where they differ
                soft = tyolo.process_mask(seg["cpu"][1][b],
                                          p[rows[j:j + 1], -nm:],
                                          dp[j:j + 1, :4], size,
                                          threshold=None)[0]
                differ += int(bad.sum())
                near += int((np.abs(soft[bad] - 0.5) <= YOLO_F32_REL).sum())
    out["segment"].update(masks_compared=masks, pixels_differing=differ,
                          pixels_differing_within_bound=near)
    # the classifier at 224²
    xc = torch.from_numpy(seeded_images(YOLO_CPU_BATCH, 19, (224, 224))
                          ).float() / 255.0
    with torch.no_grad():
        lc = card["classify"](xc.to(dev)).cpu().numpy()
        lp = cpu["classify"](xc).numpy()
    out["classify"] = {"logit_rel_err": _group_err(lc, lp),
                       "top1_equal": int((lc.argmax(1) == lp.argmax(1)).sum()),
                       "images": len(xc)}
    out["seconds"] = time.perf_counter() - t0
    nms_bad = not all(_nms_ok(a) for a in list(out["nms"].values())
                      + [out["tta"]["nms"], out["segment"]["nms"]])
    print(f"16a detector card vs CPU (yolov5s 80 classes at 640², f32, TF32 "
          f"off, batch {len(x_u8)} of letterboxed {YOLO_IMAGE[0]}x"
          f"{YOLO_IMAGE[1]} images, firing classes {list(YOLO_FIRE)}; "
          f"{out['seconds']:.1f} s): raw maps {out['raw_rel_err']:.2e} of "
          f"their largest, decoded {json.dumps(out['decoded_err'])}; NMS "
          f"{json.dumps(out['nms'])}; TTA {json.dumps(out['tta'])}; segment "
          f"{json.dumps(out['segment'])}; classifier "
          f"{json.dumps(out['classify'])} (bound {YOLO_F32_REL:g})",
          flush=True)
    errs = [out["raw_rel_err"], out["tta"]["decoded_err"]["xywh"],
            out["segment"]["proto_rel_err"], out["classify"]["logit_rel_err"]]
    errs += list(out["decoded_err"].values())
    errs += list(out["segment"]["decoded_err"].values())
    if (max(errs) > YOLO_F32_REL or nms_bad
            or out["detections_per_image"] < 2
            or out["segment"]["pixels_differing"]
            != out["segment"]["pixels_differing_within_bound"]
            or not out["segment"]["masks_compared"]):
        raise SystemExit("16a the detector on the card disagrees with the "
                         "CPU")
    return out


def write_yolo_val_dir(root: str, model, n: int, seed: int):
    """n seeded 480x640 `.npy` images; labels: the CPU model's detections
    in the val protocol (conf 0.001, multi-label, NMS at 0.6) on the
    letterboxed image, those scoring 0.25 or more, as normalized rows of
    the original image, and the
    same boxes as 4-point polygons for the segment head.  Returns
    (img_dir, label_dir, seg_label_dir, boxes a image)."""
    import torch
    from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
    from cross_modal_video_engine_tpu_torch.train.yolo_trainer import (
        letterbox)
    dirs = [os.path.join(root, d) for d in ("images", "labels", "seg")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    counts = []
    imgs = seeded_images(n, seed)
    for i0 in range(0, n, YOLO_VAL_BATCH):
        chunk = imgs[i0:i0 + YOLO_VAL_BATCH]
        lbs = [letterbox(im, model.cfg.img_size) for im in chunk]
        x = torch.from_numpy(np.stack([lb for lb, _, _ in lbs])).float() \
            / 255.0
        with torch.no_grad():
            preds = tyolo.decode_predictions(model(x), model.cfg).numpy()
        # the val run's own detections (its candidate array decides the
        # order NMS meets equal scores in), those at 0.25 and above kept
        dets = [d[d[:, 4] >= 0.25] for d in tyolo.postprocess(
            preds, 0.001, 0.6, multi_label=True)]
        for k, (img, (_, r, (px, py)), det) in enumerate(zip(chunk, lbs,
                                                             dets)):
            h, w = img.shape[:2]
            name = f"im{i0 + k:03d}"
            np.save(os.path.join(dirs[0], name + ".npy"), img)
            x1, x2 = ((det[:, [0, 2]] - px) / r / w).T
            y1, y2 = ((det[:, [1, 3]] - py) / r / h).T
            with open(os.path.join(dirs[1], name + ".txt"), "w") as f, \
                    open(os.path.join(dirs[2], name + ".txt"), "w") as g:
                for c, a, b, cc, d in zip(det[:, 5], x1, y1, x2, y2):
                    f.write(f"{int(c)} {(a + cc) / 2:.6f} {(b + d) / 2:.6f} "
                            f"{cc - a:.6f} {d - b:.6f}\n")
                    g.write(f"{int(c)} {a:.6f} {b:.6f} {cc:.6f} {b:.6f} "
                            f"{cc:.6f} {d:.6f} {a:.6f} {d:.6f}\n")
            counts.append(len(det))
    return dirs[0], dirs[1], dirs[2], float(np.mean(counts))


def _quiet(fn, *args):
    """fn(*args) with its stdout kept out of this script's."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def _report_row(report: dict) -> dict:
    keys = ("map50", "map", "precision", "recall")
    if "boxes" in report:
        return {part: _report_row(report[part]) for part in ("boxes",
                                                            "masks")}
    return {k: report[k] for k in keys}


def yolo_val_card(dev, tmp, sds, cfgs, cpu_detect) -> dict:
    """16b: `yolo_val.main` on the card over a seeded directory whose
    labels are the CPU's own detections, the detector read from a `best/`
    directory in the JAX format; the same CLI on the CPU; then --augment
    and the segment config on the card."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench.serve import device_kernels
    from cross_modal_video_engine_tpu_torch.cli import yolo_val
    from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
    from cross_modal_video_engine_tpu_torch.train.resume import (
        save_train_state)
    t0 = time.perf_counter()
    img_dir, label_dir, seg_dir, boxes = write_yolo_val_dir(
        os.path.join(tmp, "val"), cpu_detect, YOLO_VAL_IMAGES, 20)
    line = {"images": YOLO_VAL_IMAGES, "labels_per_image": boxes,
            "write_s": time.perf_counter() - t0}
    bests = {}
    for name in ("detect", "segment"):
        m = tyolo.YoloV5(cfgs[name], device="cpu")
        m.load_state_dict(sds[name])
        bests[name] = os.path.join(tmp, f"best_{name}")
        save_train_state(bests[name], {"detector": m},
                         {"epoch": 0, "fitness": 0.0})
    opts = YOLO_VAL_OPTIONS + [f"data.val.img_dir={img_dir}"]
    seg_img_dir = os.path.join(tmp, "val", "seg_images")
    os.makedirs(seg_img_dir)
    for name in sorted(os.listdir(img_dir))[:YOLO_SEG_VAL_IMAGES]:
        os.symlink(os.path.join(img_dir, name),
                   os.path.join(seg_img_dir, name))
    argv = [str(YOLO_DETECT_CONFIG), "--checkpoint", bests["detect"],
            "--cfg-options"] + opts + [f"data.val.label_dir={label_dir}"]
    runs = {"card": argv + ["--device", str(dev)],
            "cpu": argv + ["--device", "cpu"],
            "card --augment": argv + ["--device", str(dev), "--augment"],
            "card segment": [str(YOLO_SEGMENT_CONFIG), "--checkpoint",
                             bests["segment"], "--cfg-options"]
            + YOLO_VAL_OPTIONS + [f"data.val.img_dir={seg_img_dir}",
                                  f"data.val.label_dir={seg_dir}",
                                  "--device", str(dev)]}
    reports = {}
    for name, args in runs.items():
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        reports[name] = _quiet(yolo_val.main, args)
        torch.cuda.synchronize()
        line[name] = dict(_report_row(reports[name]),
                          seconds=time.perf_counter() - s0)
    wall = line["card"]["seconds"]
    line["card"]["images_per_s"] = YOLO_VAL_IMAGES / wall
    kernels = device_kernels(lambda: _quiet(yolo_val.main, runs["card"]), 1)
    line["card"].update(busy_ms=kernels["busy_ms"],
                        idle_share=1.0 - kernels["busy_ms"] / (wall * 1e3),
                        top_kernels=kernels["top_kernels"])
    diff = max(abs(reports["card"][k] - reports["cpu"][k])
               for k in ("map50", "map", "precision", "recall"))
    line["card_vs_cpu_max_diff"] = diff
    print(f"16b yolo_val.main over {YOLO_VAL_IMAGES} seeded 480x640 .npy "
          f"images ({boxes:.1f} labels an image: the CPU's own detections), "
          f"the detector from a best/ directory in the JAX format: "
          f"{json.dumps(line)} (need mAP@0.5 >= {YOLO_MAP_MIN} on the card "
          f"and the CPU, the rows within {YOLO_VAL_AGREE:g}; the segment "
          f"config on the first {YOLO_SEG_VAL_IMAGES} images, its boxes' "
          f"mAP@0.5 >= {YOLO_MAP_MIN})", flush=True)
    if (min(reports["card"]["map50"], reports["cpu"]["map50"])
            < YOLO_MAP_MIN or diff > YOLO_VAL_AGREE
            or boxes < 1 or reports["card segment"]["boxes"]["map50"]
            < YOLO_MAP_MIN):
        raise SystemExit("16b yolo_val failed")
    return line


def _flash():
    from cross_modal_video_engine_tpu_torch.ops import flash_attention as fa
    return fa.flash_attention


def ctv_build_card(dev, card, tmp, det_card, det_cpu) -> Tuple[dict, int]:
    """16c-d: ctv_build with step 14's backbone and the firing detector on
    seeded 352x480 videos through the reader seam; the flash counter read
    around each video and each detection; the banks against the CPU's
    build on two videos; the npz served by /explain against a direct
    concept_scores; a 360x480 video refused; explain_video with the
    detector, card against CPU.  Returns (line, flash launches)."""
    import argparse
    import torch
    from cross_modal_video_engine_tpu_torch.api import init_recognizer
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli import ctv_build
    from cross_modal_video_engine_tpu_torch.cli.caption_inference import (
        DEFAULT_PIPELINE)
    from cross_modal_video_engine_tpu_torch.data.pipelines import (
        build_pipeline, with_reader)
    from cross_modal_video_engine_tpu_torch.explain.model_layers import (
        get_model_layers)
    from cross_modal_video_engine_tpu_torch.explain.pipeline import (
        ConceptBank, explain_video)
    flash = _flash()
    layer = get_model_layers("timesformer", TS_JOINT["num_layers"])["target"]
    names = [f"coco{i}" for i in range(80)]
    videos = bserve.seeded_videos(CTV_VIDEOS, seed=16, height=CTV_SIZE[0],
                                  width=CTV_SIZE[1])
    order = sorted(videos)
    ckpt = os.path.join(tmp, "explain")
    bserve.write_explain_checkpoint(ckpt, TS_JOINT, seed=6)
    model, _ = init_recognizer(ckpt, device=dev)
    line = {"videos": CTV_VIDEOS, "video_size": list(CTV_SIZE),
            "video_frames": bserve.VIDEO_FRAMES, "target_layer": layer}
    marks = []
    det_fn = ctv_build.make_detector_fn(det_card)

    def detector(frames):
        before = flash.launches
        out = det_fn(frames)
        marks.append((before, flash.launches))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = {}
    flash.launches = 0
    t0 = time.perf_counter()
    banks = ctv_build.build_ctv_banks(model, order, detector, names, layer,
                                      reader=videos.__getitem__, times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = flash.launches
    starts = [a for a, _ in marks] + [total]
    per_video = [b - a for a, b in zip(starts, starts[1:])]
    in_detector = sum(b - a for a, b in marks)
    line.update(seconds=wall, seconds_per_video=wall / CTV_VIDEOS,
                phases_s_per_video={k: v / CTV_VIDEOS
                                    for k, v in times.items()},
                flash_per_video=per_video, flash_in_detector=in_detector,
                peak_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20,
                banks={k: list(v.shape) for k, v in banks.items()
                       if k.endswith("_matrix")},
                concepts=sorted(set(banks["symbolic_names"].tolist())))
    print(f"16c ctv_build (TimeSformer ViT-B/16 joint bf16 flash, probe at "
          f"block {layer}; yolov5s firing on {list(YOLO_FIRE)}) over "
          f"{CTV_VIDEOS} seeded {bserve.VIDEO_FRAMES}-frame {CTV_SIZE[0]}x"
          f"{CTV_SIZE[1]} videos through the reader: {json.dumps(line)} on "
          f"{card} (need 12 flash a video, 0 in the detector)", flush=True)
    if (per_video != [TS_JOINT["num_layers"]] * CTV_VIDEOS or in_detector
            or line["concepts"] != sorted(names[c] for c in YOLO_FIRE)):
        raise SystemExit("16c ctv_build's launches or concepts are wrong")

    # the CPU's build of the first videos against the card's
    t0 = time.perf_counter()
    cpu_model, _ = init_recognizer(ckpt, device="cpu")
    sub = order[:CTV_CPU_VIDEOS]
    card_sub = ctv_build.build_ctv_banks(
        model, sub, det_fn, names, layer, reader=videos.__getitem__)
    cpu_sub = ctv_build.build_ctv_banks(
        cpu_model, sub, ctv_build.make_detector_fn(det_cpu), names, layer,
        reader=videos.__getitem__)
    cos = {}
    for k in ("symbolic_matrix", "cluster_matrix", "instance_matrix"):
        if list(card_sub[k.replace("matrix", "names")]) != list(
                cpu_sub[k.replace("matrix", "names")]):
            raise SystemExit(f"16c {k}: card and CPU name different rows")
        cos[k] = rows_cosine_min(card_sub[k], cpu_sub[k])
    line["card_vs_cpu"] = {"videos": CTV_CPU_VIDEOS, "cosine_min": cos,
                           "seconds": time.perf_counter() - t0}
    print(f"16c banks card vs the port on the CPU ({CTV_CPU_VIDEOS} videos, "
          f"bf16 both): row cosine {json.dumps(cos)} (need >= {CTV_COS:g})",
          flush=True)
    if min(cos.values()) < CTV_COS:
        raise SystemExit("16c the banks disagree with the CPU's")

    # 360x480: refused before the detector runs
    marks.clear()
    refused = bserve.seeded_videos(1, seed=17, height=CTV_REFUSED[0],
                                   width=CTV_REFUSED[1])
    try:
        ctv_build.build_ctv_banks(model, list(refused), detector, names,
                                  layer, reader=refused.__getitem__)
        raise SystemExit("16c a 360x480 video was not refused")
    except ValueError as e:
        line["refused"] = str(e)[:120]
    if marks:
        raise SystemExit("16c the detector ran on a refused video")

    # the npz through /explain, one request against a direct call
    npz = os.path.join(tmp, "ctv_banks.npz")
    np.savez(npz, **banks)
    args = argparse.Namespace(explain_checkpoint=ckpt, concept_banks=npz,
                              target_layer=layer, device=str(dev))
    server, handler = bserve.start_route_server(
        args, "explain", explain_decode=videos.__getitem__)
    try:
        port = server.server_address[1]
        _, ans = bserve.request(port, "explain", {"video": order[0],
                                                  "topK": 3}, timeout=600.0)
        levels = {lvl: (np.asarray(banks[f"{lvl}_matrix"], np.float32),
                        [str(n) for n in banks[f"{lvl}_names"]])
                  for lvl in ("symbolic", "cluster", "instance")}
        d = explain_direct(handler, order[0], levels)
    finally:
        bserve.stop_server(server, handler)
    served = {}
    for lvl, (_, lnames) in levels.items():
        s = d["concepts"][lvl]
        want = [lnames[i] for i in np.argsort(-s)[:3]]
        got = [item["concept"] for item in ans[f"{lvl}_top"]]
        err = max(abs(item["score"] - float(s[lnames.index(item["concept"])]))
                  for item in ans[f"{lvl}_top"])
        gaps = np.diff(np.sort(s)[::-1][:4])
        served[lvl] = {"top": got, "direct_top": want, "score_err": err,
                       "gaps_clear": bool(np.all(np.abs(gaps)
                                                 > EXPLAIN_MARGIN))}
        if err > EXPLAIN_MARGIN or (served[lvl]["gaps_clear"]
                                    and got != want):
            raise SystemExit(f"16c /explain's {lvl} concepts disagree")
    line["explain_route"] = {"prediction": ans["prediction"],
                             "levels": served}
    print(f"16c the banks served by /explain: {json.dumps(served)} "
          f"(scores within {EXPLAIN_MARGIN:g} of a direct concept_scores, "
          f"the top 3 equal where the gaps clear it)", flush=True)

    # 16d: explain_video with the real detector, card against CPU
    pipe = build_pipeline(with_reader(DEFAULT_PIPELINE, videos.__getitem__))
    decode = build_pipeline(with_reader(
        [c for c in DEFAULT_PIPELINE if c["type"] in ctv_build.DECODE_TYPES],
        videos.__getitem__))
    tail = build_pipeline([c for c in DEFAULT_PIPELINE
                           if c["type"] not in ctv_build.DECODE_TYPES])
    raw = np.stack(decode({"filename": order[0], "start_index": 0})["imgs"])
    clips = np.asarray(pipe({"filename": order[0], "start_index": 0})
                       ["imgs"], np.float32)

    def prep(clip):
        return np.asarray(tail({"imgs": list(clip), "clip_len": len(clip),
                                "num_clips": 1})["imgs"][0], np.float32)

    sym = {"symbolic": ConceptBank(*levels["symbolic"])}
    kw = dict(raw_frames_u8=raw, class_names=names, preprocess_fn=prep,
              min_frames=len(raw) - 1, topk=2)
    t0 = time.perf_counter()
    flash.launches = 0
    got = explain_video(model, clips, layer, sym, detector_fn=det_fn, **kw)
    ev_launches = flash.launches
    want = explain_video(cpu_model, clips, layer, sym,
                         detector_fn=ctv_build.make_detector_fn(det_cpu),
                         **kw)
    del cpu_model
    ev = {"concepts": got["detected_concepts"],
          "cosine_min": min(rows_cosine_min(got["video_ctvs"][c],
                                            want["video_ctvs"][c])
                            for c in want["video_ctvs"]),
          "flash_launches": ev_launches,
          "seconds": time.perf_counter() - t0}
    line["explain_video"] = ev
    print(f"16d explain_video with the detector, card vs CPU: "
          f"{json.dumps(ev)} (need the same concepts, cosine >= "
          f"{CTV_COS:g})", flush=True)
    if (got["detected_concepts"] != want["detected_concepts"]
            or not got["detected_concepts"] or ev["cosine_min"] < CTV_COS):
        raise SystemExit("16d explain_video disagrees with the CPU")
    del model
    torch.cuda.empty_cache()
    return line, total


def conv_flops(model, x) -> float:
    """Operations of one forward: 2 * MACs of every Conv2d, counted from
    the shapes by forward hooks."""
    import torch
    total = [0.0]

    def hook(mod, inp, out):
        total[0] += 2.0 * out.numel() * (mod.in_channels // mod.groups) \
            * mod.kernel_size[0] * mod.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()
    return total[0]


def detector_times(dev, card, det, x_u8) -> dict:
    """16e: the detector's forward at batch 16 (CUDA events), its TFLOP/s
    from the convolutions' shapes, the host's NMS in both protocols and
    the letterbox."""
    import torch
    from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
    from cross_modal_video_engine_tpu_torch.train.yolo_trainer import (
        letterbox)
    x = (torch.from_numpy(x_u8).float() / 255.0).to(dev)
    flops = conv_flops(det, x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def fwd():
        with torch.no_grad():
            return tyolo.decode_predictions(det(x), det.cfg)

    ms = cuda_ms(fwd, iters=YOLO_TIMED_CALLS)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    preds = fwd().cpu().numpy()
    nms = {}
    for name, (conf, iou, multi) in (("detect", (0.25, 0.45, False)),
                                     ("val", (0.001, 0.6, True))):
        t0 = time.perf_counter()
        for _ in range(3):
            tyolo.postprocess(preds, conf, iou, multi_label=multi)
        nms[name] = (time.perf_counter() - t0) / 3 / len(preds) * 1e3
    raw = seeded_images(4, 21)
    t0 = time.perf_counter()
    for im in raw:
        letterbox(im, det.cfg.img_size)
    out = {"batch": len(x_u8), "forward_ms": ms,
           "images_per_s": len(x_u8) / ms * 1e3,
           "gflop_per_image": flops / len(x_u8) / 1e9,
           "tflops": flops / ms / 1e9, "peak_mb": peak,
           "nms_ms_per_image": nms,
           "letterbox_ms": (time.perf_counter() - t0) / len(raw) * 1e3}
    print(f"16e detector times on {card}: {json.dumps(out)}", flush=True)
    return out


def check_concept_detector(dev, card) -> Tuple[dict, dict]:
    """Step 16 (a-f of the docstring).  Every failed check raises.
    Returns (the `concept_detector` JSON object, flash launches of the
    bank build)."""
    import torch
    from cross_modal_video_engine_tpu_torch.train.yolo_trainer import (
        letterbox)
    from cross_modal_video_engine_tpu_torch.utils.precision import no_tf32
    t_step = time.perf_counter()
    no_tf32()
    cfgs, sds, card_m, cpu_m = yolo_models(dev)
    line = {"card": card, "configs": {k: dataclass_fields(v)
                                      for k, v in cfgs.items()},
            "fire": list(YOLO_FIRE)}
    x_u8 = np.stack([letterbox(im, cfgs["detect"].img_size)[0]
                     for im in seeded_images(YOLO_BATCH, 15)])
    line["card_vs_cpu"] = detector_card_vs_cpu((card_m, cpu_m), cfgs,
                                               x_u8[:YOLO_CPU_BATCH])
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        line["yolo_val"] = yolo_val_card(dev, tmp, sds, cfgs,
                                         cpu_m["detect"])
        line["ctv_build"], flash = ctv_build_card(
            dev, card, tmp, card_m["detect"], cpu_m["detect"])
    line["times"] = detector_times(dev, card, card_m["detect"], x_u8)
    del card_m, cpu_m
    torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t_step
    print(f"16 concept detector checked in {line['seconds']:.1f} s",
          flush=True)
    return line, {"flash_attention": flash}


# -- 17. the caption transformer and the detector's training ----------------

# 17a: the default CaptionConfig over step 13's joint ViT-B/16 backbone
CAPTION17_CLIPS, CAPTION17_BEAM = 4, 4
# bf16 backbone, card against CPU on clip 0: teacher-forcing logits within
# this share of the largest CPU logit, and each position's logits at
# cosine CAPTION17_COS or more
CAPTION17_REL, CAPTION17_COS = 5e-2, 0.99
CAPTION17_TIMED = 3
# 17b-c: seeded splits; the shipped configs' batches give 2 steps an epoch
# (the loops' idle shares read the interval between them)
YOLO17_TRAIN, YOLO17_VAL, YOLO17_SEG_VAL = 32, 8, 4
YOLO17_EPOCHS = 2
YOLO17_CLS_CLASSES, YOLO17_CLS_PER_CLASS = 16, 8     # 128 images: 2 steps
YOLO17_STEP_BATCH = 2                   # one step, card against CPU
# f32 with TF32 off, card against CPU after one step: the loss within
# `loss` relative; each gradient and the velocity at cosine `cos` or
# more (not by the largest element: SPPF's max pools route the gradient
# of near-tied windows to another element on each side, which on a
# mosaic batch moves a few percent of a tensor's largest gradient at
# cosine 0.9999x; `worst_grads` prints them), each update and EMA move
# at `update_cos` (the warmup's bias lr carries that into the small
# BatchNorm biases); the BatchNorm statistics within `stats` of the
# tensor's largest magnitude
YOLO17_F32 = {"loss": 1e-4, "cos": 0.9999, "update_cos": 0.999,
              "stats": 1e-3}
# bf16 (f32 masters) against the CPU's f32 step: the loss within `loss`,
# the running statistics within `stats`, each group's update at cosine
# `cos` or more.  At batch 2 a bf16 step's update is far from the f32
# one in either package (the CPU's own bf16 update, printed beside the
# card's as the yardstick, sits at about 0.7-0.8 of its f32 update)
YOLO17_BF16 = {"loss": 5e-3, "stats": 5e-2, "cos": 0.5}
# a resumed epoch against the uninterrupted one on the card (cuDNN's
# backward may sum in another order: the CPU test holds them equal)
YOLO17_RESUME_REL = 1e-2
YOLO17_TIMED_STEPS = 3


def kernel_counters():
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer
    from cross_modal_video_engine_tpu_torch.ops import flash_attention
    return {"fused_attention_sublayer":
            attention_sublayer.fused_attention_sublayer,
            "fused_attention_sublayer_compact":
            attention_sublayer.fused_attention_sublayer_compact,
            "fused_mlp_sublayer": attention_sublayer.fused_mlp_sublayer,
            "fused_block_sublayer_compact":
            attention_sublayer.fused_block_sublayer_compact,
            "flash_attention": flash_attention.flash_attention}


def caption_transformer_model(dev):
    """Recognizer3DCaption on TS_JOINT with the default CaptionConfig,
    weights from numpy seeds: (model, state dict)."""
    from cross_modal_video_engine_tpu_torch.models import (
        caption_transformer as ct)
    from cross_modal_video_engine_tpu_torch.models.recognizer import (
        Recognizer3DCaption, random_state_dict)
    from cross_modal_video_engine_tpu_torch.models.timesformer import (
        TimeSformerConfig)
    bcfg = TimeSformerConfig(**TS_JOINT)
    ccfg = ct.CaptionConfig(enc_dim=bcfg.embed_dims)
    sd = {k: v for k, v in random_state_dict(bcfg, seed=17,
                                             num_classes=1).items()
          if k.startswith("backbone.")}
    sd.update({f"caption_head.{k}": v
               for k, v in ct.random_state_dict(ccfg, 18).items()})
    model = Recognizer3DCaption(bcfg, ccfg, device=dev)
    model.load_state_dict(sd)
    return model, sd


def check_caption_transformer(dev, card) -> Tuple[dict, int]:
    """17a.  Returns (the line, flash launches of the two generates)."""
    import torch
    from cross_modal_video_engine_tpu_torch.models.recognizer import (
        Recognizer3DCaption)
    flash = _flash()
    t0 = time.perf_counter()
    model, sd = caption_transformer_model(dev)
    ccfg = model.caption_head.cfg
    layers = model.backbone.cfg.num_layers
    rng = np.random.default_rng(17)
    n = CAPTION17_CLIPS
    clips = normalised_clips(rng, n, dev)
    ids = np.concatenate([np.full((n, 1), ccfg.bos_id),
                          rng.integers(3, ccfg.vocab_size,
                                       (n, ccfg.max_len - 1))], 1)
    ids = torch.from_numpy(ids).to(dev)
    arms = {"teacher": lambda: model(clips, ids),
            "greedy": lambda: model.generate(clips, "greedy"),
            "beam": lambda: model.generate(clips, "beam", CAPTION17_BEAM)}
    out, launches = {}, {}
    with torch.no_grad():
        for name, fn in arms.items():
            torch.cuda.synchronize()
            flash.launches = 0
            out[name] = fn()
            torch.cuda.synchronize()
            launches[name] = flash.launches
    cpu = Recognizer3DCaption(model.backbone.cfg, ccfg, device="cpu")
    cpu.load_state_dict(sd)
    c0 = clips[:1].cpu()
    with torch.no_grad():
        want = {"teacher": cpu(c0, ids[:1].cpu()),
                "greedy": cpu.generate(c0, "greedy"),
                "beam": cpu.generate(c0, "beam", CAPTION17_BEAM)}
    del cpu
    got_logits = out["teacher"][:1].float().cpu()
    scale = float(want["teacher"].abs().max())
    rel = float((got_logits - want["teacher"]).abs().max()) / scale
    step0 = float((got_logits[:, 0] - want["teacher"][:, 0]).abs().max()
                  ) / scale
    cos = cosine_min(got_logits, want["teacher"])
    divergences = {k: int((out[k][0][:1].cpu() != want[k][0]).sum())
                   for k in ("greedy", "beam")}
    first = {k: bool(out[k][0][0, 0].cpu() == want[k][0][0, 0])
             for k in ("greedy", "beam")}
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: model._enc_tokens(clips),
                         iters=CAPTION17_TIMED, warmup=1)
        greedy_ms = cuda_ms(arms["greedy"], iters=CAPTION17_TIMED, warmup=1)
        beam_ms = cuda_ms(arms["beam"], iters=CAPTION17_TIMED, warmup=1)
    line = {"card": card, "clips": n, "beam_width": CAPTION17_BEAM,
            "caption_config": dataclass_fields(ccfg),
            "flash_launches": launches,
            "card_vs_cpu": {"logits_rel_err": rel, "step0_rel_err": step0,
                            "logits_min_cosine": cos,
                            "token_divergences_of_24": divergences,
                            "first_token_equal": first},
            "ms": {"encoder": enc_ms, "generate_greedy": greedy_ms,
                   "generate_beam4": beam_ms},
            "captions_per_s": {"greedy": n / greedy_ms * 1e3,
                               "beam4": n / beam_ms * 1e3},
            "seconds": time.perf_counter() - t0}
    print(f"17a caption transformer (ViT-B/16 joint bf16 + CaptionConfig(), "
          f"{n} clips): flash launches {launches} (need {layers} each); "
          f"card vs CPU on clip 0: logits rel err {rel:.3e} (step 0 "
          f"{step0:.3e}; tol {CAPTION17_REL:g}), min cosine {cos:.6f}; "
          f"token divergences of {ccfg.max_len}: {divergences} (reported); "
          f"generate greedy {greedy_ms:.2f} ms, beam {CAPTION17_BEAM} "
          f"{beam_ms:.2f} ms, encoder {enc_ms:.2f} ms ({card})", flush=True)
    v = ccfg.vocab_size
    checks = {
        "shapes": (tuple(out["teacher"].shape) == (n, ccfg.max_len, v)
                   and tuple(out["greedy"][0].shape) == (n, ccfg.max_len)
                   and tuple(out["beam"][0].shape) == (n, ccfg.max_len)),
        "finite": all(bool(torch.isfinite(t).all()) for t in (
            out["teacher"], out["greedy"][1], out["beam"][1])),
        "ids in vocab": all(bool(((o[0] >= 0) & (o[0] < v)).all())
                            for o in (out["greedy"], out["beam"])),
        "flash launches": all(c == layers for c in launches.values()),
        "logits vs CPU": rel <= CAPTION17_REL and cos >= CAPTION17_COS,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"17a caption transformer checks failed: {failed}")
    del model, clips
    torch.cuda.empty_cache()
    return line, launches["greedy"] + launches["beam"]


def write_yolo_split(root: str, n: int, seed: int, seg: bool) -> Tuple[str,
                                                                       str]:
    """n seeded 480x640 `.npy` images with 1-6 boxes each (normalized
    `cls cx cy w h`, 80 classes), or for the segment head a polygon per
    instance."""
    rng = np.random.default_rng(seed)
    img_dir, lab_dir = (os.path.join(root, d) for d in ("images", "labels"))
    os.makedirs(img_dir)
    os.makedirs(lab_dir)
    for i, img in enumerate(seeded_images(n, seed)):
        np.save(os.path.join(img_dir, f"{i:04d}.npy"), img)
        rows = []
        for _ in range(int(rng.integers(1, 7))):
            cls = int(rng.integers(0, 80))
            c = rng.uniform(0.2, 0.8, 2)
            if seg:
                r = rng.uniform(0.05, 0.2)
                a = np.sort(rng.uniform(0, 2 * np.pi,
                                        int(rng.integers(5, 12))))
                p = (c + r * np.stack([np.cos(a), np.sin(a)], 1)).clip(
                    0.01, 0.99)
                vals = p.ravel()
            else:
                vals = (*c, *rng.uniform(0.05, 0.5, 2))
            rows.append(" ".join([str(cls)] + [f"{v:.6f}" for v in vals]))
        with open(os.path.join(lab_dir, f"{i:04d}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return img_dir, lab_dir


def write_image_folder(root: str, classes: int, per: int, seed: int) -> str:
    for c in range(classes):
        d = os.path.join(root, f"c{c:03d}")
        os.makedirs(d)
        for i, img in enumerate(seeded_images(per, seed + c, (256, 320))):
            np.save(os.path.join(d, f"{i}.npy"), img)
    return root


def _rel_err(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-12)


def _one_step(where, kind: str, model_fn, batch, bf16: bool):
    """One train step of a fresh model (the training init, seed 0) on
    `where`: (loss, gradients, the state's tensors, the params before)."""
    import torch
    from cross_modal_video_engine_tpu_torch.losses.yolo import YoloHyp
    from cross_modal_video_engine_tpu_torch.train import yolo_trainer as yt
    opt = yt.YoloOptHyp()
    sched = yt.lr_momentum_at(50, 5, 10, 3, opt)
    model = model_fn(where)
    state = yt.init_yolo_train_state(model, seed=0)
    p0 = {k: v.detach().clone().cpu() for k, v in model.state_dict().items()}
    if kind == "classify":
        step = yt.make_yolo_cls_train_step(model, opt, 5e-5, bf16=bf16,
                                           device=where)
        state, logs = step(state, *(t.to(where) for t in batch), *sched)
    else:
        step = yt.make_yolo_train_step(model, YoloHyp(), opt,
                                       yt.scaled_weight_decay(opt, 2),
                                       bf16=bf16, device=where)
        images, targets, valid, *gt = (t.to(where) for t in batch)
        extra = {"gt_masks": gt[0]} if gt else {}
        state, logs = step(state, images, targets, valid, *sched, **extra)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    tensors = {part: {k: v.detach().cpu() for k, v in d.items()}
               for part, d in yt.state_tensors(state).items()}
    return float(logs["loss"]), grads, tensors, p0, yt.param_groups(model)


def _cos(a, b) -> float:
    import torch
    a, b = a.double().ravel(), b.double().ravel()
    if not a.any() and not b.any():
        return 1.0
    return float(torch.nn.functional.cosine_similarity(a, b, 0))


def _moves(tensors, p0) -> dict:
    """Each parameter's update and EMA move (new - old), and velocity."""
    return {"params": {k: v - p0[k] for k, v in tensors["params"].items()},
            "ema_params": {k: v - p0[k]
                           for k, v in tensors["ema_params"].items()},
            "vel": tensors["vel"]}


def yolo_steps_card_vs_cpu(dev, kind: str, model_fn, batch,
                           with_bf16: bool = False) -> dict:
    """One step from the training init on the card and on the CPU on the
    same batch.  f32 (YOLO17_F32): the loss; each gradient, velocity,
    update and EMA move by cosine (the worst three gradients by their
    largest element also reported); the BatchNorm statistics by the
    tensor's largest magnitude.  bf16 (YOLO17_BF16), against the CPU's
    f32 step: the loss, the statistics, each group's update by cosine,
    with the CPU's own bf16 step beside it as the yardstick."""
    import torch
    card = _one_step(dev, kind, model_fn, batch, False)
    cpu = _one_step(torch.device("cpu"), kind, model_fn, batch, False)
    (lc, gc, sc, p0, groups), (lp, gp, sp, _, _) = card, cpu
    per = sorted((_rel_err(gc[k], gp[k]), k) for k in gp)
    f32 = {"loss_card": lc, "loss_cpu": lp,
           "loss_rel_err": abs(lc - lp) / abs(lp),
           "grad_min_cosine": min(_cos(gc[k], gp[k]) for k in gp),
           "worst_grads": [{"name": k, "rel_err": e,
                            "cosine": _cos(gc[k], gp[k])}
                           for e, k in per[-3:]]}
    mc, mp = _moves(sc, p0), _moves(sp, p0)
    f32["state_min_cosine"] = {part: min(_cos(v, mp[part][k])
                                         for k, v in mc[part].items())
                               for part in mc}
    f32["stats_rel_err"] = max(_rel_err(v, sp[part][k])
                               for part in ("batch_stats", "ema_stats")
                               for k, v in sc[part].items())
    cos = f32["state_min_cosine"]
    f32["ok"] = (f32["loss_rel_err"] <= YOLO17_F32["loss"]
                 and min(f32["grad_min_cosine"], cos["vel"])
                 >= YOLO17_F32["cos"]
                 and min(cos["params"], cos["ema_params"])
                 >= YOLO17_F32["update_cos"]
                 and f32["stats_rel_err"] <= YOLO17_F32["stats"])
    out = {"f32": f32}
    if with_bf16:
        ref = _moves(sp, p0)["params"]

        def group_cos(moves):
            return {g: _cos(torch.cat([moves[k].ravel() for k in groups
                                       if groups[k] == g]),
                            torch.cat([ref[k].ravel() for k in groups
                                       if groups[k] == g]))
                    for g in (0, 1, 2)}

        lb, _, sb, _, _ = _one_step(dev, kind, model_fn, batch, True)
        lq, _, sq, _, _ = _one_step(torch.device("cpu"), kind, model_fn,
                                    batch, True)
        bf16 = {"loss_card": lb, "loss_cpu_f32": lp, "loss_cpu_bf16": lq,
                "loss_rel_err": abs(lb - lp) / abs(lp),
                "stats_rel_err": max(_rel_err(v, sp["batch_stats"][k])
                                     for k, v in sb["batch_stats"].items()),
                "update_cosine_vs_cpu_f32": group_cos(
                    _moves(sb, p0)["params"]),
                "cpu_bf16_update_cosine_vs_cpu_f32": group_cos(
                    _moves(sq, p0)["params"]),
                "dtypes_f32": all(v.dtype == torch.float32
                                  for part in sb.values()
                                  for v in part.values())}
        bf16["ok"] = (bf16["loss_rel_err"] <= YOLO17_BF16["loss"]
                      and bf16["dtypes_f32"]
                      and bf16["stats_rel_err"] <= YOLO17_BF16["stats"]
                      and min(bf16["update_cosine_vs_cpu_f32"].values())
                      >= YOLO17_BF16["cos"])
        out["bf16"] = bf16
    return out


class StepLog:
    """on_step hook of the trainers: host seconds of each step (the loss
    read, so the card has finished) and the clock between steps."""

    def __init__(self):
        self.rows = []

    def __call__(self, epoch, bi, state, logs, seconds):
        self.rows.append((epoch, bi, seconds, time.perf_counter()))

    def shares(self, step_device_s: float) -> dict:
        """Over consecutive steps of one epoch: the interval (the next
        batch's augmentation and assembly plus the step), the host's step
        share and the card's idle share (1 - the step's device time by
        CUDA events over the interval)."""
        gaps = [(b[3] - a[3], b[2]) for a, b in zip(self.rows, self.rows[1:])
                if a[0] == b[0]]
        if not gaps:
            return {}
        interval = sum(g for g, _ in gaps) / len(gaps)
        host = sum(s for _, s in gaps) / len(gaps)
        return {"interval_ms": interval * 1e3, "host_step_ms": host * 1e3,
                "assembly_ms": (interval - host) * 1e3,
                "idle_share": max(0.0, 1.0 - step_device_s / interval)}


def _quiet_call(fn, *args, **kw):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _history(hist) -> list:
    return [{k: float(v) if isinstance(v, (float, np.floating)) else v
             for k, v in r.items()} for r in hist]


def detection_training(dev, card, tmp) -> Tuple[dict, dict]:
    """17b.  Returns (line, the kernel counters over the trainer's run)."""
    import shutil
    import torch
    from cross_modal_video_engine_tpu_torch.cli import (ctv_build, yolo_train,
                                                        yolo_val)
    from cross_modal_video_engine_tpu_torch.config import Config
    from cross_modal_video_engine_tpu_torch.data.yolo_aug import YoloAugHyp
    from cross_modal_video_engine_tpu_torch.models.yolo import YoloV5
    tr = write_yolo_split(os.path.join(tmp, "det_train"), YOLO17_TRAIN, 171,
                          False)
    va = write_yolo_split(os.path.join(tmp, "det_val"), YOLO17_VAL, 172,
                          False)
    options = [f"data.train.img_dir={tr[0]}", f"data.train.label_dir={tr[1]}",
               f"data.val.img_dir={va[0]}", f"data.val.label_dir={va[1]}"]
    cfg = Config.fromfile(str(YOLO_DETECT_CONFIG)).merge_from_options(options)
    shipped = {k: cfg.get(k) for k in ("bf16", "data.batch_size",
                                       "model.img_size", "aug.mosaic",
                                       "aug.hsv_s")}
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    work = os.path.join(tmp, "det_work")
    log = StepLog()
    t0 = time.perf_counter()
    (state, hist), printed = _quiet_call(
        yolo_train.train_from_config, cfg, work, num_epochs=YOLO17_EPOCHS,
        device=dev, on_step=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    anchors_changed = '"autoanchor"' in printed
    # a resumed epoch 1 against the uninterrupted one
    rw = os.path.join(tmp, "det_resumed")
    shutil.copytree(os.path.join(work, "epoch_0"),
                    os.path.join(rw, "epoch_0"))
    (resumed, rhist), _ = _quiet_call(
        yolo_train.train_from_config, cfg, rw,
        resume=os.path.join(rw, "epoch_0"), num_epochs=YOLO17_EPOCHS,
        device=dev)
    resume_loss = abs(rhist[0]["loss"] - hist[1]["loss"]) / abs(
        hist[1]["loss"])
    resume_ema = max(_rel_err(a, b) for a, b in zip(
        resumed.ema.state_dict().values(), state.ema.state_dict().values())
        if a.is_floating_point())
    # best/ read by yolo_val and by ctv_build's loader
    best = os.path.join(work, "best")
    with open(os.path.join(best, "loop_state.json")) as f:
        best_epoch = json.load(f)["epoch"]
    report, _ = _quiet_call(yolo_val.main, [
        str(YOLO_DETECT_CONFIG), "--checkpoint", best, "--device",
        str(dev), "--cfg-options", *options])
    ctv_det = ctv_build.load_detector_checkpoint(best, dev)
    val_det = yolo_val.load_detector(cfg, best, dev)
    same = all(torch.equal(a, b) for a, b in zip(
        ctv_det.state_dict().values(), val_det.state_dict().values()))
    dets = ctv_build.make_detector_fn(ctv_det)(
        seeded_images(2, 173, (352, 480)))
    del ctv_det, val_det
    # one step, card against CPU, at batch 2 on one augmented batch
    ds = yolo_train.YoloDetectionDataset(*tr)
    batch = next(yolo_train.yolo_batches(
        ds, YOLO17_STEP_BATCH, cfg["model.img_size"],
        cfg["data.max_targets"], YoloAugHyp(**cfg["aug"]),
        np.random.RandomState(7), order=[0, 1]))[:3]
    mcfg = state.model.cfg
    steps = yolo_steps_card_vs_cpu(dev, "detect",
                                   lambda d: YoloV5(mcfg, device=d), batch,
                                   with_bf16=True)
    f32, bf16 = steps["f32"], steps["bf16"]
    line = {"config": str(YOLO_DETECT_CONFIG.relative_to(ROOT)),
            "shipped": shipped, "train_images": YOLO17_TRAIN,
            "val_images": YOLO17_VAL, "epochs": YOLO17_EPOCHS,
            "history": _history(hist), "anchors_changed": anchors_changed,
            "anchors": [list(map(list, l)) for l in mcfg.anchors],
            "wall_s": wall, "kernel_launches": launches,
            "resume": {"loss_rel_err": resume_loss,
                       "ema_rel_err": resume_ema},
            "best_epoch": best_epoch, "yolo_val": report,
            "ctv_build_reads_best": same,
            "ctv_detector_boxes": [len(d) for d in dets],
            "step_card_vs_cpu": steps,
            "steps": log}
    finite = all(np.isfinite(r["loss"]) for r in hist)
    checks = {
        "losses finite": finite,
        "no kernel launched": not any(launches.values()),
        "resumed epoch": (resume_loss <= YOLO17_RESUME_REL
                          and resume_ema <= YOLO17_RESUME_REL),
        "yolo_val reads best/": abs(report["map"]
                                    - hist[best_epoch]["map"]) <= 1e-6,
        "ctv_build reads best/": same,
        "f32 step vs CPU": f32["ok"], "bf16 step vs CPU": bf16["ok"],
    }
    print(f"17b detection training ({line['config']}: yolov5s 640, batch "
          f"{shipped['data.batch_size']}, bf16 {shipped['bf16']}): "
          f"{YOLO17_EPOCHS} epochs of {YOLO17_TRAIN // 16} steps in "
          f"{wall:.1f} s, losses {[round(r['loss'], 5) for r in hist]}, "
          f"AutoAnchor changed {anchors_changed}; resume: loss rel err "
          f"{resume_loss:.2e}, EMA rel err {resume_ema:.2e}; best/ (epoch "
          f"{best_epoch}) yolo_val mAP {report['map']:.4f} vs "
          f"{hist[best_epoch]['map']:.4f}; card vs CPU f32 step: loss "
          f"{f32['loss_rel_err']:.2e}, gradient min cosine "
          f"{f32['grad_min_cosine']:.6f}, state {f32['state_min_cosine']}, "
          f"stats {f32['stats_rel_err']:.2e}; bf16 step vs CPU f32: loss "
          f"{bf16['loss_rel_err']:.2e}, stats {bf16['stats_rel_err']:.2e}, "
          f"update cosines {bf16['update_cosine_vs_cpu_f32']} (the CPU's "
          f"bf16: {bf16['cpu_bf16_update_cosine_vs_cpu_f32']})", flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"17b detection training checks failed: {failed}")
    return line, launches


def segment_and_classify_training(dev, card, tmp) -> dict:
    """17c: two steps each of the shipped segment and classify configs
    through their train_from_config, and one step of each card against
    CPU."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import (yolo_cls_train,
                                                        yolo_train)
    from cross_modal_video_engine_tpu_torch.config import Config
    from cross_modal_video_engine_tpu_torch.data.yolo_aug import YoloAugHyp
    from cross_modal_video_engine_tpu_torch.models.yolo import (
        YoloClassifier, YoloV5)
    line = {}
    tr = write_yolo_split(os.path.join(tmp, "seg_train"), YOLO17_TRAIN, 174,
                          True)
    va = write_yolo_split(os.path.join(tmp, "seg_val"), YOLO17_SEG_VAL, 175,
                          True)
    options = [f"data.train.img_dir={tr[0]}", f"data.train.label_dir={tr[1]}",
               f"data.val.img_dir={va[0]}", f"data.val.label_dir={va[1]}"]
    cfg = Config.fromfile(str(YOLO_SEGMENT_CONFIG)).merge_from_options(
        options)
    seg_log = StepLog()
    t0 = time.perf_counter()
    (state, hist), _ = _quiet_call(
        yolo_train.train_from_config, cfg, os.path.join(tmp, "seg_work"),
        num_epochs=1, device=dev, on_step=seg_log)
    seg_wall = time.perf_counter() - t0
    ds = yolo_train.YoloSegDataset(*tr)
    batch = next(yolo_train.yolo_seg_batches(
        ds, YOLO17_STEP_BATCH, cfg["model.img_size"],
        cfg["data.max_targets"], cfg["data.mask_ratio"],
        YoloAugHyp(**cfg["aug"]), np.random.RandomState(8), order=[0, 1]))
    batch = batch[:4]
    mcfg = state.model.cfg
    seg_f32 = yolo_steps_card_vs_cpu(dev, "segment",
                                     lambda d: YoloV5(mcfg, device=d),
                                     batch)["f32"]
    line["segment"] = {"config": str(YOLO_SEGMENT_CONFIG.relative_to(ROOT)),
                       "masks": mcfg.masks, "protos": mcfg.protos,
                       "history": _history(hist), "wall_s": seg_wall,
                       "step_card_vs_cpu": {"f32": seg_f32},
                       "steps": seg_log}
    del state
    folder = write_image_folder(os.path.join(tmp, "cls_train"),
                                YOLO17_CLS_CLASSES, YOLO17_CLS_PER_CLASS,
                                176)
    val = write_image_folder(os.path.join(tmp, "cls_val"),
                             YOLO17_CLS_CLASSES, 1, 500)
    cfg = Config.fromfile(str(YOLO_CLASSIFY_CONFIG)).merge_from_options(
        [f"data.train_dir={folder}", f"data.val_dir={val}"])
    cls_log = StepLog()
    t0 = time.perf_counter()
    (state, chist), _ = _quiet_call(
        yolo_cls_train.train_from_config, cfg, os.path.join(tmp, "cls_work"),
        num_epochs=1, device=dev, on_step=cls_log)
    cls_wall = time.perf_counter() - t0
    ds = yolo_cls_train.ImageFolderDataset(folder)
    images, labels, _ = next(yolo_cls_train.cls_batches(
        ds, YOLO17_STEP_BATCH, cfg["model.img_size"], True,
        np.random.RandomState(9), order=[0, 8]))
    ccfg = state.model.cfg
    cls_f32 = yolo_steps_card_vs_cpu(
        dev, "classify", lambda d: YoloClassifier(ccfg, device=d),
        (images, labels))["f32"]
    line["classify"] = {"config": str(YOLO_CLASSIFY_CONFIG.relative_to(ROOT)),
                        "num_classes": ccfg.num_classes,
                        "batch": cfg["data.batch_size"],
                        "history": _history(chist), "wall_s": cls_wall,
                        "step_card_vs_cpu": {"f32": cls_f32},
                        "steps": cls_log}
    steps = (len(seg_log.rows), len(cls_log.rows))
    print(f"17c segment training: {steps[0]} steps in {seg_wall:.1f} s, "
          f"loss {hist[0]['loss']:.5f}, card vs CPU f32 step: loss "
          f"{seg_f32['loss_rel_err']:.2e}, gradient min cosine "
          f"{seg_f32['grad_min_cosine']:.6f}; classify training "
          f"({ccfg.num_classes} classes, batch {cfg['data.batch_size']}): "
          f"{steps[1]} steps in {cls_wall:.1f} s, loss "
          f"{chist[0]['loss']:.5f}, card vs CPU f32 step: loss "
          f"{cls_f32['loss_rel_err']:.2e}, gradient min cosine "
          f"{cls_f32['grad_min_cosine']:.6f}", flush=True)
    checks = {"steps": steps == (YOLO17_TRAIN // 16,
                                 YOLO17_CLS_CLASSES * YOLO17_CLS_PER_CLASS
                                 // 64),
              "finite": all(np.isfinite(h[0]["loss"]) for h in (hist, chist)),
              "segment step vs CPU": seg_f32["ok"],
              "classify step vs CPU": cls_f32["ok"]}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"17c checks failed: {failed}")
    return line


def cls_step_seconds(dev, steps: int = YOLO17_TIMED_STEPS) -> float:
    """Device seconds of one bf16 train step of the shipped classifier
    (yolov5s-cls, 1000 classes, 224²) at batch 64, by CUDA events."""
    import torch
    from cross_modal_video_engine_tpu_torch.models.yolo import (
        YoloClassifier, YoloConfig)
    from cross_modal_video_engine_tpu_torch.train import yolo_trainer as yt
    from cross_modal_video_engine_tpu_torch.utils.profiling import (
        device_time)
    model = YoloClassifier(YoloConfig(num_classes=1000, depth_multiple=0.33,
                                      width_multiple=0.50, img_size=224),
                           device=dev)
    state = [yt.init_yolo_train_state(model, seed=0)]
    step = yt.make_yolo_cls_train_step(model, yt.YoloOptHyp(lr0=0.001), 5e-5,
                                       bf16=True, device=dev)
    rng = np.random.default_rng(10)
    images = torch.from_numpy(rng.standard_normal(
        (64, 224, 224, 3), dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 1000, 64)).to(dev)

    def run():
        state[0], _ = step(state[0], images, labels, 0.001, 0.001, 0.9)

    return device_time(run, steps=steps, device=dev)


def yolo_training_times(dev, card, det_line, more) -> dict:
    """17d: step ms and images/s of the three trainers (bench/extra.py's
    rows for the detector and segmenter, CUDA events), and each loop's
    idle share."""
    from cross_modal_video_engine_tpu_torch.bench import extra
    rows = {}
    for name, fn in (("detect", extra.bench_train_step_yolov5),
                     ("segment", extra.bench_train_step_yolov5_seg)):
        row, _ = _quiet_call(fn, device=dev, steps=YOLO17_TIMED_STEPS)
        rows[name] = {"step_ms": row["step_ms"], "images_per_s": row["value"],
                      "batch": 16}
    cls_s = cls_step_seconds(dev)
    rows["classify"] = {"step_ms": cls_s * 1e3, "images_per_s": 64 / cls_s,
                        "batch": 64}
    logs = {"detect": det_line["steps"], "segment": more["segment"]["steps"],
            "classify": more["classify"]["steps"]}
    for name, log in logs.items():
        rows[name]["loop"] = log.shares(rows[name]["step_ms"] / 1e3)
    print("17d trainers (bf16, f32 masters; " + card + "): " + "; ".join(
        f"{k} step {v['step_ms']:.2f} ms, {v['images_per_s']:.1f} images/s "
        f"(batch {v['batch']}), loop idle share "
        f"{v['loop'].get('idle_share', float('nan')):.3f}"
        for k, v in rows.items()), flush=True)
    return rows


def check_yolo_training(dev, card) -> Tuple[dict, dict]:
    """Step 17b-d.  Returns (the `yolo_training` line, the kernel counters
    over the detection trainer's run)."""
    import torch
    t_step = time.perf_counter()
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        det, launches = detection_training(dev, card, tmp)
        torch.cuda.empty_cache()
        more = segment_and_classify_training(dev, card, tmp)
    torch.cuda.empty_cache()
    times = yolo_training_times(dev, card, det, more)
    for part in (det, more["segment"], more["classify"]):
        part["steps"] = [list(r) for r in part["steps"].rows]
    line = {"card": card, "detect": det, **more, "times": times,
            "seconds": time.perf_counter() - t_step}
    return line, launches


def check_step17(dev, card) -> Tuple[dict, int]:
    """Step 17 (a-d).  Returns (the `caption_transformer_and_yolo_training`
    JSON object, flash launches of the caption transformer's generates)."""
    t0 = time.perf_counter()
    caption, launches = check_caption_transformer(dev, card)
    training, det_launches = check_yolo_training(dev, card)
    line = {"caption_transformer": caption, "yolo_training": training,
            "detector_training_launches": det_launches,
            "seconds": time.perf_counter() - t0}
    print(f"17 caption transformer and detector training checked in "
          f"{line['seconds']:.1f} s", flush=True)
    return line, launches


# -- step 18: the 3D-CNN recognizers -----------------------------------------
CNN_CONFIGS = ROOT / "configs" / "recognition"
# 18a: each shipped 3D-CNN recipe at full width, 400 classes, its own clip
# length at 224²; weights: the training init (models/recognizer.
# conv_init_state_dict, numpy seed 0)
CNN18 = {"slowonly_r50_8x8": "slowonly_r50_8x8_k400.py",
         "i3d_r50_32x2": "i3d_r50_32x2_k400.py",
         "i3d_nl_r50_32x2": "i3d_nl_embedded_r50_32x2_k400.py",
         "csn_r50_ir": "csn_r50_k400.py",
         "slowfast_r50_4x16_s2d": "slowfast_r50_4x16_k400.py",
         "x3d_m": "x3d_m_k400.py"}
# card vs CPU at batch 1, f32, TF32 off: logits within CNN18_REL of the
# largest and cosine >= CNN18_COS; forwards timed at CNN18_BATCH
CNN18_REL, CNN18_COS, CNN18_BATCH, CNN18_TIMED = 1e-3, 0.999, 8, 3
CNN18_SIZE = 224
SLOWFAST18_CONFIG = CNN_CONFIGS / "slowfast_r50_4x16_k400.py"
I3D_RELSEQ_CONFIG = ROOT / "configs" / "seq_generate" / "i3d_relseq.py"
# 18b/c: a seeded collection of TRAIN18_VIDEOS (validation: the first
# TRAIN18_VAL), batch TRAIN18_BATCH as the configs say; the card-vs-CPU
# steps at TRAIN18_CPU_BATCH; the bench row at TRAIN18_BIG (halved until it
# fits); the shipped step timed over 4 steps and its loop profiled over 1;
# the CLIs of steps 18-20 train one step an epoch on the 8 videos, for the
# script's time
TRAIN18_VIDEOS, TRAIN18_VAL, TRAIN18_BATCH, TRAIN18_CPU_BATCH = 8, 8, 8, 1
TRAIN18_BIG, TRAIN18_TIMED, TRAIN18_PROFILED = 16, 4, 1
TRAIN18_STEP_HW = 112
# one step card vs CPU at full width, from the CLI's epoch_1 state (2
# steps on; the training init's steps are 19b's), head dropout 0.
# float64 on both devices is the witness: every gradient and running statistic within
# STEP18_F64 of its tensor's largest (the same arithmetic; a gradient that
# is zero but for rounding, of its STEP18_F64_FLOOR share of the model's
# largest gradient), and the
# truth the f32 and bf16 steps are held to.  The CPU tests' bounds
# against JAX (STEP18_TESTS) hold wherever f32 or bf16 arithmetic meets
# them; on these videos it misses them at the init (train-mode
# BatchNorm's backward cancels: the f32 gradients of the stems, the
# first blocks and the deep slow-path convs lie percents of their
# tensors' largest from float64 on either device, the bf16 ones at group
# cosines 0.26-0.35), and per tensor from epoch_1 too, where the two
# devices' summation orders leave some tensors four times farther from
# float64 on one device than on the other.  So the card is held to float64 as
# closely as the CPU is, where the two are compared in aggregate, and
# to the CPU tests' bounds where the CPU meets them:
# - f32: the loss within STEP18_LOSS; the whole gradient's 1 - cosine
#   to float64 within 1 - STEP18_TESTS["grad_cos"] or STEP18_ACC times
#   the CPU's (+ STEP18_FLOOR); by group (convs, BatchNorms, head) the
#   L2 error from float64 within STEP18_TESTS["grad"] of the group's
#   norm or STEP18_ACC times the CPU's;
# - bf16: the loss within BF16_LOSS_REL; by group, 1 - cosine to
#   float64 within 1 - BF16_GRAD_COS or STEP18_ACC times the CPU's (the
#   cosine card vs CPU is a reading: two steps each 0.99 from float64
#   may lie 0.98 from each other);
# - both, each tensor: where the CPU's cosine to float64 is STEP18_SIGNAL
#   times a random direction's (1/sqrt(size)), the card keeps
#   STEP18_AGREE of it; where the CPU's L2 error is within
#   STEP18_GROSS[0] of the tensor's norm, the card's is within
#   STEP18_GROSS[1] (a zero, negated, doubled or random gradient fails
#   either).  "The CPU's" is the worse of two CPU runs, at torch's
#   thread count and at half of it (two summation orders): a tensor
#   whose f32 gradient moves by more than STEP18_GROSS[0] of its norm
#   with the CPU's thread count is not fixed by f32 arithmetic, and no
#   device can be held to it alone (TIN's offset and weight nets at the
#   training init lie from percents to several times their norm from
#   float64, by summation order, on either device:
#   `bench/step_orders.py` reads it); the groups and the whole gradient
#   hold it, their bounds set by the worse of the two CPU runs too;
# - both: the card's parameters moved by the optimizer's update of its
#   own gradients, lr (clip(g) + wd p), within STEP18_UPDATE of each
#   tensor's largest update plus STEP18_ULP of its largest parameter
#   (the new parameters' f32 rounding); the running statistics within
#   STEP18_STATS of each tensor's largest from the CPU's (f32), or from
#   float64 within STEP18_ACC times the CPU's distance + STEP18_STATS
#   (bf16).
# Each run plants faults in the card's results (zero, random and
# negated gradients, unmoved parameters, statistics left where they
# were) and fails unless the check refuses every one; it also counts the
# tensors in which one zeroed, negated or doubled gradient is refused.
# The CPU tests' bounds card vs CPU (whole-gradient cosine, each
# tensor's gradient, parameter and statistic within a share of its
# largest) are printed beside the verdict as readings.
STEP18_F64, STEP18_LOSS, STEP18_ACC, STEP18_FLOOR = 1e-9, 1e-5, 2.0, 1e-6
STEP18_F64_FLOOR = 1e-6
STEP18_UPDATE, STEP18_ULP, STEP18_STATS = 1e-3, 4e-7, 1e-4
STEP18_AGREE, STEP18_SIGNAL, STEP18_GROSS = 0.5, 10.0, (0.125, 0.5)
STEP18_TESTS = {"grad_cos": 0.9999, "grad": 1e-3, "param": 1e-5,
                "stats": 1e-5}
# the served answers against caption_clips: f32, so only a label within
# CAPTION18_BAND of the threshold may differ (the decoder of a model two
# steps from its init puts its probabilities near 0.5)
CAPTION18_SINGLE, CAPTION18_BURST, CAPTION18_BAND = 4, 8, 1e-4


def _step_clips(cfg, videos, names) -> np.ndarray:
    """The first clip of each named seeded video through the config's
    pipeline, its frame sampler in test mode: fixed frame offsets, so the
    card-vs-CPU steps check the same frames in every run (the training
    sampler draws its offsets from an unseeded generator)."""
    from cross_modal_video_engine_tpu_torch.data.pipelines import (
        build_pipeline, with_reader)
    ops = [dict(op, test_mode=True) if op["type"] == "SampleFrames" else op
           for op in cfg["data.pipeline"]]
    pipe = build_pipeline(with_reader(ops, videos.__getitem__))
    return np.stack([pipe({"filename": n, "start_index": 0})["imgs"][0]
                     for n in names]).astype(np.float32)


def _clip_len(cfg) -> int:
    return next(c for c in cfg["data.pipeline"]
                if c["type"] == "SampleFrames")["clip_len"]


def _max_rel(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return err / scale if scale else (0.0 if err == 0 else float("inf"))


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = float(a.norm()), float(b.norm())
    return 1.0 if na == nb == 0 else float(a @ b / (na * nb + 1e-300))


def cnn_forwards(dev, card) -> dict:
    """18a: each shipped 3D-CNN at full width, card vs CPU at batch 1 (f32,
    TF32 off), then its forward at batch 8 in f32 and in bf16 (ms by CUDA
    events, TFLOP/s of its products, peak memory), and the SlowFast fast
    pathway's s2d stem against the plain stem conv."""
    import copy
    import torch
    import torch.nn.functional as F
    from cross_modal_video_engine_tpu_torch.cli import recognition_train
    from cross_modal_video_engine_tpu_torch.models.resnet3d import (
        forward_flops)
    from cross_modal_video_engine_tpu_torch.ops.s2d_stem import (
        s2d_stem_conv)

    out = {"card": card}
    rng = np.random.default_rng(18)
    for name, fname in CNN18.items():
        cfg = shipped_training_config(CNN_CONFIGS / fname)
        t = _clip_len(cfg)
        x1 = torch.from_numpy(rng.standard_normal(
            (1, t, CNN18_SIZE, CNN18_SIZE, 3), dtype=np.float32))
        models = {}
        for where_, d in (("card", dev), ("cpu", torch.device("cpu"))):
            models[where_] = recognition_train.build_recognition_model(
                cfg, d).eval()
        with torch.no_grad():
            t0 = time.perf_counter()
            want = models["cpu"](x1)
            cpu_s = time.perf_counter() - t0
            got = models["card"](x1.to(dev)).cpu()
        del models["cpu"]
        model = models["card"]
        rec = {"frames": t, "params_m": sum(
            p.numel() for p in model.parameters()) / 1e6,
               "max_rel": _max_rel(got, want), "cosine": _cosine(got, want),
               "cpu_s": cpu_s}
        x8 = torch.from_numpy(rng.standard_normal(
            (CNN18_BATCH, t, CNN18_SIZE, CNN18_SIZE, 3),
            dtype=np.float32)).to(dev)
        flops = forward_flops(model, x8)
        bf = copy.deepcopy(model).to(torch.bfloat16)
        for dtype, m, x in (("f32", model, x8),
                            ("bf16", bf, x8.to(torch.bfloat16))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            with torch.no_grad():
                ms = cuda_ms(lambda: m(x), iters=CNN18_TIMED, warmup=2)
            rec[dtype] = {"ms": ms, "videos_per_s": CNN18_BATCH * 1e3 / ms,
                          "tflops_per_s": flops / ms / 1e9,
                          "peak_mib": torch.cuda.max_memory_allocated(dev)
                          / 2 ** 20}
        rec["gflops_per_video"] = flops / CNN18_BATCH / 1e9
        out[name] = rec
        print(f"18a {name} ({fname}, {rec['params_m']:.2f}M parameters, "
              f"{t}x{CNN18_SIZE}², 400 classes, training init): card vs CPU "
              f"at batch "
              f"1 f32 max |diff| / max |CPU| {rec['max_rel']:.2e} (need <= "
              f"{CNN18_REL}), cosine {rec['cosine']:.7f} (need >= "
              f"{CNN18_COS}); forward at batch {CNN18_BATCH}: f32 "
              f"{rec['f32']['ms']:.2f} ms ({rec['f32']['tflops_per_s']:.1f} "
              f"TFLOP/s, {rec['f32']['peak_mib']:.0f} MiB peak), bf16 "
              f"{rec['bf16']['ms']:.2f} ms ({rec['bf16']['tflops_per_s']:.1f}"
              f" TFLOP/s, {rec['bf16']['peak_mib']:.0f} MiB peak); "
              f"{rec['gflops_per_video']:.1f} GFLOP a video; on {card}",
              flush=True)
        if (rec["max_rel"] > CNN18_REL or rec["cosine"] < CNN18_COS
                or not torch.isfinite(got).all()):
            raise SystemExit(f"18a {name}: the card disagrees with the CPU")
        del model, bf, x8, x1
        torch.cuda.empty_cache()

    # the fast pathway's stem: (kt 5, 7, 7) 3 -> 8 channels, stride (1,
    # 2, 2), on the view the backbone hands it, in f32 and bf16
    x = torch.from_numpy(rng.standard_normal(
        (CNN18_BATCH, 32, CNN18_SIZE, CNN18_SIZE, 3),
        dtype=np.float32)).to(dev)
    w = torch.from_numpy(0.1 * rng.standard_normal(
        (8, 3, 5, 7, 7), dtype=np.float32)).to(dev)
    stem = {}
    for dtype in (torch.float32, torch.bfloat16):
        xv, wv = x.to(dtype).permute(0, 4, 1, 2, 3), w.to(dtype)
        with torch.no_grad():
            plain = F.conv3d(xv, wv, stride=(1, 2, 2), padding=(2, 3, 3))
            s2d = s2d_stem_conv(xv, wv)
            err = _max_rel(s2d.float(), plain.float())
            stem[str(dtype).split(".")[1]] = {
                "plain_ms": cuda_ms(lambda: F.conv3d(
                    xv, wv, stride=(1, 2, 2), padding=(2, 3, 3))),
                "s2d_ms": cuda_ms(lambda: s2d_stem_conv(xv, wv)),
                "max_rel": err}
    out["fast_stem"] = stem
    print(f"18a the SlowFast fast-pathway stem at ({CNN18_BATCH}, 3, 32, "
          f"{CNN18_SIZE}, {CNN18_SIZE}) -> 8 channels, plain conv vs s2d "
          f"(finding only, "
          f"nothing switched): {json.dumps(stem)} on {card}", flush=True)
    if max(v["max_rel"] for v in stem.values()) > TOL["bfloat16"]:
        raise SystemExit("18a the s2d stem disagrees with the plain conv")
    del x, w
    torch.cuda.empty_cache()
    return out


def _epoch_tree(path: str) -> dict:
    """The parameters and batch_stats of an epoch state (flat name ->
    tensor)."""
    from cross_modal_video_engine_tpu_torch.io import flax_msgpack

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}/")
            else:
                yield f"{pre}{k}", v

    with open(os.path.join(path, "train_state.msgpack"), "rb") as f:
        tree = flax_msgpack.restore(f.read())
    # a RecTrainState's epoch, or an OmniSource epoch's {"params", ...}
    params = tree["state"]["params"] if "state" in tree else tree["params"]
    return dict(flat({"params": params,
                      "batch_stats": tree["batch_stats"]}))


def _group(name: str) -> str:
    """A parameter's group: the class head, BatchNorms, the rest (convs,
    and a transformer's attention, MLP and norms)."""
    return ("head" if name.startswith(("cls_head", "fc_cls")) else
            "bn" if ".bn." in name else "conv")


# The checks build each recipe's model many times at its training init (the
# float64 witness on both devices, every step run, the CLIs).  That init is
# a pure function of the model's structure and the seed: inside
# `shared_training_init` each is drawn once and reused (the INIT_MEMO
# latest), and while the CLIs' builders construct a model torch's default
# init is skipped, since the training init they load covers every parameter
# and buffer (the init functions raise on a missing key, load_state_dict is
# strict).
INIT_FNS = ("conv_init_state_dict", "init_state_dict")
INIT_BUILDERS = ("build_recognition_model", "build_caption_model",
                 "build_detection_model", "build_skeleton_model")
TORCH_INITS = ("kaiming_uniform_", "kaiming_normal_", "uniform_", "normal_",
               "trunc_normal_", "xavier_uniform_", "xavier_normal_",
               "constant_", "zeros_", "ones_", "orthogonal_")
INIT_MEMO = 8


def _structure(module) -> tuple:
    """What a module's init can read: each submodule's name, type and
    plain attributes (configs, flags, init_values) and the state dict's
    names, shapes and dtypes."""
    import dataclasses
    plain = (bool, int, float, str, tuple, type(None))
    mods = tuple((name, type(m).__name__, tuple(sorted(
        (k, repr(v)) for k, v in vars(m).items()
        if isinstance(v, plain) or dataclasses.is_dataclass(v))))
        for name, m in module.named_modules())
    return mods, tuple((k, tuple(v.shape), str(v.dtype))
                       for k, v in module.state_dict().items())


@contextlib.contextmanager
def shared_training_init():
    """Inside: the CLIs' training inits drawn once per structure and seed,
    and no default init while their builders construct a model."""
    import collections
    import torch
    from cross_modal_video_engine_tpu_torch.cli import (caption_train,
                                                        detection_train,
                                                        recognition_train,
                                                        skeleton_train)
    memo = collections.OrderedDict()
    saved = []

    def patch(owner, name, fn):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def memoized(fn):
        def draw(*args, **kw):
            key = (fn.__name__,) + tuple(
                _structure(a) if isinstance(a, torch.nn.Module) else repr(a)
                for a in args) + tuple(sorted((k, repr(v))
                                              for k, v in kw.items()))
            if key not in memo:
                memo[key] = fn(*args, **kw)
                while len(memo) > INIT_MEMO:
                    memo.popitem(last=False)
            memo.move_to_end(key)
            return dict(memo[key])
        return draw

    def keep(tensor, *args, **kw):
        return tensor

    def no_default_init(fn):
        def build(*args, **kw):
            inits = [(name, getattr(torch.nn.init, name))
                     for name in TORCH_INITS]
            for name, _ in inits:
                setattr(torch.nn.init, name, keep)
            try:
                return fn(*args, **kw)
            finally:
                for name, f in inits:
                    setattr(torch.nn.init, name, f)
        return build

    try:
        for owner in (recognition_train, caption_train, detection_train,
                      skeleton_train):
            for name in INIT_FNS:
                if hasattr(owner, name):
                    patch(owner, name, memoized(getattr(owner, name)))
            for name in INIT_BUILDERS:
                if hasattr(owner, name):
                    patch(owner, name, no_default_init(getattr(owner, name)))
        yield memo
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def _start_model(cfg, d, start, input_shape=None):
    """The config's classifier on device d at `start` (a state dict; None:
    the training init), every dropout 0 and a TRN head's train-mode tuples
    one fixed draw (seed 19), so that runs on both devices agree.
    input_shape: the clips' (T, H, W) (a Swin3D's tables follow it)."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import recognition_train
    from cross_modal_video_engine_tpu_torch.models.heads import TRNHead
    from cross_modal_video_engine_tpu_torch.models.layers import Dropout
    model = recognition_train.build_recognition_model(
        cfg, d, input_shape=input_shape)
    if start is not None:
        model.load_state_dict(start)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    head = getattr(model, "cls_head", None)
    if isinstance(head, TRNHead):
        head.generator = torch.Generator().manual_seed(19)
        picks = head.draw_picks()
        head.draw_picks = lambda: picks
    return model


def _train_loss(model, clips, labels, blend=None):
    """The train-mode loss of a classifier in its own dtype (float64 in
    the witness runs): the cross entropy, plus the TPN neck's loss_aux;
    blend: (blending type, its draws, classes): the clips blended first
    and the soft-label cross entropy (data/blending.py)."""
    import torch
    soft = None
    if blend is not None:
        from cross_modal_video_engine_tpu_torch.data.blending import (
            make_blending)
        kind, draws, classes = blend
        clips, soft = make_blending(kind, classes)(clips, labels, draws)
    out = model(clips, target=labels) if hasattr(model, "neck") \
        else model(clips)
    scores, aux = out if isinstance(out, tuple) else (out, {})
    if soft is not None:
        return -(soft.to(scores.dtype)
                 * torch.log_softmax(scores, -1)).sum(-1).mean()
    return (torch.nn.functional.cross_entropy(scores, labels)
            + aux.get("loss_aux", 0.0))


def _grads64(model) -> dict:
    import torch
    return {n: (p.grad.detach().double().cpu() if p.grad is not None
                else torch.zeros(p.shape, dtype=torch.float64))
            for n, p in model.named_parameters()}


def _stats64(model) -> dict:
    return {k: v.detach().double().cpu()
            for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _as_float64(model):
    """The model in float64, compute dtypes included: parameters and
    buffers doubled, every layer that names fp32 as its compute dtype
    (a CLIP or VideoCLIP transformer's, VideoMAE's) switched to float64,
    so the witness computes every product in float64; attention that the
    flash kernel serves (which takes f32 or bf16) runs its plain version,
    the same function, in float64."""
    import dataclasses
    import torch
    model = model.double()
    for m in model.modules():
        if getattr(m, "use_flash", False):
            m.use_flash = False
        for attr in ("dtype", "compute_dtype"):
            if getattr(m, attr, None) == torch.float32:
                setattr(m, attr, torch.float64)
        cfg = getattr(m, "cfg", None)
        if dataclasses.is_dataclass(cfg) and getattr(cfg, "dtype",
                                                     None) == "float32":
            m.cfg = dataclasses.replace(cfg, dtype="float64")
    return model


def _f64_run(cfg, d, start, clips, labels, blend=None) -> dict:
    """One train-mode forward and backward in float64 on device d: the
    loss, the gradients and the running statistics after it."""
    import torch
    model = _as_float64(_start_model(cfg, d, start,
                                     clips.shape[1:4])).train()
    loss = _train_loss(model, torch.from_numpy(clips).to(d, torch.float64),
                       torch.from_numpy(labels).to(d), blend)
    loss.backward()
    return {"loss": float(loss.detach()), "grads": _grads64(model),
            "stats": _stats64(model)}


def _step_run(cfg, d, start, clips, labels, bf16: bool, blend=None,
              update_scale=None) -> dict:
    """One make_cls_train_step_stats step (a TPNRecognizer's
    make_tpn_train_step_stats; make_cls_train_step for a model without
    BatchNorm; with update_scale the multigrid step, f32) on device d,
    with blend (_train_loss's) handed to the step: the loss, the
    gradients, the parameters and statistics before and after it."""
    import torch
    from cross_modal_video_engine_tpu_torch.data.blending import (
        make_blending)
    from cross_modal_video_engine_tpu_torch.models.recognizer import (
        TPNRecognizer)
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, has_batch_norm, init_rec_state,
        make_cls_train_step, make_cls_train_step_stats, make_rec_optimizer,
        make_multigrid_train_step, make_tpn_train_step_stats)
    model = _start_model(cfg, d, start, clips.shape[1:4])
    state = init_rec_state(model, make_rec_optimizer(
        RecognitionTrainConfig(**dict(cfg["optimizer"], warmup_steps=0)),
        10))
    draws = None
    if update_scale is not None:
        step = make_multigrid_train_step(model, update_scale, device=d)
    elif isinstance(model, TPNRecognizer):
        step = make_tpn_train_step_stats(model, bf16=bf16, device=d)
    else:
        make = (make_cls_train_step_stats if has_batch_norm(model)
                else make_cls_train_step)
        kw = {}
        if blend is not None:
            kind, draws, classes = blend
            kw["blending"] = make_blending(kind, classes)
        step = make(model, bf16=bf16, device=d, **kw)
    p0 = {n: p.detach().double().cpu() for n, p in model.named_parameters()}
    s0 = _stats64(model)
    t0 = time.perf_counter()
    args = (state, torch.from_numpy(clips).to(d),
            torch.from_numpy(labels).to(d))
    state, logs = step(*args, draws) if draws is not None else step(*args)
    loss = float(logs["loss"])
    return {"loss": loss, "s": time.perf_counter() - t0,
            "grads": _grads64(model), "p0": p0, "s0": s0,
            "params": {n: p.detach().double().cpu()
                       for n, p in model.named_parameters()},
            "stats": _stats64(model)}


def _update_over_bound(run, tcfg) -> float:
    """The largest error of a run's parameter move against the optimizer's
    first step from its own gradients, over its STEP18_UPDATE/STEP18_ULP
    bound: SGD's p - lr (clip(g) + wd p) (momentum's trace starting at
    zero), AdamW's p - lr (clip(g) / (|clip(g)| + 1e-8) + wd p) (the first
    moments bias-corrected to g and g²)."""
    import torch
    g = run["grads"]
    norm = float(sum(x.reshape(-1) @ x.reshape(-1)
                     for x in g.values())) ** 0.5
    c = 1.0 if norm < tcfg.grad_clip else tcfg.grad_clip / norm

    def abs_max(x) -> float:
        lo, hi = torch.aminmax(x)
        return max(-float(lo), float(hi))

    worst = 0.0
    for n, p0 in run["p0"].items():
        gc = g[n] * c
        if tcfg.optimizer == "adamw":
            gc.div_(gc.abs().add_(1e-8))
        update = gc.add_(p0, alpha=tcfg.weight_decay).mul_(
            tcfg.learning_rate)
        scale = (STEP18_UPDATE * abs_max(update)
                 + STEP18_ULP * abs_max(p0))
        if scale:
            err = abs_max((p0 - run["params"][n]).sub_(update))
            worst = max(worst, err / scale)
    return worst


def _sums(grads, truth, cpu) -> dict:
    """Per tensor, in float64: |g|², g·truth, g·cpu and |g - truth|²; the
    verdict and its planted faults read only these."""
    out = {}
    for n, t in truth.items():
        g, t = grads[n].reshape(-1), t.reshape(-1)
        d = g - t
        out[n] = (float(g @ g), float(g @ t),
                  float(g @ cpu[n].reshape(-1)), float(d @ d))
    return out


def _sum_cos(dot, aa, bb) -> float:
    return 1.0 if aa == bb == 0 else dot / ((aa * bb) ** 0.5 + 1e-300)


def _tensor_ok(c, gate, tt, numel) -> bool:
    """One tensor's gradient from its sums (c: the card's, gate: the CPU
    runs' worst cosine to float64 and worst |g - truth|², tt: |truth|²):
    it keeps STEP18_AGREE of that cosine where it is
    STEP18_SIGNAL/sqrt(size) or more, and lies within STEP18_GROSS[1] of
    the tensor's norm from float64 where every CPU run lies within
    STEP18_GROSS[0]."""
    card_c = _sum_cos(c[1], c[0], tt)
    cpu_c, cpu_e2 = gate
    lo, hi = STEP18_GROSS
    return ((cpu_c * numel ** 0.5 < STEP18_SIGNAL
             or card_c >= STEP18_AGREE * cpu_c)
            and (cpu_e2 > lo * lo * tt or c[3] <= hi * hi * tt))


def _gate(runs, truth, tt) -> dict:
    """Per tensor, over the CPU runs (two summation orders): the worst
    cosine to float64 and the worst |g - truth|²."""
    sums = [_sums(r["grads"], truth, r["grads"]) for r in runs]
    return {n: (min(_sum_cos(s[n][1], s[n][0], tt[n]) for s in sums),
                max(s[n][3] for s in sums)) for n in truth}


def _reference(cpu, f64, alt=None) -> dict:
    """What the verdict needs of the CPU's run (and of `alt`, the CPU's
    run at another thread count) and of float64, once."""
    truth = f64["grads"]
    names = list(truth)
    groups = {}
    for n in names:
        groups.setdefault(_group(n), []).append(n)
    tt = {n: float(t.reshape(-1) @ t.reshape(-1)) for n, t in truth.items()}
    runs = [cpu] + ([alt] if alt else [])
    return {"truth": truth, "groups": groups, "tt": tt,
            "numel": {n: t.numel() for n, t in truth.items()},
            "cpu": _sums(cpu["grads"], truth, cpu["grads"]),
            "cpus": [_sums(r["grads"], truth, cpu["grads"]) for r in runs],
            "gate": _gate(runs, truth, tt)}


def _step_verdict(card, cpu, f64, ref, tcfg, bf16: bool,
                  sums=None) -> Tuple[list, dict]:
    """The sub-checks the card's step run fails (loss, gradients, update,
    statistics) and the readings they rest on; f64: the card's float64
    run from the same start, ref: its _reference."""
    truth, tt, numel = ref["truth"], ref["tt"], ref["numel"]
    cs, us = sums or _sums(card["grads"], truth, cpu["grads"]), ref["cpu"]
    failed, read = [], {}
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    read["loss_rel"] = loss_rel
    if not (np.isfinite(card["loss"])
            and loss_rel <= (BF16_LOSS_REL if bf16 else STEP18_LOSS)):
        failed.append("loss")
    bad_tensors = [n for n in truth
                   if not _tensor_ok(cs[n], ref["gate"][n], tt[n], numel[n])]
    ok = not bad_tensors
    read["bad_tensors"] = bad_tensors[:5]
    read["worst_tensors"] = [dict(zip(
        ("card_l2_err", "name", "cpu_l2_err", "card_f64_cos", "cpu_f64_cos"),
        w)) for w in sorted(
            ((cs[n][3] / tt[n]) ** 0.5 if tt[n] else cs[n][3] ** 0.5, n,
             (us[n][3] / tt[n]) ** 0.5 if tt[n] else us[n][3] ** 0.5,
             _sum_cos(cs[n][1], cs[n][0], tt[n]),
             _sum_cos(us[n][1], us[n][0], tt[n]))
            for n in truth)[::-1][:3]]

    def total(sums, ns, i):
        return sum(sums[n][i] for n in ns)

    # the CPU's readings of a group: the worse of its runs (two summation
    # orders), as _gate reads each tensor
    by_group, bad_groups = {}, []
    for grp, ns in list(ref["groups"].items()) + [("all", list(truth))]:
        t2 = sum(tt[n] for n in ns)
        c2, u2 = total(cs, ns, 0), total(us, ns, 0)
        row = {"card_f64_cos": _sum_cos(total(cs, ns, 1), c2, t2),
               "cpu_f64_cos": min(_sum_cos(total(u, ns, 1), total(u, ns, 0),
                                           t2) for u in ref["cpus"]),
               "card_cpu_cos": _sum_cos(total(cs, ns, 2), c2, u2),
               "card_l2_err": (total(cs, ns, 3) / t2) ** 0.5,
               "cpu_l2_err": max((total(u, ns, 3) / t2) ** 0.5
                                 for u in ref["cpus"])}
        by_group[grp] = row
        if grp == "all":
            held = bf16 or (1.0 - row["card_f64_cos"] <= max(
                1.0 - STEP18_TESTS["grad_cos"],
                STEP18_ACC * (1.0 - row["cpu_f64_cos"])) + STEP18_FLOOR)
        elif bf16:
            held = 1.0 - row["card_f64_cos"] <= max(
                1.0 - BF16_GRAD_COS, STEP18_ACC * (1.0 - row["cpu_f64_cos"]))
        else:
            held = row["card_l2_err"] <= max(STEP18_TESTS["grad"],
                                             STEP18_ACC * row["cpu_l2_err"])
        if not held:
            bad_groups.append(grp)
        ok &= held
    read["by_group"], read["bad_groups"] = by_group, bad_groups
    if not ok:
        failed.append("gradients")
    read["update_over_bound"] = _update_over_bound(card, tcfg)
    if read["update_over_bound"] > 1.0:
        failed.append("update")
    # a model without BatchNorm has no statistics to hold
    if bf16:
        stats = max((_max_rel(card["stats"][k], f64["stats"][k])
                     / (STEP18_ACC * _max_rel(cpu["stats"][k],
                                              f64["stats"][k]) + STEP18_STATS)
                     for k in f64["stats"]), default=0.0)
        read["stats_over_bound"] = stats
        bad_stats = stats > 1.0
    else:
        stats = max((_max_rel(card["stats"][k], cpu["stats"][k])
                     for k in cpu["stats"]), default=0.0)
        read["stats_max_rel"] = stats
        bad_stats = stats > STEP18_STATS
    if bad_stats:
        failed.append("statistics")
    return failed, read


def _planted(card, cpu, f64, ref, tcfg, bf16: bool) -> dict:
    """The sub-checks _step_verdict fails with each fault planted in the
    card's run (every fault must fail its own sub-check), and the tensors
    in which one zeroed, negated or doubled gradient is refused."""
    import torch
    gen = torch.Generator().manual_seed(18)

    def rnd(g):
        r = torch.randn(g.shape, generator=gen).double()
        return r * (g.norm() / r.norm().clamp_min(1e-300))

    grads = card["grads"]
    faults = {
        "zero gradients": ("gradients", {"grads": {
            n: torch.zeros_like(g) for n, g in grads.items()}}),
        "random gradients": ("gradients", {"grads": {
            n: rnd(g) for n, g in grads.items()}}),
        "negated gradients": ("gradients", {"grads": {
            n: -g for n, g in grads.items()}}),
        "unmoved parameters": ("update", {"params": card["p0"]})}
    if card["s0"]:            # BatchNorm statistics to leave unmoved
        faults["stale statistics"] = ("statistics", {"stats": card["s0"]})
    real = _sums(grads, ref["truth"], cpu["grads"])
    out = {}
    for name, (must, change) in faults.items():
        failed, _ = _step_verdict(
            dict(card, **change), cpu, f64, ref, tcfg, bf16,
            None if "grads" in change else real)
        out[name] = {"failed": failed, "refused": must in failed}
    # one tensor's gradient a times the card's: |a g|², a g·t, a g·u and
    # |a g - t|² from the real sums
    for name, a in (("one zero tensor", 0.0), ("one negated tensor", -1.0),
                    ("one doubled tensor", 2.0)):
        missed = []
        for n, (gg, gt, gu, _) in real.items():
            tt = ref["tt"][n]
            faulty = (a * a * gg, a * gt, a * gu, a * a * gg - 2 * a * gt + tt)
            if _tensor_ok(faulty, ref["gate"][n], tt, ref["numel"][n]):
                missed.append(n)
        out[name] = {"refused_in": len(real) - len(missed), "of": len(real),
                     "missed": missed[:3]}
    return out


def step_card_vs_cpu(dev, cfg, clips, labels, start,
                     bf16s=(False, True), blend=None,
                     update_scale=None, witness_cfg=None) -> dict:
    """One stats step of the config's classifier from `start` (None: the
    training init) on the card and on the CPU at the clips' batch, in f32
    and (in bf16s) bf16, held to the float64 run of both devices by the
    STEP18_* bounds, with the planted faults, and the STEP18_TESTS
    readings.  blend: the blended step (_train_loss's); update_scale: the
    multigrid step, its update scaled (the update check scales lr);
    witness_cfg: the config of the float64 runs (None: cfg)."""
    import torch
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig)
    opt = dict(cfg["optimizer"], warmup_steps=0)
    if update_scale is not None:
        opt["learning_rate"] = opt["learning_rate"] * update_scale
    tcfg = RecognitionTrainConfig(**opt)
    cpu_dev = torch.device("cpu")
    t0 = time.perf_counter()
    f64 = {w: _f64_run(witness_cfg or cfg, d, start, clips, labels, blend)
           for w, d in (("card", dev), ("cpu", cpu_dev))}
    # a gradient that is zero but for rounding (a key bias after a
    # LayerNorm: softmax does not see it) is read against the model's
    # largest gradient, STEP18_F64_FLOOR of it
    floor = STEP18_F64_FLOOR * max(float(g.abs().max())
                                   for g in f64["cpu"]["grads"].values())

    def witness(a, b, at_least):
        err = float((a.double() - b.double()).abs().max())
        scale = max(float(b.double().abs().max()), at_least)
        return err / scale if scale else (0.0 if err == 0 else float("inf"))

    worst = sorted(((witness(f64["card"][k][n], f64["cpu"][k][n],
                             floor if k == "grads" else 0.0), n)
                    for k in ("grads", "stats") for n in f64["cpu"][k]),
                   reverse=True)
    witness = worst[0][0]
    out = {"f64_max_rel": witness, "f64_worst": worst[:3],
           "f64_loss": [f64["card"]["loss"], f64["cpu"]["loss"]],
           "f64_s": time.perf_counter() - t0}
    failed = [] if witness <= STEP18_F64 else ["float64 witness"]
    threads = torch.get_num_threads()
    for bf16 in bf16s:
        card = _step_run(cfg, dev, start, clips, labels, bf16, blend,
                         update_scale)
        cpu = _step_run(cfg, cpu_dev, start, clips, labels, bf16, blend,
                        update_scale)
        # the same step in another summation order: the CPU at half its
        # threads
        torch.set_num_threads(max(1, threads // 2))
        try:
            alt = _step_run(cfg, cpu_dev, start, clips, labels, bf16, blend,
                            update_scale)
        finally:
            torch.set_num_threads(threads)
        ref = _reference(cpu, f64["card"], alt)
        bad, read = _step_verdict(card, cpu, f64["card"], ref, tcfg, bf16)
        planted = _planted(card, cpu, f64["card"], ref, tcfg, bf16)
        names = list(cpu["grads"])
        # the CPU tests' bounds, card vs CPU, as readings
        grad = max((_max_rel(card["grads"][n], cpu["grads"][n]), n)
                   for n in names)
        param = max(_max_rel(card["params"][n], cpu["params"][n])
                    for n in names)
        stats = max((_max_rel(card["stats"][k], cpu["stats"][k])
                     for k in cpu["stats"]), default=0.0)
        absolute = {"grad_cos": read["by_group"]["all"]["card_cpu_cos"],
                    "grad": grad[0],
                    "grad_worst": grad[1], "param": param, "stats": stats}
        absolute["held"] = (absolute["grad_cos"] >= STEP18_TESTS["grad_cos"]
                            and all(absolute[k] <= STEP18_TESTS[k]
                                    for k in ("grad", "param", "stats")))
        key = "bf16" if bf16 else "f32"
        out[key] = dict(read, loss_card=card["loss"], loss_cpu=cpu["loss"],
                        card_s=card["s"], cpu_s=cpu["s"],
                        cpu_alt_s=alt["s"], cpu_threads=[
                            threads, max(1, threads // 2)], failed=bad,
                        planted=planted, absolute=absolute)
        failed += [f"{key} {b}" for b in bad]
        failed += [f"{key} planted {k} not refused"
                   for k, v in planted.items() if v.get("refused") is False]
        del card, cpu, alt
    out["failed"] = failed
    return out


def slowfast_training(dev, card, tmp, videos, names) -> dict:
    """18b: the shipped SlowFast-R50 4x16 recipe (fast s2d stem on)
    trained by recognition_train.train_from_config at batch 8: 2 epochs,
    a resume from epoch_0, model_best with batch_stats; one step card vs
    CPU at batch 1 in f32 and in bf16 from epoch_1; the bench row's bf16
    step at batch 8 and 32, the shipped
    config's loop by CUDA events and the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cross_modal_video_engine_tpu_torch.bench.extra import (
        bench_train_step_slowfast)
    from cross_modal_video_engine_tpu_torch.cli import recognition_train
    from cross_modal_video_engine_tpu_torch.data.datasets import VideoDataset
    from cross_modal_video_engine_tpu_torch.data.pipelines import (
        build_pipeline, with_reader)
    from cross_modal_video_engine_tpu_torch.train.checkpoint import (
        load_checkpoint)
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_cls_train_step_stats,
        make_rec_optimizer)
    from cross_modal_video_engine_tpu_torch.train.resume import (
        load_train_state)

    line = {"card": card}
    train_ann = write_training_split(tmp, names, "cls", 56)
    val_ann = write_training_split(tmp, names[:TRAIN18_VAL], "cls", 56)
    # the recipe's 500-step warmup is longer than a 4-step run (the cosine
    # schedule refuses it, in either package): the smoke run trains at the
    # recipe's learning rate from step 0
    cfg = shipped_training_config(
        SLOWFAST18_CONFIG, **{"data.train.ann_file": train_ann,
                              "data.train.data_prefix": None,
                              "data.val.ann_file": val_ann,
                              "data.val.data_prefix": None,
                              "data.videos_per_gpu": TRAIN18_BATCH,
                              "optimizer.warmup_steps": 0,
                              "total_epochs": 2, "eval_interval": 1})
    if not cfg["model.backbone"]["fast_s2d_stem"]:
        raise SystemExit("18b the shipped SlowFast recipe lost its s2d stem")
    pipe = build_pipeline(with_reader(cfg["data.pipeline"],
                                      videos.__getitem__))
    # the card-vs-CPU step on the clip's central TRAIN18_STEP_HW² (the
    # CPU's float64 and bf16 runs take most of the check's time)
    lo = (CNN18_SIZE - TRAIN18_STEP_HW) // 2
    clips = np.ascontiguousarray(_step_clips(
        cfg, videos, names[:TRAIN18_CPU_BATCH])[
            :, :, lo:lo + TRAIN18_STEP_HW, lo:lo + TRAIN18_STEP_HW])
    labels = np.arange(TRAIN18_CPU_BATCH) * 7
    work = os.path.join(tmp, "slowfast")
    t0 = time.perf_counter()
    _, history = recognition_train.train_from_config(
        cfg, work, device=dev, reader=videos.__getitem__)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    resumed_work = os.path.join(tmp, "slowfast_resumed")
    t0 = time.perf_counter()
    _, resumed = recognition_train.train_from_config(
        cfg, resumed_work, resume=os.path.join(work, "epoch_0"), device=dev,
        reader=videos.__getitem__)
    resume_s = time.perf_counter() - t0
    a = _epoch_tree(os.path.join(work, "epoch_1"))
    b = _epoch_tree(os.path.join(resumed_work, "epoch_1"))
    diffs = torch.cat([(a[k].float() - b[k].float()).abs().flatten()
                       for k in a])
    lr = cfg["optimizer"]["learning_rate"]
    one, two = history[1], resumed[0]
    variables, saved, _ = load_checkpoint(os.path.join(work, "model_best"))
    resume = {"loss_uninterrupted": one["loss"], "loss_resumed": two["loss"],
              "loss_rel": abs(one["loss"] - two["loss"]) / abs(one["loss"]),
              "state_share_within": float(
                  (diffs <= RESUME_PARAM_TOL).double().mean()),
              "state_max_abs": float(diffs.max()),
              "batch_stats_leaves": sum(k.startswith("batch_stats/")
                                        for k in a)}
    line["cli"] = {"history": history, "seconds": cli_s,
                   "resume_seconds": resume_s, "resume": resume,
                   "model_best": sorted(variables)}
    print(f"18b recognition_train.train_from_config (slowfast_r50_4x16_k400"
          f".py, f32, warmup 0) over {len(names)} seeded videos, batch "
          f"{TRAIN18_BATCH}, 2 epochs with validation on {TRAIN18_VAL}: "
          f"{json.dumps(history)} in {cli_s:.1f} s; resumed from epoch_0 "
          f"({resume_s:.1f} s): {json.dumps(resume)} (need the loss within "
          f"{RESUME_LOSS_RTOL}, {RESUME_PARAM_SHARE} of the parameters and "
          f"statistics within {RESUME_PARAM_TOL}, all within {2 * lr:g}); "
          f"model_best holds {sorted(variables)} of a "
          f"{saved['backbone']['type']}", flush=True)
    if (len(history) != 2 or not all(np.isfinite(h["loss"])
                                     for h in history)
            or [h["epoch"] for h in resumed] != [1]
            or resume["loss_rel"] > RESUME_LOSS_RTOL
            or resume["state_share_within"] < RESUME_PARAM_SHARE
            or resume["state_max_abs"] > 2 * lr
            or not resume["batch_stats_leaves"]
            or sorted(variables) != ["batch_stats", "params"]):
        raise SystemExit("18b the SlowFast CLI, its resume or model_best "
                         "failed")
    torch.cuda.empty_cache()

    # one step card vs CPU from epoch_1 (step 19b takes four recipes'
    # steps from the training init)
    holder = recognition_train.build_recognition_model(cfg, "cpu")
    load_train_state(os.path.join(work, "epoch_1"), {
        "state": init_rec_state(holder, make_rec_optimizer(
            RecognitionTrainConfig(**cfg["optimizer"]), 10)),
        "batch_stats": holder})
    for start_name, start in (("epoch_1", holder.state_dict()),):
        step_line = step_card_vs_cpu(dev, cfg, clips, labels, start)
        line[f"step_{start_name.split()[-1]}"] = step_line
        print(f"18b one stats step of slowfast_r50_4x16_k400.py (400 "
              f"classes, head dropout 0) from the {start_name} at batch "
              f"{TRAIN18_CPU_BATCH}, card vs CPU in f32 and bf16: "
              f"{json.dumps(step_line)} (need float64 gradients and "
              f"statistics card vs CPU within {STEP18_F64}; f32: loss "
              f"within {STEP18_LOSS}, the whole gradient's 1 - cosine to "
              f"float64 within {1 - STEP18_TESTS['grad_cos']:g} or "
              f"{STEP18_ACC}x the CPU's, each group's L2 error within "
              f"{STEP18_TESTS['grad']} or {STEP18_ACC}x the CPU's; bf16: "
              f"loss within {BF16_LOSS_REL}, each group's 1 - cosine to "
              f"float64 within {1 - BF16_GRAD_COS:g} or {STEP18_ACC}x the "
              f"CPU's; each tensor: "
              f"{STEP18_AGREE} of the worse CPU run's cosine to float64 "
              f"where that is {STEP18_SIGNAL}/sqrt(size) or more, the L2 "
              f"error within {STEP18_GROSS[1]} of its norm where both CPU "
              f"runs' (all threads, half) are within {STEP18_GROSS[0]}; "
              f"the parameters moved by lr (clip(g) + "
              f"wd p) within {STEP18_UPDATE} of each tensor's largest "
              f"update + {STEP18_ULP} of its largest parameter; statistics "
              f"within {STEP18_STATS} of the CPU's (f32), from float64 "
              f"within {STEP18_ACC}x the CPU's + {STEP18_STATS} (bf16); "
              f"every planted fault refused; readings at the CPU tests' "
              f"bounds {STEP18_TESTS}) on "
              f"{card}", flush=True)
        if step_line["failed"]:
            raise SystemExit(f"18b card vs CPU failed: {step_line['failed']}")
        torch.cuda.empty_cache()
    del holder

    # the bench row's bf16 step at batch 8 and at 16 (halved until it fits)
    rows = {}
    for batch in (TRAIN18_BATCH, TRAIN18_BIG):
        while True:
            try:
                torch.cuda.reset_peak_memory_stats(dev)
                row = bench_train_step_slowfast(batch=batch, device=dev,
                                                steps=BENCH_ROW_STEPS)
                row["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
                rows[batch] = row
                break
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()
                batch //= 2
                if batch < TRAIN18_BATCH:
                    raise
        torch.cuda.empty_cache()
    line["bench_rows"] = rows
    print(f"18b the bench row train_step_slowfast (bf16, f32 masters and "
          f"statistics, SlowFastConfig(alpha=8), 32x224²) at batches "
          f"{sorted(rows)}: {json.dumps(rows)} on {card}", flush=True)

    # the shipped recipe's loop: the step by CUDA events over a prebuilt
    # batch, then TRAIN18_PROFILED steps with their host batches profiled
    tcfg = RecognitionTrainConfig(**cfg["optimizer"])
    model = recognition_train.build_recognition_model(cfg, dev)
    state = init_rec_state(model, make_rec_optimizer(tcfg))
    step = make_cls_train_step_stats(
        model, generator=torch.Generator(device=dev).manual_seed(5),
        device=dev)
    ds = VideoDataset(train_ann, pipe)
    batches = recognition_train._label_batches
    b = next(batches(ds, TRAIN18_BATCH, dev))
    spans = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(TRAIN18_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, logs = step(state, *b[:2])
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = float(np.median(spans[2:]))
    it = batches(ds, TRAIN18_BATCH, dev, [
        i % len(ds) for i in range(TRAIN18_PROFILED * TRAIN18_BATCH)])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN18_PROFILED):
            b = next(it)
            state, logs = step(state, *b[:2])
        float(logs["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / TRAIN18_PROFILED * 1e3
    kernels = sorted(
        ((e.self_device_time_total / TRAIN18_PROFILED / 1e3, e.key)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")
         and not getattr(e, "is_user_annotation", False)), reverse=True)
    busy_ms = sum(ms for ms, _ in kernels)
    line["loop"] = {"dtype": "float32", "step_ms": step_ms,
                    "step_ms_all": spans,
                    "videos_per_s": TRAIN18_BATCH * 1e3 / step_ms,
                    "loop_wall_ms": wall_ms,
                    "loop_videos_per_s": TRAIN18_BATCH * 1e3 / wall_ms,
                    "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
                    "peak_mib": peak / 2 ** 20,
                    "top_kernels": [[k[:80], ms] for ms, k in kernels[:8]]}
    print(f"18b the shipped recipe's step (f32 as shipped, batch "
          f"{TRAIN18_BATCH}): {step_ms:.2f} ms by CUDA events (median of "
          f"steps 3-{TRAIN18_TIMED}) = {line['loop']['videos_per_s']:.2f} "
          f"videos/s; the loop with its host batches {wall_ms:.1f} ms a "
          f"step = {line['loop']['loop_videos_per_s']:.2f} videos/s, "
          f"kernels busy {busy_ms:.2f} ms, idle share "
          f"{line['loop']['idle_share']:.3f}; peak memory "
          f"{peak / 2 ** 20:.0f} MiB on {card}; longest kernels (ms a step): "
          f"{json.dumps(line['loop']['top_kernels'])}", flush=True)
    if not np.isfinite(float(logs["loss"])):
        raise SystemExit("18b the loop's loss is not finite")
    del model, state, step, b, it, prof
    torch.cuda.empty_cache()
    return line


def served_caption(dev, card, tmp, videos, names, config, tag: str,
                   seed: int, epochs: int,
                   route_pipeline: bool = False) -> dict:
    """caption_train.train_from_config on a shipped seq_generate config
    (18c: i3d_relseq.py, I3D-R50 32x2, RNN decoder 2048 -> 36 x 5; 19d:
    tsm_relseq.py; 20d: videomae_relseq.py) at batch 8 for `epochs`, then
    its model_best served over /caption: batch-1 requests and a burst of
    8, each answer equal to a direct caption_clips.  route_pipeline: the
    route serves with the config's pipeline (test mode) in place of its
    8-frame default (caption_inference.DEFAULT_PIPELINE, the JAX
    route's), as a VideoMAE's fixed position table needs its own clip
    length."""
    import argparse
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli import (caption_inference,
                                                        caption_train)
    from cross_modal_video_engine_tpu_torch.models.recognizer import (
        RecognizerRelseq)

    line = {"card": card}
    train_ann = write_training_split(tmp, names, "relseq", seed)
    val_ann = write_training_split(tmp, names[:TRAIN18_VAL], "relseq", seed)
    cfg = shipped_training_config(
        config, **{"data.train.ann_file": train_ann,
                   "data.train.data_prefix": None,
                   "data.val.ann_file": val_ann,
                   "data.val.data_prefix": None,
                   "data.videos_per_gpu": TRAIN18_BATCH,
                   "total_epochs": epochs, "eval_interval": 1})
    work = os.path.join(tmp, config.stem)
    t0 = time.perf_counter()
    history = caption_train.train_from_config(cfg, work, device=dev,
                                              reader=videos.__getitem__)
    torch.cuda.synchronize()
    line["cli"] = {"history": history, "seconds": time.perf_counter() - t0}
    print(f"{tag} caption_train.train_from_config ({config.name}, f32) "
          f"over {len(names)} seeded videos, batch {TRAIN18_BATCH}, "
          f"{epochs} epoch(s) with validation on {TRAIN18_VAL}: "
          f"{json.dumps(history)} in {line['cli']['seconds']:.1f} s on "
          f"{card}", flush=True)
    if len(history) != epochs or not all(np.isfinite(h["loss"])
                                         for h in history):
        raise SystemExit(f"{tag} the caption CLI failed")

    args = argparse.Namespace(caption_checkpoint=os.path.join(
        work, "model_best"), device=str(dev))
    default = caption_inference.DEFAULT_PIPELINE
    if route_pipeline:
        caption_inference.DEFAULT_PIPELINE = [
            dict(op, test_mode=True) if op["type"] == "SampleFrames" else op
            for op in cfg["data.pipeline"]]
    try:
        server, handler = bserve.start_caption_server(args,
                                                      videos.__getitem__)
    finally:
        caption_inference.DEFAULT_PIPELINE = default
    try:
        if not isinstance(handler.model, RecognizerRelseq):
            raise SystemExit(f"{tag} /caption did not load a "
                             f"RecognizerRelseq")
        port = server.server_address[1]
        bserve.post_caption(port, {"video": names[0]})          # warm-up
        single = [bserve.request(port, "caption",
                                 {"video": names[i % len(names)]},
                                 timeout=600.0)
                  for i in range(CAPTION18_SINGLE)]
        asked = [names[i % len(names)] for i in range(CAPTION18_SINGLE)]
        burst = bserve.clients_in_threads(
            port, [{"video": names[i % len(names)]}
                   for i in range(CAPTION18_BURST)], CAPTION18_BURST,
            lambda port, p: bserve.request(port, "caption", p,
                                           timeout=600.0))
        asked += [names[i % len(names)] for i in range(CAPTION18_BURST)]
        direct = {n: caption_direct(handler, n) for n in set(asked)}
    finally:
        bserve.stop_server(server, handler)
    agree = caption_agreement(
        [(n, a["steps"]) for n, (_, a) in zip(asked, single + burst)],
        direct, band=CAPTION18_BAND)
    line.update(batch1_ms=bserve.percentiles([ms for ms, _ in single]),
                burst_ms=bserve.percentiles([ms for ms, _ in burst]),
                agreement=agree)
    print(f"{tag} model_best served over /caption: {CAPTION18_SINGLE} batch-1 "
          f"requests p50 {line['batch1_ms']['p50']:.2f} ms, p99 "
          f"{line['batch1_ms']['p99']:.2f} ms; a burst of {CAPTION18_BURST} "
          f"p50 {line['burst_ms']['p50']:.2f} ms, p99 "
          f"{line['burst_ms']['p99']:.2f} ms; against a direct caption_clips "
          f"on the route's clips: {json.dumps(agree)} (need every step-0 "
          f"label farther than {CAPTION18_BAND} from the threshold equal; "
          f"f32, so a wave's other rows move a probability by rounding only)"
          f" on {card}", flush=True)
    if agree["step0_disagree"]:
        raise SystemExit(f"{tag} /caption disagrees with caption_clips")
    torch.cuda.empty_cache()
    return line


def check_step18(dev, card) -> Tuple[dict, dict]:
    """Step 18 (a-d).  Returns (the `cnn_recognizers` JSON object, the
    kernels' launches over the step: all must be 0)."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve

    t_step = time.perf_counter()
    counted = kernel_counters()
    for fn in counted.values():
        fn.launches = 0
    line = {"card": card}
    t0 = time.perf_counter()
    line["forwards"] = cnn_forwards(dev, card)
    line["forwards"]["seconds"] = time.perf_counter() - t0
    videos = bserve.seeded_videos(TRAIN18_VIDEOS, seed=18,
                                    **TRAIN_VIDEO_HW)
    names = sorted(videos)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        line["slowfast"] = slowfast_training(dev, card, tmp, videos, names)
        line["slowfast"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        line["i3d_caption"] = served_caption(
            dev, card, tmp, videos, names, I3D_RELSEQ_CONFIG, "18c", 57, 1)
        line["i3d_caption"]["seconds"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    line["launches"] = launches
    line["seconds"] = time.perf_counter() - t_step
    print(f"18d kernel launches over step 18: {json.dumps(launches)} (need "
          f"0: no 3D-CNN path reaches a kernel); step 18 checked in "
          f"{line['seconds']:.1f} s", flush=True)
    if any(launches.values()):
        raise SystemExit("18d a 3D-CNN path launched a kernel")
    return line, launches


# -- step 19: the 2D, TSM and pyramid recognizers (ROADMAP item 8b) -----------
# 19a: each shipped recipe of the slice at its own widths, classes and clip
# (the sampler's frames, times the segments MergeClips folds in, at the
# crop size), the training init (numpy seed 0); the tsm_relseq caption
# model's pooled TSM feature
CNN19 = {"tsm_r50_1x1x8": "tsm_r50_1x1x8_k400.py",
         "tsn_r50_1x1x3": "tsn_r50_1x1x3_k400.py",
         "tin_r50_1x1x8": "tin_r50_1x1x8_sthv2.py",
         "trn_r50_1x1x8": "trn_r50_1x1x8_sthv1.py",
         "tanet_r50": "tanet_r50_k400.py",
         "tpn_slowonly_r50_8x8": "tpn_slowonly_r50_8x8_k400.py",
         "c3d_16x1": "c3d_sports1m_16x1_ucf101.py",
         "r2plus1d_r34_8x8": "r2plus1d_r34_8x8_k400.py"}
TSM_RELSEQ_CONFIG = ROOT / "configs" / "seq_generate" / "tsm_relseq.py"
# 19b: one stats step card vs CPU at batch TRAIN19_CPU_BATCH from the
# training init, held to float64 by step_card_vs_cpu (18b's bounds and
# planted faults); bf16 too for the recipes in STEP19_BF16 (TPN's bf16
# step is left out for the script's time)
STEP19 = ("tsm_r50_1x1x8", "tin_r50_1x1x8", "trn_r50_1x1x8",
          "tpn_slowonly_r50_8x8")
STEP19_BF16 = ("tsm_r50_1x1x8",)
# depth cut for the script's time (widths kept): every backbone at one
# block a stage (at full depth TPN's stats step took 34.8 s of 19b, TSM's
# f32 and bf16 steps 19.0 s, TIN's 7.9 and TRN's 8.6)
STEP19_DEPTH = dict.fromkeys(STEP19, {
    "model.backbone.stage_blocks": [1, 1, 1, 1]})
TRAIN19_CPU_BATCH = 1
# 19c/d: the CLIs over 16 seeded videos at batch 8, one epoch
TRAIN19_EPOCHS = 1


def _clip_shape(cfg) -> Tuple[int, int]:
    """(T, size) of a config's clips."""
    ops = {op["type"]: op for op in cfg["data.pipeline"]}
    sample = ops.get("SampleFrames") or ops["DenseSampleFrames"]
    t = sample["clip_len"] * (sample["num_clips"] if "MergeClips" in ops
                              else 1)
    return t, ops["CenterCrop"]["crop_size"]


def cnn2d_forwards(dev, card) -> dict:
    """19a: each shipped recipe of the slice card vs CPU at batch 1 (f32,
    TF32 off; tsm_relseq: its pooled backbone feature), then its forward
    at batch 8 in f32 and bf16 (ms, TFLOP/s of its products, peak
    memory)."""
    import copy
    import torch
    from cross_modal_video_engine_tpu_torch.cli import (caption_train,
                                                        recognition_train)
    from cross_modal_video_engine_tpu_torch.models.resnet3d import (
        forward_flops)

    out = {"card": card}
    rng = np.random.default_rng(19)
    recipes = [(n, CNN_CONFIGS / f) for n, f in CNN19.items()]
    recipes.append(("tsm_relseq", TSM_RELSEQ_CONFIG))
    for name, path in recipes:
        t0 = time.perf_counter()
        cfg = shipped_training_config(path)
        t, size = _clip_shape(cfg)
        models = {}
        for where_, d in (("card", dev), ("cpu", torch.device("cpu"))):
            if name == "tsm_relseq":
                models[where_] = caption_train.build_caption_model(
                    cfg, d)[0].backbone.eval()
            else:
                models[where_] = recognition_train.build_recognition_model(
                    cfg, d).eval()
        x1 = torch.from_numpy(rng.standard_normal((1, t, size, size, 3),
                                                  dtype=np.float32))
        with torch.no_grad():
            t1 = time.perf_counter()
            want = models["cpu"](x1)
            cpu_s = time.perf_counter() - t1
            got = models["card"](x1.to(dev)).cpu()
        del models["cpu"]
        model = models["card"]
        rec = {"clip": [t, size], "params_m": sum(
            p.numel() for p in model.parameters()) / 1e6,
               "type": type(model).__name__,
               "max_rel": _max_rel(got, want), "cosine": _cosine(got, want),
               "cpu_s": cpu_s}
        x8 = torch.from_numpy(rng.standard_normal(
            (CNN18_BATCH, t, size, size, 3), dtype=np.float32)).to(dev)
        flops = forward_flops(model, x8)
        bf = copy.deepcopy(model).to(torch.bfloat16)
        for dtype, m, x in (("f32", model, x8),
                            ("bf16", bf, x8.to(torch.bfloat16))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            with torch.no_grad():
                ms = cuda_ms(lambda: m(x), iters=CNN18_TIMED, warmup=2)
            rec[dtype] = {"ms": ms, "videos_per_s": CNN18_BATCH * 1e3 / ms,
                          "tflops_per_s": flops / ms / 1e9,
                          "peak_mib": torch.cuda.max_memory_allocated(dev)
                          / 2 ** 20}
        rec["gflops_per_video"] = flops / CNN18_BATCH / 1e9
        rec["seconds"] = time.perf_counter() - t0
        out[name] = rec
        print(f"19a {name} ({path.name}, {rec['type']}, "
              f"{rec['params_m']:.2f}M parameters, {t}x{size}², training "
              f"init): card vs CPU at batch 1 f32 max |diff| / max |CPU| "
              f"{rec['max_rel']:.2e} (need <= {CNN18_REL}), cosine "
              f"{rec['cosine']:.7f} (need >= {CNN18_COS}); forward at batch "
              f"{CNN18_BATCH}: f32 {rec['f32']['ms']:.2f} ms "
              f"({rec['f32']['tflops_per_s']:.1f} TFLOP/s, "
              f"{rec['f32']['peak_mib']:.0f} MiB peak), bf16 "
              f"{rec['bf16']['ms']:.2f} ms ({rec['bf16']['tflops_per_s']:.1f}"
              f" TFLOP/s, {rec['bf16']['peak_mib']:.0f} MiB peak); "
              f"{rec['gflops_per_video']:.1f} GFLOP a video; "
              f"{rec['seconds']:.1f} s on {card}", flush=True)
        if (rec["max_rel"] > CNN18_REL or rec["cosine"] < CNN18_COS
                or not torch.isfinite(got).all()):
            raise SystemExit(f"19a {name}: the card disagrees with the CPU")
        del model, bf, x8, x1
        torch.cuda.empty_cache()
    return out


def cnn2d_steps(dev, card, videos, names) -> dict:
    """19b: one stats step card vs CPU for each recipe of STEP19 from the
    training init on seeded clips through the recipe's own pipeline."""
    out = {"card": card}
    for name in STEP19:
        t0 = time.perf_counter()
        cfg = shipped_training_config(CNN_CONFIGS / CNN19[name],
                                      **STEP19_DEPTH.get(name, {}))
        clips = _step_clips(cfg, videos, names[:TRAIN19_CPU_BATCH])
        labels = (np.arange(TRAIN19_CPU_BATCH) * 7) % cfg["model.num_classes"]
        bf16s = (False, True) if name in STEP19_BF16 else (False,)
        rec = step_card_vs_cpu(dev, cfg, clips, labels, None, bf16s)
        rec["seconds"] = time.perf_counter() - t0
        out[name] = rec
        for key in ("f32", "bf16")[:len(bf16s)]:
            r = rec[key]
            by = r["by_group"]
            groups = {g: round(v["card_f64_cos"], 6) for g, v in by.items()}
            planted = {k: v.get("refused", v.get("refused_in"))
                       for k, v in r["planted"].items()}
            print(f"19b {name} one stats step at batch {TRAIN19_CPU_BATCH} "
                  f"{key}, card vs CPU held to float64 (witness "
                  f"{rec['f64_max_rel']:.1e} <= {STEP18_F64}, worst "
                  f"{rec['f64_worst'][0][1]}): loss card {r['loss_card']:.6f}"
                  f" CPU {r['loss_cpu']:.6f} (rel {r['loss_rel']:.1e}); whole "
                  f"gradient 1 - cosine to float64 card "
                  f"{1 - by['all']['card_f64_cos']:.2e} CPU "
                  f"{1 - by['all']['cpu_f64_cos']:.2e}; by group "
                  f"{json.dumps(groups)}; update/bound "
                  f"{r['update_over_bound']:.3f}; failed {r['failed']} "
                  f"(groups {r['bad_groups']}, tensors {r['bad_tensors']}); "
                  f"planted faults refused {json.dumps(planted)}; step "
                  f"card {r['card_s']:.2f} s CPU {r['cpu_s']:.2f} s (at "
                  f"{r['cpu_threads'][1]} threads {r['cpu_alt_s']:.2f} s); "
                  f"{rec['seconds']:.1f} s on {card}", flush=True)
        if rec["failed"]:
            raise SystemExit(f"19b {name}: {rec['failed']}; " + "; ".join(
                f"{k} groups {rec[k]['bad_groups']} tensors "
                f"{rec[k]['bad_tensors']}" for k in ("f32", "bf16")
                if k in rec))
    return out


def tsm_cli(dev, card, tmp, videos, names) -> dict:
    """19c: recognition_cli_run on the shipped tsm_r50_1x1x8_k400.py."""
    return recognition_cli_run(dev, card, tmp, videos, names,
                               CNN_CONFIGS / CNN19["tsm_r50_1x1x8"], "19c",
                               "Recognizer2D")


def recognition_cli_run(dev, card, tmp, videos, names, config, tag: str,
                        model_type: str, **options) -> dict:
    """recognition_train.train_from_config on a shipped config (with
    `options` set) at batch 8 over the seeded videos, one epoch with
    validation, then recognition_test.test_from_config on its model_best
    over the validation split (scores against a direct forward_test of
    the same clips); the trained model must be a `model_type`."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import (recognition_test,
                                                        recognition_train)
    from cross_modal_video_engine_tpu_torch.data.pipelines import (
        build_pipeline, with_reader)

    line = {"card": card}
    train_ann = write_training_split(tmp, names, "cls", 59)
    val_ann = write_training_split(tmp, names[:TRAIN18_VAL], "cls", 59)
    cfg = shipped_training_config(
        config,
        **{"data.train.ann_file": train_ann, "data.train.data_prefix": None,
           "data.val.ann_file": val_ann, "data.val.data_prefix": None,
           "data.videos_per_gpu": TRAIN18_BATCH,
           "total_epochs": TRAIN19_EPOCHS, "eval_interval": 1, **options})
    work = os.path.join(tmp, config.stem)
    t0 = time.perf_counter()
    state, history = recognition_train.train_from_config(
        cfg, work, device=dev, reader=videos.__getitem__)
    torch.cuda.synchronize()
    line["train"] = {"history": history, "seconds": time.perf_counter() - t0}
    if type(state.model).__name__ != model_type or not all(
            np.isfinite(h["loss"]) for h in history):
        raise SystemExit(f"{tag} the recognition CLI failed on "
                         f"{config.name}")
    best = os.path.join(work, "model_best")
    out = os.path.join(tmp, f"{config.stem}_scores.npz")
    # the test protocol's fixed frame offsets, so that the direct run
    # below sees the CLI's clips
    cfg.set("data.pipeline", [dict(op, test_mode=True)
                              if op["type"] == "SampleFrames" else op
                              for op in cfg["data.pipeline"]])
    t0 = time.perf_counter()
    report = recognition_test.test_from_config(cfg, best, dev, out=out,
                                               reader=videos.__getitem__)
    line["test"] = {"report": report, "seconds": time.perf_counter() - t0}
    model = recognition_test.load_recognizer(cfg, best, dev)
    pipe = build_pipeline(with_reader(cfg["data.pipeline"],
                                      videos.__getitem__))
    clips = np.concatenate([pipe({"filename": n, "start_index": 0})["imgs"]
                            for n in names[:TRAIN18_VAL]]).astype(np.float32)
    with torch.no_grad():
        direct = model.forward_test(torch.from_numpy(clips).to(dev)).cpu()
    scores = torch.from_numpy(np.load(out)["scores"])
    line["test"]["scores_max_rel"] = _max_rel(scores, direct)
    print(f"{tag} recognition_train ({config.name}, f32) over "
          f"{len(names)} seeded videos, batch {TRAIN18_BATCH}: "
          f"{json.dumps(history)} in {line['train']['seconds']:.1f} s; "
          f"recognition_test on model_best over {TRAIN18_VAL} videos: "
          f"{json.dumps(report)} in {line['test']['seconds']:.1f} s, scores "
          f"against a direct forward_test {line['test']['scores_max_rel']:.1e}"
          f" of the largest (need <= 1e-5) on {card}", flush=True)
    if line["test"]["scores_max_rel"] > 1e-5:
        raise SystemExit(f"{tag} recognition_test disagrees with "
                         f"forward_test")
    torch.cuda.empty_cache()
    return line


def check_step19(dev, card) -> Tuple[dict, dict]:
    """Step 19 (a-e): the 2D, TSM and pyramid recognizers.  Returns (the
    `cnn2d_recognizers` JSON object, the kernels' launches over the step:
    all must be 0)."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve

    t_step = time.perf_counter()
    counted = kernel_counters()
    for fn in counted.values():
        fn.launches = 0
    line = {"card": card}
    t0 = time.perf_counter()
    line["forwards"] = cnn2d_forwards(dev, card)
    line["forwards"]["seconds"] = time.perf_counter() - t0
    videos = bserve.seeded_videos(TRAIN18_VIDEOS, seed=19,
                                    **TRAIN_VIDEO_HW)
    names = sorted(videos)
    t0 = time.perf_counter()
    line["steps"] = cnn2d_steps(dev, card, videos, names)
    line["steps"]["seconds"] = time.perf_counter() - t0
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        line["tsm_cli"] = tsm_cli(dev, card, tmp, videos, names)
        line["tsm_cli"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        line["tsm_caption"] = served_caption(
            dev, card, tmp, videos, names, TSM_RELSEQ_CONFIG, "19d", 60,
            TRAIN19_EPOCHS)
        line["tsm_caption"]["seconds"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    line["launches"] = launches
    line["seconds"] = time.perf_counter() - t_step
    print(f"19e kernel launches over step 19: {json.dumps(launches)} (need "
          f"0: no 2D, TSM or pyramid path reaches a kernel); step 19 checked "
          f"in {line['seconds']:.1f} s on {card}", flush=True)
    if any(launches.values()):
        raise SystemExit("19e a 2D, TSM or pyramid path launched a kernel")
    return line, launches


# -- 20. the transformer and CLIP recognizers (part 8c) ------------------------
# 20a: each shipped recipe at its own widths (400 classes, its clip
# length at 224², the training init from numpy seed 0) and the two relseq
# recipes' pooled backbones; card vs CPU at batch 1 in f32 (TF32 off):
# logits or features within TX20_REL of the largest; forwards at batch
# TX20_BATCH in f32 and through the bf16=True copy (the trainer's bf16
# parameters via functional_call), TFLOP/s of every product aten counts
TX20 = {"swin_tiny": "swin_tiny_k400.py", "mvit_small": "mvit_small_k400.py",
        "videomae_b_16x4": "videomae_b_16x4_k400.py",
        "clip_mean_pooling_8x32": "clip_mean_pooling_8x32_k400.py",
        "videoclip_ctv": "videoclip_ctv_extraction_k400.py"}
RELSEQ20 = {"mvit_relseq": ROOT / "configs" / "seq_generate" /
            "mvit_relseq.py",
            "videomae_relseq": ROOT / "configs" / "seq_generate" /
            "videomae_relseq.py"}
TX20_REL, TX20_COS, TX20_BATCH, TX20_TIMED = 1e-3, 0.999, 8, 3
# 20b: clip_mean_pooling_8x32 with fused_attn=fused_mlp=True against the
# plain arm on the same weights at batch CLIP20_BATCH (x 8 frames), in bf16
# (the config's compute dtype; f32 masters) and f32: logits by cosine >=
# CLIP20_COS (f32 also within CLIP20_F32_REL of the largest), exactly
# CLIP20_LAUNCHES compact and MLP launches a forward, one training step of
# each arm with the gradients by group at cosine >= CLIP20_GRAD_COS
CLIP20_BATCH, CLIP20_COS, CLIP20_F32_REL, CLIP20_LAUNCHES = 8, 0.999, 1e-4, 12
CLIP20_GRAD_COS = {"f32": 0.9999, "bf16": 0.999}
# 20c: one make_cls_train_step card vs CPU at batch 1 from the training
# init per recipe (at STEP20_DEPTH), held to float64 by step_card_vs_cpu
# (18b's bounds and planted faults); bf16 too for STEP20_BF16
STEP20_BF16 = ("swin_tiny", "videomae_b_16x4")
# depth cut for the script's time (widths kept, 20a runs full depth):
# VideoMAE-B's step took 65.2 s of 20c at 12 layers, the five 133 s;
# the whole script must stay well inside its 1200 s time limit
STEP20_DEPTH = {"swin_tiny": {"model.backbone.depths": [2, 2, 2, 2]},
                "mvit_small": {"model.backbone.depths": [1, 1, 1, 1]},
                "videomae_b_16x4": {"model.backbone.num_layers": 1},
                "clip_mean_pooling_8x32": {
                    "model.backbone.vision_layers": 1},
                # 20a's relseq features (their recipes' backbones run 20a
                # at full depth)
                "mvit_relseq": {"model.backbone.depths": [1, 1, 1, 1]},
                "videomae_relseq": {"model.backbone.num_layers": 4}}
TRAIN20_CPU_BATCH = 1


def _pipeline_clip(cfg) -> Tuple[int, int]:
    """(T, crop) of a config's pipeline."""
    ops = {op["type"]: op for op in cfg["data.pipeline"]}
    return ops["SampleFrames"]["clip_len"], ops["CenterCrop"]["crop_size"]


def _product_flops(fn) -> float:
    """The FLOPs of every matrix product and convolution fn() runs, as
    torch's FlopCounterMode counts them (2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


def transformer_forwards(dev, card) -> dict:
    """20a (see TX20 above)."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import (caption_train,
                                                        recognition_train)
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        _bf16_forward)

    out = {"card": card}
    rng = np.random.default_rng(20)
    recipes = [(n, CNN_CONFIGS / f) for n, f in TX20.items()]
    recipes += list(RELSEQ20.items())
    for name, path in recipes:
        t0 = time.perf_counter()
        cfg = shipped_training_config(
            path, **(STEP20_DEPTH.get(name, {}) if name in RELSEQ20 else {}))
        t, size = _pipeline_clip(cfg)
        shape = (t, size, size)
        models = {}
        for where_, d in (("card", dev), ("cpu", torch.device("cpu"))):
            if name in RELSEQ20:
                models[where_] = caption_train.build_caption_model(
                    cfg, d, shape)[0].backbone.eval()
            else:
                models[where_] = recognition_train.build_recognition_model(
                    cfg, d, input_shape=shape).eval()
        x1 = torch.from_numpy(rng.standard_normal((1, *shape, 3),
                                                  dtype=np.float32))
        with torch.no_grad():
            t1 = time.perf_counter()
            want = models["cpu"](x1)
            cpu_s = time.perf_counter() - t1
            got = models["card"](x1.to(dev)).cpu()
        del models["cpu"]
        model = models["card"]
        rec = {"clip": [t, size], "type": type(model).__name__,
               "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
               "max_rel": _max_rel(got, want), "cosine": _cosine(got, want),
               "cpu_s": cpu_s}
        if name not in RELSEQ20:
            x8 = torch.from_numpy(rng.standard_normal(
                (TX20_BATCH, *shape, 3), dtype=np.float32)).to(dev)
            with torch.no_grad():
                flops = _product_flops(lambda: model(x8))
            bf16 = _bf16_forward(model)
            for dtype, fn in (("f32", lambda: model(x8)),
                              ("bf16_copy", lambda: bf16(x8))):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                with torch.no_grad():
                    ms = cuda_ms(fn, iters=TX20_TIMED, warmup=2)
                rec[dtype] = {"ms": ms,
                              "videos_per_s": TX20_BATCH * 1e3 / ms,
                              "tflops_per_s": flops / ms / 1e9,
                              "peak_mib": torch.cuda.max_memory_allocated(
                                  dev) / 2 ** 20}
            rec["gflops_per_video"] = flops / TX20_BATCH / 1e9
            del x8, bf16
        rec["seconds"] = time.perf_counter() - t0
        out[name] = rec
        timed = (f"; forward at batch {TX20_BATCH}: f32 "
                 f"{rec['f32']['ms']:.2f} ms ({rec['f32']['tflops_per_s']:.1f}"
                 f" TFLOP/s, {rec['f32']['peak_mib']:.0f} MiB peak), through "
                 f"the bf16=True copy {rec['bf16_copy']['ms']:.2f} ms "
                 f"({rec['bf16_copy']['tflops_per_s']:.1f} TFLOP/s, "
                 f"{rec['bf16_copy']['peak_mib']:.0f} MiB peak); "
                 f"{rec['gflops_per_video']:.1f} GFLOP a video"
                 if "f32" in rec else
                 f" (the pooled backbone feature, "
                 f"{json.dumps(STEP20_DEPTH[name])})")
        print(f"20a {name} ({path.name}, {rec['type']}, "
              f"{rec['params_m']:.2f}M parameters, {t}x{size}², training "
              f"init): card vs CPU at batch 1 f32 max |diff| / max |CPU| "
              f"{rec['max_rel']:.2e} (need <= {TX20_REL}), cosine "
              f"{rec['cosine']:.7f} (need >= {TX20_COS}){timed}; "
              f"{rec['seconds']:.1f} s on {card}", flush=True)
        if (rec["max_rel"] > TX20_REL or rec["cosine"] < TX20_COS
                or not torch.isfinite(got).all()):
            raise SystemExit(f"20a {name}: the card disagrees with the CPU")
        del model, models, x1
        torch.cuda.empty_cache()
    return out


def _group_cosines(a: dict, b: dict) -> dict:
    """Per group (_group) and over all parameters: the cosine of two
    gradient dicts."""
    groups = {}
    for n in a:
        groups.setdefault(_group(n), []).append(n)
    groups["all"] = list(a)
    return {g: _cosine(_flat_cat(a, ns), _flat_cat(b, ns))
            for g, ns in groups.items()}


def _flat_cat(d: dict, names):
    import torch
    return torch.cat([d[n].double().flatten() for n in names])


def clip_kernel_arm(dev, card) -> Tuple[dict, dict]:
    """20b (see CLIP20 above).  Returns (the readings, the kernel arm's
    launches over one forward of each dtype)."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import recognition_train
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_cls_train_step,
        make_rec_optimizer)

    counted = kernel_counters()
    out, per_forward = {"card": card}, {}
    rng = np.random.default_rng(21)
    path = CNN_CONFIGS / TX20["clip_mean_pooling_8x32"]
    for dtype in ("bf16", "f32"):
        t0 = time.perf_counter()
        base = shipped_training_config(path)
        t, size = _pipeline_clip(base)
        arms = {}
        for arm, fused in (("plain", False), ("kernel", True)):
            cfg = shipped_training_config(path, **{
                "model.backbone.dtype": "bfloat16" if dtype == "bf16"
                else "float32",
                "model.backbone.fused_attn": fused,
                "model.backbone.fused_mlp": fused})
            arms[arm] = recognition_train.build_recognition_model(cfg, dev)
            arms[arm].eval()
        arms["kernel"].load_state_dict(arms["plain"].state_dict())
        x = torch.from_numpy(rng.standard_normal(
            (CLIP20_BATCH, t, size, size, 3), dtype=np.float32)).to(dev)
        labels = torch.from_numpy((np.arange(CLIP20_BATCH) * 37) % 400).to(dev)
        with torch.no_grad():
            want = arms["plain"](x).float()
            torch.cuda.synchronize()
            for fn in counted.values():
                fn.launches = 0
            got = arms["kernel"](x).float()
            torch.cuda.synchronize()
            launches = {n: fn.launches for n, fn in counted.items()}
            times = {arm: cuda_ms(lambda m=m: m(x), iters=TX20_TIMED,
                                  warmup=2) for arm, m in arms.items()}
        rec = {"launches": launches, "cosine": _cosine(got, want),
               "max_rel": _max_rel(got, want), "forward_ms": times}
        per_forward[dtype] = launches
        # one training step of each arm from the same weights and batch
        # each arm's first step from the shared weights gives the
        # gradients; its second step is timed
        grads, step_ms, losses = {}, {}, {}
        for arm, model in arms.items():
            opt = make_rec_optimizer(RecognitionTrainConfig(
                **dict(base["optimizer"], warmup_steps=0)), 10)
            state = init_rec_state(model, opt)
            step = make_cls_train_step(model, device=dev)
            state, logs = step(state, x, labels)
            losses[arm] = float(logs["loss"])
            grads[arm] = {n: p.grad.detach().float().cpu()
                          for n, p in model.named_parameters()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(state, x, labels)
            torch.cuda.synchronize()
            step_ms[arm] = (time.perf_counter() - t1) * 1e3
        rec.update(step_ms=step_ms, losses=losses,
                   grad_cosines=_group_cosines(grads["kernel"],
                                               grads["plain"]))
        rec["seconds"] = time.perf_counter() - t0
        out[dtype] = rec
        need = CLIP20_GRAD_COS[dtype]
        print(f"20b clip_mean_pooling_8x32 {dtype} at batch {CLIP20_BATCH} "
              f"({CLIP20_BATCH * t} frames of {size}²): kernel arm "
              f"(fused_attn=fused_mlp=True) against the plain arm on the "
              f"same weights, logits cosine {rec['cosine']:.7f} (need >= "
              f"{CLIP20_COS}), max |diff| / max {rec['max_rel']:.2e}"
              + (f" (need <= {CLIP20_F32_REL})" if dtype == "f32" else "")
              + f"; launches a forward {json.dumps(launches)} (need "
              f"{CLIP20_LAUNCHES} compact and {CLIP20_LAUNCHES} MLP); "
              f"forward ms kernel {times['kernel']:.2f} plain "
              f"{times['plain']:.2f}; a training step (the sublayers' "
              f"plain backward; the second step timed) ms kernel "
              f"{step_ms['kernel']:.1f} plain "
              f"{step_ms['plain']:.1f}, loss {losses['kernel']:.6f} vs "
              f"{losses['plain']:.6f}, gradient cosines by group "
              f"{json.dumps({k: round(v, 7) for k, v in rec['grad_cosines'].items()})}"
              f" (need >= {need}); {rec['seconds']:.1f} s on {card}",
              flush=True)
        bad = (rec["cosine"] < CLIP20_COS
               or (dtype == "f32" and rec["max_rel"] > CLIP20_F32_REL)
               or launches["fused_attention_sublayer_compact"]
               != CLIP20_LAUNCHES
               or launches["fused_mlp_sublayer"] != CLIP20_LAUNCHES
               or any(v for k, v in launches.items() if k not in (
                   "fused_attention_sublayer_compact", "fused_mlp_sublayer"))
               or min(rec["grad_cosines"].values()) < need
               or not all(np.isfinite(v) for v in losses.values()))
        if bad:
            raise SystemExit(f"20b the CLIP kernel arm ({dtype}) failed")
        del arms, x, grads
        torch.cuda.empty_cache()
    return out, per_forward


def transformer_steps(dev, card, videos, names) -> dict:
    """20c: one make_cls_train_step card vs CPU for each recipe (its depth
    cut as STEP20_DEPTH says) from the training init on seeded clips
    through the recipe's own pipeline."""
    out = {"card": card}
    for name, file in TX20.items():
        t0 = time.perf_counter()
        cfg = shipped_training_config(CNN_CONFIGS / file,
                                      **STEP20_DEPTH.get(name, {}))
        clips = _step_clips(cfg, videos, names[:TRAIN20_CPU_BATCH])
        labels = (np.arange(TRAIN20_CPU_BATCH) * 7) % cfg["model.num_classes"]
        bf16s = (False, True) if name in STEP20_BF16 else (False,)
        rec = step_card_vs_cpu(dev, cfg, clips, labels, None, bf16s)
        rec["seconds"] = time.perf_counter() - t0
        out[name] = rec
        for key in ("f32", "bf16")[:len(bf16s)]:
            r = rec[key]
            by = r["by_group"]
            groups = {g: round(v["card_f64_cos"], 6) for g, v in by.items()}
            planted = {k: v.get("refused", v.get("refused_in"))
                       for k, v in r["planted"].items()}
            print(f"20c {name} ({json.dumps(STEP20_DEPTH.get(name, {}))}) "
                  f"one step at batch {TRAIN20_CPU_BATCH} {key}, "
                  f"card vs CPU held to float64 (witness "
                  f"{rec['f64_max_rel']:.1e} <= {STEP18_F64}, worst "
                  f"{rec['f64_worst'][0][1]}): loss card {r['loss_card']:.6f}"
                  f" CPU {r['loss_cpu']:.6f} (rel {r['loss_rel']:.1e}); whole "
                  f"gradient 1 - cosine to float64 card "
                  f"{1 - by['all']['card_f64_cos']:.2e} CPU "
                  f"{1 - by['all']['cpu_f64_cos']:.2e}; by group "
                  f"{json.dumps(groups)}; update/bound "
                  f"{r['update_over_bound']:.3f}; failed {r['failed']} "
                  f"(groups {r['bad_groups']}, tensors {r['bad_tensors']}); "
                  f"planted faults refused {json.dumps(planted)}; step "
                  f"card {r['card_s']:.2f} s CPU {r['cpu_s']:.2f} s; "
                  f"{rec['seconds']:.1f} s on {card}", flush=True)
        if rec["failed"]:
            raise SystemExit(f"20c {name}: {rec['failed']}; " + "; ".join(
                f"{k} groups {rec[k]['bad_groups']} tensors "
                f"{rec[k]['bad_tensors']}" for k in ("f32", "bf16")
                if k in rec))
    return out


def check_step20(dev, card) -> Tuple[dict, dict, dict]:
    """Step 20 (a-e): the transformer and CLIP recognizers.  Returns (the
    `transformer_recognizers` JSON object, the kernels' launches over the
    step's paths but 20b (all must be 0), the CLIP kernel arm's launches
    over one bf16 forward)."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve

    t_step = time.perf_counter()
    counted = kernel_counters()

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def read():
        torch.cuda.synchronize()
        return {n: fn.launches for n, fn in counted.items()}

    other = dict.fromkeys(counted, 0)

    def add(counts):
        for n, v in counts.items():
            other[n] += v

    line = {"card": card}
    zero()
    t0 = time.perf_counter()
    line["forwards"] = transformer_forwards(dev, card)
    line["forwards"]["seconds"] = time.perf_counter() - t0
    add(read())
    t0 = time.perf_counter()
    line["clip_kernel_arm"], clip_launches = clip_kernel_arm(dev, card)
    line["clip_kernel_arm"]["seconds"] = time.perf_counter() - t0
    videos = bserve.seeded_videos(TRAIN18_VIDEOS, seed=20,
                                    **TRAIN_VIDEO_HW)
    names = sorted(videos)
    zero()
    t0 = time.perf_counter()
    line["steps"] = transformer_steps(dev, card, videos, names)
    line["steps"]["seconds"] = time.perf_counter() - t0
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        line["swin_cli"] = recognition_cli_run(
            dev, card, tmp, videos, names, CNN_CONFIGS / TX20["swin_tiny"],
            "20d", "BackboneClassifier",
            # the recipe's 1000 warmup steps need a longer run than 2 steps
            **{"optimizer.warmup_steps": 0})
        line["swin_cli"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        line["videomae_caption"] = served_caption(
            dev, card, tmp, videos, names, RELSEQ20["videomae_relseq"],
            "20d", 61, 1, route_pipeline=True)
        line["videomae_caption"]["seconds"] = time.perf_counter() - t0
    add(read())
    line["launches"] = other
    line["clip_kernel_arm_launches"] = clip_launches
    line["seconds"] = time.perf_counter() - t_step
    print(f"20e kernel launches over step 20 but 20b: {json.dumps(other)} "
          f"(need 0: JAX's Swin, MViT, VideoMAE and VideoCLIP use plain "
          f"products, as the port does, and the recipes' CLIP runs unfused); "
          f"20b's kernel arm a bf16 forward: "
          f"{json.dumps(clip_launches['bf16'])}; step 20 checked in "
          f"{line['seconds']:.1f} s on {card}", flush=True)
    if any(other.values()):
        raise SystemExit("20e a path of step 20 other than 20b launched a "
                         "kernel")
    return line, other, clip_launches["bf16"]


def dataclass_fields(cfg) -> dict:
    import dataclasses
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k != "anchors"}


def kernel_json(results, launches, core, block_extra, counts) -> dict:
    """The kernels line: bf16 errors over every case of a kernel; times,
    bound and library time of its main-path case; `launches` on the main
    path of steps 4, 6 and 8, and by route or trainer (`counts`, each None
    when its step did not run): `composed_launches` over the requests of
    the ViT-B/32 composed route (step 12d), `caption_launches` over the
    batch-1 requests of the caption route (step 13), `explain_launches`
    over the batch-1 requests of the explain route (step 14),
    `training_launches` over the joint caption steps of step 15c,
    `ctv_launches` over the bank build of step 16c,
    `caption_transformer_launches` over the greedy and beam generates of
    step 17a, `detector_training_launches` over the detection trainer's
    run of step 17b, `cnn_launches` over the 3D-CNN recognizers of step
    18, `cnn2d_launches` over the 2D, TSM and pyramid recognizers of step
    19, `transformer_launches` over the transformer and CLIP recognizers
    of step 20 but 20b, `clip_recognizer_launches` over one bf16 forward
    of 20b's CLIP kernel arm, `recipes_launches` over the counted calls of
    step 21d, `localization_launches` over step 22, `detection_launches`
    over step 23, `host_tools_launches` over 24c's host-feed loop and 24d's
    card run of dump_features, `skeleton_convert_launches` over step 25.
    A main-path count is None when its step did not run.
    `bound_ms` is the
    larger of the case's bytes over the card's memory rate and its
    operations over the bf16 tensor-core peak.  The attention sublayers
    also carry the host time of one call and their core kernel by itself
    at the same rows (`core_ms`, beside its bytes bound); the block kernel
    its route, ptxas's registers and spills of both bf16 routes, the
    12-layer stack beside the chain's, and its ablation."""
    core_case = {"fused_attention_sublayer_compact": "vision 6400 rows",
                 "fused_attention_sublayer": "text 616 rows causal"}
    main_case = {"fused_attention_sublayer_compact": "compact vision",
                 "fused_attention_sublayer": "rank-3 causal text",
                 "fused_mlp_sublayer": "mlp vision",
                 "fused_block_sublayer_compact": BLOCK_MAIN_CASE,
                 "flash_attention": next(iter(FLASH_CASES))}
    sources = {"fused_attention_sublayer_compact": "attention_core.cu",
               "fused_attention_sublayer": "attention_core.cu",
               "fused_mlp_sublayer": "gemm.cu",
               "fused_block_sublayer_compact": "block_sublayer.cu",
               "flash_attention": "flash_attention.cu"}
    replaces = {"fused_attention_sublayer_compact": f"{TPU_SRC}:354",
                "fused_attention_sublayer": f"{TPU_SRC}:132",
                "fused_mlp_sublayer": f"{TPU_SRC}:479",
                "fused_block_sublayer_compact": f"{TPU_SRC}:617",
                "flash_attention": TPU_FLASH}
    kernels = []
    for name, case in main_case.items():
        bf16 = [r for r in results
                if r["kernel"] == name and r["dtype"] == "bfloat16"]
        main = next(r for r in bf16 if r["case"] == case)
        flops, nbytes = main["bound"]
        by_ops, by_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        kernels.append({
            "name": name, "route": "cuda", "source": SRC + sources[name],
            "replaces": replaces[name],
            "launches": launches.get(name),
            **{f"{route}_launches": (None if c is None else c.get(name, 0))
               for route, c in counts.items()},
            "max_abs_err": max(r["err"] for r in bf16),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": main["library_ms"]})
        if name == "fused_block_sublayer_compact" and block_extra:
            kernels[-1].update(route=main["route"], **block_extra)
        if name in core_case:
            c = core[core_case[name]]
            kernels[-1].update(host_us=main["host_us"], core_ms=c["ms"],
                               core_bound_ms=c["bound_ms"],
                               core_library_ms=c["library_ms"])
    return {"kernels": kernels}


# -- step 21: the training recipes and the bf16-configured TimeSformer ----------

# 21a: the shipped multigrid recipe (SlowFast-R50 4x16, 400 classes): one
# stats step in each of its buckets, MG21_TIMED timed by CUDA events; card
# vs CPU at batch 1 in its coarsest and finest buckets; the CLI over
# MG21_VIDEOS seeded videos with the shipped buckets at 1/8 of their batch
# (base_batch 1), one epoch a stage and one final epoch, so that its
# history shows the switch from the coarsest to the finest bucket
MULTIGRID21_CONFIG = CNN_CONFIGS / "slowfast_multigrid_k400.py"
MG21_TIMED, MG21_VIDEOS, MG21_EPOCHS = 2, 8, 2
# the card-vs-CPU steps with the SlowFast at one block a stage (widths
# kept; 17.5 s for both at full depth)
MG21_STEP_DEPTH = {"model.backbone.depth_blocks": [1, 1, 1, 1]}
MG21_CLI_BUCKETS = [[8, 4, 112], [4, 8, 112], [2, 8, 224], [1, 8, 224]]
# 21b: the shipped OmniSource recipe (TSN-R50, 200 classes, batch 8, two
# aux sources) over OMNI21_MAIN seeded videos, each aux source a split of
# OMNI21_AUX of them: a whole aux cycle an epoch (one wave of one batch
# after every second of the two main steps), so that a resumed run meets
# the uninterrupted one; the frame sampler in test mode (its offsets
# fixed, as a resume needs)
OMNI21_CONFIG = CNN_CONFIGS / "tsn_r50_1x1x8_minikinetics_omnisource.py"
OMNI21_MAIN, OMNI21_AUX, OMNI21_VAL = 16, 8, 8
# 21c: mixup and cutmix on the stats step of the shipped TSN-R50 1x1x3
# recipe at batch 2, their draws handed in, its backbone at one block a
# stage (widths kept; 27.3 s for both at full depth)
BLEND21_CONFIG = CNN_CONFIGS / "tsn_r50_1x1x3_k400.py"
BLEND21_DEPTH = {"model.backbone.stage_blocks": [1, 1, 1, 1]}
BLEND21_DRAWS = {
    "MixupBlending": {"lam": np.float32(0.3125), "perm": np.array([1, 0])},
    "CutmixBlending": {"lam": np.float32(0.5625), "perm": np.array([1, 0]),
                       "cx": 150, "cy": 40}}
# 21d: TS_JOINT (ViT-B/16 joint, flash) configured bfloat16 on f32 masters
# (trained without bf16=True) at batch TS21_BATCH; card vs CPU at
# TS21_LAYERS of its 12 layers (widths kept)
TS21_BATCH, TS21_LAYERS, TS21_CLASSES = 2, 2, 400
# 21e: hvu_loss over the 3142 tags at batch HVU21_BATCH, card vs CPU
HVU21_BATCH, HVU21_REL = 8, 1e-5


def _schedule21(cfg):
    from cross_modal_video_engine_tpu_torch.train.multigrid import (
        GridBucket, MultigridSchedule)
    mg = dict(cfg["multigrid"])
    mg["buckets"] = tuple(GridBucket(*b) for b in mg["buckets"])
    return MultigridSchedule(**mg)


def multigrid_steps(dev, card, videos, names) -> dict:
    """21a: the bucket steps, card vs CPU in two buckets, the CLI."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import recognition_train
    from cross_modal_video_engine_tpu_torch.train.multigrid import GridBucket
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, adapt_clips_to_bucket, init_rec_state,
        make_multigrid_train_step, make_rec_optimizer)

    line = {"card": card}
    cfg = shipped_training_config(MULTIGRID21_CONFIG)
    sched = _schedule21(cfg)
    model = recognition_train.build_recognition_model(cfg, dev)
    # the recipe's optimizer, its 500-step warmup included
    state = init_rec_state(model, make_rec_optimizer(
        RecognitionTrainConfig(**cfg["optimizer"]), 10_000))
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = {}
    for b in sched.buckets:
        step = make_multigrid_train_step(model, b.batch_size
                                         / sched.base_batch, device=dev)
        x = torch.randn((b.batch_size, b.num_frames, b.resolution,
                         b.resolution, 3), generator=gen, device=dev)
        lab = torch.randint(0, 400, (b.batch_size,), generator=gen,
                            device=dev)
        held = {"state": state}

        def run():
            held["state"], held["logs"] = step(held["state"], x, lab)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(run, iters=MG21_TIMED, warmup=1)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        flops = _product_flops(run)
        state = held["state"]
        rows["x".join(map(str, (b.batch_size, b.num_frames,
                                b.resolution)))] = {
            "lr_scale": b.batch_size / sched.base_batch, "ms": ms,
            "videos_per_s": b.batch_size * 1e3 / ms,
            "tflops_per_s": flops / ms / 1e9, "peak_mib": peak,
            "loss": float(held["logs"]["loss"])}
        del x, lab, step
    line["buckets"] = rows
    print(f"21a slowfast_multigrid_k400.py (SlowFast-R50 4x16, 400 classes, "
          f"the recipe's optimizer) one stats step a bucket: "
          f"{json.dumps(rows)} on {card}", flush=True)
    if not all(np.isfinite(r["loss"]) for r in rows.values()):
        raise SystemExit("21a a multigrid bucket step is not finite")
    del model, state
    torch.cuda.empty_cache()

    raw = _step_clips(cfg, videos, names[:1])
    labels = np.array([7])
    for where, b in (("coarse", sched.buckets[0]), ("fine",
                                                   sched.buckets[-1])):
        one = GridBucket(1, b.num_frames, b.resolution)
        clips = adapt_clips_to_bucket(torch.from_numpy(raw), one).numpy()
        t0 = time.perf_counter()
        step_line = step_card_vs_cpu(
            dev, shipped_training_config(MULTIGRID21_CONFIG,
                                         **MG21_STEP_DEPTH),
            clips, labels, None, bf16s=(False,),
            update_scale=b.batch_size / sched.base_batch)
        step_line["seconds"] = time.perf_counter() - t0
        line[f"step_{where}"] = step_line
        print(f"21a one multigrid step in the {where} bucket "
              f"({b.num_frames}x{b.resolution}², lr_scale "
              f"{b.batch_size / sched.base_batch:g}) at batch 1 from the "
              f"training init, card vs CPU in f32: {json.dumps(step_line)} "
              f"(held to float64 as 18b)", flush=True)
        if step_line["failed"]:
            raise SystemExit(f"21a the {where} bucket's step failed: "
                             f"{step_line['failed']}")
    line["cli"] = multigrid_cli(dev, card, videos, names)
    return line


def multigrid_cli(dev, card, videos, names) -> dict:
    """21a: recognition_train on the multigrid recipe, its buckets at 1/8
    of their batch, a stage an epoch."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import recognition_train
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        ann = write_training_split(tmp, names[:MG21_VIDEOS], "cls", 211)
        cfg = shipped_training_config(
            MULTIGRID21_CONFIG,
            **{"data.train.ann_file": ann, "data.train.data_prefix": None,
               "data.val.ann_file": ann, "data.val.data_prefix": None,
               "data.videos_per_gpu": 8, "total_epochs": MG21_EPOCHS,
               # the recipe's 500 warmup steps need a longer run
               "optimizer.warmup_steps": 0,
               "multigrid.buckets": MG21_CLI_BUCKETS,
               "multigrid.base_batch": 1, "multigrid.long_cycle_epochs": 1,
               "multigrid.final_epochs": 1})
        t0 = time.perf_counter()
        state, history = recognition_train.train_from_config(
            cfg, os.path.join(tmp, "mg"), device=dev,
            reader=videos.__getitem__)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        final = os.path.isdir(os.path.join(tmp, "mg", "multigrid_final"))
    buckets = [list(h["bucket"]) for h in history]
    want = MG21_CLI_BUCKETS[:MG21_EPOCHS - 1] + MG21_CLI_BUCKETS[-1:]
    steps = [h["steps"] for h in history]
    print(f"21a recognition_train (slowfast_multigrid_k400.py, buckets "
          f"{MG21_CLI_BUCKETS}, base batch 1, warmup 0) over {MG21_VIDEOS} "
          f"seeded videos, {MG21_EPOCHS} epochs: {json.dumps(history)} in "
          f"{seconds:.1f} s; multigrid_final written: {final}", flush=True)
    if (buckets != want
            or steps != [MG21_VIDEOS // b[0] for b in want] or not final
            or not all(np.isfinite(h["loss"]) for h in history)
            or state.optimizer.count != sum(steps)):
        raise SystemExit("21a the multigrid CLI did not switch buckets as "
                         "the schedule says")
    return {"history": history, "seconds": seconds}


def _omni_cfg(tmp, names, epochs: int):
    main = write_training_split(tmp, names[:OMNI21_MAIN], "cls", 212)
    aux = [write_training_split(os.path.join(tmp, f"aux{i}"), part, "cls",
                                213 + i)
           for i, part in enumerate((names[:OMNI21_AUX],
                                     names[OMNI21_AUX:2 * OMNI21_AUX]))]
    val = write_training_split(os.path.join(tmp, "val"),
                               names[:OMNI21_VAL], "cls", 215)
    cfg = shipped_training_config(
        OMNI21_CONFIG,
        **{"data.train.ann_file": main, "data.train.data_prefix": None,
           "data.val.ann_file": val, "data.val.data_prefix": None,
           "total_epochs": epochs,
           "omnisource.aux": [dict(ann_file=a) for a in aux]})
    cfg.set("data.pipeline", [dict(op, test_mode=True)
                              if op["type"] == "SampleFrames" else op
                              for op in cfg["data.pipeline"]])
    # 200 classes: labels of the split files are 0-399
    for path in [main, val] + aux:
        lines = open(path).read().split("\n")
        with open(path, "w") as f:
            f.write("\n".join(f"{ln.split()[0]} {int(ln.split()[1]) % 200}"
                              for ln in lines if ln.strip()))
    return cfg


def omnisource_run(dev, card, videos, names) -> dict:
    """21b: the OmniSource CLI for two epochs, a resume from epoch_0 against
    the uninterrupted epoch 1, one step card vs CPU."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import recognition_train

    line = {"card": card}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    # cuDNN's default algorithms sum in an order that moves from call to
    # call, and eight steps of train-mode BatchNorm amplify that: the two
    # runs compared here take deterministic algorithms (torch warns of any
    # op that has none)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp, \
            contextlib.ExitStack() as restore:
        restore.callback(lambda: setattr(torch.backends.cudnn,
                                         "deterministic", flags[0]))
        restore.callback(lambda: setattr(torch.backends.cudnn, "benchmark",
                                         flags[1]))
        restore.callback(lambda: torch.use_deterministic_algorithms(
            flags[2]))
        for d in ("aux0", "aux1", "val"):
            os.makedirs(os.path.join(tmp, d))
        cfg = _omni_cfg(tmp, names, 2)
        work = os.path.join(tmp, "omni")
        t0 = time.perf_counter()
        _, history = recognition_train.train_from_config(
            cfg, work, device=dev, reader=videos.__getitem__)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        again = os.path.join(tmp, "omni_resumed")
        t0 = time.perf_counter()
        _, resumed = recognition_train.train_from_config(
            cfg, again, resume=os.path.join(work, "epoch_0"), device=dev,
            reader=videos.__getitem__)
        resume_s = time.perf_counter() - t0
        a = _epoch_tree(os.path.join(work, "epoch_1"))
        b = _epoch_tree(os.path.join(again, "epoch_1"))
        loops = [json.load(open(os.path.join(p, "epoch_1",
                                             "loop_state.json")))
                 for p in (work, again)]
        final = os.path.isdir(os.path.join(work, "omnisource_final"))
    diffs = torch.cat([(a[k].float() - b[k].float()).abs().flatten()
                       for k in a])
    worst = max((float((a[k].float() - b[k].float()).abs().max()), k,
                 float(a[k].float().abs().max())) for k in a)
    lr = cfg["optimizer"]["learning_rate"]
    one, two = history[1], resumed[0]
    resume = {"loss_uninterrupted": one["loss"], "loss_resumed": two["loss"],
              "loss_rel": abs(one["loss"] - two["loss"]) / abs(one["loss"]),
              "aux_loss_rel": abs(one["loss/aux0"] - two["loss/aux0"])
              / abs(one["loss/aux0"]),
              "state_share_within": float(
                  (diffs <= RESUME_PARAM_TOL).double().mean()),
              "state_max_abs": float(diffs.max()), "worst_leaf": worst,
              "loop_states": loops}
    line["cli"] = {"history": history, "seconds": cli_s,
                   "resume_seconds": resume_s, "resume": resume}
    keys = {"epoch", "loss", "top1_acc", "loss/aux0", "top1_acc/aux0",
            "loss/aux1", "top1_acc/aux1"}
    print(f"21b recognition_train ({OMNI21_CONFIG.name}, train_ratio "
          f"{cfg['omnisource.train_ratio']}, batch 8) over {OMNI21_MAIN} "
          f"seeded videos and two aux splits of {OMNI21_AUX}, 2 epochs: "
          f"{json.dumps(history)} in {cli_s:.1f} s; resumed from epoch_0 "
          f"({resume_s:.1f} s): {json.dumps(resume)} (need the losses "
          f"within {RESUME_LOSS_RTOL}, {RESUME_PARAM_SHARE} of the "
          f"parameters and statistics within {RESUME_PARAM_TOL}, all within "
          f"{2 * lr:g}); omnisource_final written: {final}", flush=True)
    if (len(history) != 2 or [h["epoch"] for h in resumed] != [1]
            or any(set(h) != keys for h in history)
            or loops[0] != loops[1]
            or loops[0]["it"] != 2 * OMNI21_MAIN // 8
            or resume["loss_rel"] > RESUME_LOSS_RTOL
            or resume["aux_loss_rel"] > RESUME_LOSS_RTOL
            or resume["state_share_within"] < RESUME_PARAM_SHARE
            or resume["state_max_abs"] > 2 * lr or not final
            or not all(np.isfinite(h["loss"]) for h in history)):
        raise SystemExit("21b the OmniSource CLI or its resume failed")
    torch.cuda.empty_cache()
    clips = _step_clips(cfg, videos, names[:1])
    t0 = time.perf_counter()
    step_line = step_card_vs_cpu(dev, cfg, clips, np.array([7]), None,
                                 bf16s=(False,), update_scale=1.0)
    step_line["seconds"] = time.perf_counter() - t0
    line["step"] = step_line
    print(f"21b one OmniSource step (the multigrid step at lr_scale 1) of "
          f"TSN-R50 at batch 1 from the training init, card vs CPU in f32: "
          f"{json.dumps(step_line)}", flush=True)
    if step_line["failed"]:
        raise SystemExit(f"21b the step failed: {step_line['failed']}")
    return line


def blending_steps(dev, card, videos, names) -> dict:
    """21c: mixup and cutmix on the TSN stats step, card vs CPU."""
    line = {"card": card}
    cfg = shipped_training_config(BLEND21_CONFIG, **BLEND21_DEPTH)
    clips = _step_clips(cfg, videos, names[:2])
    labels = np.array([3, 250])
    for kind, draws in BLEND21_DRAWS.items():
        t0 = time.perf_counter()
        step_line = step_card_vs_cpu(
            dev, cfg, clips, labels, None,
            blend=(kind, draws, cfg["model.num_classes"]))
        step_line["seconds"] = time.perf_counter() - t0
        line[kind] = step_line
        print(f"21c {kind} ({json.dumps({k: np.asarray(v).tolist() for k, v in draws.items()})}) "
              f"on the stats step of {BLEND21_CONFIG.name} at batch 2 "
              f"from the training init, card vs CPU in f32 and bf16: "
              f"{json.dumps(step_line)}", flush=True)
        if step_line["failed"]:
            raise SystemExit(f"21c the {kind} step failed: "
                             f"{step_line['failed']}")
    return line


def _flash21():
    from cross_modal_video_engine_tpu_torch.ops import flash_attention
    return flash_attention.flash_attention


def _head21(bcfg, seed: int, **head) -> dict:
    """The `cls_head.*` entries of models.recognizer.random_state_dict for
    a head on bcfg's width, drawn on a one-block, one-patch stand-in of
    bcfg (the head's shapes follow the width alone), not on 86M backbone
    numbers drawn again."""
    import dataclasses
    from cross_modal_video_engine_tpu_torch.models.recognizer import (
        random_state_dict)
    tiny = dataclasses.replace(bcfg, num_layers=1, img_size=bcfg.patch_size,
                               num_frames=bcfg.tubelet_size)
    return {k: v for k, v in random_state_dict(tiny, seed, **head).items()
            if k.startswith("cls_head.")}


def timesformer_bf16_config(dev, card) -> Tuple[dict, int]:
    """21d.  Returns (the line, flash launches over its counted calls)."""
    import torch
    from cross_modal_video_engine_tpu_torch.config import Config
    from cross_modal_video_engine_tpu_torch.models.decoder_head import (
        RNNDecoderConfig)
    from cross_modal_video_engine_tpu_torch.models.recognizer import (
        SHUFFLE_RECOGNIZERS, Recognizer3D, Recognizer3DRelseq,
        random_state_dict)
    from cross_modal_video_engine_tpu_torch.models.timesformer import (
        TimeSformerConfig)
    from cross_modal_video_engine_tpu_torch.ops.flash_attention import (
        _reference_attention)
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_cls_train_step,
        make_rec_optimizer, make_seq_train_step)

    flash = _flash21()
    line = {"card": card, "backbone": "TS_JOINT", "dtype": "bfloat16",
            "batch": TS21_BATCH}
    bcfg = TimeSformerConfig(**TS_JOINT)
    if bcfg.dtype != "bfloat16" or not bcfg.use_flash_attention:
        raise SystemExit("21d TS_JOINT is not the bf16 flash config")
    layers = bcfg.num_layers         # one flash launch a block a pass
    tcfg = RecognitionTrainConfig(**shipped_training_config(
        RECOGNITION_CONFIG)["optimizer"])
    rng = np.random.default_rng(21)
    clips = normalised_clips(rng, TS21_BATCH, dev)
    labels = torch.from_numpy(rng.integers(0, TS21_CLASSES,
                                           TS21_BATCH)).to(dev)
    launches, runs = 0, {}

    def counted(name, fn, want):
        nonlocal launches
        torch.cuda.synchronize()
        flash.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        n = flash.launches
        launches += n
        runs[name] = {"launches": n, "want": want,
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "peak_mib": torch.cuda.max_memory_allocated(dev)
                      / 2 ** 20}
        return out

    sd = random_state_dict(bcfg, seed=21, num_classes=TS21_CLASSES)
    model = Recognizer3D(bcfg, TS21_CLASSES, device=dev)
    model.load_state_dict(sd)
    masters = {str(p.dtype) for p in model.parameters()}
    with torch.no_grad():
        logits = counted("forward", lambda: model(clips), layers)
        tokens = model.backbone.embed_tokens(clips)
    line["masters"], line["logits_dtype"] = sorted(masters), str(
        logits.dtype)
    line["tokens_dtype"] = str(tokens.dtype)
    state = init_rec_state(model, make_rec_optimizer(tcfg, 10))
    step = make_cls_train_step(model, device=dev)
    state, logs = counted("cls_step", lambda: step(state, clips, labels),
                          layers)
    runs["cls_step"]["loss"] = float(logs["loss"])
    flops = _product_flops(lambda: step(state, clips, labels))
    ms = cuda_ms(lambda: step(state, clips, labels), iters=3, warmup=1)
    runs["cls_step"].update(event_ms=ms, tflops_per_s=flops / ms / 1e9,
                            videos_per_s=TS21_BATCH * 1e3 / ms)

    # block 0's attention, f32, through the kernel and its plain version
    with torch.no_grad():
        blk = model.backbone.blocks[0]
        attn = blk.attentions[0].attn
        h = blk.norms[0](model.backbone.embed_tokens(clips))
        wq, bq, wk, bk, wv, bv = attn.qkv_params()
        b_, s_, d_ = h.shape
        q, k, v = (torch.nn.functional.linear(h, w, bias).reshape(
            b_, s_, attn.heads, d_ // attn.heads).transpose(1, 2)
            for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
        scale = (d_ // attn.heads) ** -0.5
        got = flash(q, k, v, scale)
        want = _reference_attention(q, k, v, scale, False)
        kern_ms = cuda_ms(lambda: flash(q, k, v, scale), iters=10)
        plain_ms = cuda_ms(lambda: _reference_attention(q, k, v, scale,
                                                        False), iters=10)
    err = float((got.float() - want.float()).abs().max())
    line["block0_flash"] = {"shape": [b_ * attn.heads, s_, d_ // attn.heads],
                            "dtype": str(q.dtype), "max_abs_err": err,
                            "tol": TOL["float32"], "ms": kern_ms,
                            "plain_ms": plain_ms}
    del state, step, q, k, v, got, want, h

    # the shipped caption decoder, on this backbone's width
    dec = dict(relseq_model()["decoder"], in_channels=bcfg.embed_dims)
    seq = Recognizer3DRelseq(bcfg, RNNDecoderConfig(**dec), device=dev)
    seq.load_state_dict({**{k: v for k, v in sd.items()
                            if k.startswith("backbone.")},
                         **_head21(bcfg, 22,
                                   decoder_cfg=RNNDecoderConfig(**dec))})
    targets = torch.from_numpy((rng.random(
        (TS21_BATCH, dec["max_len"], dec["num_classes"])) > 0.7).astype(
        np.float32)).to(dev)
    mask = torch.ones(TS21_BATCH, dec["max_len"], device=dev)
    sstate = init_rec_state(seq, make_rec_optimizer(tcfg, 10))
    sstep = make_seq_train_step(seq, device=dev)
    sstate, slogs = counted("seq_step", lambda: sstep(sstate, clips, targets,
                                                      mask), layers)
    runs["seq_step"]["loss"] = float(slogs["loss"])
    del seq, sstate, sstep, model

    shuffled = clips[:, torch.from_numpy(rng.permutation(8)).to(dev)]
    for cls in SHUFFLE_RECOGNIZERS:
        extra = cls.__name__.endswith("Extra")
        n = TS21_CLASSES + 1 if extra else TS21_CLASSES
        sm = cls(bcfg, n, device=dev)
        sm.load_state_dict({**{k: v for k, v in sd.items()
                               if k.startswith("backbone.")},
                            **_head21(bcfg, 23, num_classes=n)})
        opt = make_rec_optimizer(tcfg, 10)(list(sm.named_parameters()))

        def shuffle_step():
            opt.zero_grad(set_to_none=True)
            out = sm.forward_train(clips, shuffled, labels)
            out["loss"].backward()
            opt.step()
            return out

        out = counted(cls.__name__, shuffle_step, 2 * layers)
        runs[cls.__name__]["losses"] = {k: float(v) for k, v in out.items()}
        del sm, opt
    torch.cuda.empty_cache()
    line["runs"] = runs

    # card vs CPU at TS21_LAYERS layers (widths kept), held to float64
    small = Config({"model": {"backbone": dict(
        TS_JOINT, type="TimeSformer", num_layers=TS21_LAYERS,
        drop_path_max=0.0), "num_classes": TS21_CLASSES},
        "optimizer": dict(shipped_training_config(
            RECOGNITION_CONFIG)["optimizer"])})
    one = clips[:1].cpu().numpy()
    # the float64 witness without the bf16 roundings of the input and the
    # embeddings (their gradients pass through bf16, so float64 runs that
    # keep them differ by a flipped rounding): card and CPU keep them alike
    witness = Config({"model": {"backbone": dict(
        small["model.backbone"], dtype="float32"),
        "num_classes": TS21_CLASSES}, "optimizer": small["optimizer"]})
    t0 = time.perf_counter()
    step_line = step_card_vs_cpu(dev, small, one, np.array([11]), None,
                                 bf16s=(False,), witness_cfg=witness)
    step_line["seconds"] = time.perf_counter() - t0
    line["step_card_vs_cpu"] = step_line
    bad = [k for k, r in runs.items() if r["launches"] != r["want"]]
    finite = all(np.isfinite(r.get("loss", 0.0)) and all(
        np.isfinite(x) for x in r.get("losses", {}).values())
        for r in runs.values())
    print(f"21d TS_JOINT configured bfloat16 (ViT-B/16 joint, flash, 8x224²,"
          f" 400 classes) on f32 masters {line['masters']}, trained without "
          f"bf16=True at batch {TS21_BATCH}: tokens "
          f"{line['tokens_dtype']}, logits {line['logits_dtype']}; "
          f"{json.dumps(runs)}; block 0's attention through the flash "
          f"kernel in f32 against its plain version: "
          f"{json.dumps(line['block0_flash'])}; one make_cls_train_step at "
          f"{TS21_LAYERS} layers, batch 1, card vs CPU in f32: "
          f"{json.dumps(step_line)} on {card}", flush=True)
    if (masters != {"torch.float32"} or line["tokens_dtype"] != "torch.float32"
            or bad or not finite or err > TOL["float32"]
            or step_line["failed"]):
        raise SystemExit(f"21d the bf16-configured TimeSformer failed: "
                         f"launches {bad}, finite {finite}, flash error "
                         f"{err:.3e}, step {step_line['failed']}")
    return line, launches


def hvu_check(dev, card) -> dict:
    """21e: hvu_loss over the full vocabulary, every mode, card vs CPU."""
    import torch
    from cross_modal_video_engine_tpu_torch.losses import hvu
    rng = np.random.default_rng(215)
    total = sum(hvu.DEFAULT_CATEGORY_NUMS)
    n_cat = len(hvu.DEFAULT_CATEGORIES)
    score = torch.from_numpy((2 * rng.standard_normal(
        (HVU21_BATCH, total))).astype(np.float32))
    label = torch.from_numpy((rng.random((HVU21_BATCH, total)) > 0.98)
                             .astype(np.float32))
    mask = torch.from_numpy((rng.random((HVU21_BATCH, total)) > 0.2)
                            .astype(np.float32))
    cmask = torch.from_numpy((rng.random((HVU21_BATCH, n_cat)) > 0.3)
                             .astype(np.float32))
    worst, rows = 0.0, {}
    for loss_type in ("all", "individual"):
        for with_mask in (False, True):
            out = {}
            for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
                s = score.to(d).clone().requires_grad_(True)   # a leaf
                res = hvu.hvu_loss(s, label.to(d), mask.to(d), cmask.to(d),
                                   loss_type=loss_type, with_mask=with_mask)
                res["loss_cls"].backward()
                out[where] = ({k: float(v) for k, v in res.items()},
                              s.grad.cpu())
            rel = max(abs(out["card"][0][k] - v) / max(abs(v), 1e-6)
                      for k, v in out["cpu"][0].items())
            grad = _max_rel(out["card"][1], out["cpu"][1])
            worst = max(worst, rel, grad)
            rows[f"{loss_type}{'_masked' if with_mask else ''}"] = {
                "loss_cls": out["card"][0]["loss_cls"], "max_rel": rel,
                "grad_max_rel": grad, "entries": len(out["card"][0])}
    print(f"21e hvu_loss over {total} tags at batch {HVU21_BATCH}, card vs "
          f"CPU: {json.dumps(rows)} (need <= {HVU21_REL})", flush=True)
    if worst > HVU21_REL:
        raise SystemExit("21e hvu_loss differs between the card and the CPU")
    return {"card": card, "tags": total, "modes": rows}


def check_step21(dev, card) -> Tuple[dict, dict]:
    """Step 21 (a-e): the training recipes and the bf16-configured
    TimeSformer.  Returns (the `training_recipes` JSON object, flash
    launches over 21d's counted calls)."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve

    t_step = time.perf_counter()
    videos = bserve.seeded_videos(OMNI21_MAIN, seed=21)
    names = sorted(videos)
    line = {"card": card}
    for key, fn in (("multigrid", multigrid_steps),
                    ("omnisource", omnisource_run),
                    ("blending", blending_steps)):
        t0 = time.perf_counter()
        line[key] = fn(dev, card, videos, names)
        line[key]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    line["timesformer_bf16_config"], launches = timesformer_bf16_config(
        dev, card)
    line["timesformer_bf16_config"]["seconds"] = time.perf_counter() - t0
    line["hvu"] = hvu_check(dev, card)
    line["seconds"] = time.perf_counter() - t_step
    print(f"21 the training recipes and the bf16-configured TimeSformer "
          f"checked in {line['seconds']:.1f} s", flush=True)
    return line, {"flash_attention": launches}


# -- step 22: temporal localization (ROADMAP item 8e) -------------------------
# The four shipped localization configs at their own widths, weights the
# training init (numpy seed 0), features and proposals from numpy seeds.
# 22a: BMN (T=100, F=400, N=32, D=100, hidden 256/128/512) card against
# the port on the CPU at BMN22_CPU_BATCH, each output within BMN22_REL of
# its largest; the forward timed at the config's batch (BMN22_BATCH) by
# CUDA events over BMN22_TIMED calls.  22b: one training step of the
# config's AdamW at BMN22_STEP_BATCH, card against CPU, held to float64
# by 18b's verdict (_step_verdict, _planted; the witness within
# STEP18_F64), the step then timed at BMN22_BATCH.  22c: the CLI over
# LOC22_VIDEOS seeded videos of 100 x 400 features (validation: the
# first LOC22_VAL) for LOC22_EPOCHS epochs each: BMN, TEM, bsn_pgm over
# the trained TEM's curves, PEM on its artifacts, SSN over LOC22_SSN
# videos of a seeded normalized_ proposal file put through
# denormalize_proposals; the AR@AN of BMN's and PEM's checkpoints
# evaluated by the port on the CPU within LOC22_AR of the card's.
LOC_CONFIGS = ROOT / "configs" / "localization"
BMN22_CONFIG = LOC_CONFIGS / "bmn_anet_400x100.py"
TEM22_CONFIG = LOC_CONFIGS / "bsn_tem_400x100_anet.py"
PEM22_CONFIG = LOC_CONFIGS / "bsn_pem_400x100_anet.py"
SSN22_CONFIG = LOC_CONFIGS / "ssn_r50_450e_thumos14.py"
BMN22_BATCH, BMN22_CPU_BATCH, BMN22_STEP_BATCH, BMN22_TIMED = 8, 2, 1, 10
BMN22_REL = 1e-5
LOC22_VIDEOS, LOC22_VAL, LOC22_SSN, LOC22_EPOCHS = 16, 4, 8, 2
LOC22_AR = 1e-6


def bmn22_model(d, cfg=None):
    """The shipped BMN config's model at the training init on device d."""
    from cross_modal_video_engine_tpu_torch.models.bmn import BMN, BMNConfig
    from cross_modal_video_engine_tpu_torch.models.recognizer import (
        conv_init_state_dict)
    if cfg is None:
        mcfg = dict(shipped_training_config(BMN22_CONFIG)["model"])
        mcfg.pop("type")
        cfg = BMNConfig(**mcfg)
    model = BMN(cfg, device=d)
    model.load_state_dict(conv_init_state_dict(model, 0))
    return model


def bmn22_flops(cfg, batch: int) -> dict:
    """The products of one BMN forward (2 x multiply-adds), by part."""
    T, N, D = cfg.temporal_dim, cfg.num_samples, cfg.max_duration
    h1, h2, h3, f = cfg.hidden_1d, cfg.hidden_2d, cfg.hidden_3d, cfg.feat_dim
    parts = {"bm_product": 2 * h2 * T * N * D * T,
             "pem_3d": 2 * h3 * h2 * N * D * T,
             "conv3x3": 2 * h2 * h2 * 9 * D * T,
             "conv1x1": 2 * (h3 * h2 + 2 * h2) * D * T,
             "conv1d": 2 * T * (3 * h1 * f // 4 + 2 * 3 * h1 * h1 // 4
                                + 3 * h2 * h1 + 2 * h1)}
    return {k: v * batch for k, v in parts.items()}


def bmn22_batch(cfg, batch: int, seed: int):
    """Seeded features (B, T, F), the labels of one or two seeded gt
    segments a video, the validity mask and the loss's two draws."""
    from cross_modal_video_engine_tpu_torch.train.localization_trainer import (
        bm_mask, bmn_labels)
    rng = np.random.default_rng(seed)
    T, D = cfg.temporal_dim, cfg.max_duration
    labels = [bmn_labels(np.sort(rng.uniform(0, 1, (int(rng.integers(1, 3)),
                                                   2)), -1), T, D)
              for _ in range(batch)]
    return {"feats": rng.standard_normal((batch, T, cfg.feat_dim)).astype(
                np.float32),
            "gt": [np.stack([l[i] for l in labels]) for i in range(3)],
            "mask": np.broadcast_to(bm_mask(T, D), (batch, D, T)).copy(),
            "draws": tuple(rng.random((batch, D, T), np.float32)
                           for _ in range(2))}


def _bmn22_step_run(d, cfg, start, batch, dtype=None) -> dict:
    """One make_bmn_train_step step (the config's AdamW, no clip) from
    `start` on device d with the batch's draws; with dtype=float64 the
    loss's forward and backward alone, in float64 (the witness)."""
    import torch
    from cross_modal_video_engine_tpu_torch.losses.localization import (
        bmn_loss)
    from cross_modal_video_engine_tpu_torch.train import (
        localization_trainer as lt)
    model = bmn22_model(d, cfg)
    model.load_state_dict(start)
    t = [torch.from_numpy(a).to(d) for a in
         (batch["feats"], *batch["gt"], batch["mask"])]
    if dtype is not None:
        model = model.to(dtype)
        t = [x.to(dtype) for x in t]
        out = model(t[0])
        loss = bmn_loss(out["pem_reg"], out["pem_cls"], out["tem_start"],
                        out["tem_end"], *t[1:], draws=batch["draws"])[0]
        loss.backward()
        return {"loss": float(loss.detach()), "grads": _grads64(model),
                "stats": {}}
    opt = shipped_training_config(BMN22_CONFIG)["optimizer"]
    state = lt.init_loc_state(model, lt.make_loc_optimizer(
        opt["optimizer"], opt["learning_rate"],
        opt.get("weight_decay", 0.0)))
    step = lt.make_bmn_train_step(model, device=d)
    p0 = {n: p.detach().double().cpu() for n, p in model.named_parameters()}
    t0 = time.perf_counter()
    _, logs = step(state, *t, draws=batch["draws"])
    loss = float(logs["loss"])
    return {"loss": loss, "s": time.perf_counter() - t0,
            "grads": _grads64(model), "p0": p0, "s0": {}, "stats": {},
            "params": {n: p.detach().double().cpu()
                       for n, p in model.named_parameters()}}


def bmn22_step_card_vs_cpu(dev, cfg) -> dict:
    """22b: the step at BMN22_STEP_BATCH on the card and on the CPU (at
    torch's thread count and at half of it), held to the float64 run by
    18b's verdict, with its planted faults."""
    import types
    import torch
    start = {k: v.cpu() for k, v in bmn22_model("cpu", cfg).state_dict(
        ).items()}
    batch = bmn22_batch(cfg, BMN22_STEP_BATCH, seed=221)
    cpu_dev = torch.device("cpu")
    t0 = time.perf_counter()
    f64 = {w: _bmn22_step_run(d, cfg, start, batch, torch.float64)
           for w, d in (("card", dev), ("cpu", cpu_dev))}
    floor = STEP18_F64_FLOOR * max(float(g.abs().max())
                                   for g in f64["cpu"]["grads"].values())
    witness = max(float((f64["card"]["grads"][n] - g).abs().max())
                  / max(float(g.abs().max()), floor)
                  for n, g in f64["cpu"]["grads"].items())
    out = {"f64_max_rel": witness, "f64_s": time.perf_counter() - t0,
           "f64_loss": [f64["card"]["loss"], f64["cpu"]["loss"]]}
    failed = [] if witness <= STEP18_F64 else ["float64 witness"]
    threads = torch.get_num_threads()
    card = _bmn22_step_run(dev, cfg, start, batch)
    cpu = _bmn22_step_run(cpu_dev, cfg, start, batch)
    torch.set_num_threads(max(1, threads // 2))
    try:
        alt = _bmn22_step_run(cpu_dev, cfg, start, batch)
    finally:
        torch.set_num_threads(threads)
    opt = shipped_training_config(BMN22_CONFIG)["optimizer"]
    tcfg = types.SimpleNamespace(
        optimizer=opt["optimizer"], learning_rate=opt["learning_rate"],
        weight_decay=opt.get("weight_decay", 0.0), grad_clip=float("inf"))
    ref = _reference(cpu, f64["card"], alt)
    bad, read = _step_verdict(card, cpu, f64["card"], ref, tcfg, False)
    planted = _planted(card, cpu, f64["card"], ref, tcfg, False)
    failed += bad + [f"planted {k} not refused" for k, v in planted.items()
                     if v.get("refused") is False]
    out.update(read, loss_card=card["loss"], loss_cpu=cpu["loss"],
               card_s=card["s"], cpu_s=cpu["s"], cpu_alt_s=alt["s"],
               failed=failed, planted=planted)
    return out


def bmn22_forward_and_step(dev, card) -> dict:
    """22a and 22b."""
    import torch
    from cross_modal_video_engine_tpu_torch.models import bmn
    from cross_modal_video_engine_tpu_torch.train import (
        localization_trainer as lt)
    line = {"card": card}
    model = bmn22_model(dev)
    cfg = model.cfg
    t0 = time.perf_counter()
    W = bmn.bm_sampling_matrix(cfg.temporal_dim, cfg.num_samples,
                               cfg.max_duration)
    line["sampling_matrix"] = {
        "build_s": time.perf_counter() - t0, "bytes": W.nbytes,
        "nonzero_share": float(np.count_nonzero(W)) / W.size}
    del W
    cpu_model = bmn22_model("cpu", cfg)
    batch = bmn22_batch(cfg, BMN22_CPU_BATCH, seed=220)
    x = torch.from_numpy(batch["feats"])
    with torch.no_grad():
        got = {k: v.cpu() for k, v in model(x.to(dev)).items()}
        want = cpu_model(x)
    rel = {k: _max_rel(got[k], want[k]) for k in want}
    line["card_vs_cpu"] = {"batch": BMN22_CPU_BATCH, "max_rel": rel}
    print(f"22a BMN {cfg} card vs CPU at batch {BMN22_CPU_BATCH}: "
          f"{json.dumps(rel)} (need <= {BMN22_REL}); sampling matrix "
          f"{json.dumps(line['sampling_matrix'])}", flush=True)
    if max(rel.values()) > BMN22_REL or not all(
            torch.isfinite(v).all() for v in got.values()):
        raise SystemExit("22a BMN differs between the card and the CPU")
    del cpu_model

    big = bmn22_batch(cfg, BMN22_BATCH, seed=222)
    xb = torch.from_numpy(big["feats"]).to(dev)
    flops = bmn22_flops(cfg, BMN22_BATCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms = cuda_ms(lambda: model(xb), iters=BMN22_TIMED, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    line["forward"] = {
        "batch": BMN22_BATCH, "ms": ms, "gflop": {
            k: v / 1e9 for k, v in flops.items()},
        "tflops": sum(flops.values()) / ms / 1e9, "peak_gib": peak / 2**30}
    print(f"22a BMN forward at batch {BMN22_BATCH}: {ms:.3f} ms, "
          f"{line['forward']['tflops']:.2f} TFLOP/s of "
          f"{sum(flops.values()) / 1e9:.1f} GFLOP, peak "
          f"{peak / 2**30:.2f} GiB ({card})", flush=True)

    line["step_card_vs_cpu"] = bmn22_step_card_vs_cpu(dev, cfg)
    s = line["step_card_vs_cpu"]
    print(f"22b BMN step at batch {BMN22_STEP_BATCH}, card vs CPU held to "
          f"float64: witness {s['f64_max_rel']:.2e} (need <= {STEP18_F64}), "
          f"loss {s['loss_card']:.6f} / {s['loss_cpu']:.6f}, all-gradient "
          f"cosine to float64 card {s['by_group']['all']['card_f64_cos']:.7f}"
          f" CPU {s['by_group']['all']['cpu_f64_cos']:.7f}; planted "
          f"{json.dumps({k: v.get('refused', v.get('refused_in')) for k, v in s['planted'].items()})}; "
          f"failed {s['failed']}", flush=True)
    if s["failed"]:
        raise SystemExit(f"22b the BMN step failed {s['failed']}")

    opt = shipped_training_config(BMN22_CONFIG)["optimizer"]
    state = lt.init_loc_state(model, lt.make_loc_optimizer(
        opt["optimizer"], opt["learning_rate"]))
    step = lt.make_bmn_train_step(model, device=dev)
    t = [torch.from_numpy(a).to(dev) for a in (*big["gt"], big["mask"])]
    draws = tuple(torch.from_numpy(u).to(dev) for u in big["draws"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, xb, *t, draws=draws), iters=5,
                 warmup=2)
    peak = torch.cuda.max_memory_allocated()
    line["train_step"] = {
        "batch": BMN22_BATCH, "ms": ms, "videos_per_s": BMN22_BATCH / ms
        * 1e3, "tflops": 3 * sum(flops.values()) / ms / 1e9,
        "peak_gib": peak / 2**30}
    print(f"22b BMN train step at batch {BMN22_BATCH}: {ms:.3f} ms, "
          f"{line['train_step']['videos_per_s']:.1f} videos/s, "
          f"{line['train_step']['tflops']:.2f} TFLOP/s (3 x the forward's "
          f"products), peak {peak / 2**30:.2f} GiB ({card})", flush=True)
    del model, state, step, xb, t
    torch.cuda.empty_cache()
    return line


def write_loc22_corpus(root: str, n: int, T: int = 100, F: int = 400,
                       seed: int = 223):
    """n seeded videos of (T, F) snippet features whose channel 0 marks
    one seeded action span, and their ActivityNet-style annotations."""
    rng = np.random.default_rng(seed)
    feats = os.path.join(root, "feats")
    os.makedirs(feats, exist_ok=True)
    ann = {}
    for i in range(n):
        s = rng.uniform(0.1, 0.5)
        e = s + rng.uniform(0.2, 0.4)
        x = 0.2 * rng.standard_normal((T, F)).astype(np.float32)
        x[:, 0] += ((np.arange(T) / T >= s) & (np.arange(T) / T < e))
        np.save(os.path.join(feats, f"v{i:02d}.npy"), x)
        ann[f"v{i:02d}"] = {"duration": 120.0, "annotations": [
            {"segment": [s * 120.0, e * 120.0], "label": 1}]}
    paths = {}
    for split, names in (("train", sorted(ann)),
                         ("val", sorted(ann)[:LOC22_VAL])):
        paths[split] = os.path.join(root, f"anet_{split}.json")
        with open(paths[split], "w") as f:
            json.dump({k: ann[k] for k in names}, f)
    return paths, feats


def write_ssn22_corpus(root: str, n: int, classes: int = 20, F: int = 400,
                       seed: int = 224):
    """n seeded videos: (frames/8, F) snippet features, a rawframes tree
    of empty frame files, and a normalized_ THUMOS-style proposal file
    (per video two gts, proposals near each, inside each and away from
    both)."""
    rng = np.random.default_rng(seed)
    feats = os.path.join(root, "ssn_feats")
    os.makedirs(feats, exist_ok=True)
    lines = []
    for i in range(n):
        vid, frames = f"video_{i:02d}", int(rng.integers(160, 320))
        fdir = os.path.join(root, "rawframes", vid)
        os.makedirs(fdir)
        for j in range(frames):
            open(os.path.join(fdir, f"img_{j:05d}.jpg"), "w").close()
        np.save(os.path.join(feats, vid + ".npy"), rng.standard_normal(
            (frames // 8, F)).astype(np.float32))
        gts = [(int(rng.integers(1, classes + 1)), 0.1 + 0.4 * k,
                0.3 + 0.4 * k) for k in range(2)]
        props = []
        for c, s, e in gts:
            props += [(c, 0.9, 0.95, s + 0.01, e - 0.01),
                      (c, 0.25, 0.9, s + 0.02, s + 0.07),
                      (c, 0.2, 0.8, e - 0.06, e - 0.01),
                      (c, 0.15, 0.7, s + 0.05, s + 0.1)]
        props += [(0, 0.0, 0.0, 0.02, 0.08), (0, 0.0, 0.0, 0.9, 0.98)]
        lines += [f"# {i}", vid, str(frames), "1", str(len(gts))]
        lines += [f"{c} {s:.4f} {e:.4f}" for c, s, e in gts]
        lines += [str(len(props))]
        lines += [f"{c} {a:.4f} {b:.4f} {s:.4f} {e:.4f}"
                  for c, a, b, s, e in props]
    path = os.path.join(root, "normalized_thumos14_proposal_list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path, os.path.join(root, "rawframes"), feats


def _readback(model, path: str, kind: str) -> bool:
    """The checkpoint at `path` read by the port's loader equals the
    trained model's state, bit for bit."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli.localization_train import (
        load_localizer)
    back = load_localizer(path, kind, device="cpu").state_dict()
    own = model.state_dict()
    return sorted(back) == sorted(own) and all(
        torch.equal(back[k], own[k].cpu()) for k in own)


def _finite_history(history) -> bool:
    return bool(history) and all(np.isfinite(h["loss"]) for h in history)


def localization_clis(dev, card, tmp) -> dict:
    """22c: the CLI's four arms and the two tools on the card."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import (
        data_tools, localization_train, misc_tools)
    from cross_modal_video_engine_tpu_torch.data.datasets_extra import (
        ActivityNetDataset)
    line = {"card": card}
    paths, feats = write_loc22_corpus(tmp, LOC22_VIDEOS)
    data = {"data.train.ann_file": paths["train"],
            "data.train.feature_prefix": feats,
            "data.val.ann_file": paths["val"],
            "data.val.feature_prefix": feats}

    def arm(name, config, kind, **options):
        t0 = time.perf_counter()
        cfg = shipped_training_config(config, **options)
        work = os.path.join(tmp, name)
        model, history, report = localization_train.train_from_config(
            cfg, work, LOC22_EPOCHS, device=dev)
        torch.cuda.synchronize()
        row = {"history": history, "report": report,
               "readback_equal": _readback(
                   model, os.path.join(work, f"{name}_final"), kind),
               "seconds": time.perf_counter() - t0}
        print(f"22c {name}: {json.dumps(row)}", flush=True)
        if not (_finite_history(history) and row["readback_equal"]):
            raise SystemExit(f"22c {name}: a loss is not finite or the "
                             f"checkpoint does not read back")
        return cfg, model, row

    def ar_gap(card_report, cpu_report):
        return max(abs(card_report[k] - cpu_report[k]) for k in card_report)

    cfg, _, line["bmn"] = arm("bmn", BMN22_CONFIG, "BMN", **data)
    t0 = time.perf_counter()
    cpu_bmn = localization_train.load_localizer(
        os.path.join(tmp, "bmn", "bmn_final"), "BMN", device="cpu")
    val = ActivityNetDataset(paths["val"], feats, cpu_bmn.cfg.temporal_dim)
    cpu_report = localization_train.evaluate_bmn_proposals(
        cpu_bmn, val, LOC22_VAL, device="cpu")
    gap = ar_gap(line["bmn"]["report"], cpu_report)
    line["bmn"].update(cpu_report=cpu_report, ar_gap=gap,
                       cpu_eval_s=time.perf_counter() - t0)
    print(f"22c bmn AR@AN card {json.dumps(line['bmn']['report'])} vs the "
          f"checkpoint on the CPU {json.dumps(cpu_report)}: {gap:.2e} "
          f"(need <= {LOC22_AR})", flush=True)
    if gap > LOC22_AR:
        raise SystemExit("22c BMN's AR@AN differs between card and CPU")
    del cpu_bmn

    _, tem, line["tem"] = arm("tem", TEM22_CONFIG, "TEM", **data)
    t0 = time.perf_counter()
    tem_dir = os.path.join(tmp, "tem_results")
    os.makedirs(tem_dir)
    tem.eval()
    train = ActivityNetDataset(paths["train"], feats, 100)
    with torch.no_grad():
        out = tem(torch.from_numpy(np.stack(
            [train[i]["features"] for i in range(len(train))])).to(dev))
    for i, v in enumerate(train.videos):
        np.savez(os.path.join(tem_dir, v["video"] + ".npz"),
                 **{k: out[k][i].float().cpu().numpy()
                    for k in ("action", "start", "end")})
    pgm = {"proposals": os.path.join(tmp, "pgm_proposals"),
           "features": os.path.join(tmp, "pgm_features")}
    misc_tools.main(["bsn_pgm", "--tem_dir", tem_dir, "--proposals_dir",
                     pgm["proposals"], "--features_dir", pgm["features"],
                     "--ann_file", paths["train"]])
    rows = [np.loadtxt(os.path.join(pgm["proposals"], f), delimiter=",",
                       skiprows=1, ndmin=2)
            for f in sorted(os.listdir(pgm["proposals"]))]
    line["bsn_pgm"] = {"videos": len(rows),
                       "proposals": [len(r) for r in rows],
                       "seconds": time.perf_counter() - t0}
    print(f"22c bsn_pgm over the trained TEM's curves: "
          f"{json.dumps(line['bsn_pgm'])}", flush=True)
    if len(rows) != LOC22_VIDEOS:
        raise SystemExit("22c bsn_pgm wrote no artifacts for some videos")

    pgm_data = {f"data.{s}.{k}": v for s in ("train", "val")
                for k, v in (("pgm_proposals_dir", pgm["proposals"]),
                             ("pgm_features_dir", pgm["features"]))}
    pgm_data.update({"data.train.ann_file": paths["train"],
                     "data.val.ann_file": paths["val"]})
    cfg, _, line["pem"] = arm("pem", PEM22_CONFIG, "PEM", **pgm_data)
    t0 = time.perf_counter()
    mcfg = cfg["model"]
    cpu_report = localization_train.evaluate_pem_proposals(
        localization_train.load_localizer(
            os.path.join(tmp, "pem", "pem_final"), "PEM", device="cpu"),
        localization_train.load_pgm_videos(cfg, "val", mcfg["top_k"]),
        mcfg["top_k"], mcfg["post_process_top_k"], device="cpu")
    gap = ar_gap(line["pem"]["report"], cpu_report)
    line["pem"].update(cpu_report=cpu_report, ar_gap=gap,
                       cpu_eval_s=time.perf_counter() - t0)
    print(f"22c pem AR@AN card {json.dumps(line['pem']['report'])} vs the "
          f"checkpoint on the CPU {json.dumps(cpu_report)}: {gap:.2e} "
          f"(need <= {LOC22_AR})", flush=True)
    if gap > LOC22_AR:
        raise SystemExit("22c PEM's AR@AN differs between card and CPU")

    t0 = time.perf_counter()
    norm, frames, ssn_feats = write_ssn22_corpus(tmp, LOC22_SSN)
    data_tools.main(["denormalize_proposals", "--input", norm,
                     "--frames_dir", frames])
    ann = norm.replace("normalized_", "")
    line["denormalize_s"] = time.perf_counter() - t0
    ssn_data = {f"data.{s}.{k}": v for s in ("train", "val")
                for k, v in (("ann_file", ann),
                             ("feature_prefix", ssn_feats))}
    _, _, line["ssn"] = arm("ssn", SSN22_CONFIG, "SSN", **ssn_data)
    return line


def check_step22(dev, card) -> Tuple[dict, dict]:
    """Step 22 (a-d).  Returns (the `localization` JSON object, the
    kernels' launches over the step: all must be 0)."""
    import torch
    t_step = time.perf_counter()
    print(f"22 numpy {np.__version__}, torch {torch.__version__}", flush=True)
    counted = kernel_counters()
    for fn in counted.values():
        fn.launches = 0
    line = {"card": card, "numpy": np.__version__}
    t0 = time.perf_counter()
    line["bmn"] = bmn22_forward_and_step(dev, card)
    line["bmn"]["seconds"] = time.perf_counter() - t0
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        line["clis"] = localization_clis(dev, card, tmp)
        line["clis"]["seconds"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    line["launches"] = launches
    line["seconds"] = time.perf_counter() - t_step
    print(f"22d kernel launches over step 22: {json.dumps(launches)} (need "
          f"0: no localization path reaches a kernel); step 22 checked in "
          f"{line['seconds']:.1f} s", flush=True)
    if any(launches.values()):
        raise SystemExit("22d a localization path launched a kernel")
    return line, launches


# -- step 23: spatio-temporal action detection (AVA) -------------------------------

DET_CONFIGS = ROOT / "configs" / "detection"
AVA23 = {"slowonly": DET_CONFIGS / "ava" /
         "slowonly_kinetics_pretrained_r50_4x16x1_20e_ava_rgb.py",
         "slowfast": DET_CONFIGS / "ava" /
         "slowfast_kinetics_pretrained_r50_4x16x1_20e_ava_rgb.py",
         "acrn": DET_CONFIGS / "acrn" /
         "slowfast_acrn_kinetics_pretrained_r50_8x8x1_cosine_10e_ava22_rgb.py",
         "lfb": DET_CONFIGS / "lfb" /
         "lfb_nl_kinetics_pretrained_slowonly_r50_4x16x1_20e_ava_rgb.py"}
# 23a: each config at full width (the training init), card vs CPU at
# AVA23_CPU_BATCH keyframes of AVA23_CPU_ROIS RoIs (f32, TF32 off: logits
# within AVA23_REL of the largest, cosine >= AVA23_COS, as 18a holds its
# 3D-CNNs), then timed at AVA23_BATCH keyframes of AVA23_ROIS RoIs (the
# configs' videos_per_gpu and max_boxes); the LFB config over a seeded bank
# of AVA23_BANK_SECONDS seconds (window 60, capacity 5)
AVA23_BATCH, AVA23_ROIS, AVA23_TIMED = 8, 32, 2
AVA23_CPU_BATCH, AVA23_CPU_ROIS = 1, 2
AVA23_REL, AVA23_COS = 1e-3, 0.999
AVA23_BANK_SECONDS = 90
# 23b: one step of each config's optimizer (warmup 0) at full width and one
# block a stage, AVA23_STEP_ROIS RoIs of one keyframe at AVA23_STEP_SIZE²,
# card vs CPU held to float64 by 18b's verdict with its planted faults,
# the dropout masks handed to both devices
AVA23_STEP_SIZE, AVA23_STEP_ROIS = 128, 2
# gradients that are zero by the model's structure, read apart from the
# float64 witness: a non-local block's phi bias (the softmax ignores a
# shift shared by all keys; the FBO's key biases likewise) and g bias (a
# shift of every value, through conv_out, removed by the train-mode
# BatchNorm after it).  Their float64 values are cancellation noise, which
# the card's and the CPU's summation orders make differently; each must
# stay within AVA23_ZERO of the largest gradient on both devices
AVA23_ZERO_BY_STRUCTURE = re.compile(
    r"(non_local_block\.(phi|g)\.0\.conv|non_local_layer_\d+\.lt_feat_conv)"
    r"\.bias$")
AVA23_ZERO = 1e-9
AVA23_STEP_DEPTH = {"slowfast": {"model.backbone.depth_blocks": [1, 1, 1, 1]}}
# 23c: the CLIs over AVA23_VIDEOS seeded videos of AVA23_FRAMES frames, two
# keyframes each, AVA23_CLI_BATCH keyframes a step; the results csv's mAP
# of the card's model_best against the same checkpoint on the CPU: the
# unrounded scores' mAP within AVA23_MAP, the csv's (scores printed %.3f,
# so a score at a rounding edge may land on the other side and reorder a
# tie) within AVA23_CSV_MAP.  The CLIs train at AVA23_CLI_LR: the configs'
# 0.2 (0.1 for ACRN) drives every score under action_thr (0.002) within
# two steps on these keyframes, and both mAPs would read 0
AVA23_VIDEOS, AVA23_FRAMES, AVA23_CLI_BATCH, AVA23_EPOCHS = 2, 150, 2, 2
AVA23_MAP, AVA23_CSV_MAP, AVA23_CLI_LR = 1e-6, 0.02, 0.002


def ava23_config(name, **options):
    return shipped_training_config(AVA23[name], **options)


def ava23_clip_shape(cfg, size=None) -> Tuple[int, int, int]:
    ops = {op["type"]: op for op in cfg["data.pipeline"]}
    h, w = ops["Resize"]["scale"]
    return (ops["SampleAVAFrames"]["clip_len"], size or h, size or w)


def ava23_batch(cfg, batch: int, rois: int, seed: int, size=None) -> dict:
    """Seeded clips, `rois` person boxes a keyframe (normalized x1y1x2y2),
    many-hot labels over the config's classes (a few of them), the last
    row of each keyframe padded (valid 0)."""
    rng = np.random.default_rng(seed)
    t, h, w = ava23_clip_shape(cfg, size)
    classes = cfg["model.roi_head.num_classes"]
    xy = rng.uniform(0.0, 0.6, (batch * rois, 2))
    wh = rng.uniform(0.15, 0.4, (batch * rois, 2))
    boxes = np.clip(np.concatenate([xy, xy + wh], 1), 0.0, 1.0)
    r = np.concatenate([np.repeat(np.arange(batch), rois)[:, None], boxes],
                       1).astype(np.float32)
    labels = (rng.random((batch * rois, classes)) < 0.05).astype(np.float32)
    valid = np.ones(batch * rois, np.float32)
    if rois > 1:
        valid[rois - 1::rois] = 0.0
    return {"clips": rng.standard_normal((batch, t, h, w, 3)).astype(
                np.float32),
            "rois": r, "labels": labels, "valid": valid,
            "video_id": ["bank"] * batch,
            "timestamp": [930 + 3 * b for b in range(batch)]}


def ava23_bank(channels: int, d, seed: int = 230):
    """A seeded bank of one video: 1-7 RoI rows a second for
    AVA23_BANK_SECONDS seconds, sampled to the config's capacity."""
    from cross_modal_video_engine_tpu_torch.models.lfb import LFBBuilder
    rng = np.random.default_rng(seed)
    builder = LFBBuilder(channels, 5)
    for sec in range(AVA23_BANK_SECONDS):
        builder.add("bank", 900 + sec, rng.standard_normal(
            (int(rng.integers(1, 8)), channels)).astype(np.float32))
    return builder.build(seed, device=d)


def ava23_lt(cfg, model, batch, d):
    """The batch's long-term windows for an FBO config, else None."""
    from cross_modal_video_engine_tpu_torch.models.lfb import FBOHead
    from cross_modal_video_engine_tpu_torch.train.detection_trainer import (
        sample_lt_features)
    if not isinstance(model.shared_head, FBOHead):
        return None
    n = len(batch["video_id"])
    return sample_lt_features(ava23_bank(model.backbone.feat_dim, d),
                              batch["video_id"], batch["timestamp"],
                              len(batch["rois"]) // n,
                              cfg.get("model.lfb.window_size", 60), n)


def _on23(batch, d):
    import torch
    return [torch.from_numpy(batch[k]).to(d) for k in ("clips", "rois")]


def _counted_flops(fn) -> float:
    """The products one call of fn runs (torch's FLOP counter)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _ava23_optimizer(cfg, model, steps: int = 10):
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_rec_optimizer)
    tcfg = RecognitionTrainConfig(**dict(cfg["optimizer"], warmup_steps=0))
    return tcfg, init_rec_state(model, make_rec_optimizer(tcfg, steps))


def ava23_forwards(dev, card) -> dict:
    """23a and the timed full-depth steps: each config card vs CPU, its
    forward at AVA23_BATCH x AVA23_ROIS and its SGD step there."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli.detection_train import (
        build_detection_model)
    from cross_modal_video_engine_tpu_torch.train.detection_trainer import (
        make_det_train_step)
    out = {"card": card}
    for name in AVA23:
        t0 = time.perf_counter()
        cfg = ava23_config(name)
        model = build_detection_model(cfg, dev).eval()
        cpu_model = build_detection_model(cfg, "cpu").eval()
        small = ava23_batch(cfg, AVA23_CPU_BATCH, AVA23_CPU_ROIS, seed=231)
        with torch.no_grad():
            t1 = time.perf_counter()
            want = cpu_model(*_on23(small, "cpu"), lt_feat=ava23_lt(
                cfg, cpu_model, small, "cpu"))
            cpu_s = time.perf_counter() - t1
            got = model(*_on23(small, dev), lt_feat=ava23_lt(
                cfg, model, small, dev)).cpu()
        del cpu_model
        rec = {"params_m": sum(p.numel() for p in model.parameters()) / 1e6,
               "clip": list(ava23_clip_shape(cfg)),
               "max_rel": _max_rel(got, want), "cosine": _cosine(got, want),
               "cpu_s": cpu_s}
        if not (torch.isfinite(got).all() and rec["max_rel"] <= AVA23_REL
                and rec["cosine"] >= AVA23_COS):
            raise SystemExit(f"23a {name}: the card and the CPU differ "
                             f"{json.dumps(rec)}")
        big = ava23_batch(cfg, AVA23_BATCH, AVA23_ROIS, seed=232)
        clips, rois = _on23(big, dev)
        lt = ava23_lt(cfg, model, big, dev)
        with torch.no_grad():
            flops = _counted_flops(lambda: model(clips, rois, lt_feat=lt))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: model(clips, rois, lt_feat=lt),
                         iters=AVA23_TIMED, warmup=1)
        rec["forward"] = {"batch": AVA23_BATCH, "rois": AVA23_ROIS, "ms": ms,
                          "gflop": flops / 1e9,
                          "tflops": flops / ms / 1e9,
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2**30}
        _, state = _ava23_optimizer(cfg, model)
        step = make_det_train_step(model, device=dev)
        labels, valid = (torch.from_numpy(big[k]).to(dev)
                         for k in ("labels", "valid"))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, clips, rois, labels, valid, lt),
                     iters=AVA23_TIMED - 1, warmup=1)
        rec["train_step"] = {
            "batch": AVA23_BATCH, "ms": ms,
            "keyframes_per_s": AVA23_BATCH / ms * 1e3,
            "tflops": 3 * flops / ms / 1e9,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        rec["seconds"] = time.perf_counter() - t0
        out[name] = rec
        print(f"23a {name}: card vs CPU at {AVA23_CPU_BATCH}x{AVA23_CPU_ROIS} "
              f"RoIs max_rel {rec['max_rel']:.2e} cosine "
              f"{rec['cosine']:.7f} (need <= {AVA23_REL}, >= {AVA23_COS}); "
              f"forward at {AVA23_BATCH}x{AVA23_ROIS} "
              f"{rec['forward']['ms']:.2f} ms, {rec['forward']['gflop']:.0f} "
              f"GFLOP, {rec['forward']['tflops']:.2f} TFLOP/s, peak "
              f"{rec['forward']['peak_gib']:.2f} GiB; SGD step "
              f"{ms:.2f} ms, {rec['train_step']['keyframes_per_s']:.1f} "
              f"keyframes/s, {rec['train_step']['tflops']:.2f} TFLOP/s, peak "
              f"{rec['train_step']['peak_gib']:.2f} GiB ({card}; "
              f"{rec['seconds']:.1f} s)", flush=True)
        del model, state, step, clips, rois, lt, labels, valid
        torch.cuda.empty_cache()
    return out


def _ava23_masks(cfg, model, n: int, lt_rows, seed: int):
    """Keep masks for the step's dropout calls in call order: the FBO's
    st, lt and each non-local layer's output, then the head's."""
    from cross_modal_video_engine_tpu_torch.models.lfb import FBOHead
    rng = np.random.default_rng(seed)
    shapes = []
    head = model.shared_head
    if isinstance(head, FBOHead) and head.cfg.fbo_type == "non_local":
        c = head.cfg.latent_channels
        shapes += [((n, 1, c), 0.2), ((n, lt_rows, c), 0.2)]
        shapes += [((n, 1, c), 0.2)] * head.cfg.num_non_local_layers
    p = cfg["model.roi_head.dropout"]
    if p:
        shapes.append(((n, model.roi_head.fc_cls.in_features), p))
    return [rng.random(s) >= q for s, q in shapes]


def _ava23_step_run(d, cfg, start, batch, dtype=None) -> dict:
    """One make_det_train_step step from `start` on device d with the
    batch's masks; with dtype=float64 the loss's forward and backward
    alone (the witness)."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli.detection_train import (
        build_detection_model)
    from cross_modal_video_engine_tpu_torch.models.ava_head import (
        ava_bbox_loss)
    from cross_modal_video_engine_tpu_torch.train import (
        detection_trainer as dt)
    model = build_detection_model(cfg, d)
    model.load_state_dict(start)
    clips, rois = _on23(batch, d)
    labels, valid = (torch.from_numpy(batch[k]).to(d)
                     for k in ("labels", "valid"))
    lt = ava23_lt(cfg, model, batch, d)
    masks = [torch.from_numpy(m).to(d) for m in batch["masks"]]
    if dtype is not None:
        model = model.to(dtype).train()
        with dt.handed_masks(model, masks):
            logits = model(clips.to(dtype), rois, lt_feat=None if lt is None
                           else lt.to(dtype))
        loss = ava_bbox_loss(logits, labels.to(dtype), valid.to(dtype))
        loss.backward()
        return {"loss": float(loss.detach()), "grads": _grads64(model),
                "stats": _stats64(model)}
    _, state = _ava23_optimizer(cfg, model)
    step = dt.make_det_train_step(model, device=d)
    p0 = {n: p.detach().double().cpu() for n, p in model.named_parameters()}
    s0 = _stats64(model)
    t0 = time.perf_counter()
    _, logs = step(state, clips, rois, labels, valid, lt, draws=masks)
    loss = float(logs["loss"])
    return {"loss": loss, "s": time.perf_counter() - t0,
            "grads": _grads64(model), "p0": p0, "s0": s0,
            "params": {n: p.detach().double().cpu()
                       for n, p in model.named_parameters()},
            "stats": _stats64(model)}


def ava23_step_card_vs_cpu(dev, name) -> dict:
    """23b for one config: its step at one block a stage on the card and
    on the CPU (at torch's thread count and at half of it), held to the
    float64 run by 18b's verdict, with its planted faults."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli.detection_train import (
        build_detection_model)
    depth = AVA23_STEP_DEPTH.get(name,
                                 {"model.backbone.stage_blocks": [1, 1, 1, 1]})
    cfg = ava23_config(name, **depth)
    base = build_detection_model(cfg, "cpu")
    start = {k: v.clone() for k, v in base.state_dict().items()}
    batch = ava23_batch(cfg, 1, AVA23_STEP_ROIS + 1, seed=233,
                        size=AVA23_STEP_SIZE)
    lt_rows = 5 * cfg.get("model.lfb.window_size", 60)
    batch["masks"] = _ava23_masks(cfg, base, len(batch["rois"]), lt_rows,
                                  seed=234)
    del base
    cpu_dev = torch.device("cpu")
    t0 = time.perf_counter()
    f64 = {w: _ava23_step_run(d, cfg, start, batch, torch.float64)
           for w, d in (("card", dev), ("cpu", cpu_dev))}
    floor = STEP18_F64_FLOOR * max(float(g.abs().max())
                                   for g in f64["cpu"]["grads"].values())

    def witness(a, b, at_least):
        err = float((a - b).abs().max())
        scale = max(float(b.abs().max()), at_least)
        return err / scale if scale else (0.0 if err == 0 else float("inf"))

    zero = [n for n in f64["cpu"]["grads"]
            if AVA23_ZERO_BY_STRUCTURE.search(n)]
    ranked = sorted(((witness(f64["card"][k][n], f64["cpu"][k][n],
                              floor if k == "grads" else 0.0), n)
                     for k in ("grads", "stats") for n in f64["cpu"][k]
                     if n not in zero), reverse=True)
    worst = ranked[0][0]
    top = floor / STEP18_F64_FLOOR
    zero_max = max((float(f64[w]["grads"][n].abs().max()) / top
                    for w in ("card", "cpu") for n in zero), default=0.0)
    out = {"f64_max_rel": worst, "f64_worst": ranked[:3],
           "zero_by_structure": zero, "zero_max": zero_max,
           "f64_s": time.perf_counter() - t0,
           "f64_loss": [f64["card"]["loss"], f64["cpu"]["loss"]]}
    failed = [] if worst <= STEP18_F64 else ["float64 witness"]
    if zero_max > AVA23_ZERO:
        failed.append("a gradient zero by structure")
    threads = torch.get_num_threads()
    card = _ava23_step_run(dev, cfg, start, batch)
    cpu = _ava23_step_run(cpu_dev, cfg, start, batch)
    torch.set_num_threads(max(1, threads // 2))
    try:
        alt = _ava23_step_run(cpu_dev, cfg, start, batch)
    finally:
        torch.set_num_threads(threads)
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig)
    tcfg = RecognitionTrainConfig(**dict(cfg["optimizer"], warmup_steps=0))
    ref = _reference(cpu, f64["card"], alt)
    bad, read = _step_verdict(card, cpu, f64["card"], ref, tcfg, False)
    planted = _planted(card, cpu, f64["card"], ref, tcfg, False)
    failed += bad + [f"planted {k} not refused" for k, v in planted.items()
                     if v.get("refused") is False]
    out.update(read, loss_card=card["loss"], loss_cpu=cpu["loss"],
               card_s=card["s"], cpu_s=cpu["s"], cpu_alt_s=alt["s"],
               failed=failed, planted=planted,
               seconds=time.perf_counter() - t0)
    print(f"23b {name} step at one block a stage, {AVA23_STEP_ROIS} RoIs at "
          f"{AVA23_STEP_SIZE}², card vs CPU held to float64: witness "
          f"{worst:.2e} (need <= {STEP18_F64}; worst {ranked[:2]}), "
          f"{len(zero)} gradients zero by structure within "
          f"{zero_max:.2e} of the largest (need <= {AVA23_ZERO}), loss "
          f"{card['loss']:.6f} / "
          f"{cpu['loss']:.6f}, all-gradient cosine to float64 card "
          f"{read['by_group']['all']['card_f64_cos']:.7f} CPU "
          f"{read['by_group']['all']['cpu_f64_cos']:.7f}; planted "
          f"{json.dumps({k: v.get('refused', v.get('refused_in')) for k, v in planted.items()})}; "
          f"failed {failed} ({out['seconds']:.1f} s)", flush=True)
    if failed:
        raise SystemExit(f"23b the {name} step failed {failed}")
    return out


def write_ava23_corpus(root: str, seed: int = 235):
    """AVA23_VIDEOS seeded videos (a reader by name), two keyframes each
    with one or two persons of one to three of five actions, the label
    map of those actions."""
    from cross_modal_video_engine_tpu_torch.bench.serve import SeededVideo
    rng = np.random.default_rng(seed)
    videos = {f"ava{i}": SeededVideo(seed + i, frames=AVA23_FRAMES,
                                     height=180, width=320)
              for i in range(AVA23_VIDEOS)}
    actions = (1, 5, 8, 11, 14)
    rows = []
    for vid in videos:
        for ts in (902, 903):
            for e in range(int(rng.integers(1, 3))):
                x, y = rng.uniform(0.05, 0.5, 2)
                w, h = rng.uniform(0.2, 0.45, 2)
                for a in rng.choice(actions, int(rng.integers(1, 4)),
                                    replace=False):
                    rows.append(f"{vid},{ts},{x:.3f},{y:.3f},"
                                f"{min(x + w, 1):.3f},{min(y + h, 1):.3f},"
                                f"{a},{e}")
    ann = os.path.join(root, "ava.csv")
    with open(ann, "w") as f:
        f.write("\n".join(rows) + "\n")
    labels = os.path.join(root, "labels.pbtxt")
    with open(labels, "w") as f:
        f.write("".join(f'item {{\n  name: "action{a}"\n  id: {a}\n}}\n'
                        for a in actions))
    return videos, ann, labels


def _ava23_readback(cfg, model, path: str) -> bool:
    """An epoch directory read by the port into a fresh CPU detector
    equals the trained model, bit for bit."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli.detection_train import (
        build_detection_model)
    from cross_modal_video_engine_tpu_torch.train.resume import (
        load_train_state)
    back = build_detection_model(cfg, "cpu")
    _, state = _ava23_optimizer(cfg, back)
    load_train_state(path, {"state": state, "batch_stats": back})
    own, got = model.state_dict(), back.state_dict()
    return sorted(own) == sorted(got) and all(
        torch.equal(got[k], own[k].cpu()) for k in own
        if not k.endswith("num_batches_tracked"))


def _ava23_maps(cfg, best, d, ann, labels, val_pipe, tmp, tag):
    """The checkpoint over the val keyframes on device d, one pass: the
    unrounded scores' frame-mAP (evaluate_ava_detection) and the mAP
    ava_eval reads off the results csv written from the same scores."""
    from cross_modal_video_engine_tpu_torch.cli import detection_train
    from cross_modal_video_engine_tpu_torch.data.datasets_extra import (
        AVADataset)
    from cross_modal_video_engine_tpu_torch.metrics.ava import (
        ava_eval, results2csv)
    from cross_modal_video_engine_tpu_torch.train import (
        detection_trainer as dt)
    classes = cfg["model.roi_head.num_classes"]
    max_boxes = cfg["model.train_cfg.max_boxes"]
    ds = AVADataset(ann, classes)
    batches = list(detection_train.det_batches(
        ds, val_pipe, AVA23_CLI_BATCH, classes, max_boxes, cfg["data.fps"],
        cfg["data.timestamp_start"], include_meta=True))
    infer = dt.make_det_infer(detection_train.load_detector(cfg, best, d))
    seen = []

    def recorded(clips, rois, lt=None):
        scores = infer(clips, rois, lt)
        seen.append(scores.cpu().numpy())
        return scores

    raw = dt.evaluate_ava_detection(recorded, batches, classes)["mAP@0.5IOU"]
    results = []
    for batch, scores in zip(batches, seen):
        for b in range(batch["n"]):
            sl = slice(b * max_boxes, (b + 1) * max_boxes)
            results.append(dt.detection_results(
                scores[sl], batch["rois"][sl][:, 1:],
                int(batch["valid"][sl].sum()), classes,
                cfg["model.test_cfg.action_thr"]))
    out = os.path.join(tmp, f"results_{tag}_pass.csv")
    results2csv(ds, results, out)
    return raw, ava_eval(out, "mAP", labels, ann, verbose=False)[
        "PascalBoxes_Precision/mAP@0.5IOU"]


def ava23_clis(dev, card, tmp) -> dict:
    """23c: ava_proposals, detection_train (SlowOnly, with eval),
    detection_test against the same checkpoint on the CPU, the LFB recipe
    (its bank built, saved and loaded back) and the ACRN recipe."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import (
        ava_proposals, detection_test, detection_train)
    from cross_modal_video_engine_tpu_torch.cli.yolo_train import yolo_config
    from cross_modal_video_engine_tpu_torch.config import Config
    from cross_modal_video_engine_tpu_torch.convert import (
        yolo_variables_to_jax)
    from cross_modal_video_engine_tpu_torch.data.datasets_extra import (
        AVADataset)
    from cross_modal_video_engine_tpu_torch.data.pipelines import (
        build_pipeline, with_reader)
    from cross_modal_video_engine_tpu_torch.models import yolo
    from cross_modal_video_engine_tpu_torch.models.lfb import (
        LongTermFeatureBank)
    from cross_modal_video_engine_tpu_torch.train import (
        detection_trainer as dt)
    from cross_modal_video_engine_tpu_torch.train.checkpoint import (
        load_checkpoint, save_checkpoint)
    line = {"card": card}
    videos, ann, labels = write_ava23_corpus(tmp)
    reader = videos.__getitem__

    t0 = time.perf_counter()
    ycfg = yolo_config(Config.fromfile(str(YOLO_DETECT_CONFIG)))
    ckpt = os.path.join(tmp, "yolov5s")
    save_checkpoint(ckpt, yolo_variables_to_jax(
        yolo.random_state_dict(ycfg, seed=236, fire=(0,)), ycfg), ycfg)
    props = os.path.join(tmp, "proposals.json")
    got = ava_proposals.main(["--ann_file", ann, "--yolo_checkpoint", ckpt,
                              "--out", props, "--timestamp_start", "900",
                              "--device", str(dev)],
                             reader=reader)
    n_boxes = sum(len(v) for v in got.values())
    line["ava_proposals"] = {"keyframes": len(got), "boxes": n_boxes,
                             "seconds": time.perf_counter() - t0}
    if len(got) != 2 * AVA23_VIDEOS or not n_boxes:
        raise SystemExit(f"23c ava_proposals: {line['ava_proposals']}")

    data = {"data.train.ann_file": ann, "data.val.ann_file": ann,
            "data.train.data_prefix": None, "data.val.data_prefix": None,
            "data.train.proposal_file": props,
            "data.videos_per_gpu": AVA23_CLI_BATCH,
            "optimizer.warmup_steps": 0,
            "optimizer.learning_rate": AVA23_CLI_LR}

    def arm(name, epochs, **options):
        t1 = time.perf_counter()
        cfg = ava23_config(name, **dict(data, **options))
        work = os.path.join(tmp, name)
        state, history = detection_train.train_from_config(
            cfg, work, num_epochs=epochs, device=dev, reader=reader)
        torch.cuda.synchronize()
        row = {"history": history, "readback_equal": _ava23_readback(
            cfg, state.model, os.path.join(work, f"epoch_{epochs - 1}")),
               "seconds": time.perf_counter() - t1}
        print(f"23c {name}: {json.dumps(row)}", flush=True)
        if not (_finite_history(history) and row["readback_equal"]):
            raise SystemExit(f"23c {name}: a loss is not finite or the "
                             f"checkpoint does not read back")
        return cfg, work, state.model, row

    cfg, work, model, line["slowonly"] = arm("slowonly", AVA23_EPOCHS)
    t1 = time.perf_counter()
    best = os.path.join(work, "model_best")
    _, _, meta = load_checkpoint(best)
    a = detection_train.load_detector(cfg, best, "cpu").state_dict()
    b = detection_train.build_detection_model(cfg, "cpu")
    _, state = _ava23_optimizer(cfg, b)
    from cross_modal_video_engine_tpu_torch.train.resume import (
        load_train_state)
    load_train_state(os.path.join(work, f"epoch_{meta['epoch']}"),
                     {"state": state, "batch_stats": b})
    b = b.state_dict()
    best_equal = all(torch.equal(a[k], b[k]) for k in a
                     if not k.endswith("num_batches_tracked"))
    card_report = detection_test.run_detection_test(
        cfg, best, os.path.join(tmp, "results_card.csv"), labels,
        device=dev, reader=reader)
    val_pipe = build_pipeline(with_reader(detection_train.val_pipeline(cfg),
                                          reader))
    maps = {where_: _ava23_maps(cfg, best, d, ann, labels, val_pipe, tmp,
                                where_) for where_, d in (("card", dev),
                                                          ("cpu", "cpu"))}
    raw = {k: v[0] for k, v in maps.items()}
    key = "PascalBoxes_Precision/mAP@0.5IOU"
    line["detection_test"] = {
        "best_epoch": meta["epoch"], "best_reads_back_equal": best_equal,
        "csv_map": {"card_cli": card_report[key],
                    **{k: v[1] for k, v in maps.items()}},
        "csv_map_gap": max(abs(card_report[key] - maps["cpu"][1]),
                           abs(maps["card"][1] - maps["cpu"][1])),
        "map": raw, "map_gap": abs(raw["card"] - raw["cpu"]),
        "seconds": time.perf_counter() - t1}
    print(f"23c detection_test: {json.dumps(line['detection_test'])} (need "
          f"the mAP gap <= {AVA23_MAP}, the csv's <= {AVA23_CSV_MAP})",
          flush=True)
    if not (best_equal and np.isfinite(raw["card"])
            and line["detection_test"]["map_gap"] <= AVA23_MAP
            and line["detection_test"]["csv_map_gap"] <= AVA23_CSV_MAP):
        raise SystemExit("23c detection_test: the card's mAP differs from "
                         "the CPU's or model_best does not read back")

    t1 = time.perf_counter()
    lfb_path = os.path.join(tmp, "lfb.npz")
    cfg = ava23_config("lfb", **data)
    pipe = build_pipeline(with_reader(cfg["data.pipeline"], reader))
    ds = AVADataset(ann, cfg["model.roi_head.num_classes"])
    args = (AVA23_CLI_BATCH, cfg["model.roi_head.num_classes"],
            cfg["model.train_cfg.max_boxes"], cfg["data.fps"],
            cfg["data.timestamp_start"])
    bank = detection_train.bootstrap_lfb(
        cfg, detection_train.det_batches(ds, pipe, *args, include_meta=True),
        detection_train.det_batches(ds, val_pipe, *args, include_meta=True),
        dev)
    bank.save(lfb_path)
    back = LongTermFeatureBank.load(lfb_path, dev)
    bank_equal = back.video_index == bank.video_index and all(
        torch.equal(getattr(back, k), getattr(bank, k))
        for k in ("features", "step_table", "start_sec", "counts"))
    line["lfb_bank"] = {"steps": int(bank.features.shape[0]),
                        "channels": bank.channels,
                        "reads_back_equal": bank_equal,
                        "seconds": time.perf_counter() - t1}
    print(f"23c LFB bank: {json.dumps(line['lfb_bank'])}", flush=True)
    if not bank_equal:
        raise SystemExit("23c the LFB bank does not read back equal")
    _, _, _, line["lfb"] = arm("lfb", 1, **{"model.lfb.path": lfb_path})
    _, _, _, line["acrn"] = arm("acrn", 1)
    return line


def check_step23(dev, card) -> Tuple[dict, dict]:
    """Step 23 (a-d).  Returns (the `detection` JSON object, the kernels'
    launches over the step: all must be 0)."""
    import torch
    t_step = time.perf_counter()
    counted = kernel_counters()
    for fn in counted.values():
        fn.launches = 0
    line = {"card": card}
    t0 = time.perf_counter()
    line["forwards"] = ava23_forwards(dev, card)
    line["forwards"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["steps"] = {name: ava23_step_card_vs_cpu(dev, name)
                     for name in AVA23}
    line["steps"]["seconds"] = time.perf_counter() - t0
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        line["clis"] = ava23_clis(dev, card, tmp)
        line["clis"]["seconds"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    line["launches"] = launches
    line["seconds"] = time.perf_counter() - t_step
    print(f"23d kernel launches over step 23: {json.dumps(launches)} (need "
          f"0: no detection path reaches a kernel); step 23 checked in "
          f"{line['seconds']:.1f} s ({card})", flush=True)
    if any(launches.values()):
        raise SystemExit("23d a detection path launched a kernel")
    return line, launches


# -- step 24: the native host IO layer and the host tools -------------------------

# 24a: a LINAS-sized frame-feature file (BF24_ROWS x BF24_DIMS f32, 410
# MB), a batch of BF24_VIDEOS videos of 3-64 frames each gathered with
# BF24_THREADS threads, bit-equal to a numpy memmap, BF24_TIMED gathers
BF24_ROWS, BF24_DIMS, BF24_VIDEOS, BF24_THREADS, BF24_TIMED = (
    50_000, 2048, 128, 4, 20)
# 24b: raw AVIs read back exactly; the fused swscale resize of smooth
# frames against data/pipelines.resize_linear on the unresized frames
# (mean and largest |difference| of the uint8 values); read_audio of a
# stereo 44.1 kHz WAV at 16 kHz against the analytic sine past the
# resampler's first and last AUDIO24_EDGE samples
AVI24_FRAMES, AVI24_HW = 30, (240, 320)
RESIZE24_HW, RESIZE24_MEAN, RESIZE24_MAX = (480, 640), 1.0, 8
AUDIO24_RATE, AUDIO24_HZ, AUDIO24_TOL, AUDIO24_EDGE = 16000, 440.0, 1e-3, 32
# 24c: the host-feed row as bench/extra.py runs it (96 clips of 8 frames
# over FEED24_SOURCES raw AVIs of FEED24_FRAMES frames at 480x640); where
# libav was not found but cv2 is there, the same sources as cv2-written
# mp4s through decode_videos_batch's cv2 fallback, FALLBACK24_VIDEOS clips
# in one batch with FALLBACK24_WORKERS workers (cv2 segfaults on the raw
# AVI, and its seeks take about 0.13 s a clip)
FEED24_SOURCES, FEED24_FRAMES, FEED24_HW, FEED24_BATCH = 4, 64, (480, 640), 32
FEED24_VIDEOS, FEED24_WORKERS = 96, (1, 2, 4)
FALLBACK24_VIDEOS, FALLBACK24_WORKERS = 8, (2,)
# 24d: dump_features on a joint TimeSformer ViT-B/16 (f32, flash) over the
# 24c sources, 400 classes; the card against the CPU for one video at
# every layer (embeddings) and at DUMP24_GRAD_LAYERS (gradients), each
# vector within DUMP24_REL of its largest CPU element
DUMP24_LAYERS, DUMP24_GRAD_LAYERS, DUMP24_REL = (0, 5, 11), (5, 11), 1e-3
DUMP24_PIPELINE = [
    dict(type="DecordInit"),
    dict(type="SampleFrames", clip_len=8, frame_interval=8, num_clips=1,
         test_mode=True),
    dict(type="DecordDecode"), dict(type="Resize", scale=(-1, 256)),
    dict(type="CenterCrop", crop_size=224),
    dict(type="Normalize", mean=[127.5] * 3, std=[127.5] * 3),
    dict(type="FormatShape", input_format="NTHWC")]
# 24e: PrefetchIterator over PREFETCH24_BATCHES host batches of
# PREFETCH24_ROWS x 4096 f32 (64 MiB), a step of PREFETCH24_PRODUCTS f32
# products against a 4096 x 4096 matrix
PREFETCH24_BATCHES, PREFETCH24_ROWS, PREFETCH24_PRODUCTS = 8, 4096, 3


class FramesReader24:
    """A decord-alike over frames held in memory (24d where libav was not
    found)."""

    def __init__(self, frames):
        self.frames, self.fps = frames, 30.0

    def __len__(self):
        return len(self.frames)

    def get_batch(self, indices):
        return self.frames[np.asarray(indices)]

    def release(self):
        pass


def smooth_frames24(n: int, hw) -> np.ndarray:
    """n uint8 frames of low-frequency colour waves (a resize of noise
    measures aliasing, not the resize)."""
    y, x = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float64)
    return np.stack([np.stack([
        127 + 100 * np.sin(x / 37.0 + t) * np.cos(y / 23.0),
        127 + 100 * np.cos(x / 51.0 - t),
        127 + 80 * np.sin((x + y) / 29.0 + t)], -1)
        for t in range(n)]).astype(np.uint8)


def write_wav24(path: str, seconds: float, rate: int, channels: int,
                amp: float = 0.5):
    import wave
    t = np.arange(int(seconds * rate)) / rate
    y = amp * np.sin(2 * np.pi * AUDIO24_HZ * t)
    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes((np.repeat(y[:, None], channels, 1).ravel() * 32767)
                      .astype("<i2").tobytes())


def sine_error24(y: np.ndarray, rate: int, amp: float = 0.5) -> float:
    t = np.arange(len(y)) / rate
    ref = amp * np.sin(2 * np.pi * AUDIO24_HZ * t)
    return float(np.abs(y - ref)[AUDIO24_EDGE:-AUDIO24_EDGE].max())


def host24_bigfile(tmp: str, card: str) -> dict:
    """24a: NativeBigFile's gather against a numpy memmap, rows/s."""
    from cross_modal_video_engine_tpu_torch.io.bigfile import write_bigfile
    from cross_modal_video_engine_tpu_torch.io.native import NativeBigFile
    rng = np.random.default_rng(241)
    t0 = time.perf_counter()
    d = os.path.join(tmp, "frames_bf")
    write_bigfile(d, [f"f{i}" for i in range(BF24_ROWS)],
                  rng.random((BF24_ROWS, BF24_DIMS), dtype=np.float32))
    write_s = time.perf_counter() - t0
    ref = np.memmap(os.path.join(d, "feature.bin"), np.float32, "r",
                    shape=(BF24_ROWS, BF24_DIMS))
    bf = NativeBigFile(d, n_threads=BF24_THREADS)
    batches = []
    for _ in range(BF24_TIMED):
        lens = rng.integers(3, 65, BF24_VIDEOS)
        starts = rng.integers(0, BF24_ROWS - 64, BF24_VIDEOS)
        batches.append(np.concatenate([np.arange(s, s + n)
                                       for s, n in zip(starts, lens)]))
    got = bf.gather_rows(batches[0])
    equal = bool(np.array_equal(got, ref[batches[0]]))
    t0 = time.perf_counter()
    for rows in batches:
        bf.gather_rows(rows)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()               # the same rows, now mapped
    for rows in batches:
        bf.gather_rows(rows)
    again = time.perf_counter() - t0
    n_rows = sum(len(r) for r in batches)
    last = BF24_ROWS - 1
    by_name = bf.read_batch(["f7", f"f{last}", "f7"])
    equal &= bool(np.array_equal(by_name, ref[[7, last, 7]]))
    bf.close()
    line = {"rows": BF24_ROWS, "dims": BF24_DIMS, "native": bf.is_native,
            "videos_a_batch": BF24_VIDEOS, "rows_a_batch": n_rows / BF24_TIMED,
            "threads": BF24_THREADS, "equal_to_memmap": equal,
            "rows_per_s": n_rows / seconds,
            "gbytes_per_s": n_rows * BF24_DIMS * 4 / seconds / 1e9,
            "rows_per_s_mapped": n_rows / again, "write_s": write_s}
    print(f"24a NativeBigFile over {BF24_ROWS} x {BF24_DIMS} f32 "
          f"({BF24_ROWS * BF24_DIMS * 4 / 1e6:.0f} MB, written in "
          f"{write_s:.1f} s; warm in the page cache): {BF24_TIMED} gathers "
          f"of {BF24_VIDEOS} videos ({line['rows_a_batch']:.0f} rows a "
          f"batch) with {BF24_THREADS} threads, {line['rows_per_s']:.0f} "
          f"rows/s = {line['gbytes_per_s']:.2f} GB/s (the same gathers "
          f"again, their pages mapped: {line['rows_per_s_mapped']:.0f} "
          f"rows/s) on the host of {card}; bit-equal to a numpy memmap: "
          f"{equal}", flush=True)
    if not (equal and bf.is_native):
        raise SystemExit("24a the native gather disagrees with the memmap")
    return line


def host24_decode(tmp: str, card: str) -> dict:
    """24b: raw AVIs through NativeVideoReader and decode_videos_batch,
    and read_audio of a stereo 44.1 kHz WAV."""
    from cross_modal_video_engine_tpu_torch.bench.extra import write_raw_avi
    from cross_modal_video_engine_tpu_torch.data.pipelines import (
        resize_linear)
    from cross_modal_video_engine_tpu_torch.io.native import (
        NativeVideoReader, decode_videos_batch, read_audio)
    rng = np.random.default_rng(242)
    noise = rng.integers(0, 256, (AVI24_FRAMES,) + AVI24_HW + (3,),
                         dtype=np.uint8)
    smooth = smooth_frames24(8, RESIZE24_HW)
    paths = {name: os.path.join(tmp, f"{name}.avi")
             for name in ("noise", "smooth")}
    write_raw_avi(paths["noise"], noise)
    write_raw_avi(paths["smooth"], smooth)
    reader = NativeVideoReader(paths["noise"])
    idx = [0, 5, AVI24_FRAMES - 1, 7, 5, 12]
    exact = bool(np.array_equal(reader.get_batch(idx), noise[idx]))
    meta = [len(reader), reader.height, reader.width, reader.fps,
            reader.is_native]
    reader.release()
    batch = decode_videos_batch(
        [paths["smooth"], paths["noise"], os.path.join(tmp, "missing.avi")],
        np.array([np.arange(8), idx + [1, 2], np.arange(8)]), 224, 224)
    want = resize_linear(smooth, (224, 224)).astype(np.int64)
    diff = np.abs(batch[0].astype(np.int64) - want)
    live = [bool(batch[i, j].any()) for i in (0, 1) for j in range(8)]
    noise_resized = NativeVideoReader(paths["noise"]).get_batch(
        idx + [1, 2], (224, 224))
    wav = os.path.join(tmp, "stereo44k.wav")
    write_wav24(wav, 2.0, 44100, 2)
    audio = read_audio(wav, AUDIO24_RATE)
    audio_err = sine_error24(audio, AUDIO24_RATE)
    line = {"exact_native_size": exact,
            "frames_height_width_fps_native": meta,
            "resize_mean_abs": float(diff.mean()),
            "resize_max_abs": int(diff.max()),
            "batch_equals_reader": bool(np.array_equal(batch[1],
                                                       noise_resized)),
            "frames_nonzero": all(live),
            "missing_is_zeros": not batch[2].any(),
            "audio_samples": len(audio), "audio_max_abs_err": audio_err}
    print(f"24b raw AVIs on the card's machine: {AVI24_FRAMES} frames of "
          f"{AVI24_HW[0]}x{AVI24_HW[1]} read back at indices {idx}: exact "
          f"{exact} (len, height, width, fps, native: {meta}); "
          f"decode_videos_batch's fused resize of 8 smooth "
          f"{RESIZE24_HW[0]}x{RESIZE24_HW[1]} frames to 224² against "
          f"resize_linear: mean |diff| {line['resize_mean_abs']:.4f} (need <= "
          f"{RESIZE24_MEAN}), max {line['resize_max_abs']} (need <= "
          f"{RESIZE24_MAX}); the batch's second video equals the reader's "
          f"get_batch(out_size): {line['batch_equals_reader']}, no frame "
          f"zeros: {all(live)}, a missing file zeros: "
          f"{line['missing_is_zeros']}; read_audio of a stereo 44.1 kHz WAV "
          f"at {AUDIO24_RATE} Hz: {len(audio)} samples, max |error| against "
          f"the {AUDIO24_HZ:g} Hz sine {audio_err:.2e} (need <= "
          f"{AUDIO24_TOL:g}) ({card})", flush=True)
    if not (exact and meta[:3] == [AVI24_FRAMES, *AVI24_HW] and meta[4]
            and line["resize_mean_abs"] <= RESIZE24_MEAN
            and line["resize_max_abs"] <= RESIZE24_MAX
            and line["batch_equals_reader"] and all(live)
            and line["missing_is_zeros"]
            and abs(len(audio) - 2 * AUDIO24_RATE) <= AUDIO24_EDGE
            and audio_err <= AUDIO24_TOL):
        raise SystemExit("24b the native decoder failed a check")
    return line


def host24_feed(dev, card: str, srcs, counted, n_videos: int, batch: int,
                workers) -> Tuple[dict, dict]:
    """24c: bench/extra.py's host-feed row on the fixture, the launches
    of its end-to-end loop, then the loop again under torch.profiler."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cross_modal_video_engine_tpu_torch.bench.extra import (
        bench_host_feed, host_feed_e2e)
    from cross_modal_video_engine_tpu_torch.io.native import (
        decode_videos_batch)
    from cross_modal_video_engine_tpu_torch.io.pipeline import (
        uniform_indices)
    from cross_modal_video_engine_tpu_torch.models.clip import (
        CLIPModel, flagship_config, seeded_state_dict)
    cfg = flagship_config()
    t0 = time.perf_counter()
    model = CLIPModel(dataclasses.replace(cfg, fused_attn=True,
                                          fused_mlp=True), device=dev)
    model.load_state_dict(seeded_state_dict(cfg, 0))
    model.eval().requires_grad_(False)
    res = cfg.image_resolution
    with torch.no_grad():
        model.encode_video_u8(torch.zeros((batch, 8, res, res, 3),
                                          dtype=torch.uint8, device=dev))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for fn in counted.values():
        fn.launches = 0
    rows = bench_host_feed(n_videos=n_videos, batch=batch,
                           src_frames=FEED24_FRAMES, workers_sweep=workers,
                           device=dev, srcs=srcs, model=model)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    e2e = rows[-1]
    paths = [srcs[i % len(srcs)] for i in range(n_videos)]
    idx = uniform_indices(n_videos, FEED24_FRAMES, 8)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = host_feed_e2e(model, paths, idx, batch)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")
                  and not getattr(e, "is_user_annotation", False)) / 1e3
    wall_ms = out["seconds"] * 1e3
    tail = decode_videos_batch(paths[-batch:], idx[-batch:], res, res)
    with torch.no_grad():
        direct = model.encode_video_u8(torch.from_numpy(tail).to(dev))[0]
    cos = rows_cosine_min(out["embeddings"].reshape(-1, cfg.embed_dim),
                          direct.float().cpu().numpy().reshape(
                              -1, cfg.embed_dim))
    per_batch = {k: v / e2e["batches"] for k, v in launches.items()}
    line = {"rows": rows, "launches": launches, "model_build_s": build_s,
            "profiled_wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "last_batch_cosine_vs_direct": cos}
    decode = ", ".join(f"{r['metric'][-2:]} {r['value']:.1f}"
                       for r in rows[:-1])
    print(f"24c host-feed row ({FEED24_SOURCES} {e2e['fixture']} sources "
          f"of {FEED24_FRAMES} frames at {FEED24_HW[0]}x{FEED24_HW[1]}, "
          f"{n_videos} clips of 8, decoder {e2e['decoder']}): decode only "
          f"{decode} videos/s; end to end into the fused ViT-B/32 (bf16, "
          f"batch {batch}) {e2e['value']:.1f} videos/s; launches over the "
          f"loop {json.dumps(launches)} (need {cfg.vision_layers} compact and "
          f"{cfg.vision_layers} MLP a batch, "
          f"{e2e['batches']} batches, no other kernel); under torch.profiler "
          f"{wall_ms:.1f} ms, kernels busy {busy_ms:.2f} ms, idle share "
          f"{line['idle_share']:.3f}; the last batch against a direct "
          f"encode_video_u8 of the same clips: cosine {cos:.6f} (need >= "
          f"{COSINE_MIN}); model built in {build_s:.1f} s ({card})",
          flush=True)
    want = {"fused_attention_sublayer_compact": float(cfg.vision_layers),
            "fused_mlp_sublayer": float(cfg.vision_layers)}
    if (any(per_batch[k] != want.get(k, 0.0) for k in per_batch)
            or e2e["batches"] != -(-n_videos // batch)
            or not np.isfinite(out["embeddings"]).all()
            or out["embeddings"].shape != (batch, 8, cfg.embed_dim)
            or cos < COSINE_MIN):
        raise SystemExit("24c the host-feed loop failed a check")
    del model
    torch.cuda.empty_cache()
    return line, launches


def _dump24_config(root: str, videos, name: str) -> str:
    ann = os.path.join(root, f"{name}.txt")
    with open(ann, "w") as f:
        f.write("\n".join(f"{os.path.basename(v)} {i}"
                          for i, v in enumerate(videos)))
    cfg = os.path.join(root, f"{name}.py")
    with open(cfg, "w") as f:
        f.write(f"data = dict(videos_per_gpu={len(videos)}, "
                f"pipeline={DUMP24_PIPELINE!r},\n    val=dict(ann_file="
                f"{ann!r}, data_prefix={os.path.dirname(videos[0])!r}))\n")
    return cfg


def host24_dump(dev, card: str, tmp: str, srcs, reader, flash) -> Tuple[
        dict, int]:
    """24d: dump_features.main over the fixture on the card (the flash
    launches counted), and for one video the card against the CPU."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.cli import dump_features
    backbone = dict(TS_JOINT, dtype="float32")
    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "dump_ckpt")
    bserve.write_explain_checkpoint(ckpt, backbone, seed=24)
    write_s = time.perf_counter() - t0
    main_cfg = _dump24_config(tmp, srcs, "dump_all")
    one_cfg = _dump24_config(tmp, srcs[:1], "dump_one")
    layers = [str(l) for l in DUMP24_LAYERS]
    every = [str(l) for l in range(TS_JOINT["num_layers"])]

    def run(cfg, layer_args, mode, device, out):
        return _quiet_call(dump_features.main, [
            cfg, "--checkpoint", ckpt, "--mode", mode, "--layers",
            *layer_args, "--out", os.path.join(tmp, out)]
            + ([] if device is None else ["--device", device]),
            reader=reader)[0]

    # the card as a user asks for it: no --device (a CPU rehearsal names
    # its device)
    on_card = None if dev.type == "cuda" else str(dev)
    torch.cuda.synchronize()
    flash.launches = 0
    t0 = time.perf_counter()
    card_all = run(main_cfg, layers, "both", on_card, "card_all.pkl")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = flash.launches
    need = TS_JOINT["num_layers"] + sum(TS_JOINT["num_layers"] - 1 - l
                                        for l in DUMP24_LAYERS)
    t0 = time.perf_counter()
    card_one = run(one_cfg, every, "embeddings", on_card, "card_one.pkl")
    cpu_emb = run(one_cfg, every, "embeddings", "cpu", "cpu_emb.pkl")
    cpu_grad = run(one_cfg, [str(l) for l in DUMP24_GRAD_LAYERS], "grads",
                   "cpu", "cpu_grad.pkl")
    compare_s = time.perf_counter() - t0
    name = srcs[0]
    errs = {}
    for key, got, want in (
            [(l, card_one[name][l], cpu_emb[name][l])
             for l in range(TS_JOINT["num_layers"])]
            + [(("grad", l), card_all[name][("grad", l)],
                cpu_grad[name][("grad", l)]) for l in DUMP24_GRAD_LAYERS]
            + [(("batch", l), card_all[name][l], cpu_emb[name][l])
               for l in DUMP24_LAYERS]):
        errs[str(key)] = float(np.abs(got - want).max()
                               / max(np.abs(want).max(), 1e-30))
    finite = all(np.isfinite(v).all() for rec in card_all.values()
                 for k, v in rec.items() if k != "pred")
    preds = [card_all[name]["pred"], card_one[name]["pred"],
             cpu_emb[name]["pred"], cpu_grad[name]["pred"]]
    line = {"videos": len(srcs), "layers": list(DUMP24_LAYERS),
            "checkpoint_write_s": write_s, "card_s": card_s,
            "flash_launches": launches, "flash_need": need,
            "cpu_compare_s": compare_s, "max_rel_err": max(errs.values()),
            "worst": max(errs, key=errs.get), "preds": preds,
            "reader": getattr(reader, "__name__", type(reader).__name__),
            "finite": finite}
    print(f"24d dump_features.main (joint TimeSformer ViT-B/16, 8x224², 12 "
          f"layers, flash, f32, 400 classes; checkpoint written in "
          f"{write_s:.1f} s) over {len(srcs)} videos in mode both at layers "
          f"{list(DUMP24_LAYERS)} on the card in {card_s:.2f} s (the CLI "
          f"with its checkpoint read): flash launches {launches} (need "
          f"{need}: {TS_JOINT['num_layers']} in the capture forward, "
          f"{TS_JOINT['num_layers'] - 1} - l from each layer l in the "
          f"gradients' pass); one video card vs CPU, embeddings at all "
          f"{TS_JOINT['num_layers']} layers and gradients at "
          f"{list(DUMP24_GRAD_LAYERS)}: max |diff| / max |CPU| "
          f"{line['max_rel_err']:.2e} at {line['worst']} (need <= "
          f"{DUMP24_REL:g}), predictions {preds} (need equal), the CPU runs "
          f"{compare_s:.1f} s ({card})", flush=True)
    if (launches != need or line["max_rel_err"] > DUMP24_REL or not finite
            or len(set(preds)) != 1 or sorted(card_all) != sorted(srcs)):
        raise SystemExit("24d dump_features failed a check")
    torch.cuda.empty_cache()
    return line, launches


def host24_prefetch(dev, card: str) -> dict:
    """24e: PrefetchIterator's batches on the card equal to the host's;
    a step loop with the prefetch against one that copies in the loop."""
    import torch
    from cross_modal_video_engine_tpu_torch.data.prefetch import (
        PrefetchIterator)
    rng = np.random.default_rng(245)
    host = [{"x": rng.random((PREFETCH24_ROWS, 4096), dtype=np.float32),
             "y": (rng.integers(0, 400, PREFETCH24_ROWS), np.int64(i))}
            for i in range(PREFETCH24_BATCHES)]
    w = torch.from_numpy(rng.random((4096, 4096), dtype=np.float32)
                         / 4096).to(dev)

    def step(x):
        for _ in range(PREFETCH24_PRODUCTS):
            x = x @ w
        return x.sum()

    equal = True
    for i, b in enumerate(PrefetchIterator(iter(host), depth=2,
                                           device=dev)):
        equal &= bool(np.array_equal(b["x"].cpu().numpy(), host[i]["x"]))
        equal &= bool(np.array_equal(b["y"][0].cpu().numpy(),
                                     host[i]["y"][0]))
        equal &= b["x"].device.type == dev.type and int(b["y"][1]) == i
    step(torch.from_numpy(host[0]["x"]).to(dev))
    times = {}
    for arm in ("copy", "prefetch", "prefetch", "copy"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if arm == "copy":
            out = [step(torch.from_numpy(h["x"]).to(dev)) for h in host]
        else:
            out = [step(b["x"]) for b in PrefetchIterator(
                iter(host), depth=2, device=dev)]
        float(sum(out))
        times.setdefault(arm, []).append((time.perf_counter() - t0) * 1e3)
    step_ms = cuda_ms(lambda: step(torch.from_numpy(host[0]["x"]).to(dev)),
                      iters=3, warmup=1)
    line = {"batches": PREFETCH24_BATCHES,
            "batch_mib": host[0]["x"].nbytes / 2 ** 20, "equal": equal,
            "copy_ms": min(times["copy"]),
            "prefetch_ms": min(times["prefetch"]), "runs": times,
            "copy_and_step_ms": step_ms}
    line["overlap_speedup"] = line["copy_ms"] / line["prefetch_ms"]
    print(f"24e PrefetchIterator over {PREFETCH24_BATCHES} host batches of "
          f"{line['batch_mib']:.0f} MiB: every tensor on the card equal to "
          f"its host array: {equal}; a loop of {PREFETCH24_PRODUCTS} f32 "
          f"products a batch {line['copy_ms']:.1f} ms copying in the loop, "
          f"{line['prefetch_ms']:.1f} ms with the prefetch (pinned, side "
          f"stream) = {line['overlap_speedup']:.2f}x (best of two each, "
          f"turns copy/prefetch/prefetch/copy; one copy and step "
          f"{step_ms:.2f} ms by CUDA events) ({card})", flush=True)
    if not equal:
        raise SystemExit("24e a prefetched batch differs from the host's")
    return line


def host24_tools(tmp: str, card: str, native_decode: bool) -> dict:
    """24f: data_tools txt2bin, combine_features, build_tags and (with
    libav) extract_audio, outputs read back; the cv2 tools refused."""
    import wave
    from cross_modal_video_engine_tpu_torch.cli import data_tools, misc_tools
    from cross_modal_video_engine_tpu_torch.io.bigfile import (BigFile,
                                                               write_bigfile)
    from cross_modal_video_engine_tpu_torch.utils.concept_tags import (
        build_tag_vocab, video_tag_scores, write_tag_file)
    rng = np.random.default_rng(246)
    mat = rng.standard_normal((100, 64)).astype(np.float32)
    txt = os.path.join(tmp, "feats.txt")
    with open(txt, "w") as f:
        f.writelines(f"v{i} " + " ".join(repr(float(x)) for x in row) + "\n"
                     for i, row in enumerate(mat))
    _quiet(data_tools.main, ["txt2bin", "--input", txt, "--output",
                             os.path.join(tmp, "bf_a")])
    bf = BigFile(os.path.join(tmp, "bf_a"))
    line = {"txt2bin": bool(np.array_equal(
        bf.read_batch([f"v{i}" for i in range(100)]), mat))}
    other = rng.standard_normal((50, 8)).astype(np.float32)
    write_bigfile(os.path.join(tmp, "bf_b"),
                  [f"v{i}" for i in range(0, 100, 2)], other)
    _quiet(data_tools.main, ["combine_features", "--a",
                             os.path.join(tmp, "bf_a"), "--b",
                             os.path.join(tmp, "bf_b"), "--output",
                             os.path.join(tmp, "bf_c")])
    comb = BigFile(os.path.join(tmp, "bf_c"))
    line["combine_features"] = bool(
        comb.names == [f"v{i}" for i in range(0, 100, 2)]
        and np.array_equal(comb.read_batch(comb.names),
                           np.concatenate([mat[::2], other], 1)))
    words = ("man horse dog ball woman cook kitchen snow beach field "
             "running riding playing cutting").split()
    caps, per_video = [], {}
    for v in range(20):
        for k in range(3):
            cap = " ".join(rng.choice(words, 5))
            caps.append(f"vid{v}#{k} {cap}")
            per_video.setdefault(f"vid{v}", []).append(cap)
    cap_file = os.path.join(tmp, "caps.txt")
    with open(cap_file, "w") as f:
        f.write("\n".join(caps) + "\n")
    tags = os.path.join(tmp, "tags", "tags.txt")
    _quiet(data_tools.main, ["build_tags", "--captions", cap_file,
                             "--output", tags, "--vocab_size", "8"])
    vocab = build_tag_vocab([c for cl in per_video.values() for c in cl], 8)
    write_tag_file(os.path.join(tmp, "tags_direct.txt"),
                   video_tag_scores(per_video, vocab))
    with open(tags + ".vocab.json") as f:
        line["build_tags"] = bool(
            json.load(f) == vocab and open(tags).read()
            == open(os.path.join(tmp, "tags_direct.txt")).read()
            and len(open(tags).read().splitlines()) == 20)
    if native_decode:
        media = os.path.join(tmp, "media")
        os.makedirs(media)
        write_wav24(os.path.join(media, "a.wav"), 1.0, 44100, 2)
        _quiet(data_tools.main, ["extract_audio", "--src_dir", media,
                                 "--out_dir", os.path.join(tmp, "wavs"),
                                 "--ext", "wav"])
        with wave.open(os.path.join(tmp, "wavs", "a.wav")) as f:
            fmt = (f.getnchannels(), f.getframerate())
            y = np.frombuffer(f.readframes(f.getnframes()), "<i2") / 32767
        line["extract_audio"] = {"channels_rate": list(fmt),
                                 "samples": len(y),
                                 "max_abs_err": sine_error24(y, 16000)}
    refusals = {}
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        # cv2 is installed: the tools run, their frames decoded by
        # NativeVideoReader (its cv2 fallback where libav was not found)
        from cross_modal_video_engine_tpu_torch.io.video_decode import (
            write_test_video)
        clip = np.zeros((6, 48, 64, 3), np.uint8)
        for t in range(6):
            clip[t, 10:20, 5 + 4 * t:15 + 4 * t] = (255, 120, 30)
        os.makedirs(os.path.join(tmp, "cls", "jump"))
        write_test_video(os.path.join(tmp, "cls", "jump", "a.mp4"), clip)
        _quiet(data_tools.main, [
            "build_rawframes", "--src_dir", os.path.join(tmp, "cls"),
            "--out_dir", os.path.join(tmp, "raw"), "--ext", "mp4",
            "--new_short", "32"])
        jpgs = sorted(os.listdir(os.path.join(tmp, "raw", "jump", "a")))
        first = cv2.imread(os.path.join(tmp, "raw", "jump", "a", jpgs[0]))
        _quiet(misc_tools.main, [
            "flow_extraction", "--input", os.path.join(tmp, "cls", "jump",
                                                       "a.mp4"),
            "--dest", os.path.join(tmp, "flow")])
        flow = sorted(os.listdir(os.path.join(tmp, "flow")))
        fx = cv2.imread(os.path.join(tmp, "flow", "flow_x_00002.jpg"),
                        cv2.IMREAD_GRAYSCALE)
        refusals = {"cv2": cv2.__version__,
                    "build_rawframes": [len(jpgs), list(first.shape)],
                    "flow_extraction": [len(flow), int(fx.max())]}
        ran = (len(jpgs) == 6 and list(first.shape) == [32, 43, 3]
               and len(flow) == 10 and fx.max() > 140)
    else:
        for name, (tool, argv) in {
                "build_rawframes": (data_tools, [
                    "build_rawframes", "--src_dir", tmp, "--out_dir",
                    os.path.join(tmp, "raw")]),
                "flow_extraction": (misc_tools, [
                    "flow_extraction", "--input", os.path.join(
                        tmp, "missing.avi"), "--dest",
                    os.path.join(tmp, "flow")])}.items():
            try:
                tool.main(argv)
                refusals[name] = "ran"
            except ImportError as e:
                refusals[name] = str(e)
        ran = all("cv2" in v for v in refusals.values())
    line["cv2_tools"] = refusals
    print(f"24f the data tools on the card's machine, outputs read back: "
          f"{json.dumps(line)} (need every check true, extract_audio mono "
          f"16 kHz within {AUDIO24_TOL:g} of the sine; the cv2 tools: where "
          f"cv2 is installed, 6 frames of 32x43 and 5 flow pairs whose x "
          f"flow passes 140 for the moving square, else each an ImportError "
          f"naming cv2) ({card})", flush=True)
    audio = line.get("extract_audio")
    if (not (line["txt2bin"] and line["combine_features"]
             and line["build_tags"])
            or (audio and (audio["channels_rate"] != [1, 16000]
                           or audio["max_abs_err"] > AUDIO24_TOL))
            or not ran):
        raise SystemExit("24f a data tool failed a check")
    return line


def check_step24(dev, card) -> Tuple[dict, dict]:
    """Step 24 (a-f).  Returns (the `host_tools` JSON object, the
    kernels' launches over 24c's loop and 24d's card run)."""
    import torch
    from cross_modal_video_engine_tpu_torch.bench.extra import write_raw_avi
    from cross_modal_video_engine_tpu_torch.io import native
    t_step = time.perf_counter()
    counted = kernel_counters()
    line = {"card": card}
    t0 = time.perf_counter()
    status = native.native_status()
    line["build"] = dict(status, seconds_total=time.perf_counter() - t0)
    found = status["libav"] == "found"
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    print(f"24a host libraries from cross_modal_video_engine_tpu_torch/"
          f"native/ with g++: bigfile {status['bigfile']} "
          f"({'built' if status['built']['bigfile'] else 'loaded'} in "
          f"{status['seconds']['bigfile']:.2f} s); libav probe "
          f"({status['seconds']['probe']:.2f} s): {status['libav']}; decode "
          + (f"{status['decode']} ("
             f"{'built' if status['built']['decode'] else 'loaded'} in "
             f"{status['seconds']['decode']:.2f} s)" if found else
             "not built: 24b and extract_audio do not run here, 24c runs "
             "through cv2's fallback where cv2 is installed, 24d reads "
             "frames from memory")
          + f" ({card})", flush=True)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    launches = {name: 0 for name in counted}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        line["bigfile"] = host24_bigfile(tmp, card)
        if found:
            line["decode"] = host24_decode(tmp, card)
        rng = np.random.default_rng(9)
        frames, srcs = {}, []
        t0 = time.perf_counter()
        for i in range(FEED24_SOURCES):
            srcs.append(os.path.join(tmp, f"s{i}.avi"))
            frames[srcs[-1]] = rng.integers(
                0, 256, (FEED24_FRAMES,) + FEED24_HW + (3,), dtype=np.uint8)
            if found:
                write_raw_avi(srcs[-1], frames[srcs[-1]])
        line["fixture_s"] = time.perf_counter() - t0
        feed = None
        if found:
            line["host_feed"], feed = host24_feed(
                dev, card, srcs, counted, FEED24_VIDEOS, FEED24_BATCH,
                FEED24_WORKERS)
        elif has_cv2:
            # the same frames as mp4s cv2 writes and reads (the fallback)
            from cross_modal_video_engine_tpu_torch.io.video_decode import (
                write_test_video)
            mp4s = [p[:-4] + ".mp4" for p in srcs]
            for src, mp4 in zip(srcs, mp4s):
                write_test_video(mp4, frames[src])
            line["host_feed"], feed = host24_feed(
                dev, card, mp4s, counted, FALLBACK24_VIDEOS,
                FALLBACK24_VIDEOS, FALLBACK24_WORKERS)
        else:
            print("24c did not run: neither libav nor cv2 is here to decode "
                  "a video file", flush=True)
        for k, v in (feed or {}).items():
            launches[k] += v
        reader = (native.NativeVideoReader if found
                  else (lambda p: FramesReader24(frames[p])))
        line["dump_features"], flash = host24_dump(
            dev, card, tmp, srcs, reader, counted["flash_attention"])
        launches["flash_attention"] += flash
        del frames
        line["prefetch"] = host24_prefetch(dev, card)
        line["tools"] = host24_tools(tmp, card, found)
    torch.cuda.synchronize()
    line["launches"] = launches
    line["seconds"] = time.perf_counter() - t_step
    print(f"24 kernel launches over 24c's loop and 24d's card run: "
          f"{json.dumps(launches)}; step 24 checked in "
          f"{line['seconds']:.1f} s ({card})", flush=True)
    return line, launches


# -- step 25: skeleton recognition, the checkpoint converter and the exports ---

SKEL_CONFIGS = ROOT / "configs" / "skeleton"
STGCN25_CONFIG = SKEL_CONFIGS / "stgcn" / "stgcn_80e_ntu60_xsub_keypoint.py"
AGCN25_CONFIG = (SKEL_CONFIGS / "2s-agcn"
                 / "2sagcn_80e_ntu60_xsub_keypoint_3d.py")
POSEC3D25_CONFIG = (SKEL_CONFIGS / "posec3d"
                    / "slowonly_r50_u48_240e_ntu60_xsub_keypoint.py")
# 25a's CLI fixture: 2 steps of the recipe's batch 16, one val batch; a
# clip has SK25_FRAMES frames that PoseDataset samples down to clip_len
SK25_TRAIN, SK25_VAL, SK25_FRAMES = 32, 16, 120
# the GCNs' card-vs-CPU steps run at the recipes' batch (16); the COCO
# bone stream's forward at SK25_BONE_BATCH clips
SK25_BONE_BATCH = 8
STGCN25_CLI_OPTIONS = []     # more --cfg-options for 25a's CLI
POSE25_STEP_BATCH = 1
SK25_TIMED = 3               # calls a forward or step time averages
POSE25_LOOP = 8              # PoseC3D's host-fed steps in the idle share
# the biases whose gradient is zero by structure: a train-mode BatchNorm
# right after them (ST-GCN's temporal and residual convs; AGCN's conv_d,
# down, temporal and residual convs) or, AGCN's conv_a, a shift the
# softmax over the source joints does not see.  Their float64 gradients
# are cancellation noise, which the card's and the CPU's summation orders
# make differently (the batch-8 witness read 1.47e-09 with them in): read
# apart, each within AVA23_ZERO of the largest gradient on both devices
SK25_ZERO_BY_STRUCTURE = re.compile(
    r"(st_gcn_networks\.\d+\.(tcn\.2|residual\.0)|agcn_networks\.\d+\."
    r"(gcn\.conv_[ad]\.\d|gcn\.down\.0|tcn\.0|residual\.0))\.bias$")
# a forward, card against CPU, f32 (TF32 off), of the largest score: the
# GCNs; PoseC3D, a ResNet3D, is held to 18a's CNN18_REL
SK25_REL = 1e-4
# 25d's SlowOnly-R50 (ResNet3DConfig's defaults) and its clips' size
R3D25, R3D25_HW = {}, 224


def pose25_annotations(n: int, joints: int, persons: int, frames: int,
                       seed: int, classes: int = 60) -> list:
    """Seeded pose annotations as the poseC3D pickles hold them: keypoints
    (M, T, V, 3) in pixels of a 1080x1920 frame (a body near the middle,
    moving), the score channel in (0.3, 1), a label, the img_shape."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        base = rng.uniform([500, 300], [1400, 700], (persons, 1, joints, 2))
        walk = np.cumsum(rng.normal(0, 4, (persons, frames, joints, 2)), 1)
        kp = np.concatenate([base + walk, rng.uniform(
            0.3, 1.0, (persons, frames, joints, 1))], -1).astype(np.float32)
        out.append({"keypoint": kp, "label": int(i % classes),
                    "img_shape": (1080, 1920)})
    return out


def _pickle25(path: str, annos: list) -> str:
    import pickle
    with open(path, "wb") as f:
        pickle.dump(annos, f)
    return path


def _sk25_model(path, d, **options):
    from cross_modal_video_engine_tpu_torch.cli import skeleton_train
    return skeleton_train.build_skeleton_model(
        shipped_training_config(path, **options), d)


def _sk25_step_run(d, path, start, x, y, dtype=None, masks=None,
                   **options) -> dict:
    """One make_cls_train_step_stats step of the recipe (its SGD, no
    warmup) from `start` on device d, the head's dropout masks handed in;
    with dtype=float64 the train-mode forward and backward alone, in
    float64 (the witness)."""
    import torch
    from cross_modal_video_engine_tpu_torch.models.layers import Dropout
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_cls_train_step_stats,
        make_rec_optimizer)
    model = _sk25_model(path, d, **options)
    model.load_state_dict(start)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.masks = iter(masks) if masks is not None else None
    xs, ys = torch.from_numpy(x).to(d), torch.from_numpy(y).to(d)
    if dtype is not None:
        model = model.to(dtype).train()
        loss = torch.nn.functional.cross_entropy(model(xs.to(dtype)), ys)
        loss.backward()
        return {"loss": float(loss.detach()), "grads": _grads64(model),
                "stats": _stats64(model)}
    cfg = shipped_training_config(path, **options)
    tcfg = RecognitionTrainConfig(**dict(cfg["optimizer"], warmup_steps=0))
    state = init_rec_state(model, make_rec_optimizer(tcfg, 10))
    step = make_cls_train_step_stats(model, device=d)
    p0 = {n: p.detach().double().cpu() for n, p in model.named_parameters()}
    s0 = _stats64(model)
    t0 = time.perf_counter()
    _, logs = step(state, xs, ys)
    loss = float(logs["loss"])
    return {"loss": loss, "s": time.perf_counter() - t0,
            "grads": _grads64(model), "p0": p0, "s0": s0,
            "params": {n: p.detach().double().cpu()
                       for n, p in model.named_parameters()},
            "stats": _stats64(model), "tcfg": tcfg}


def _sk25_seeded(model, seed: int) -> dict:
    """The model's state dict drawn from a numpy seed (the graph and the
    counts kept): convs at lecun-normal scale, BatchNorm scales, edge masks
    and PA near 1, biases and running means small, running variances in
    [0.5, 1.5).  At the training init (unit scales, zero biases, PA and
    AGCN's gcn BatchNorm at 1e-6) train-mode BatchNorm's f32 backward
    cancels and the running means sit at rounding level, on either device;
    from these weights the step's f32 numbers are well conditioned."""
    import torch
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        leaf = k.rsplit(".", 1)[-1]
        if not v.is_floating_point() or leaf == "A":
            out[k] = v.clone()
            continue
        shape = tuple(v.shape)
        if leaf == "running_var":
            a = 0.5 + rng.random(shape)
        elif leaf in ("running_mean", "bias"):
            a = 0.05 * rng.standard_normal(shape)
        elif v.dim() == 1 or "edge_importance" in k or leaf == "PA":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = int(np.prod(shape[1:])) ** -0.5 * rng.standard_normal(shape)
        out[k] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def sk25_step_card_vs_cpu(dev, path, x, y, masks=None, **options) -> dict:
    """One SGD step of the recipe at x's batch from seeded weights
    (_sk25_seeded) on the card and on the CPU (at torch's thread count and
    at half of it), held to the float64 run by 18b's verdict, with its
    planted faults."""
    import torch
    start = _sk25_seeded(_sk25_model(path, "cpu", **options), seed=25)
    cpu_dev = torch.device("cpu")
    t0 = time.perf_counter()
    f64 = {w: _sk25_step_run(d, path, start, x, y, torch.float64, masks,
                             **options)
           for w, d in (("card", dev), ("cpu", cpu_dev))}
    top = max(float(g.abs().max()) for g in f64["cpu"]["grads"].values())
    floor = STEP18_F64_FLOOR * top
    # the gradients zero by structure are read apart, as 23b reads its own
    zero = [n for n in f64["cpu"]["grads"] if SK25_ZERO_BY_STRUCTURE.search(n)]
    ranked = sorted(((float((f64["card"]["grads"][n] - g).abs().max())
                      / max(float(g.abs().max()), floor), n)
                     for n, g in f64["cpu"]["grads"].items()
                     if n not in zero), reverse=True)
    witness = ranked[0][0]
    zero_max = max((float(f64[w]["grads"][n].abs().max()) / top
                    for w in ("card", "cpu") for n in zero), default=0.0)
    out = {"batch": int(x.shape[0]), "f64_max_rel": witness,
           "f64_worst": ranked[:3], "zero_by_structure": len(zero),
           "zero_max": zero_max, "f64_s": time.perf_counter() - t0,
           "f64_loss": [f64["card"]["loss"], f64["cpu"]["loss"]]}
    failed = [] if witness <= STEP18_F64 else ["float64 witness"]
    if zero_max > AVA23_ZERO:
        failed.append("a gradient zero by structure")
    threads = torch.get_num_threads()
    card = _sk25_step_run(dev, path, start, x, y, masks=masks, **options)
    cpu = _sk25_step_run(cpu_dev, path, start, x, y, masks=masks, **options)
    torch.set_num_threads(max(1, threads // 2))
    try:
        alt = _sk25_step_run(cpu_dev, path, start, x, y, masks=masks,
                             **options)
    finally:
        torch.set_num_threads(threads)
    tcfg = card.pop("tcfg")
    ref = _reference(cpu, f64["card"], alt)
    bad, read = _step_verdict(card, cpu, f64["card"], ref, tcfg, False)
    planted = _planted(card, cpu, f64["card"], ref, tcfg, False)
    failed += bad + [f"planted {k} not refused" for k, v in planted.items()
                     if v.get("refused") is False]
    out.update(read, loss_card=card["loss"], loss_cpu=cpu["loss"],
               card_s=card["s"], cpu_s=cpu["s"], cpu_alt_s=alt["s"],
               failed=failed, planted=planted)
    return out


def _sk25_times(model, x, y, card: str, tag: str) -> dict:
    """The recipe's forward (eval, no graph) and SGD step at x's batch by
    CUDA events, TFLOP/s of the counted products (3 x the forward's for
    the step), peak memory of each."""
    import torch
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_cls_train_step_stats,
        make_rec_optimizer)
    out = {"batch": list(x.shape)}
    model.eval()
    with torch.no_grad():
        flops = _counted_flops(lambda: model(x))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: model(x), iters=SK25_TIMED, warmup=1)
    out["forward"] = {"ms": ms, "gflop": flops / 1e9,
                      "tflops": flops / ms / 1e9,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    state = init_rec_state(model, make_rec_optimizer(
        RecognitionTrainConfig(optimizer="sgd", learning_rate=1e-3), 10))
    step = make_cls_train_step_stats(model, device=x.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, x, y), iters=SK25_TIMED, warmup=1)
    out["step"] = {"ms": ms, "tflops": 3 * flops / ms / 1e9,
                   "clips_per_s": x.shape[0] / ms * 1e3,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"{tag} at {out['batch']}: forward {out['forward']['ms']:.3f} "
          f"ms ({out['forward']['tflops']:.2f} TFLOP/s of "
          f"{out['forward']['gflop']:.1f} GFLOP, peak "
          f"{out['forward']['peak_gib']:.2f} GiB), SGD step {ms:.3f} ms "
          f"({out['step']['tflops']:.2f} TFLOP/s, peak "
          f"{out['step']['peak_gib']:.2f} GiB) ({card})", flush=True)
    return out


def _sk25_card_vs_cpu(model, x) -> float:
    """The eval-mode forward of the model on the card against a CPU copy
    of it, max |diff| over the largest score."""
    import copy
    import torch
    cpu = copy.deepcopy(model).to("cpu").eval()
    model.eval()
    with torch.no_grad():
        return _max_rel(model(x).cpu(), cpu(x.cpu()))


def _sk25_verdict(tag: str, s: dict) -> None:
    print(f"{tag} step at batch {s['batch']}, card vs CPU held to "
          f"float64: witness {s['f64_max_rel']:.2e} (need <= {STEP18_F64}),"
          f" loss {s['loss_card']:.6f} / {s['loss_cpu']:.6f}, all-gradient "
          f"cosine to float64 card {s['by_group']['all']['card_f64_cos']:.7f}"
          f" CPU {s['by_group']['all']['cpu_f64_cos']:.7f}; planted "
          f"{json.dumps({k: v.get('refused', v.get('refused_in')) for k, v in s['planted'].items()})}; "
          f"failed {s['failed']}", flush=True)
    if s["failed"]:
        print(f"{tag} readings: {json.dumps({k: s.get(k) for k in ('f64_worst', 'zero_max', 'by_group', 'bad_groups', 'bad_tensors', 'worst_tensors', 'stats_max_rel', 'update_over_bound', 'loss_rel')})}",
              flush=True)
        raise SystemExit(f"25 the {tag} step failed {s['failed']}")


def _sk25_inputs(cfg, batch: int, seed: int, joints=None):
    """Seeded (B, M, T, V, 3) keypoints (normalised scale) and labels for a
    GCN recipe."""
    rng = np.random.default_rng(seed)
    M = cfg.get("data.num_persons", 1)
    V = joints or cfg.get("model.backbone.num_joints", 17)
    x = rng.standard_normal((batch, M, cfg["data.clip_len"], V, 3)).astype(
        np.float32)
    return x, rng.integers(0, cfg["model.num_classes"], batch)


def stgcn25(dev, card, tmp) -> Tuple[dict, dict]:
    """25a: the ST-GCN recipe through skeleton_train.main for one epoch of
    2 steps and an eval on a seeded pickle, its epoch and best checkpoint
    read back; one step card vs CPU held to float64; forward and step
    times.  Returns (its line, the state dict converted in 25d)."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import skeleton_train
    from cross_modal_video_engine_tpu_torch.convert.from_jax import (
        conv_recognizer_state_dict_from_jax)
    from cross_modal_video_engine_tpu_torch.train.checkpoint import (
        load_checkpoint)
    cfg = shipped_training_config(STGCN25_CONFIG)
    line = {"config": str(STGCN25_CONFIG.relative_to(ROOT))}
    train = _pickle25(os.path.join(tmp, "stgcn_train.pkl"), pose25_annotations(
        SK25_TRAIN, 17, 2, SK25_FRAMES, seed=250))
    val = _pickle25(os.path.join(tmp, "stgcn_val.pkl"), pose25_annotations(
        SK25_VAL, 17, 2, SK25_FRAMES, seed=251))
    work = os.path.join(tmp, "stgcn_work")
    t0 = time.perf_counter()
    history, _ = _quiet_call(skeleton_train.main, [
        str(STGCN25_CONFIG), "--work_dir", work, "--total_epochs", "1",
        "--cfg-options", f"data.train.ann_file={train}",
        f"data.val.ann_file={val}"] + STGCN25_CLI_OPTIONS)
    line["cli"] = {"seconds": time.perf_counter() - t0, "history": history}
    model = _sk25_model(STGCN25_CONFIG, dev)
    variables, config, _ = load_checkpoint(os.path.join(work, "model_best"))
    model.load_state_dict(conv_recognizer_state_dict_from_jax(variables,
                                                              model))
    ok = (len(history) == 1 and np.isfinite(history[0]["loss"])
          and "top1_acc" in history[0]
          and os.path.isdir(os.path.join(work, "epoch_0"))
          and all(torch.isfinite(p).all() for p in model.parameters()))
    print(f"25a ST-GCN {line['config']} (COCO-17, channels "
          f"{model.backbone.cfg.channels}, clip_len {cfg['data.clip_len']}, "
          f"2 persons, batch {cfg['data.batch_size']}): skeleton_train.main "
          f"1 epoch of 2 steps and an eval in {line['cli']['seconds']:.1f} s:"
          f" {json.dumps(history)}; model_best read back", flush=True)
    if not ok:
        raise SystemExit("25a the ST-GCN CLI's history or checkpoints are "
                         "not what it must write")
    x, y = _sk25_inputs(cfg, cfg["data.batch_size"], seed=252)
    s = sk25_step_card_vs_cpu(dev, STGCN25_CONFIG, x, y)
    _sk25_verdict("25a ST-GCN", s)
    line["step_card_vs_cpu"] = s
    xb, yb = _sk25_inputs(cfg, cfg["data.batch_size"], seed=253)
    xb, yb = torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev)
    line["forward_card_vs_cpu"] = _sk25_card_vs_cpu(model, xb[:2])
    if not line["forward_card_vs_cpu"] <= SK25_REL:
        raise SystemExit(f"25a the ST-GCN forward differs between the card "
                         f"and the CPU: {line['forward_card_vs_cpu']}")
    line["times"] = _sk25_times(model, xb, yb, card, "25a ST-GCN")
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    del model, xb, yb
    torch.cuda.empty_cache()
    return line, sd


def agcn25(dev, card, tmp) -> Tuple[dict, dict]:
    """25b: the 2s-AGCN joint recipe (NTU-25, 10 blocks): one step card vs
    CPU held to float64, forward and step times; the bone stream on a
    COCO-17 AGCN of the same widths; NTU-25's bone stream refused.
    Returns (its line, the state dict converted in 25d)."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import skeleton_train
    from cross_modal_video_engine_tpu_torch.data.datasets_extra import (
        PoseDataset)
    cfg = shipped_training_config(AGCN25_CONFIG)
    line = {"config": str(AGCN25_CONFIG.relative_to(ROOT))}
    x, y = _sk25_inputs(cfg, cfg["data.batch_size"], seed=254)
    s = sk25_step_card_vs_cpu(dev, AGCN25_CONFIG, x, y)
    _sk25_verdict("25b 2s-AGCN joint", s)
    line["step_card_vs_cpu"] = s
    model = _sk25_model(AGCN25_CONFIG, dev)
    xb, yb = _sk25_inputs(cfg, cfg["data.batch_size"], seed=255)
    xb, yb = torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev)
    line["forward_card_vs_cpu"] = _sk25_card_vs_cpu(model, xb[:2])
    if not line["forward_card_vs_cpu"] <= SK25_REL:
        raise SystemExit(f"25b the AGCN forward differs between the card "
                         f"and the CPU: {line['forward_card_vs_cpu']}")
    line["times"] = _sk25_times(model, xb, yb, card, "25b 2s-AGCN joint")
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    del model, xb, yb

    # the bone stream: a COCO-17 AGCN of the same widths on bone vectors
    coco = {"model.backbone.num_joints": 17, "model.backbone.layout": "coco",
            "data.stream": "bone"}
    bone = _sk25_model(AGCN25_CONFIG, dev, **coco)
    path = _pickle25(os.path.join(tmp, "coco.pkl"), pose25_annotations(
        SK25_BONE_BATCH, 17, 2, SK25_FRAMES, seed=256))
    ds = PoseDataset(path, cfg["data.clip_len"], 17, 2)
    xs, ys, _ = next(skeleton_train.skeleton_arrays(ds, SK25_BONE_BATCH,
                                                    "bone"))
    rel = _sk25_card_vs_cpu(bone, torch.from_numpy(xs).to(dev))
    line["bone"] = {"forward_card_vs_cpu": rel}
    print(f"25b 2s-AGCN bone stream on a COCO-17 AGCN of the same widths: "
          f"forward card vs CPU {rel:.2e} (need <= {SK25_REL})", flush=True)
    if not rel <= SK25_REL:
        raise SystemExit("25b the bone-stream AGCN differs between the card "
                         "and the CPU")
    del bone
    # the shipped recipe's bone stream: 25 joints, 17 COCO parents
    ntu = _pickle25(os.path.join(tmp, "ntu.pkl"), pose25_annotations(
        1, 25, 2, 20, seed=257))
    try:
        next(skeleton_train.skeleton_arrays(PoseDataset(ntu, 8, 25, 2), 1,
                                            "bone"))
        refusal = None
    except ValueError as e:
        refusal = str(e)
    line["ntu_bone_refusal"] = refusal
    print(f"25b the shipped NTU-25 recipe with data.stream=bone: "
          f"ValueError {refusal!r} (the JAX package's numpy broadcast "
          f"refusal)", flush=True)
    if not refusal or "broadcast" not in refusal:
        raise SystemExit("25b NTU-25's bone stream was not refused as the "
                         "JAX package refuses it")
    torch.cuda.empty_cache()
    return line, sd


def posec3d25(dev, card, tmp) -> dict:
    """25c: PoseC3D (SlowOnly stage blocks (4, 6, 3), base 32) over
    GeneratePoseTarget heatmaps made on the host: the host's heatmap ms a
    batch, one step card vs CPU with the dropout masks handed in, forward
    and step times, and POSE25_LOOP host-fed steps with the card's idle
    share."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import skeleton_train
    from cross_modal_video_engine_tpu_torch.data.datasets_extra import (
        PoseDataset)
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig, init_rec_state, make_cls_train_step_stats,
        make_rec_optimizer)
    cfg = shipped_training_config(POSEC3D25_CONFIG)
    line = {"config": str(POSEC3D25_CONFIG.relative_to(ROOT))}
    bs, hm = cfg["data.batch_size"], cfg["data.heatmap"]
    path = _pickle25(os.path.join(tmp, "posec3d.pkl"), pose25_annotations(
        bs * POSE25_LOOP, 17, 1, SK25_FRAMES, seed=258))
    ds = PoseDataset(path, cfg["data.clip_len"], 17, 1)
    batches = skeleton_train.skeleton_arrays(ds, bs, "joint", hm)
    t0 = time.perf_counter()
    x, y, _ = next(batches)
    host_ms = (time.perf_counter() - t0) * 1e3
    print(f"25c PoseC3D heatmaps {list(x.shape)} by GeneratePoseTarget on "
          f"the host: {host_ms:.1f} ms a batch of {bs}", flush=True)
    feat = _sk25_model(POSEC3D25_CONFIG, "cpu").backbone.feat_dim
    masks = np.random.default_rng(259).random(
        (POSE25_STEP_BATCH, feat)) < 0.5
    s = sk25_step_card_vs_cpu(dev, POSEC3D25_CONFIG, x[:POSE25_STEP_BATCH],
                              y[:POSE25_STEP_BATCH], masks=[masks])
    _sk25_verdict("25c PoseC3D", s)
    line["step_card_vs_cpu"] = s
    model = _sk25_model(POSEC3D25_CONFIG, dev)
    xb, yb = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    line["forward_card_vs_cpu"] = _sk25_card_vs_cpu(model, xb[:1])
    if not line["forward_card_vs_cpu"] <= CNN18_REL:
        raise SystemExit(f"25c the PoseC3D forward differs between the card "
                         f"and the CPU: {line['forward_card_vs_cpu']}")
    line["times"] = _sk25_times(model, xb, yb, card, "25c PoseC3D")
    # host-fed steps: heatmaps on the host, the copy to the card, the step
    # on the card; the card is busy from the step's start (after the copy)
    # to its end, the copies are read apart
    state = init_rec_state(model, make_rec_optimizer(RecognitionTrainConfig(
        **dict(cfg["optimizer"], warmup_steps=0)), 10))
    step = make_cls_train_step_stats(model, device=dev)
    busy, copy, host, losses = 0.0, [], [], []
    batches = skeleton_train.skeleton_arrays(ds, bs, "joint", hm)
    torch.cuda.synchronize()
    t_loop = time.perf_counter()
    for _ in range(POSE25_LOOP):
        t0 = time.perf_counter()
        x, y, _ = next(batches)
        t1 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        copy.append((time.perf_counter() - t1) * 1e3)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        state, logs = step(state, xd, yd)
        end.record()
        losses.append(float(logs["loss"]))
        busy += start.elapsed_time(end)
    wall = (time.perf_counter() - t_loop) * 1e3
    line["loop"] = {"steps": POSE25_LOOP, "first_heatmap_ms": host_ms,
                    "host_heatmap_ms": host, "copy_ms": copy,
                    "wall_ms": wall, "device_ms": busy,
                    "idle_share": 1.0 - busy / wall, "losses": losses}
    print(f"25c PoseC3D {POSE25_LOOP} host-fed steps at batch {bs}: "
          f"{wall:.1f} ms wall, card busy {busy:.1f} ms in its steps (idle "
          f"share {1.0 - busy / wall:.3f}); host heatmaps "
          f"{json.dumps([round(h, 1) for h in host])} ms a batch, copies "
          f"to the card {json.dumps([round(c, 1) for c in copy])} ms, beside"
          f" a step of {line['times']['step']['ms']:.1f} ms; losses "
          f"{json.dumps(losses)} ({card})", flush=True)
    if not np.isfinite(losses).all():
        raise SystemExit("25c the PoseC3D loop's losses are not finite")
    del model, state, step, xb, yb
    torch.cuda.empty_cache()
    return line


def _convert25_sources(dev, tmp, gcn_sds) -> dict:
    """type -> (the .pth's checkpoint, --config blob or None, the model
    the reference state dict loads into, the port's loader of the written
    directory's variables, a seeded input)."""
    import dataclasses
    import torch
    from cross_modal_video_engine_tpu_torch.cli.yolo_train import yolo_config
    from cross_modal_video_engine_tpu_torch.convert import from_jax
    from cross_modal_video_engine_tpu_torch.models import clip, yolo
    from cross_modal_video_engine_tpu_torch.models.recognizer import (
        BackboneClassifier, conv_init_state_dict)
    from cross_modal_video_engine_tpu_torch.models.resnet3d import (
        ResNet3D, ResNet3DConfig)
    rng = np.random.default_rng(260)
    out = {}
    for kind, path in (("stgcn", STGCN25_CONFIG), ("agcn", AGCN25_CONFIG)):
        cfg = shipped_training_config(path)
        model = _sk25_model(path, dev)
        x, _ = _sk25_inputs(cfg, 2, seed=261)
        out[kind] = ({"state_dict": gcn_sds[kind]}, None, model,
                     lambda v, m: from_jax.conv_recognizer_state_dict_from_jax(
                         v, m), torch.from_numpy(x).to(dev))
    ccfg = clip.flagship_config()
    model = clip.CLIPModel(ccfg, device=dev)
    blob = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(ccfg).items()}
    R = ccfg.image_resolution
    out["clip"] = (clip.random_state_dict(ccfg, seed=262), blob, model,
                   lambda v, m: from_jax.clip_state_dict_from_jax(v, m.cfg),
                   torch.from_numpy(rng.standard_normal(
                       (2, 4, R, R, 3)).astype(np.float32)).to(dev))
    ycfg = yolo_config(shipped_training_config(YOLO_DETECT_CONFIG))
    out["yolov5"] = ({"model": yolo.random_state_dict(ycfg, seed=263)}, None,
                     yolo.YoloV5(ycfg, device=dev),
                     lambda v, m: from_jax.yolo_state_dict_from_jax(v, m.cfg),
                     torch.from_numpy(rng.random(
                         (2, ycfg.img_size, ycfg.img_size, 3)).astype(
                         np.float32)).to(dev))
    r3cfg = ResNet3DConfig(**R3D25)
    r3 = BackboneClassifier(ResNet3D(r3cfg, device=dev), 400)
    out["resnet3d"] = (
        {"state_dict": conv_init_state_dict(r3, 264)},
        {"backbone": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in dataclasses.asdict(r3cfg).items()},
         "num_classes": 400}, r3,
        lambda v, m: from_jax.conv_recognizer_state_dict_from_jax(v, m),
        torch.from_numpy(rng.standard_normal(
            (2, 8, R3D25_HW, R3D25_HW, 3)).astype(np.float32)).to(dev))
    return out


def _forward25(model, x):
    import torch
    with torch.no_grad():
        model.eval()
        out = (model.encode_video(x)[0] if hasattr(model, "encode_video")
               else model(x))
        return torch.utils._pytree.tree_leaves(out)


def convert25(dev, card, tmp, gcn_sds) -> dict:
    """25d: convert_checkpoint.main on the card for stgcn, agcn, clip
    (ViT-B/32), yolov5 (v5s) and resnet3d (SlowOnly-R50) at full width: each written directory read back through the port's
    loader gives a forward bit-equal to the model loaded straight from
    the .pth; ST-GCN's params.msgpack written with --device cuda is
    byte-equal to the one written with --device cpu."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import convert_checkpoint
    from cross_modal_video_engine_tpu_torch.train.checkpoint import (
        load_checkpoint)
    line = {}
    for kind, (ckpt, blob, model, loader, x) in _convert25_sources(
            dev, tmp, gcn_sds).items():
        src, dst = os.path.join(tmp, f"{kind}.pth"), os.path.join(tmp, kind)
        torch.save(ckpt, src)
        argv = ["--type", kind, "--src", src, "--dst", dst]
        if blob is not None:
            with open(src + ".json", "w") as f:
                json.dump(blob, f)
            argv += ["--config", src + ".json"]
        t0 = time.perf_counter()
        _quiet_call(convert_checkpoint.main, argv)
        seconds = time.perf_counter() - t0
        model.load_state_dict(ckpt.get("state_dict", ckpt.get("model",
                                                              ckpt)))
        want = _forward25(model, x)
        # read back into NaN parameters and NaN floating buffers (running
        # statistics, the GCNs' graph): one the directory lacks shows in
        # the forward; only integer buffers (BatchNorm's counts, which an
        # eval forward does not read) may be missing from what it loads
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                if t.is_floating_point():
                    t.fill_(float("nan"))
        variables, _, _ = load_checkpoint(dst)
        keys = model.load_state_dict(loader(variables, model), strict=False)
        floating = {k for k, v in model.state_dict().items()
                    if v.is_floating_point()}
        missing = sorted(set(keys.missing_keys) & floating)
        got = _forward25(model, x)
        equal = (all(torch.equal(a, b) for a, b in zip(got, want))
                 and not missing and not keys.unexpected_keys)
        row = {"seconds": seconds, "bytes": sum(
            os.path.getsize(os.path.join(dst, f)) for f in os.listdir(dst)),
            "pth_bytes": os.path.getsize(src), "forward_bit_equal": equal,
            "missing_floating": missing[:5],
            "unexpected": keys.unexpected_keys[:5]}
        if kind == "stgcn":
            _quiet_call(convert_checkpoint.main,
                        ["--type", kind, "--src", src, "--dst", dst + "_cpu",
                         "--device", "cpu"])
            with open(os.path.join(dst, "params.msgpack"), "rb") as f:
                a = f.read()
            with open(os.path.join(dst + "_cpu", "params.msgpack"),
                      "rb") as f:
                row["cuda_cpu_msgpack_equal"] = a == f.read()
        line[kind] = row
        print(f"25d convert_checkpoint --type {kind}: {seconds:.2f} s, "
              f"{row['pth_bytes'] / 2**20:.1f} MiB .pth -> "
              f"{row['bytes'] / 2**20:.1f} MiB directory; its forward read "
              f"back {'bit-equal' if equal else 'DIFFERENT'} to the .pth's "
              f"(floating entries missing {missing[:5]}, unexpected "
              f"{keys.unexpected_keys[:5]})"
              + (f"; --device cuda and cpu msgpack "
                 f"{'byte-equal' if row['cuda_cpu_msgpack_equal'] else 'DIFFERENT'}"
                 if kind == "stgcn" else "") + f" ({card})", flush=True)
        if not equal or row.get("cuda_cpu_msgpack_equal") is False:
            raise SystemExit(f"25d the converted {kind} checkpoint is not "
                             f"the .pth's")
        del model, x, ckpt
        torch.cuda.empty_cache()
    return line


def exports25(dev, card, tmp, clip_ckpt: str) -> dict:
    """25e: misc_tools export_model --preset vitb32 (bf16, batch 1, 8
    frames; the weights of 25d's converted ViT-B/32 directory,
    `--checkpoint`) and export_yolo on yolov5s_coco_640.py and
    yolov5s_seg_coco_640.py on the card: each artifact loaded back with
    torch.export.load and called with the weights the tool traced with,
    its outputs against the module's own (misc_tools.EXPORT_TOL of the
    largest), its bytes and its export seconds."""
    import torch
    from cross_modal_video_engine_tpu_torch.cli import misc_tools
    from cross_modal_video_engine_tpu_torch.cli.yolo_train import (
        build_yolo_model)
    from cross_modal_video_engine_tpu_torch.convert.from_jax import (
        clip_state_dict_from_jax)
    from cross_modal_video_engine_tpu_torch.models import clip, yolo
    from cross_modal_video_engine_tpu_torch.train.checkpoint import (
        load_checkpoint)
    line = {}
    cases = [("vitb32", ["export_model", "--preset", "vitb32", "--batch",
                         "1", "--frames", "8", "--checkpoint", clip_ckpt])]
    cases += [(os.path.basename(str(c))[:-3], ["export_yolo", str(c)])
              for c in (YOLO_DETECT_CONFIG, YOLO_SEGMENT_CONFIG)]
    for name, argv in cases:
        out = os.path.join(tmp, name + ".pt2")
        t0 = time.perf_counter()
        _quiet_call(misc_tools.main, argv + ["--output", out])
        seconds = time.perf_counter() - t0
        if name == "vitb32":
            cfg = misc_tools.clip_preset("vitb32")
            model = clip.CLIPModel(cfg, device=dev)
            model.load_state_dict(clip_state_dict_from_jax(
                load_checkpoint(clip_ckpt)[0], cfg))
            R = cfg.image_resolution
            x = torch.from_numpy(np.random.default_rng(265).standard_normal(
                (1, 8, R, R, 3)).astype(np.float32)).to(dev)
            with torch.no_grad():
                want = [model.encode_video(x)[0]]
            tol = misc_tools.EXPORT_TOL[cfg.dtype]
        else:
            model = build_yolo_model(shipped_training_config(
                YOLO_CONFIGS / (name + ".py")), device=dev)
            model.load_state_dict(yolo.init_state_dict(model.cfg, seed=0))
            S = model.cfg.img_size
            x = torch.from_numpy(np.random.default_rng(266).random(
                (1, S, S, 3)).astype(np.float32)).to(dev)
            with torch.no_grad():
                raw = model(x)
            maps = raw[0] if model.cfg.masks else raw
            want = [yolo.decode_predictions(maps, model.cfg)] + (
                [raw[1]] if model.cfg.masks else [])
            tol = misc_tools.EXPORT_TOL["float32"]
        state = dict(model.state_dict())
        t0 = time.perf_counter()
        program = torch.export.load(out).module()
        with torch.no_grad():
            got = torch.utils._pytree.tree_leaves(program(state, x))
        load_s = time.perf_counter() - t0
        err = max(_max_rel(g, w) for g, w in zip(got, want))
        line[name] = {"bytes": os.path.getsize(out), "export_s": seconds,
                      "load_and_call_s": load_s, "max_rel": err,
                      "outputs": [list(w.shape) for w in want]}
        print(f"25e {' '.join(argv)}: {line[name]['bytes'] / 2**20:.2f} MiB "
              f"program (weights an input) in {seconds:.2f} s; loaded back "
              f"and called with the state dict in {load_s:.2f} s, outputs "
              f"{line[name]['outputs']} within {err:.2e} of the module's "
              f"(need <= {tol}) ({card})", flush=True)
        if not err <= tol or len(got) != len(want):
            raise SystemExit(f"25e the {name} program differs from its "
                             f"module")
        del model, program, state
        torch.cuda.empty_cache()
    return line


def check_step25(dev, card) -> Tuple[dict, dict]:
    """Step 25 (a-e).  Returns (the `skeleton_convert` JSON object, the
    kernels' launches over the step: all must be 0)."""
    import torch
    t_step = time.perf_counter()
    counted = kernel_counters()
    for fn in counted.values():
        fn.launches = 0
    line = {"card": card}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        sds = {}
        for key, fn in (("stgcn", stgcn25), ("agcn", agcn25)):
            t0 = time.perf_counter()
            line[key], sds[key] = fn(dev, card, tmp)
            line[key]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        line["posec3d"] = posec3d25(dev, card, tmp)
        line["posec3d"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        line["convert"] = convert25(dev, card, tmp, sds)
        line["convert"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        line["exports"] = exports25(dev, card, tmp,
                                    os.path.join(tmp, "clip"))
        line["exports"]["seconds"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    line["launches"] = launches
    line["seconds"] = time.perf_counter() - t_step
    print(f"25 kernel launches over step 25: {json.dumps(launches)} (need 0: "
          f"no skeleton, converter or export path reaches a kernel); step "
          f"25 checked in {line['seconds']:.1f} s", flush=True)
    if any(launches.values()):
        raise SystemExit("25 a skeleton, converter or export path launched a "
                         "kernel")
    return line, launches


STEPS = tuple(range(4, 26))      # the steps a selection may name


def selected_steps(argv) -> set:
    """The steps to run: all of 4-25 with no argument, else the numbers
    given ("19", "13 19" or "13,19"); 4-5 and 6-7 run as pairs (5 and 7
    time what 4 and 6 build).  The build (2), the kernel checks (3) and
    the results (26) always run."""
    if not argv:
        return set(STEPS)
    steps = set()
    for arg in argv:
        for part in filter(None, arg.split(",")):
            if not part.isdigit() or int(part) not in range(2, 27):
                raise SystemExit(f"chip_smoke: unknown step {part!r}; "
                                 f"choose among {STEPS[0]}-{STEPS[-1]}")
            steps.add(int(part))
    for pair in ({4, 5}, {6, 7}):
        if steps & pair:
            steps |= pair
    return steps & set(STEPS)


def step_seconds(record: dict, step: str, t0: float) -> None:
    """Records and prints, on a line of its own, a step's seconds."""
    record[step] = time.perf_counter() - t0
    print(f"step {step}: {record[step]:.1f} s", flush=True)


def main(argv=None) -> int:
    import torch

    steps = selected_steps(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    # the port and its CUDA sources come from this checkout, nowhere else
    if not (PACKAGE / "csrc").is_dir():
        print(f"chip_smoke: {PACKAGE} not found; run this script from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    from cross_modal_video_engine_tpu_torch.models.clip import (
        CLIPModel, enable_fused_inference, flagship_config,
        random_state_dict)
    from cross_modal_video_engine_tpu_torch.ops._build import load_kernels
    from cross_modal_video_engine_tpu_torch.utils.device import card_line

    # plain f32 arms: full-f32 matmuls and convs (cuDNN would use TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # each training init drawn once per model structure (shared_training_init)
    builds = contextlib.ExitStack()
    builds.enter_context(shared_training_init())

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; TF32 off for f32 "
          f"matmul and cuDNN conv; steps {sorted(steps)}", flush=True)

    # -- 2. build -----------------------------------------------------------
    step_s = {}
    t_step = time.perf_counter()
    kern = load_kernels()
    print(f"kernels {'built' if kern.built else 'loaded'} in "
          f"{kern.seconds:.1f} s: {kern.path}")
    for line in kern.log.splitlines():
        if ("registers" in line or "spill" in line or "entry function" in line
                or "Potential Performance Loss" in line):
            print("  ptxas:", line.strip())
    ptxas = block_ptxas(kern.log)
    print(f"block kernel ptxas by route: {json.dumps(ptxas)}", flush=True)
    # the block kernel's ablation (step 8) builds beside the checks (its
    # own nvcc per source, all started together); drive_bench_path waits
    built = {}
    ablation_build = threading.Thread(target=lambda: built.update(
        lib=load_kernels(defines=("-DCMVE_BLK_NO_MMA",)).lib))
    if 8 in steps:
        ablation_build.start()

    def ablation():
        ablation_build.join()
        return built.get("lib") or load_kernels(
            defines=("-DCMVE_BLK_NO_MMA",)).lib

    step_seconds(step_s, "2", t_step)

    # -- 3. each kernel against its plain version ---------------------------
    t_step = time.perf_counter()
    check_selfcheck(dev, kern)
    check_gemm(dev)
    core = check_core(dev)
    results = check_kernels(dev) + check_flash(dev)
    check_backward(dev)
    step_seconds(step_s, "3", t_step)

    launches, block_extra, lines = {}, {}, {}
    counts = dict.fromkeys(("composed", "caption", "explain", "training",
                            "ctv", "caption_transformer",
                            "detector_training", "cnn", "cnn2d",
                            "transformer", "clip_recognizer", "recipes",
                            "localization", "detection", "host_tools",
                            "skeleton_convert"))
    rng = np.random.default_rng(1)
    if 4 in steps:
        t_step = time.perf_counter()
        # -- 4. the CLIP path -----------------------------------------------
        cfg = flagship_config()
        t0 = time.perf_counter()
        sd = random_state_dict(cfg, seed=0)
        model = CLIPModel(enable_fused_inference(cfg, device=dev),
                          device=dev)
        model.load_state_dict(sd)
        plain = CLIPModel(cfg, device=dev)
        plain.load_state_dict(sd)
        del sd
        if not (model.cfg.fused_attn and model.cfg.fused_mlp):
            raise SystemExit("enable_fused_inference left the kernels off")
        print(f"ViT-B/32 bf16 built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        main_launches, index, ids = drive_main_path(model, plain, cfg, dev,
                                                    rng)
        launches.update(main_launches)

        # -- 5. CLIP videos/s and query latency -----------------------------
        throughput(model, plain, cfg, dev, rng, card)
        query_latency(model, plain, index, ids, card)
        del model, plain, index
        torch.cuda.empty_cache()
        step_seconds(step_s, "4-5", t_step)

    if 6 in steps:
        t_step = time.perf_counter()
        # -- 6. the caption path --------------------------------------------
        ts_model, ts_plain = build_timesformer(dev)
        clips = normalised_clips(rng, CLIPS, dev)
        launches["flash_attention"] = drive_caption_path(ts_model, ts_plain,
                                                         clips)
        divided_caption_config(dev, clips)

        # -- 7. TimeSformer videos/s ----------------------------------------
        caption_throughput(ts_model, ts_plain, clips, card)
        del ts_model, ts_plain, clips
        torch.cuda.empty_cache()
        step_seconds(step_s, "6-7", t_step)

    if 8 in steps:
        t_step = time.perf_counter()
        # -- 8. the bench entry points' path --------------------------------
        launches["fused_block_sublayer_compact"], block_extra = \
            drive_bench_path(dev, card, ablation)
        block_extra["ptxas"] = ptxas
        torch.cuda.empty_cache()
        step_seconds(step_s, "8", t_step)

    if 9 in steps:
        t_step = time.perf_counter()
        # -- 9. the 1M-row index --------------------------------------------
        check_big_index(dev, card)
        step_seconds(step_s, "9", t_step)

    if 10 in steps:
        t_step = time.perf_counter()
        # -- 10. LINAS retrieval serving ------------------------------------
        torch.cuda.empty_cache()
        lines["serving"] = check_linas_serving(dev, card)
        step_seconds(step_s, "10", t_step)

    if 11 in steps:
        t_step = time.perf_counter()
        # -- 11. LINAS training ---------------------------------------------
        torch.cuda.empty_cache()
        lines["training"] = check_linas_training(dev, card)
        step_seconds(step_s, "11", t_step)

    if 12 in steps:
        t_step = time.perf_counter()
        # -- 12. composed retrieval -----------------------------------------
        torch.cuda.empty_cache()
        lines["composed"], counts["composed"] = check_composed(dev, card)
        step_seconds(step_s, "12", t_step)

    if 13 in steps:
        t_step = time.perf_counter()
        # -- 13. the caption route ------------------------------------------
        torch.cuda.empty_cache()
        lines["caption"], counts["caption"] = check_caption_route(dev, card)
        step_seconds(step_s, "13", t_step)

    if 14 in steps:
        t_step = time.perf_counter()
        # -- 14. the explain route ------------------------------------------
        torch.cuda.empty_cache()
        lines["explain"], counts["explain"] = check_explain_route(dev, card)
        step_seconds(step_s, "14", t_step)

    if 15 in steps:
        t_step = time.perf_counter()
        # -- 15. TimeSformer training ---------------------------------------
        torch.cuda.empty_cache()
        lines["timesformer_training"], counts["training"] = \
            check_timesformer_training(dev, card)
        step_seconds(step_s, "15", t_step)

    if 16 in steps:
        t_step = time.perf_counter()
        # -- 16. the concept detector and the bank build --------------------
        torch.cuda.empty_cache()
        lines["concept_detector"], counts["ctv"] = check_concept_detector(
            dev, card)
        step_seconds(step_s, "16", t_step)

    if 17 in steps:
        t_step = time.perf_counter()
        # -- 17. the caption transformer and the detector's training --------
        torch.cuda.empty_cache()
        step17, generate_launches = check_step17(dev, card)
        lines["caption_transformer_and_yolo_training"] = step17
        counts["caption_transformer"] = {"flash_attention":
                                         generate_launches}
        counts["detector_training"] = step17["detector_training_launches"]
        step_seconds(step_s, "17", t_step)

    if 18 in steps:
        t_step = time.perf_counter()
        # -- 18. the 3D-CNN recognizers -------------------------------------
        torch.cuda.empty_cache()
        lines["cnn_recognizers"], counts["cnn"] = check_step18(dev, card)
        step_seconds(step_s, "18", t_step)

    if 19 in steps:
        t_step = time.perf_counter()
        # -- 19. the 2D, TSM and pyramid recognizers ------------------------
        torch.cuda.empty_cache()
        lines["cnn2d_recognizers"], counts["cnn2d"] = check_step19(dev, card)
        step_seconds(step_s, "19", t_step)

    if 20 in steps:
        t_step = time.perf_counter()
        # -- 20. the transformer and CLIP recognizers -----------------------
        torch.cuda.empty_cache()
        (lines["transformer_recognizers"], counts["transformer"],
         counts["clip_recognizer"]) = check_step20(dev, card)
        step_seconds(step_s, "20", t_step)

    if 21 in steps:
        t_step = time.perf_counter()
        # -- 21. the training recipes and the bf16-configured TimeSformer ---
        torch.cuda.empty_cache()
        lines["training_recipes"], counts["recipes"] = check_step21(dev,
                                                                    card)
        step_seconds(step_s, "21", t_step)

    if 22 in steps:
        t_step = time.perf_counter()
        # -- 22. temporal localization --------------------------------------
        torch.cuda.empty_cache()
        lines["localization"], counts["localization"] = check_step22(dev,
                                                                     card)
        step_seconds(step_s, "22", t_step)

    if 23 in steps:
        t_step = time.perf_counter()
        # -- 23. spatio-temporal action detection (AVA) ---------------------
        torch.cuda.empty_cache()
        lines["detection"], counts["detection"] = check_step23(dev, card)
        step_seconds(step_s, "23", t_step)

    if 24 in steps:
        t_step = time.perf_counter()
        # -- 24. the native host IO layer and the host tools ----------------
        torch.cuda.empty_cache()
        lines["host_tools"], counts["host_tools"] = check_step24(dev, card)
        step_seconds(step_s, "24", t_step)

    if 25 in steps:
        t_step = time.perf_counter()
        # -- 25. skeleton recognition, the converter and the exports ---------
        torch.cuda.empty_cache()
        lines["skeleton_convert"], counts["skeleton_convert"] = \
            check_step25(dev, card)
        step_seconds(step_s, "25", t_step)
    builds.close()

    # -- 26. results ----------------------------------------------------------
    for key, value in lines.items():
        print(json.dumps({key: value}))
    print(json.dumps(kernel_json(results, launches, core, block_extra,
                                 counts)))
    print(json.dumps({"step_seconds": step_s}))
    skipped = sorted(set(STEPS) - steps)
    print(f"steps run: 2, 3, {', '.join(map(str, sorted(steps)))}, 26"
          + (f"; skipped: {skipped} (a partial run)" if skipped else
             " (the whole smoke run)"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()},
        "steps": sorted(steps), "skipped": skipped}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
