#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepcv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # on a machine with one CUDA card

Phases, each printing one JSON line:

0. device — the card (``nvidia-smi`` name and power limit), torch and CUDA.
1. build — the port's CUDA kernels (K1, K2, K3-K5 in one library, and
   ``int8_conv``: 8 tensor-core instantiations, channel block 128 or 64 x
   16-byte or byte-by-byte A x f32 or bf16 out, each with its registers,
   dynamic shared memory and ``IMMA`` count, none without IMMA; 16 dp4a
   ones; none of the 24 spilling)
   compiled by ``nvcc`` from ``csrc/``, all at once, with the build times
   and ``ptxas``'s registers, shared memory and spills; for the K2 and flash
   libraries also their tensor-core kernels (K2 in bf16 and in f32 by
   3xTF32, per tile width BN; K3, K4 and K5 in bf16 and in f32 by 3xTF32,
   each per head dim, 80 included: registers, spills, shared memory) and
   the ``HMMA`` instructions in the library's SASS (``cuobjdump -sass``),
   which must be in every instantiation of them (TF32 ones in every f32
   K2, K3, K4 and K5, bf16 ones in every bf16 K2); no CUDA-core kernel may
   be compiled (no K2 in either dtype, no flash kernel), no f32 K2 may
   spill, and neither f32 K4 nor f32 K5 may spill at head dims 64 and 80.
   K1's float32 and bfloat16 kernels' registers; neither may spill.
   K2's f32 tile plan per ResNet-50 and ``classifier_train`` conv shape:
   tile, chunk, shared memory and blocks an SM.
2. kernel — K2 against its plain PyTorch version at ResNet-50's stride-1
   conv shapes at batch 64 (plus one ragged case), with and without bias,
   every epilogue activation (none, relu, leaky_relu, relu6, hard_swish,
   silu; relu6 and hard_swish on x scaled by 4, and the check fails unless
   their plain outputs reach both corners: 0 and 6, pre-activations past
   -3 and 3), float32 and bfloat16, at image_classifier's conv shapes at
   batch 4096 in bfloat16, and at the dense paths' own shapes (the dense
   head, 1x1 32 -> 4, in float32 at batch 64; U-Net's 3 -> 32 and 96 -> 32
   at 256x256 and 768 -> 256 at 32x32 in bfloat16 at batch 32), and at the
   detection and keypoint paths' (the detectors' stem 3 -> 16 and the
   single-grid head 1x1 32 -> 8 in float32 at batch 64; config 12's stem
   3 -> 32 at 64x64 and c4 conv 64 -> 128 at 8x8 in bfloat16 at batch
   512; the autoencoder's stem and its last conv 16 -> 3 in bfloat16 at
   batch 32); error
   relative to max|ref|, kernel
   time (median of CUDA-event timed launches), its bound on the card (f32:
   by 3xTF32, with the CUDA-core one beside it), and the same ``F.conv2d``
   call's time as a yardstick. Then per-forward sums: in bfloat16,
   image_classifier's five convs at batch 4096, all 46 of ResNet-50's
   stride-1 convs at batch 64, and the wide classifiers' six 3x3 convs at
   64-256 channels and batch 1024 with bias and leaky_relu, and the K2
   convs of a MobileNetV2 forward (34: 1x1s, relu6 on 17), of a
   MobileNetV3-Large forward (30: hard_swish on 10, relu on 5) and of a
   DenseNet-121 forward (119) at batch 256 without bias, and the 19 convs
   of a U-Net segmenter forward at batch 32 and 256x256 (18 3x3 with relu
   and no bias, the head), and the four backbone convs of config 12's FPN
   detector forward at batch 512 and 64x64, read from the models (``kernel_forward_bf16``,
   per shape, with the same corner checks); in float32, the
   same 46 (the serving forward) and image_classifier's five at
   ``classifier_train``'s batch 32 (``kernel_forward_f32``), each per
   forward by CUDA events around its convs in order, with cuDNN's device
   kernels by name (``torch.profiler``). Every device time
   (``device_ms``) holds the profiler to the launches each call makes, and
   profiles again or fails when it recorded fewer or more.
3. flash_kernels — K3, K4 and K5 against their plain versions at ViT-B/16's
   attention shapes (batch 64 and the training batch 256, 12 heads, T 197,
   Dh 64), ViT-H/14's (16 heads of Dh 80), a ragged T and T = 1024, float32
   and bfloat16: error relative to max|ref|, times, bounds (on f32 also
   the CUDA-core one beside the 3xTF32 one), and
   ``F.scaled_dot_product_attention`` forward (with the names of its device
   kernels, from ``torch.profiler``), forward + backward and their
   difference, the backward alone (the one call that computes K4's and K5's
   work together), as the yardstick.
4. serve — ``resnet_spec(50)`` at 224x224x3, 1000 classes, weights from a
   seed: bundle saved and loaded, ``Predictor`` at batch 64 behind the
   port's ``InferenceServer``; four client threads POST ``.npy`` batches of
   1, 5, 17 and 64 images; every answer is held against the port's CPU path
   on the same weights; K2 must have launched 46 times per forward, all on
   float32 inputs, so all on ``fused_conv2d_bias_act_f32tc_kernel``.
4b. int8_kernel — ``int8_conv`` (``csrc/int8_conv.cu``, the port-only w8a8
   conv: ungrouped convs on the tensor cores, grouped ones on ``__dp4a``)
   against its plain version at the shapes bench.py config 8 serves: the
   wide classifier's six 3x3 convs at batch 4096, 32x32, and ResNet-50's
   23 distinct convs at batch 256, 224x224 (read from an int8 forward on
   the meta device), then a depthwise and a ragged shape and the
   tensor-core route's edge shapes (``INT8_EXTRA_CONVS``): int32 sums and
   the bf16 output bit-equal to the plain version's, the route each took
   (counted by ``launches_by_route``) and its tile, the kernel's time
   (CUDA events, median, bf16 out and ``return_acc``), the plain
   version's, the bound (int8 operations at 1,979 TOP/s or bytes at 3.35
   TB/s) and the bf16 ``F.conv*d`` at the same shape; at every 1x1,
   stride-1, ungrouped shape ``torch._int_mm`` on the same codes (its
   int32 sums equal to the kernel's; no PyTorch call computes any other
   int8 conv on CUDA); per-forward sums by count.
4c. int8_serve — bench.py config 8 (``bench_serving_int8``) for ``wide``
   (batch 4096) and ``resnet50`` (batch 256, 224x224): the bf16 model from
   the seed, static scales calibrated on its first 256 and 64 images, the
   int8 build; 5 alternating draws of bf16 and int8 (3 calls each, cut
   from bench.py's 40), the median ratio, img/s, the top-1 agreement on
   min(512, B) rows; ``int8_conv`` counted from 0 over those calls (6 and
   53 a forward, every one on the tensor cores) and one counted forward
   with K2 at 0; one float32 int8
   forward on the card against the CPU path (``int8_cpu_check``: every
   int8 op on the CPU path's own input equal to the CPU op; in the first
   op whose activation codes differ between the paths, every difference
   one step at a rounding tie; the whole forward within rel L2 1e-3 with
   no flipped code, else 2e-2 with the top-1 class equal on 95 % of the
   rows). Then ``run
   --pipeline=train_wide_classifier`` with ``quantize: int8_qat`` (batch
   1024, bf16, 19 steps: one epoch on 20,000 images, no validation), the
   result calibrated and served int8 against its fake-quant forward.
4d. serve_extras — ``predict`` (``cli.main``) in this process on the serve
   phase's ResNet-50 weights as a bundle, float and ``--quantize int8
   --calibrate 64``, equal to ``Predictor`` on the same weights (K2 46
   launches in each, the int8 run's in its float calibration forward;
   ``int8_conv`` 0 and 53); MC-dropout of the wide classifier with dropout
   0.2 (4 samples, std > 0, running statistics unchanged, 6 K2 launches a
   forward); a two-member ``EnsemblePredictor`` against the CPU path
   within 1e-5 and a ``StackedEnsemble`` fit on the card, its weights
   within 1e-4 of the CPU fit's (6 K2 launches a member forward).
5. vit_serve — the same for ``vit_spec('b_16', attn_impl='flash')``: K3
   must have launched 12 times per forward, all on float32 inputs, so all
   on ``flash_fwd_f32tc_kernel`` (3xTF32 on the tensor cores).
6. vit_train — ``python -m deepcv_tpu_torch run --pipeline=train_vit
   --params vit_model.attn_impl:flash ...`` in this process, at full width
   on the synthetic ``imagenet224`` set (8,192 + 1,024 images), cut to 2
   epochs and no checkpoints: a finite loss, img/s, peak memory, and K3, K4
   and K5 launches of 12 per step (K3 also 12 per validation forward), all
   on bfloat16 inputs, so all three on the tensor cores. Then 8 more
   steps, validation off, under ``torch.profiler`` (``vit_train_profile``):
   device time per step by kernel group, the ten largest kernels, and the
   device's idle share of the unprofiled step.
6b. vit_train_f32 — the same ``run --pipeline=train_vit`` in float32
   (``vit_model.dtype:float32``, ``train_resnet50.dtype:float32``), batch
   256, one epoch of 31 steps and its validation: finite losses, K4 and K5
   12 launches a step, K3 12 a step and per validation forward, every one
   on float32 inputs (3xTF32 on the tensor cores); step ms, img/s, peak
   memory. Then 8 more steps, validation off, under ``torch.profiler``
   (``vit_train_f32_profile``), as ``vit_train_profile``.
6c. vmoe_train — the same ``run --pipeline=train_vit`` with bench.py config
   13's routing as ``--params`` (``vit_model.moe_experts:8``,
   ``moe_every:2``, ``moe_k:1``, ``moe_group_size:788``: ViT-B/16 with 8
   experts on every 2nd block, top-1, groups of 4 images), batch 256, bf16,
   one epoch and its validation: 284,946,664 parameters, finite losses and
   ``moe_aux`` terms in (0, 8], each MoE layer's share of dropped routing
   choices in the run's last forward (the last validation batch, read after
   the run), K3, K4 and K5 12 launches a step (K3 also 12 a validation
   forward), all bf16; the median step against ``vit_train``'s (both by
   CUDA events after each step), bench.py's ``moe_over_dense``, img/s and
   peak memory. Then 8 more steps, validation off, under
   ``torch.profiler`` with ``MoEMlp``'s stages in ranges
   (``vmoe_train_profile``): device ms a step for K3-K5, the experts'
   GEMMs, routing (router and top-k, dispatch, combine), the GEMMs outside
   the experts, layer norms, copies, SGD, and the idle share. Then
   ``vmoe_cpu_check``: one forward of the same model on the card against
   the CPU path, float32, TF32 off, batch 8, the same weights: logits
   within rel L2 1e-3, fewer than 0.1 % of the routing choices differing,
   with the count of near-ties in the router's argmax.
7. augment_kernel (run right after the build, ahead of the long profiles
   of the train phases) — K1 against its plain version (the port's eager chain)
   at 4096x32x32x3 (the warp plan) and 256x224x224x3 (the block plan)
   with random factors, a ragged shape and one shape each side of the
   plans' threshold, and neutral factors (pure ``to_tensor`` +
   ``normalize``), noise off, within 1e-5 in float32; bfloat16 out must be
   the float32 out rounded. With noise on, the statistics of the noise on
   a mid-grey image and its seeding; kernel times by CUDA events and by
   the profiler's device time of the kernel alone, eager-chain times and
   the bound.
8. classifier_train — ``run --pipeline=train_image_classifier`` in this
   process with the conf's hp (batch 32, float32, ``deterministic: true``)
   on CIFAR-10 (the synthetic stand-in), cut to 1 epoch and a quarter of
   the training images (validset_ratio 0.8), no checkpoints: a
   finite loss, 5 K2 launches per forward, cuDNN's deterministic flags set
   during the run and restored after it, no K1 launch (no recipe).
9. augment_train — the same pipeline with bench.py config 1's settings
   passed as ``--params``: the recipe [brightness 0.2, contrast 0.1,
   tweak_colors 0.1, gamma 0.05, noise 0.1], validset_ratio 0.05, batch
   4096, bfloat16, AdamW, 4 epochs, no validation or checkpoints: one K1
   launch per step with every batch on the K1 route, 5 K2 launches per step
   all in bfloat16; steady img/s (bench.py's median of the warm epochs),
   step ms, peak memory and the K1 and K2 shares of the step. Then one
   more epoch under ``torch.profiler``: device time per step by kernel
   group, the ten largest kernels, and the device's idle share of the
   unprofiled step.
10. wide_train — ``run --pipeline=train_wide_classifier``, ``_gn`` and
   ``_ws`` (batch norm, group norm, weight norm) in this process with the
   conf's hp (batch 1024, bfloat16, AdamW lr 1e-3 wd 1e-2,
   ``deterministic: true``) on CIFAR-10 (the line names which pixels), cut
   to 2 epochs, no checkpoints: finite losses, 6 K2 launches per training
   and validation forward, all on bfloat16 inputs; the median step of the
   last epoch (CUDA events after each step), img/s, peak memory. Then one
   more epoch of each on 10,000 training images (validset_ratio 0.8),
   validation off, under ``torch.profiler`` (``wide_train_profile``): device time per step by group (K2's forward;
   K2's backward, the plain version again in float32 with cuDNN's dgrad
   and wgrad; batch or group norm and the weight-norm reparameterisation,
   forward and backward, found by profiler ranges around them; pools, the
   dense head, the loss, AdamW, copies), the ten largest kernels, and the
   device's idle share of the unprofiled step.
11. zoo_train — ``run --pipeline=train_mobilenet_v2`` (2 epochs),
   ``train_mobilenet_v3``, ``train_densenet``, ``train_convnext`` and
   ``train_swin`` (1 epoch each) in this process at full width with the
   conf's models (MobileNetV2 1.0, MobileNetV3-Large, DenseNet-121,
   ConvNeXt-Tiny, Swin-T with drop path 0.2) and
   ``train_resnet50``'s hp (SGD lr 0.1, batch 256, bf16) on the synthetic
   ``imagenet224`` set, no checkpoints: finite losses; torchvision's
   parameter counts; K2 launches per
   training and validation forward of 34, 30, 119, 0 and 0, by epilogue
   activation (relu6 17 and none 17; hard_swish 10, relu 5 and none 15;
   none 119), every one bf16 in x and w, and no flash launch; the median
   step of the last epoch (CUDA events after each step), img/s, peak
   memory, parameters, the data's digest and the cuts. Then one more epoch of
   ``train_mobilenet_v2``, cut to 8 steps, validation off, under
   ``torch.profiler`` (``zoo_train_profile``): device time a step by group
   (K2's forward, K2's backward, the depthwise and stem convs and
   BatchNorm, each forward and backward, found by profiler ranges and
   autograd sequence numbers, SGD, elementwise, the rest), the ten largest
   kernels and the device's idle share of the unprofiled step.
12. dense_train — ``run --pipeline=train_semantic_segmentation`` (6
   epochs) and ``--pipeline=train_pose_estimator`` (8) in this process with
   the conf's HRNet models and hp (batch 64, AdamW, one_cycle for
   segmentation, float32), epochs not cut, on the catalog's synthetic
   32x32 sets: finite losses and validation metrics (pixel accuracy and
   mean IoU; PCK), 89,258 parameters each, exactly one float32 K2 launch
   (the head) a training and a validation forward; the median step of the
   last epoch (CUDA events after each step).
13. unet_train — ``create_segmenter(datasets, unet_spec())`` and
   ``train_segmenter``, as bench.py config 12 drives them, at full width
   (depth 4, base 32, group norm) on 1,280 synthetic 256x256 images of
   ``generate_segmentation_dataset`` (a fifth for validation), batch 32,
   bf16, AdamW, one_cycle, 2 epochs: 7,849,700 parameters, 19 K2 launches
   a training and a validation forward, all bf16 in x and w, finite losses
   and mIoU; the median step of the last epoch, img/s, peak memory. Then,
   in a process of its own (``--unet-profile``, below), one unprofiled step
   and 8 steps of a fresh model under ``torch.profiler``
   (``unet_train_profile``): device ms a step by group (K2's forward and
   backward, group norm, the resize, max pool, the links, the loss and
   metrics, AdamW, copies), the ten largest kernels, the idle share.
14. dense_cpu_check — one float32 forward of the conf's HRNet segmenter
   (32x32) and of the U-Net segmenter (64x64), batch 8, on the card against
   the CPU path with the same weights: rel L2 within 1e-3, 1 and 19 float32
   K2 launches.
15. detect_train — ``run --pipeline=train_object_detector`` (6 epochs) and
   ``--pipeline=train_fpn_detector`` (8) in this process with the conf's
   models and hp (batch 64, AdamW lr 2e-3 wd 1e-4, float32, TF32 off),
   epochs not cut, on the catalog's synthetic 32x32 shapes sets: finite
   losses, a finite ``valid_map50`` in [0, 1] with the objectness accuracy
   (and the mean IoU on the single grid), 14,760 and 117,864 parameters,
   exactly 4 float32 K2 launches a training and a validation forward, no
   K1 and no flash launch; the median step of the last epoch and the wall
   of every validation pass, mAP included.
16. fpn_train — bench.py config 12's FPN detector (bench.py:1049-1087)
   through the port's ``generate_shapes_dataset_fpn``, ``preprocess``,
   ``create_fpn_detector`` and ``train_fpn_detector``: 8,192 64x64 images,
   grids (16, 8), a 0.05 validation split, fpn_channels 64, batch 512,
   bf16, AdamW lr 2e-3, 4 epochs, validation after the last (bench.py's is
   off: the one cut): 221,064 parameters, 4 bf16 K2 launches a forward,
   finite losses and map50; the median step of the last epoch, img/s, peak
   memory. Then, in a process of its own (``--fpn-profile``), 8 profiled
   steps (``fpn_train_profile``): device ms a step for K2's forward and
   backward, the FPN's cuDNN convs, the nearest resize, the focal loss,
   AdamW, copies, and the idle share.
17. keypoints_train — ``run --pipeline=train_keypoint_detector`` with the
   conf's hp (batch 32, AdamW lr 1e-3), cut to 1 epoch and a quarter of the
   training images (validset_ratio 0.8), on CIFAR-10 (the
   line names which pixels), twice: in bf16 (passed as ``--params``) and in
   the conf's own float32: 3,267 parameters, 3 K2 launches a forward in the
   run's dtype (relu, relu, and none before the sigmoid), finite
   ``reconstruction_mse`` in training and validation; the median step.
18. keypoints_match — bench.py config 4 (bench.py:256-341): the conf's
   encoder at 64x64 in bf16 eval, 64 pairs (``img_b = img_a + 0.02
   noise``), K = 256: encode, dense descriptors, keypoints of the mean
   |activation|, their descriptors, per-pair mutual NN; pairs/s over 20
   iterations by CUDA events, 1 K2 launch an encoder forward; AdaLAM on the
   first pair (its surviving share); then the chain in float32 on the card
   and on the CPU (8 pairs, the same weights, inputs and Gumbel draws):
   matches and AdaLAM masks agree for at least 99 % of the keypoints.
   Config 4's classical half is ``classical_match`` (23).
19. video_train — ``run --pipeline=train_optical_flow`` (cut from 40 to 10
   epochs),
   ``train_video_classifier`` (12), ``train_temporal_classifier`` with the
   conf's ``gru`` and with ``temporal_classifier_model.temporal:transformer``
   (20 each) in this process with the conf's models and hp (batch 64,
   AdamW, float32, TF32 off), the others' epochs not cut, on the catalog's synthetic
   flow pairs (32x32) and clips (6 frames of 12x12): 14,754, 15,396, 13,668
   and 16,196 parameters, finite losses, a finite ``valid_epe`` and
   ``valid_accuracy`` in [0, 1], no K1, K2 or flash launch (no TPU kernel
   lies on these paths); the median step of the last epoch, img/s, peak
   memory and the wall of each validation pass.
20. video_cpu_check — one float32 forward (eval, batch 8, validation
   inputs) of each of the four trained models on the card against a copy
   on the CPU: rel L2 within 1e-3; then ``flow_warp`` and
   ``interpolate_frames`` on the flow set's 32x32 pairs with the trained
   flow model's flow, on the card against the CPU: within 1e-5.
21. tracking — ``track_sequence`` and ``mot_metrics`` on a synthetic clip
   at half MOT17-04's length (525 of its 1,050 frames, 1920x1080): 48
   lanes, objects at constant velocity (bouncing at the edges) with position
   jitter, births,
   deaths and dropped detections, 64 padded detection rows a frame in a
   shuffled order, ``max_tracks`` 128, on the card and on the CPU: the ids
   equal on every row (else the first frame where they part), the counts
   equal and MOTA within 1e-6; frames/s on the card and on the CPU.
22. augment_ops — the 13 AugMix ops, the float and PIL-exact transforms,
   AugMix, RandAugment, TrivialAugment, random erasing, mixup and CutMix at
   4096x32x32x3 on the card against the CPU on the same images and draws
   (made on the CPU): PIL-exact ops at most one u8 level apart on 0.1 % of
   the values, float ones within 1e-5; each op's ms by CUDA events.
   ``augment_full_train`` then runs ``train_image_classifier`` at bench.py
   config 1's settings (batch 4096, bf16, 4 steps) with the conf's
   ``basic_augmentation`` and ``augmix_augmentation`` plus ``augmix_jsd``
   (the eager route, 5 and 15 K2 launches a step) and with config 1's
   recipe plus mixup and CutMix (K1 each step): routes, K1 and K2 launches,
   step ms.
23. classical_match — config 4's classical half: Harris, ORB and Hamming
   matching of the same 64 pairs, pairs/s beside keypoints_match's, and 8
   pairs against the CPU (keypoints and matches 99 %, a descriptor bit
   flipped only where the CPU's samples are within 1e-5). ``geometry``:
   ``stitch_pair``, ``ransac_homography``, ``stabilize_video`` and
   ``remove_watermark`` against the CPU on the same RANSAC sets.
   ``video_predict``: a .y4m clip through ``predict`` and ``process_video``
   on the card against the CPU (5 f32 K2 launches a forward).
24. stream_train — bench.py config 7: a 403 MB memmap written under
   ``_build/``, streamed through the C++ loader (``native_loader: auto``;
   the memmap reaches it without a copy), then with the wire codec
   (``wire_compression: {bits: 3, axis: -2}``: every batch must go coded,
   its first losses held to the raw run's), then resident; the numpy and
   C++ gathers, the loader's hand-over, the host encode, a batch decoded on
   the card bit-equal to the host's, and bench.py's wire-feed probe (raw
   and coded images a second); ``runtime_train``: 22 runs of 4
   steps over the optimizers, schedules and the update chain (the AdamW,
   ``remat: true`` and ``dots`` runs traced in a process of its own,
   ``--remat-profile``); ``partial_run``: ``run --to-nodes``,
   ``--only-nodes`` and ``--from-nodes`` against a full run.
25. search — ``python -m deepcv_tpu_torch search --pipeline
   train_image_classifier`` in this process: TPE over a space written by the
   phase (the conf's ``model:dropout_prob``, ``model:batch_norm.momentum``
   and ``training:optimizer_opts.lr`` domains, config 1's batch of 4096 and
   one epoch as one-value choices), 4 trials, each the whole pipeline with
   config 1's recipe and settings: each trial's value, seconds and step ms,
   K1 (one a step) and K2 (5 bf16 a forward) launches, the best params held
   to ``summary.json``. ``hp_search``: bench.py config 5's runner (4 random
   trials, 1,024 synthetic 16x16 images, batch 128, bf16, ``runtime_lr:
   true``): the trial seconds and their first-to-fastest ratio (here no
   compile: the first trial's first-call costs). ``nas``: on CIFAR-10 32x32,
   bf16, 10,000 training images, classic NAS over the conf's
   ``larger_backbone`` classifier (3 ``SearchRunner`` trials of
   ``sample_architecture`` -> ``apply_fixed_architecture`` -> 1 epoch at
   batch 512, 11 K2 launches a forward) and single-shot NAS (darts, spos,
   proxylessnas, enas; 13 K2 launches a forward, every candidate) on the same
   classifier with ``mutable_layer_1``'s candidates at a common 32 channels
   (the conf's 32, 16 and 8 cannot be summed); then, in float32, the
   supernet against the CPU path and the forced-arch supernet against the
   fixed model of its export on the chosen weights, within SERVE_REL_L2,
   and the export saved as a NAS bundle, loaded and served once.
   ``lr_find``: ``lr-find --pipeline train_image_classifier --steps 100
   --batch-size 4096``: the suggested LRs and the CSV curve, 5 K2 launches a
   step.
26. codec — bench.py config 14 (``bench_codec``) at its TPU settings: the
   learned lossless codec fitted on 4,064 CIFAR-10 images (600 steps at
   batch 64, hidden 48), the 32 held out encoded and decoded (all lossless,
   the native range coder), the model and coded bits a subpixel, encode and
   decode px/s, the ratio to raw and to PNG, the card's bits a subpixel
   against the CPU path's on the same weights (rel 1e-4); then a video codec
   fitted on moving-square clips, written to a ``.dvv`` container and read
   back equal.
27. data_gen — SinGAN at ``train_singan``'s defaults on one 64x64 image
   (every scale's reconstruction loss falls; the fixed-noise reconstruction
   against the CPU path's within SERVE_REL_L2), 8 variants in a viz grid,
   16 WFC tilemaps of 32x32 (every one valid) and a texture from learned
   tiles. These last two phases launch no kernel of the port: their device
   work is PyTorch ops, as it is XLA in the JAX package.
28. active_learning — ``active_learning_loop`` with the conf's
   ``image_classifier`` (its head's dropout 0.1) and
   ``train_image_classifier`` hp on CIFAR-10: a pool of 4,096, 1,024
   labeled at the start, 512 acquired a round by BALD over 8 MC samples, 3
   rounds; every acquired index new and the rounds disjoint; 5 K2 launches
   per training, validation and scoring forward; the last model with
   dropout off scored on the card and on the CPU in f32 (probabilities
   within F32_TOL, the top 512 by entropy equal but at scores tied within
   that bound); each round's metrics in an ExperimentTracker store and the
   last round in the training metadata.
29. boosting — ``adaboost_train`` (SAMME) on the conf's
   ``wide_classifier_gn_model``, float32: 3 rounds of 100 SGD steps at
   batch 256 on 10,000 CIFAR-10 images, a fifth of their labels redrawn at
   random (the stand-in's classes are separable: a perfect member would end
   SAMME after one round); 6 K2 launches per forward; the weighted errors,
   alphas and vote accuracy. Card vs CPU: 3 steps at batch
   32 (lr 0.005) from the same init and index batches, the fitted
   parameters (the whole vector, L2), weighted error and alpha within 1e-4
   relative.
30. meta_learning — ``reptile_train`` on the wide classifier with a 4-way
   head: 4-way 5-shot, 5 queries, 4 episodes a meta-step, 5 inner steps, 50
   meta-steps on 6 CIFAR-10 classes, then ``adapt`` and
   ``episode_accuracy`` on 5 episodes of the 4 held-out classes (reported,
   no threshold: the pixels are synthetic); 6 K2 launches per forward. Card
   vs CPU: 2 meta-steps (of 2 episodes and 3 inner steps at lr 0.005) from
   the same parameters and episodes, the whole parameter vector within 1e-4
   relative (L2; the in-place updates that keep K2's packed weights
   current).
31. tooling — ``profiling.profile_op_breakdown`` of a wide classifier
   forward and backward at batch 1,024 in bf16 (K2's kernels in the rows, 6
   a forward), ``model_flops`` (305,610,752 FLOPs an image), ``mfu_report``
   of the forward against the H100's dense bf16 peak, ``check_determinism``
   of a forward (0.0), the dashboard over ``active_learning``'s tracker
   store (``GET /`` lists its runs) and ``docs``, in a process of its own
   (``chip_smoke.py --tooling CARD STORE``: late in the run the profiler
   loses K2 records).

Host libraries: ``build`` also compiles the host runtime (``runtime/
deepcv_io.cpp``, ``deepcv_rc.cpp``) with g++ beside the nvcc builds. Device
times: where the profiler keeps too few records in every window of a
main-path conv (``device_ms_or_events``), the call is timed by CUDA events
and its row says ``device_ms_by: cuda_events``; the K2 line counts such rows.

Then the wall seconds of every phase (``walls``), the kernels line and,
last, the contract line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without the last line. With no CUDA device, or without the
repository beside it, it exits non-zero at once. A hang dumps the stacks and
exits non-zero after ``HANG_LIMIT_S``.

    python3 chip_smoke.py --k2-forward

runs only the device phase, ``kernel_forward_bf16``, ``kernel_forward_f32``
and the ResNet-50 predictor's forward at batch 64 in float32
(``resnet50_predictor_forward``) with whatever K2 the package beside the
script has (no build checks, no contract line): the way to time an earlier
K2 against this one on the same card.

    python3 chip_smoke.py --k3-forward

does the same for K3's float32 route (``k3_forward_f32``): 12 launches at
ViT-B/16's serving shape against SDPA's f32 forward, and the ViT-B/16
predictor's forward at batch 64 in float32.

    python3 chip_smoke.py --k45-f32

does the same for K4's and K5's float32 routes (``k45_f32``): 12 launches
each at ViT-B/16's serving shape against SDPA's f32 backward, and
``train_vit`` in float32 at batch 256 for two epochs of 8 steps,
validation off (the last epoch's step time).

    python3 chip_smoke.py --k1

does the same for K1: the build of K1's and K2's libraries (K1's
registers and spills), ``augment_kernel`` (every ``AUG_SHAPES`` row with
its CUDA-event and device times, and the noise statistics), and
``augment_train`` cut to 2 epochs plus one profiled epoch
(``k1_augment_train``: the step time and K1's device time a step).

    python3 chip_smoke.py --unet-profile STEP_MS CARD
    python3 chip_smoke.py --fpn-profile STEP_MS CARD

are ``unet_train_profile`` and ``fpn_train_profile`` alone, the idle
share taken of ``STEP_MS`` and the line marked with ``CARD``; the whole
run starts them so.

    python3 chip_smoke.py --tooling CARD STORE

is the ``tooling`` phase alone, the dashboard over the tracker store
``STORE``; the whole run starts it so, after ``active_learning``.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import faulthandler
import functools
import hashlib
import http.client
import io
import json
import math
import platform
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path
from typing import Optional
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from deepcv_tpu_torch import cli
from deepcv_tpu_torch.compression import activation_codes, calibrate_int8_scales
from deepcv_tpu_torch.config import load_yaml
from deepcv_tpu_torch.data.datasets import ArrayDataset
from deepcv_tpu_torch.data.preprocess import PreprocessedDataset, preprocess
from deepcv_tpu_torch.data.transforms import normalize, to_tensor
from deepcv_tpu_torch.ops import nn as port_nn
from deepcv_tpu_torch.ops.kernels import _build
from deepcv_tpu_torch.ops.kernels.fused_augment import (
    fused_augment_normalize, plain_fused_augment_normalize)
from deepcv_tpu_torch.ops.kernels.flash_attention import (
    HEAD_DIMS as FLASH_HEAD_DIMS, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_fwd, plain_flash_bwd_dkv, plain_flash_bwd_dq, plain_flash_fwd)
from deepcv_tpu_torch.ops.kernels.fused_layer import (
    fused_conv2d_bias_act, plain_conv2d_bias_act)
from deepcv_tpu_torch.ops.kernels import fused_layer
from deepcv_tpu_torch.ops.kernels.int8_conv import (
    ROUTES as INT8_ROUTES, TC_BN as INT8_TC_BN, conv_output_shape, int8_conv, launch_args,
    pack_weight_for, plain_int8_conv, tc_smem_bytes)
from deepcv_tpu_torch.ops.moe import MoEMlp
from deepcv_tpu_torch.ops.nn import FusedConv2d
from deepcv_tpu_torch.pipelines import detection as det_pipeline
from deepcv_tpu_torch.pipelines import keypoints as kp_pipeline
from deepcv_tpu_torch.pipelines import segmentation as seg_pipeline
from deepcv_tpu_torch.pipelines import tracking as tracking_pipeline
from deepcv_tpu_torch.pipelines import video as video_pipeline
from deepcv_tpu_torch.pipelines.framework import append_dense_head
from deepcv_tpu_torch.serve import (EnsemblePredictor, Predictor, StackedEnsemble,
                                    load_model_bundle, save_model_bundle)
from deepcv_tpu_torch.server import InferenceServer
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec.creators import ForwardCallback, MaxPool
from deepcv_tpu_torch.spec.zoo import (densenet_spec, mobilenet_v2_spec, mobilenet_v3_spec,
                                       resnet_spec, unet_spec, vit_spec)
from deepcv_tpu_torch.train import training
from deepcv_tpu_torch.train.losses import cross_entropy_loss

REPO = Path(__file__).resolve().parent
HANG_LIMIT_S = 1000
SEED = 20261017

# relative to max|ref|. f32: both accumulate in f32, in another order, the
# kernels by 3xTF32 (K2: 3.3e-6 at K = 4,608 on an H100). bf16: both round
# one f32 result to bf16, so they differ by at most one ulp, 2**-7 of the
# largest value.
F32_TOL = 2e-5
BF16_TOL = 1e-2
SERVE_REL_L2 = 1e-3  # card vs CPU, both f32 with TF32 off

#: published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
#: cores, bf16 and TF32 dense on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 494.7e12}
HBM_BYTES_PER_S = 3.35e12

#: ResNet-50's stride-1 conv shapes at the serving batch: (N, H, W, Cin, Cout, k)
PHASE2_SHAPES = [
    (64, 56, 56, 64, 64, 1), (64, 56, 56, 64, 64, 3), (64, 56, 56, 64, 256, 1),
    (64, 56, 56, 256, 64, 1), (64, 28, 28, 128, 128, 3), (64, 14, 14, 256, 256, 3),
    (64, 7, 7, 512, 512, 3), (64, 7, 7, 512, 2048, 1),
    (3, 13, 13, 5, 7, 5),  # ragged: partial tiles on every axis
]
#: image_classifier's stride-1 convs at bench.py's batch 4096, with how often
#: each runs per forward; Cin 3 and Cout 4 leave partial tiles
CLASSIFIER_CONVS = {(4096, 32, 32, 3, 4, 5): 1, (4096, 32, 32, 4, 4, 5): 2,
                    (4096, 16, 16, 4, 16, 3): 1, (4096, 16, 16, 16, 16, 3): 1}
#: all 46 stride-1 convs of one resnet_spec(50) forward at the serving batch,
#: by shape, with how often each runs (the model's FusedConv2d calls)
RESNET50_CONVS = {
    (64, 56, 56, 64, 64, 1): 1, (64, 56, 56, 64, 64, 3): 3, (64, 56, 56, 64, 256, 1): 4,
    (64, 56, 56, 256, 64, 1): 2, (64, 56, 56, 256, 128, 1): 1,
    (64, 28, 28, 128, 512, 1): 4, (64, 28, 28, 512, 128, 1): 3,
    (64, 28, 28, 128, 128, 3): 3, (64, 28, 28, 512, 256, 1): 1,
    (64, 14, 14, 256, 1024, 1): 6, (64, 14, 14, 1024, 256, 1): 5,
    (64, 14, 14, 256, 256, 3): 5, (64, 14, 14, 1024, 512, 1): 1,
    (64, 7, 7, 512, 2048, 1): 3, (64, 7, 7, 2048, 512, 1): 2, (64, 7, 7, 512, 512, 3): 2}
#: image_classifier's convs at classifier_train's batch 32 (the conf's hp)
CLASSIFIER_TRAIN_CONVS = {(32, *shape[1:]): count for shape, count in CLASSIFIER_CONVS.items()}
#: the wide classifiers' six stride-1 3x3 convs (leaky_relu, bias) at
#: train_wide_classifier's batch 1024, each once per forward
WIDE_BATCH = 1024
WIDE_CONVS = {(WIDE_BATCH, 32, 32, 3, 64, 3): 1, (WIDE_BATCH, 32, 32, 64, 64, 3): 1,
              (WIDE_BATCH, 16, 16, 64, 128, 3): 1, (WIDE_BATCH, 16, 16, 128, 128, 3): 1,
              (WIDE_BATCH, 8, 8, 128, 256, 3): 1, (WIDE_BATCH, 8, 8, 256, 256, 3): 1}
WIDE_CONVS_PER_FORWARD = sum(WIDE_CONVS.values())
#: the three wide pipelines, all trained with the train_wide_classifier hp
WIDE_PIPELINES = ("train_wide_classifier", "train_wide_classifier_gn",
                  "train_wide_classifier_ws")
WIDE_EPOCHS = 2            # cut from train_wide_classifier's 10
#: the CNN zoo's pipelines as zoo_train runs them, with train_resnet50's hp
#: (SGD lr 0.1, batch 256, bf16) on the synthetic imagenet224 set: the
#: epochs each is cut to (from 10) and K2's launches per forward by epilogue
#: activation ("none": no activation in the epilogue; DenseNet's relu runs
#: before each conv, ConvNeXt and Swin have no conv K2 takes)
ZOO_PIPELINES = {"train_mobilenet_v2": (2, {"relu6": 17, "none": 17}),
                 "train_mobilenet_v3": (1, {"hard_swish": 10, "relu": 5, "none": 15}),
                 "train_densenet": (1, {"none": 119}),
                 "train_convnext": (1, {}),
                 "train_swin": (1, {})}
#: the zoo models' parameters at 1000 classes: torchvision's counts
ZOO_PARAMETERS = {"train_mobilenet_v2": 3_504_872, "train_mobilenet_v3": 5_483_032,
                  "train_densenet": 7_978_856, "train_convnext": 28_589_128,
                  "train_swin": 28_288_354}
#: the zoo models whose K2 convs kernel_forward_bf16 times, at batch 256
ZOO_FORWARDS = (("mobilenet_v2", mobilenet_v2_spec),
                ("mobilenet_v3", functools.partial(mobilenet_v3_spec, variant="large")),
                ("densenet_121", densenet_spec))
#: a pipeline that a train phase (:func:`phase_pipeline_runs`) runs through
#: the port's ``run`` with the conf's model and hp: its label, the
#: pipeline (also its training hp's key), the --params it adds, its epochs
#: (the conf's unless ``params`` cut them), its parameters, its K2 convs a
#: training and a validation forward by epilogue activation, K2's dtype,
#: its validation metrics with the top of their range, and its cuts
PipelineRun = collections.namedtuple(
    "PipelineRun", "label pipeline params epochs parameters k2_by_act dtype metrics cut")
#: the conf's HRNet segmenter and pose estimator at 32x32: the JAX models'
#: 90,698 less the 1,440 weights of their stems' zero-padded input rows
DENSE_PARAMETERS = 89_258
#: dense_train: the conf's HRNet models (hrnet_backbone and the 1x1 head to
#: 4 channels, its one K2 launch) and hp (batch 64, AdamW lr 2e-3 wd 1e-4,
#: one_cycle for segmentation, float32), epochs not cut
DENSE_RUNS = (
    PipelineRun("segmentation", "train_semantic_segmentation", (), 6, DENSE_PARAMETERS,
                {"none": 1}, "float32", {"valid_pixel_accuracy": 1, "valid_mean_iou": 1}, {}),
    PipelineRun("pose", "train_pose_estimator", (), 8, DENSE_PARAMETERS, {"none": 1},
                "float32", {"valid_pck": 1}, {}))
#: unet_train: bench.py config 12's functions (create_segmenter,
#: train_segmenter) on unet_spec() at its defaults (depth 4, base 32, group
#: norm), generate_segmentation_dataset's images at 256x256 (1,280, a fifth
#: for validation), batch 32, bf16, AdamW, one_cycle
UNET_IMAGES, UNET_SIZE, UNET_BATCH, UNET_EPOCHS = 1280, 256, 32, 2
#: unet_spec() with the 4-class head: the JAX model's 7,851,140 less 1,440
UNET_PARAMETERS = 7_849_700
#: K2 convs a U-Net forward: 18 3x3 (no bias, relu) and the head (bias)
UNET_CONVS_PER_FORWARD = 19
UNET_HP = {"epochs": UNET_EPOCHS, "batch_size": UNET_BATCH, "optimizer": "adamw",
           "optimizer_opts": {"lr": 2e-3, "weight_decay": 1e-4}, "scheduler": "one_cycle",
           "dtype": "bfloat16", "save_every_iters": 0, "validate_every_epochs": UNET_EPOCHS,
           "log_progress_every_iters": (UNET_IMAGES * 4 // 5) // UNET_BATCH}
UNET_PROFILE_STEPS = 8
#: K2 at the dense paths' own shapes in the kernel phase: the head in f32 at
#: dense_train's batch (Cout 4, below every tile width), U-Net's first conv,
#: its widest decoder input and its full-resolution decoder conv in bf16 at
#: unet_train's batch
DENSE_KERNEL_CASES = [((64, 8, 8, 32, 4, 1), ("float32",)),
                      ((UNET_BATCH, 256, 256, 3, 32, 3), ("bfloat16",)),
                      ((UNET_BATCH, 32, 32, 768, 256, 3), ("bfloat16",)),
                      ((UNET_BATCH, 256, 256, 96, 32, 3), ("bfloat16",))]
#: detect_train: the conf's single-grid and FPN detectors with the conf's
#: hp (batch 64, AdamW lr 2e-3 wd 1e-4, float32, epochs not cut) on the
#: catalog's synthetic 32x32 sets; their parameters are the JAX models'
#: 15,480 and 118,584 less the stem's 720 zero-padded kernel rows
DETECT_BATCH, DETECT_SIZE = 64, 32
DETECT_RUNS = (
    PipelineRun("single", "train_object_detector", (), 6, 14_760, {"relu": 3, "none": 1},
                "float32", {"valid_map50": 1, "valid_objectness_accuracy": 1,
                            "valid_mean_iou": 1}, {}),
    PipelineRun("fpn", "train_fpn_detector", (), 8, 117_864, {"relu": 4}, "float32",
                {"valid_map50": 1, "valid_objectness_accuracy": 1}, {}))
#: fpn_train: bench.py config 12's FPN detector (bench.py:1049-1087) at full
#: size: 8,192 synthetic 64x64 images of generate_shapes_dataset_fpn, grids
#: (16, 8), a 0.05 validation split, its backbone with fpn_channels 64,
#: batch 512, bf16, AdamW lr 2e-3, 4 epochs; validation after the last
#: (bench.py's is off), so that map50 runs on the card
FPN_IMAGES, FPN_SIZE, FPN_GRIDS, FPN_BATCH, FPN_EPOCHS = 8192, 64, (16, 8), 512, 4
FPN_BACKBONE = {"act_fn": "relu", "fpn_channels": 64, "architecture": [
    {"conv2d": {"kernel_size": [3, 3], "out_channels": 32, "padding": 1}},
    {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
    {"conv2d": {"kernel_size": [3, 3], "out_channels": 64, "padding": 1}},
    {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
    {"conv2d": ["c3", {"kernel_size": [3, 3], "out_channels": 64, "padding": 1}]},
    {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
    {"conv2d": ["c4", {"kernel_size": [3, 3], "out_channels": 128, "padding": 1}]},
    {"_new_branch_from_tensor": {"_from": ["c3", "c4"]}}]}
FPN_HP = {"epochs": FPN_EPOCHS, "batch_size": FPN_BATCH, "optimizer": "adamw",
          "optimizer_opts": {"lr": 2e-3}, "save_every_iters": 0,
          "validate_every_epochs": FPN_EPOCHS, "log_progress_every_iters": 1_000_000,
          "seed": 0, "device_resident_dataset": True, "dtype": "bfloat16",
          "handle_preemption": False, "fpn_grids": FPN_GRIDS}
#: the JAX model's 222,504 less the stem's 1,440 zero-padded kernel rows
FPN_PARAMETERS = 221_064
FPN_CONVS_PER_FORWARD = 4
FPN_PROFILE_STEPS = 8
FPN_PROFILE_PROCESS_S = 300
#: keypoints_train: the conf's autoencoder (3,267 parameters: the JAX
#: model's 3,987 less 720 zero-padded rows) with the conf's hp (batch 32,
#: AdamW lr 1e-3, its warm-up schedule, deterministic), cut to 1 epoch, on
#: CIFAR-10: in bf16 (passed as --params) and in the conf's own float32
KEYPOINT_BATCH = 32
#: cut to a quarter of the conf's training images (1,250 -> 312 steps)
KEYPOINT_VALID_RATIO = "cifar10_preprocessing.split_dataset.validset_ratio:0.8"
KEYPOINT_IMAGES_CUT = "40,000 -> 10,000 (validset_ratio 0.2 -> 0.8)"
KEYPOINT_RUNS = (
    PipelineRun("autoencoder", "train_keypoint_detector",
                ("train_keypoint_detector.epochs:1", "train_keypoint_detector.dtype:bfloat16",
                 KEYPOINT_VALID_RATIO), 1, 3_267, {"relu": 2, "none": 1}, "bfloat16",
                {"valid_reconstruction_mse": math.inf},
                {"epochs": "2 -> 1", "dtype": "the conf trains in float32; bfloat16 "
                                              "passed as --params",
                 "train_images": KEYPOINT_IMAGES_CUT}),
    PipelineRun("autoencoder_f32", "train_keypoint_detector",
                ("train_keypoint_detector.epochs:1", KEYPOINT_VALID_RATIO), 1, 3_267,
                {"relu": 2, "none": 1}, "float32", {"valid_reconstruction_mse": math.inf},
                {"epochs": "2 -> 1", "train_images": KEYPOINT_IMAGES_CUT}))
#: keypoints_match: bench.py config 4 (bench.py:256-341): the conf's encoder
#: at 64x64 in bf16 eval, 64 pairs, K = 256 keypoints, 20 timed iterations
MATCH_PAIRS, MATCH_SIZE, MATCH_K, MATCH_ITERS = 64, 64, 256, 20
MATCH_AGREE = 0.99
#: K2 at the detection and keypoint paths' own shapes: the detectors' stem
#: and single-grid head (Cout 8) in f32 at batch 64, the FPN's stem and c4
#: conv at config 12's batch 512 and the autoencoder's stem and last conv
#: (Cout 3) at batch 32 in bf16
DETECT_KERNEL_CASES = [((64, 32, 32, 3, 16, 3), ("float32",)),
                       ((64, 8, 8, 32, 8, 1), ("float32",)),
                       ((FPN_BATCH, 64, 64, 3, 32, 3), ("bfloat16",)),
                       ((FPN_BATCH, 8, 8, 64, 128, 3), ("bfloat16",)),
                       ((32, 32, 32, 3, 16, 3), ("bfloat16",)),
                       ((32, 32, 32, 16, 3, 3), ("bfloat16",))]
#: video_train: the video pipelines with the conf's models and hp (batch
#: 64, AdamW, float32), epochs not cut, on the catalog's synthetic flow
#: pairs and clips; no TPU kernel lies on these paths, so no K2 launch
VIDEO_RUNS = (
    PipelineRun("flow", "train_optical_flow", ("train_optical_flow.epochs:10",), 10, 14_754,
                {}, "float32", {"valid_epe": math.inf}, {"epochs": "40 -> 10"}),
    PipelineRun("conv3d", "train_video_classifier", (), 12, 15_396, {}, "float32",
                {"valid_accuracy": 1}, {}),
    PipelineRun("gru", "train_temporal_classifier", (), 20, 13_668, {}, "float32",
                {"valid_accuracy": 1}, {}),
    PipelineRun("transformer", "train_temporal_classifier",
                ("temporal_classifier_model.temporal:transformer",), 20, 16_196, {}, "float32",
                {"valid_accuracy": 1}, {"temporal": "transformer passed as --params (the "
                                                    "conf's is gru)"}))
VIDEO_CHECK_BATCH = 8
VIDEO_OP_TOL = 1e-5
#: tracking: a clip at MOT17-04's frame size (1920x1080) and half its length
#: (cut from 1,050 frames to keep the whole run under 850 s), 48 lanes, 64
#: detection rows a frame, 128 track slots
TRACK_FRAMES, TRACK_OBJECTS, TRACK_ROWS, TRACK_SLOTS = 525, 48, 64, 128
TRACK_FRAME_WH = (1920, 1080)
MOTA_TOL = 1e-6
DEVICE = "cuda"
IMAGE_SHAPE = (224, 224, 3)
SERVE_BATCH = 64
REQUEST_SIZES = (1, 5, 17, 64)
ROUNDS = 6
LAUNCHES_PER_FORWARD = 46
KERNEL_LIBRARIES = ("fused_augment", "fused_conv2d_bias_act", "flash_attention", "int8_conv")
#: the host runtime (``runtime/*.cpp``): the C++ batch loader, the range coder
HOST_LIBRARIES = ("deepcv_io", "deepcv_rc")
#: ViT-B/16 at 224: 12 blocks, 12 heads, 197 tokens, head dim 64
VIT_BLOCKS, VIT_HEADS, VIT_T, VIT_DH = 12, 12, 197, 64
TRAIN_BATCH = 256          # train_resnet50's batch_size, which train_vit uses
TRAIN_EPOCHS = 2           # cut from train_resnet50's 10
#: train_vit in float32: the model's and the training hp's dtype
F32_TRAIN_PARAMS = ("vit_model.dtype:float32", "train_resnet50.dtype:float32")
#: a train_vit or train_mobilenet_v2 run cut to 8 steps at batch 256: the
#: split gives the 8,192-image synthetic set 2,048 to train on; validation
#: off
SHORT_TRAIN_PARAMS = ("imagenet224_preprocessing.split_dataset.validset_ratio:0.75",
                      "train_resnet50.validate_every_epochs:1000")
#: (label, N, H, T, Dh, dtypes): the serve and train shapes of the main
#: paths, ViT-H/14's attention (16 heads of 80: F3) at a small batch, a
#: ragged T and T = 1024
FLASH_CASES = [("vit_serve", SERVE_BATCH, VIT_HEADS, VIT_T, VIT_DH, ("float32", "bfloat16")),
               ("vit_train", TRAIN_BATCH, VIT_HEADS, VIT_T, VIT_DH, ("float32", "bfloat16")),
               ("h_14", 8, 16, VIT_T, 80, ("float32", "bfloat16")),
               ("ragged", 8, VIT_HEADS, 77, VIT_DH, ("float32", "bfloat16")),
               ("t1024", 4, VIT_HEADS, 1024, VIT_DH, ("float32", "bfloat16"))]
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CIFAR_MEAN = (0.491, 0.482, 0.447)
CIFAR_STD = (0.247, 0.243, 0.261)
#: K1 against its plain version, noise off: absolute, on values of up to
#: ~4 after the normalize. Both round the grey level in the same integers, so
#: what is left is the float32 rounding of the unquantized steps and the
#: kernel's power (ex2(g * lg2(y)), relative error near 2^-22) and FMA
#: normalize (by 1/std and -mean/std): a few ulps of values below 4.
AUG_TOL = 1e-5
#: K1's shapes: bench.py's augment+train batch (warp plan), a 224x224 batch
#: (block plan), a ragged one, and one each side of the plans' threshold
#: (1,024 pixels): 31x33 and 25x41, whose images start off 16 bytes
AUG_SHAPES = [(4096, 32, 32, 3), (256, 224, 224, 3), (5, 13, 29, 3), (64, 31, 33, 3),
              (64, 25, 41, 3)]
#: K1's operations per element, counted from the chain (to_tensor, brightness
#: and its clip, the 601 luma per pixel, contrast, saturation, clip and
#: gamma as one power, normalize; pass 1 repeats to_tensor and brightness)
AUG_OPS_PER_ELEMENT = 32
NOISE_SIGMA = 0.1
CLASSIFIER_CONVS_PER_FORWARD = 5
AUGMENT_BATCH, AUGMENT_EPOCHS = 4096, 4
#: bench.py config 1's recipe, as flow YAML for --params
BENCH_RECIPE = ("{keep_same_input_shape: true, augmentation_ops_depth: [1, 4], "
                "transforms: [{brightness: 0.2}, {contrast: 0.1}, {tweak_colors: 0.1}, "
                "{gamma: 0.05}, {noise: 0.1}]}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _profile_calls(fn, calls: int, margin_s: float = 0.05):
    """torch.profiler (CUDA activity) over ``calls`` calls of ``fn``, with
    ``margin_s`` of idle time at each end of the window: within a long run
    the launches nearest a window's ends have gone missing from it (half of
    20 short launches; all of a one-call window; a few of longer ones), as
    if the device's clock had drifted from the host's, by which the profiler
    cuts the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    return prof


def _kernel_records(prof):
    """The profiler's device kernel records (by name, with counts), less its
    device copies of host ranges: a ``torch.library`` op such as K2's
    launch is one, a span over the kernels it launched, and counting it
    would count those kernels twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and (getattr(e, "self_device_time_total", 0) or 0) > 0]


def device_ms(fn, launches: Optional[int], iters: int = 20, tries: int = 6) -> float:
    """Device time of one call: every kernel's time under torch.profiler over
    ``iters`` calls, summed and divided (no host gaps, unlike ``cuda_ms`` at
    the smallest shapes). ``launches`` is how many kernels one call
    launches: the profiler must have recorded ``iters`` times that many.
    ``None`` is for a call whose kernels are not known beforehand (a
    library's, or a wrapper's with copies around its kernel): then two
    windows in a row must have recorded the same count, a multiple of
    ``iters``. Otherwise the window is profiled again, up to ``tries``
    times, and then this raises: a sum over a short count reads low
    (:func:`_profile_calls` says where launches have gone missing)."""
    fn()
    torch.cuda.synchronize()
    seen = None
    for _ in range(tries):
        events = _kernel_records(_profile_calls(fn, iters))
        recorded = sum(e.count for e in events)
        want = iters * launches if launches is not None else seen
        if recorded == want and recorded % iters == 0:
            return sum(e.self_device_time_total for e in events) / 1e3 / iters
        if launches is not None or seen is not None:
            print(f"chip_smoke: the profiler recorded {recorded} launches for {iters} calls "
                  f"(expected {want}); profiling again", file=sys.stderr, flush=True)
        seen = recorded
        time.sleep(0.2)
    raise AssertionError(f"the profiler recorded {recorded} launches for {iters} calls, "
                         f"expected {iters * launches if launches is not None else 'two equal counts'}, "
                         f"in {tries} tries; the last window's kernels: "
                         f"{ {e.key: e.count for e in events} }")


#: how a device time was taken: from the profiler's records, or (the
#: profiler having kept too few records in every window) by CUDA events
BY_PROFILER, BY_EVENTS = "profiler", "cuda_events"


def device_ms_or_events(fn, launches: Optional[int]):
    """``(ms, how)``: :func:`device_ms` of ``fn``, or, where the profiler
    kept too few of its records in every window (a main-path conv late in
    the long run: 39 records for 20 calls, six windows in a row),
    :func:`cuda_ms` of it, with ``how`` saying which (:data:`BY_EVENTS`)."""
    try:
        return device_ms(fn, launches), BY_PROFILER
    except AssertionError as e:
        print(f"chip_smoke: {e}; timing the call by CUDA events instead", file=sys.stderr,
              flush=True)
        return cuda_ms(fn), BY_EVENTS


def conv_bound(n, h, w, cin, cout, k, dtype: str, bias: bool, tf32x3=False):
    """Least time for the work on an H100 SXM: each input read once, the
    output written once, FLOPs at the type's peak. ``tf32x3``: the
    operations of K2's f32 route, three TF32 products per f32 FLOP at the
    TF32 tensor-core peak. Returns (ms, bound_by)."""
    item = 4 if dtype == "float32" else 2
    flops = 2.0 * n * h * w * k * k * cin * cout
    nbytes = item * (n * h * w * cin + k * k * cin * cout + n * h * w * cout
                     + (cout if bias else 0))
    t_ops = 3 * flops / PEAK_FLOPS["tf32"] if tf32x3 else flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k2_bounds(n, h, w, cin, cout, k, dtype: str, bias: bool):
    """K2's bound for its route (f32: by 3xTF32) as {"bound_ms", "bound_by"},
    with the CUDA-core bound of the same f32 work as ``cuda_core_bound_ms``."""
    bound_ms, bound_by = conv_bound(n, h, w, cin, cout, k, dtype, bias,
                                    tf32x3=dtype == "float32")
    out = {"bound_ms": bound_ms, "bound_by": bound_by}
    if dtype == "float32":
        out["cuda_core_bound_ms"] = conv_bound(n, h, w, cin, cout, k, dtype, bias)[0]
    return out


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": platform.python_version()})
    return card


#: dynamic shared memory of the flash tensor-core kernels (TcLayout,
#: BwdLayout, F32TcLayout and F32BwdLayout, csrc/flash_attention.cu). bf16,
#: rows of Dh + 8: K3 holds 64 q rows and two stages of 64-key K and V
#: tiles; K4 64 q and dO rows and the same stages; K5 64 K and V rows, two
#: stages of 64-row Q and dO tiles and of their lse and delta (f32). f32 K3:
#: 64 q rows and two stages of 32-key K tiles in rows of Dh + 8 floats, two
#: of V in Dh + 4. f32 K4: 64 q and dO rows and two stages of 32-key K and V
#: tiles, all rows of Dh + 8 floats; f32 K5 the mirror plus two stages of
#: the 32 rows' lse and delta
TC_KERNELS = {
    "flash_fwd_tc_kernel": lambda dh: (64 + 4 * 64) * (dh + 8) * 2,
    "flash_bwd_dq_tc_kernel": lambda dh: (2 * 64 + 4 * 64) * (dh + 8) * 2,
    "flash_bwd_dkv_tc_kernel": lambda dh: (2 * 64 + 4 * 64) * (dh + 8) * 2 + 2 * 2 * 64 * 4,
    "flash_fwd_f32tc_kernel": lambda dh: ((64 + 2 * 32) * (dh + 8) + 2 * 32 * (dh + 4)) * 4,
    "flash_bwd_dq_f32tc_kernel": lambda dh: (2 * 64 + 4 * 32) * (dh + 8) * 4,
    "flash_bwd_dkv_f32tc_kernel": lambda dh: (2 * 64 + 4 * 32) * (dh + 8) * 4 + 2 * 2 * 32 * 4,
}
#: the f32 flash kernels, all on the tensor cores by 3xTF32 (their HMMA must
#: be TF32 ones), and the CUDA-core flash kernels they replaced, which must
#: not be compiled
F32_FLASH_KERNELS = ("flash_fwd_f32tc_kernel", "flash_bwd_dq_f32tc_kernel",
                     "flash_bwd_dkv_f32tc_kernel")
OLD_FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
#: head dims at which an f32 backward kernel must not spill (ViT-B/16, ViT-H/14)
F32_BWD_NO_SPILL_DIMS = (64, 80)


#: K2's tensor-core kernels, one instantiation per tile width BN and
#: epilogue family EXT_ACT (relu6, hard_swish, silu; or none, relu,
#: leaky_relu): bf16, and f32 by 3xTF32; their dynamic shared memory follows the conv's shape
#: (fused_layer.tc_plan). The CUDA-core K2 that f32 ran before must not be
#: compiled in either dtype.
K2_TC_KERNEL = "fused_conv2d_bias_act_tc_kernel"
K2_F32_KERNEL = "fused_conv2d_bias_act_f32tc_kernel"
OLD_K2_KERNEL = "fused_conv2d_bias_act_kernel"


def _k2_tc_smem(bn, itemsize=2):
    """The most dynamic shared memory the BN instantiation takes at the
    shapes this script runs in that dtype."""
    shapes = ([*PHASE2_SHAPES, *CLASSIFIER_CONVS, *RESNET50_CONVS] if itemsize == 2
              else [*PHASE2_SHAPES, *CLASSIFIER_TRAIN_CONVS, *RESNET50_CONVS])
    plans = (fused_layer.tc_plan(*s[:5], s[5], s[5], itemsize) for s in shapes)
    return max((p.smem_bytes for p in plans if p.bn == bn), default=None)


def _k2_f32_plans():
    """K2's f32 tile plan at each ResNet-50 and classifier_train conv shape:
    tile, chunk, shared memory, blocks an SM and grid size."""
    rows = []
    for (n, h, w, cin, cout, k), count in {**RESNET50_CONVS, **CLASSIFIER_TRAIN_CONVS}.items():
        p = fused_layer.tc_plan(n, h, w, cin, cout, k, k, 4)
        tiles = (math.ceil(n * h * w / p.bm) if p.flat
                 else math.ceil(n / p.ti) * math.ceil(h / p.th) * math.ceil(w / p.tw))
        rows.append({"shape_nhwc_cin_cout_k": [n, h, w, cin, cout, k], "count": count,
                     "bn": p.bn, "tile": "flat" if p.flat else [p.ti, p.th, p.tw],
                     "ck": p.ck, "tg": p.tg, "smem_bytes": p.smem_bytes,
                     "blocks_per_sm": min(fused_layer.blocks_per_sm(p.smem_bytes),
                                          fused_layer.F32_TC_BLOCKS[p.bn]),
                     "blocks": tiles * math.ceil(cout / p.bn)})
    return rows


def _tc_kernel_stats(log, kernels=TC_KERNELS):
    """Registers and spills of each tensor-core kernel per template argument
    (head dim, or BN and EXT_ACT as ``(bn, ext_act)``), from ptxas's -v log:
    {kernel: {arg: {...}}}; the dynamic shared memory from
    ``kernels[name](head dim or bn)``."""
    stats, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry" in ln or "Function properties" in ln:
            m = re.search("(" + "|".join(kernels) + r")ILi(\d+)E(?:Lb([01])E)?", ln)
            key = None if m is None else (m.group(1), int(m.group(2)) if m.group(3) is None
                                          else (int(m.group(2)), m.group(3) == "1"))
        elif key is not None and "spill" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln).groups()
            stats.setdefault(key[0], {}).setdefault(key[1], {}).update(
                spill_store_bytes=int(st), spill_load_bytes=int(ld))
        elif key is not None and "registers" in ln:
            smem = re.search(r"(\d+) bytes smem", ln)
            stats.setdefault(key[0], {}).setdefault(key[1], {}).update(
                registers=int(re.search(r"Used (\d+) registers", ln).group(1)),
                static_smem_bytes=int(smem.group(1)) if smem else 0,
                dynamic_smem_bytes=kernels[key[0]](
                    key[1][0] if isinstance(key[1], tuple) else key[1]))
    return stats


def _hmma_counts(path, kind="", op="HMMA"):
    """HMMA (tensor-core) instructions per kernel in a library's SASS, for
    every kernel it holds (0 where there is none); with ``kind`` (as "TF32")
    only the HMMA instructions whose line names it; ``op`` "IMMA" counts the
    integer ones instead."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, fn = collections.Counter(), None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            counts[fn] += 0
        elif op in ln and kind in ln:
            counts[fn] += 1
    return counts


#: K1's two instantiations, by the template argument in their mangled names
K1_KERNEL = "fused_augment_normalize_kernel"
K1_DTYPES = {"If": "float32", "I13__nv_bfloat16": "bfloat16"}


def _k1_kernel_stats(log):
    """Registers, stack frame and spills of K1's float32 and bfloat16
    instantiations, from ptxas's -v log: {dtype: {...}}."""
    stats, key = {}, None
    pat = re.compile(K1_KERNEL + r"(If|I13__nv_bfloat16)E")
    for ln in log.splitlines():
        if "Compiling entry" in ln or "Function properties" in ln:
            m = pat.search(ln)
            key = K1_DTYPES[m.group(1)] if m else None
        elif key is not None and "spill" in ln:
            fr, st, ld = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                   r"(\d+) bytes spill loads", ln).groups()
            stats.setdefault(key, {}).update(stack_frame_bytes=int(fr),
                                             spill_store_bytes=int(st),
                                             spill_load_bytes=int(ld))
        elif key is not None and "registers" in ln:
            stats.setdefault(key, {})["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return stats


#: int8_conv's instantiations. The tensor-core route (groups 1): channel
#: block BN, A by 16-byte copies or byte by byte, output type; the dp4a
#: route (grouped convs): load width, output tile, output type
INT8_TC_KERNEL = "int8_conv_tc_kernel"
INT8_KERNEL = "int8_conv_kernel"
INT8_OUT_TYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
INT8_A_LOADS = {"1": "vec16", "0": "bytes"}
INT8_TC_INSTANTIATIONS = len(INT8_TC_BN) * len(INT8_A_LOADS) * len(INT8_OUT_TYPES)
INT8_INSTANTIATIONS = (3 * 3 - 1) * len(INT8_OUT_TYPES)     # no 16-byte loads at 1 channel
INT8_PATTERNS = {
    "tensor_core": re.compile(INT8_TC_KERNEL + r"ILi(\d+)ELb([01])E(f|13__nv_bfloat16)E"),
    "dp4a": re.compile(INT8_KERNEL + r"ILi(\d+)ELi(\d+)E(f|13__nv_bfloat16)E")}


def _int8_key(name):
    """(route, instantiation key) of a mangled int8_conv kernel name, or
    None: "bn128_vec16_float32" (tensor cores), "vec16_oct8_bfloat16" (dp4a)."""
    for route, pat in INT8_PATTERNS.items():
        m = pat.search(name)
        if m and route == "tensor_core":
            return route, f"bn{m.group(1)}_{INT8_A_LOADS[m.group(2)]}_{INT8_OUT_TYPES[m.group(3)]}"
        if m:
            return route, f"vec{m.group(1)}_oct{m.group(2)}_{INT8_OUT_TYPES[m.group(3)]}"
    return None


def _int8_kernel_stats(log, path):
    """Registers, shared memory and spills of each int8_conv instantiation,
    from ptxas's -v log, by route; the tensor-core ones also with their
    dynamic shared memory (the launcher's) and the IMMA instructions in
    their SASS: {"tensor_core": {"bn128_vec16_float32": {...}}, "dp4a":
    {"vec16_oct8_bfloat16": {...}}}."""
    stats, key = {route: {} for route in INT8_PATTERNS}, None
    for ln in log.splitlines():
        if "Compiling entry" in ln or "Function properties" in ln:
            key = _int8_key(ln)
        elif key is not None and "spill" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln).groups()
            stats[key[0]].setdefault(key[1], {}).update(spill_store_bytes=int(st),
                                                         spill_load_bytes=int(ld))
        elif key is not None and "registers" in ln:
            smem = re.search(r"(\d+) bytes smem", ln)
            stats[key[0]].setdefault(key[1], {}).update(
                registers=int(re.search(r"Used (\d+) registers", ln).group(1)),
                static_smem_bytes=int(smem.group(1)) if smem else 0)
    for fn, n in _hmma_counts(path, op="IMMA").items():
        key = _int8_key(fn)
        if key is not None and key[0] == "tensor_core":
            st = stats["tensor_core"].setdefault(key[1], {})
            st["imma"] = n
            st["dynamic_smem_bytes"] = tc_smem_bytes(int(key[1][2:key[1].index("_")]))
    return stats


def phase_build(libraries=KERNEL_LIBRARIES, host_libraries=HOST_LIBRARIES):
    """Every kernel library built at once (one nvcc each), beside the host
    runtime's libraries (one g++ each), then loaded."""
    t0 = time.perf_counter()
    results, errors = {}, []

    def build(name, build_fn):
        try:
            results[name] = build_fn(name)
        except Exception as e:  # re-raised below, after every build ended
            errors.append(f"{name}: {e}")

    threads = [threading.Thread(target=build, args=(n, _build.build)) for n in libraries]
    threads += [threading.Thread(target=build, args=(n, _build.build_host))
                for n in host_libraries]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("kernel build failed: " + "\n".join(errors))
    wall = time.perf_counter() - t0
    for name in host_libraries:
        path, _, seconds = results[name]
        _build.load_host(name)
        emit({"phase": "build", "host_library": name, "cxx_s": round(seconds, 3),
              "wall_s": round(wall, 3), "library": str(path.relative_to(REPO)),
              "flags": " ".join(_build.CXX_FLAGS)})
    for name in libraries:
        path, log, seconds = results[name]
        _build.load(name)
        entries, ptxas = None, []
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                entries = ln.split("'")[1] if "'" in ln else ln
            elif "registers" in ln or "spill" in ln:
                ptxas.append(f"{entries}: {ln.strip()}" if "registers" in ln else ln.strip())
        row = {"phase": "build", "kernel": name, "nvcc_s": round(seconds, 3),
               "wall_s": round(wall, 3), "library": str(path.relative_to(REPO)),
               "ptxas": ptxas}
        if name == "fused_augment":
            # both instantiations, neither spilling (log is empty only when
            # the library was built before this run)
            row["kernel_stats"] = k1 = _k1_kernel_stats(log)
            spills = {d: st for d, st in k1.items()
                      if st.get("spill_store_bytes") or st.get("spill_load_bytes")}
            if (log and set(k1) != set(K1_DTYPES.values())) or spills:
                raise AssertionError(f"K1 ptxas stats {k1}: an instantiation is missing or "
                                     f"spills ({spills})")
        if name == "flash_attention":
            tc = _tc_kernel_stats(log)
            hmma, tf32 = _hmma_counts(path), _hmma_counts(path, "TF32")

            def count(counts, kern, dh):
                return sum(n for f, n in counts.items() if f"{kern}ILi{dh}E" in f)
            row["tensor_core_kernels"] = {
                kern: {str(dh): {**(tc.get(kern, {}).get(dh) or {}),
                                 "hmma": count(hmma, kern, dh),
                                 "hmma_tf32": count(tf32, kern, dh)}
                       for dh in FLASH_HEAD_DIMS}
                for kern in TC_KERNELS}
            row["hmma"] = {"total": sum(hmma.values()), "tf32": sum(tf32.values()),
                           "by_kernel": {f: n for f, n in hmma.items() if n}}
            # every flash kernel is a tensor-core one: no CUDA-core kernel
            # is compiled in either dtype (K3, K4, K5 in f32 by 3xTF32)
            cuda_core = [f for f in hmma if any(f"{old}I" in f for old in OLD_FLASH_KERNELS)]
            # log is empty only when the library was built before this run;
            # each instantiation has HMMA, TF32 ones in the f32 kernels
            missing = [(kern, dh) for kern in TC_KERNELS for dh in FLASH_HEAD_DIMS
                       if (log and dh not in tc.get(kern, {}))
                       or not count(hmma, kern, dh)
                       or (kern in F32_FLASH_KERNELS) != bool(count(tf32, kern, dh))]
            spills = {(kern, dh): st for kern in F32_FLASH_KERNELS[1:]
                      for dh, st in tc.get(kern, {}).items()
                      if dh in F32_BWD_NO_SPILL_DIMS
                      and (st.get("spill_store_bytes") or st.get("spill_load_bytes"))}
            if missing or cuda_core or spills:
                raise AssertionError(f"tensor-core kernels {missing} lack ptxas stats or (TF32) "
                                     f"HMMA ({dict(hmma)}); CUDA-core kernels that must not "
                                     f"be compiled: {cuda_core}; f32 backward spills {spills}")
        if name == "int8_conv":
            # every instantiation of both routes, none spilling (log is empty
            # only when the library was built before); IMMA in every
            # tensor-core one
            row["kernel_stats"] = st = _int8_kernel_stats(log, path)
            spills = {(r, k): v for r, by in st.items() for k, v in by.items()
                      if v.get("spill_store_bytes") or v.get("spill_load_bytes")}
            no_imma = [k for k, v in st["tensor_core"].items() if not v.get("imma")]
            counts = {r: len(by) for r, by in st.items()}
            want = {"tensor_core": INT8_TC_INSTANTIATIONS, "dp4a": INT8_INSTANTIATIONS}
            row["imma"] = {k: v.get("imma", 0) for k, v in st["tensor_core"].items()}
            if (log and counts != want) or len(st["tensor_core"]) != want["tensor_core"] \
                    or spills or no_imma:
                raise AssertionError(f"int8_conv ptxas stats {st}: instantiations {counts} "
                                     f"(expected {want}), spills {spills}, tensor-core "
                                     f"instantiations without IMMA {no_imma}")
        if name == "fused_conv2d_bias_act":
            tc = _tc_kernel_stats(log, {K2_TC_KERNEL: _k2_tc_smem,
                                        K2_F32_KERNEL: lambda bn: _k2_tc_smem(bn, 4)})
            hmma = _hmma_counts(path)
            kinds = {"bf16": _hmma_counts(path, "BF16"), "tf32": _hmma_counts(path, "TF32")}

            # each BN twice: EXT_ACT false (none, relu, leaky_relu) and true
            # (relu6, hard_swish, silu), keyed "64" and "64+ext_act"
            variants = ((False, ""), (True, "+ext_act"))

            def count(counts, kern, bn, ext):
                return sum(n for f, n in counts.items() if f"{kern}ILi{bn}ELb{int(ext)}E" in f)
            routes = ((K2_TC_KERNEL, fused_layer.TC_BN, "bf16"),
                      (K2_F32_KERNEL, fused_layer.F32_TC_BN, "tf32"))
            for kern, widths, kind in routes:
                row[kern] = {f"{bn}{tag}": {**(tc.get(kern, {}).get((bn, ext)) or {}),
                                            "hmma": count(hmma, kern, bn, ext),
                                            f"hmma_{kind}": count(kinds[kind], kern, bn, ext)}
                             for bn in widths for ext, tag in variants}
            row["hmma"] = {"total": sum(hmma.values()),
                           **{k: sum(c.values()) for k, c in kinds.items()},
                           "by_kernel": {f: n for f, n in hmma.items() if n}}
            row["f32_plans"] = _k2_f32_plans()
            # both dtypes run on the tensor cores only: no CUDA-core K2 is
            # compiled; every bf16 instantiation has bf16 HMMA and every f32
            # one TF32 HMMA and no other; no f32 one spills (log is empty
            # only when the library was built before this run)
            cuda_core = [f for f in hmma if f"{OLD_K2_KERNEL}I" in f]
            missing = [(kern, bn, ext) for kern, widths, kind in routes for bn in widths
                       for ext, _ in variants
                       if (log and (bn, ext) not in tc.get(kern, {}))
                       or not count(kinds[kind], kern, bn, ext)
                       or count(kinds[kind], kern, bn, ext) != count(hmma, kern, bn, ext)]
            spills = {arg: st for arg, st in tc.get(K2_F32_KERNEL, {}).items()
                      if st.get("spill_store_bytes") or st.get("spill_load_bytes")}
            if missing or cuda_core or spills:
                raise AssertionError(f"K2 tensor-core kernels {missing} lack ptxas stats or "
                                     f"their HMMA kind ({dict(hmma)}); CUDA-core K2 kernels "
                                     f"{cuda_core}; f32 spills {spills}")
        emit(row)


def _case_tensors(gen, n, h, w, cin, cout, k, dtype):
    x = torch.randn((n, cin, h, w), generator=gen, device=DEVICE)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    wt = (torch.randn((cout, cin, k, k), generator=gen, device=DEVICE)
          / float(cin * k * k) ** 0.5).to(dtype)
    b = (0.1 * torch.randn((cout,), generator=gen, device=DEVICE)).to(dtype)
    return x, wt, b


#: the epilogue activations with corners outside a unit-scale output (relu6
#: at 0 and 6, hard_swish at -3 and 3): their checks scale x by
#: CORNER_SCALE, so that conv outputs (std about 1 from _case_tensors) reach
#: both corners, and :func:`_reach_corners` asserts that they did
CORNER_ACTS = ("relu6", "hard_swish")
CORNER_SCALE = 4.0


def _corner_input(x, act):
    """``x`` as the check of ``act`` takes it: scaled for CORNER_ACTS."""
    if act not in CORNER_ACTS:
        return x
    return (x * CORNER_SCALE).contiguous(memory_format=torch.channels_last)


def _reach_corners(x, wt, b, act, ref, what):
    """Raises unless the plain output ``ref`` of a CORNER_ACTS activation
    took both its corners: relu6 both 0 and 6, hard_swish pre-activations
    both below -3 and above 3 (so a kernel without a clamp disagrees)."""
    if act == "relu6":
        reached = bool((ref >= 6).any()) and bool((ref == 0).any())
    elif act == "hard_swish":
        pre = plain_conv2d_bias_act(x, wt, b, None)
        reached = bool((pre > 3).any()) and bool((pre < -3).any())
        del pre
    else:
        return
    if not reached:
        raise AssertionError(f"{what}: the check of {act} does not reach both its corners")


def _rel_err(got, ref):
    g, r = got.float(), ref.float()
    err = (g - r).abs().max().item()
    return err / max(r.abs().max().item(), 1e-30), err


def _library_call(x, w, b, act):
    """``F.conv2d`` (with its bias) and the activation as its own kernel."""
    k = w.shape[-1]
    fn = port_nn.ACTIVATION_FNS[act] if act else None

    def call():
        y = F.conv2d(x, w, b, padding=k // 2)
        return fn(y) if fn is not None else y
    return call


def phase_kernel(card):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(shape, ("float32", "bfloat16")) for shape in PHASE2_SHAPES] + \
        [(shape, ("bfloat16",)) for shape in CLASSIFIER_CONVS] + DENSE_KERNEL_CASES \
        + DETECT_KERNEL_CASES
    rows = {}
    for (n, h, w, cin, cout, k), dtypes in cases:
        for dtype in dtypes:
            tol = F32_TOL if dtype == "float32" else BF16_TOL
            x, wt, b = _case_tensors(gen, n, h, w, cin, cout, k,
                                     getattr(torch, dtype))
            errs = {}
            for bias in (False, True):
                for act in fused_layer.EPILOGUE_ACTS:
                    bb = b if bias else None
                    xa = _corner_input(x, act)
                    got = fused_conv2d_bias_act(xa, wt, bb, act)
                    ref = plain_conv2d_bias_act(xa, wt, bb, act)
                    torch.cuda.synchronize()
                    _reach_corners(xa, wt, bb, act, ref,
                                   f"kernel {dtype} {(n, h, w, cin, cout, k)} bias={bias}")
                    rel, _ = _rel_err(got, ref)
                    errs[f"{'bias' if bias else 'nobias'}_{act or 'none'}"] = rel
                    if not rel <= tol:
                        raise AssertionError(
                            f"kernel vs plain {dtype} {(n, h, w, cin, cout, k)} "
                            f"bias={bias} act={act}: rel err {rel:.3e} > {tol:.0e}")
            worst[dtype] = max(worst[dtype], max(errs.values()))
            row = {"phase": "kernel", "shape_nhwc_cin_cout_k": [n, h, w, cin, cout, k],
                   "dtype": dtype, "rel_err": errs, "tol": tol,
                   "ms": cuda_ms(lambda: fused_conv2d_bias_act(x, wt, b, "relu")),
                   "plain_ms": cuda_ms(lambda: plain_conv2d_bias_act(x, wt, b, "relu")),
                   "library_ms": cuda_ms(_library_call(x, wt, b, "relu")),
                   **k2_bounds(n, h, w, cin, cout, k, dtype, True), "card": card}
            emit(row)
            rows[((n, h, w, cin, cout, k), dtype)] = row
            del x, wt, b
    torch.cuda.empty_cache()
    emit({"phase": "kernel_summary", "max_rel_err": worst,
          "tol": {"float32": F32_TOL, "bfloat16": BF16_TOL}, "card": card})
    rows["forward_bf16"] = phase_kernel_forward(card, "bfloat16")
    rows["forward_f32"] = phase_kernel_forward(card, "float32")
    return rows


def _with_act(convs, act, bias=True):
    """A shape table as (N, H, W, Cin, Cout, k, act, bias) -> count."""
    return {(*shape, act, bias): count for shape, count in convs.items()}


def model_convs(hp, batch, image_shape=IMAGE_SHAPE):
    """K2's convs in one forward of the model of ``hp`` at ``image_shape``
    (224x224 by default) and ``batch``: :func:`module_convs` of the
    DeepcvModule on the meta device."""
    return module_convs(DeepcvModule(image_shape, hp, device="meta"), batch, image_shape)


def module_convs(model, batch, image_shape):
    """K2's convs in one forward of ``model`` (built on the meta device) at
    ``batch``, as (N, H, W, Cin, Cout, k, act, bias) -> count: read from
    the model's own FusedConv2d calls in a forward on the meta device. ``act``
    is the kernel's epilogue (None where the activation, such as a sigmoid,
    runs after the kernel)."""
    seen = collections.Counter()

    def hook(mod, args):
        n, cin, h, w = args[0].shape
        cout, _, k, _ = mod.weight.shape
        act = mod.act if isinstance(mod.act, str) else None
        seen[(n, h, w, cin, cout, k, act, mod.bias is not None)] += 1

    for m in model.modules():
        if isinstance(m, FusedConv2d):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        model.eval()(torch.empty((batch, *image_shape), device="meta"))
    return dict(seen)


def conf_hp(key):
    """The entry ``key`` of the conf's ``parameters.yml``."""
    return load_yaml(REPO / "conf" / "base" / "parameters.yml")[key]


def _creator_datasets(image_shape):
    """The ``datasets['trainset']`` view the creators read: the image shape
    and the detection targets' last axis (5 + 3 classes a cell)."""
    targets = np.zeros((1, 5 + len(det_pipeline.SHAPE_CLASSES)), np.float32)
    return {"trainset": types.SimpleNamespace(
        image_shape=image_shape, dataset=types.SimpleNamespace(targets=targets))}


def detector_convs(create, hp, batch, size):
    """K2's convs in one forward of the detector ``create`` (the pipeline's
    ``create_detector`` or ``create_fpn_detector``) makes of ``hp`` at
    ``size`` x ``size`` and ``batch``."""
    shape = (size, size, 3)
    return module_convs(create(_creator_datasets(shape), hp, device="meta"), batch, shape)


def autoencoder_convs():
    """K2's convs in one forward of the conf's keypoint autoencoder as
    keypoints_train runs it (CIFAR-10's 32x32, its batch 32)."""
    shape = (32, 32, 3)
    model = kp_pipeline.create_autoencoder(_creator_datasets(shape),
                                           conf_hp("keypoints_encoder_model"),
                                           conf_hp("keypoints_decoder_model"), device="meta")
    return module_convs(model, KEYPOINT_BATCH, shape)


def unet_segmenter_hp():
    """unet_spec() with create_segmenter's 4-class head at UNET_SIZE."""
    return append_dense_head(unet_spec(), "seg_head", len(seg_pipeline.SEG_CLASSES),
                             (UNET_SIZE, UNET_SIZE))


def forward_convs(dtype):
    """The per-forward conv sets of K2's route ``dtype``, each read from its
    model where the model is built from a spec: bf16 as augment_train runs
    image_classifier (batch 4096), ResNet-50 at the serving batch, the wide
    classifiers as wide_train runs them (batch 1024), MobileNetV2,
    MobileNetV3-Large and DenseNet-121 at the conf's batch 256 (their own
    activations, no bias), the U-Net segmenter as unet_train runs it (batch
    32, 256x256: 18 convs with relu and no bias, the head with bias),
    config 12's FPN detector as fpn_train runs it (batch 512, 64x64: its
    four backbone convs with relu and bias), the conf's keypoint
    autoencoder as keypoints_train runs it (batch 32, 32x32) and its
    encoder as keypoints_match runs it (batch 64, 64x64); f32 as ResNet-50
    serving and classifier_train (batch 32) run them, the conf's two
    detectors as detect_train runs them (batch 64, 32x32) and the conf's
    autoencoder in its own float32 as keypoints_train's float32 row runs it
    (batch 32, 32x32)."""
    if dtype == "float32":
        return (("resnet_spec(50)", _with_act(RESNET50_CONVS, "relu")),
                ("image_classifier", _with_act(CLASSIFIER_TRAIN_CONVS, "relu")),
                ("object_detector", detector_convs(
                    det_pipeline.create_detector, conf_hp("object_detector_model"),
                    DETECT_BATCH, DETECT_SIZE)),
                ("fpn_detector_conf", detector_convs(
                    det_pipeline.create_fpn_detector, conf_hp("fpn_detector_model"),
                    DETECT_BATCH, DETECT_SIZE)),
                ("keypoint_autoencoder", autoencoder_convs()))
    return (("image_classifier", _with_act(CLASSIFIER_CONVS, "relu")),
            ("resnet_spec(50)", _with_act(RESNET50_CONVS, "relu")),
            ("wide_classifier", _with_act(WIDE_CONVS, "leaky_relu")),
            *((name, model_convs(spec(), TRAIN_BATCH)) for name, spec in ZOO_FORWARDS),
            ("unet", model_convs(unet_segmenter_hp(), UNET_BATCH,
                                 (UNET_SIZE, UNET_SIZE, 3))),
            ("fpn_detector", detector_convs(det_pipeline.create_fpn_detector, FPN_BACKBONE,
                                            FPN_BATCH, FPN_SIZE)),
            ("keypoint_autoencoder", autoencoder_convs()),
            ("keypoint_encoder", model_convs(conf_hp("keypoints_encoder_model"), MATCH_PAIRS,
                                             (MATCH_SIZE, MATCH_SIZE, 3))))


def phase_kernel_forward(card, dtype):
    """K2 per model forward in ``dtype``: each conv of the models of
    :func:`forward_convs` checked against the plain
    version (with the model's bias and activation; x scaled for
    CORNER_ACTS) and timed by CUDA events, then the kernel's, the plain
    version's, ``F.conv2d``'s (with its activation as a kernel of its own)
    and the bound's times summed over one forward by how often each conv
    runs. The kernel takes its packed weight, as ``FusedConv2d`` passes it.
    ``forward_ms`` and ``forward_library_ms``, each set's per-forward
    times, time a whole forward's calls in order by CUDA events (no
    profiler window: one of five MobileNetV2 forwards lost 8 of its 170
    launches every time); ``library_kernels`` are cuDNN's and cuBLAS's
    device kernels by name."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    out = {}
    for model, convs in forward_convs(dtype):
        tot, max_abs, shapes = collections.Counter(), 0.0, []
        kern_calls, lib_calls = [], []
        for (n, h, w, cin, cout, k, act, bias), count in convs.items():
            x, wt, b = _case_tensors(gen, n, h, w, cin, cout, k, getattr(torch, dtype))
            x, b = _corner_input(x, act), b if bias else None
            wp = fused_layer.pack_weight(wt)
            got = fused_conv2d_bias_act(x, wt, b, act, w_packed=wp)
            ref = plain_conv2d_bias_act(x, wt, b, act)
            _reach_corners(x, wt, b, act, ref, f"{model} {dtype} conv {(n, h, w, cin, cout, k)}")
            rel, err = _rel_err(got, ref)
            if not rel <= tol:
                raise AssertionError(f"{model} {dtype} conv {(n, h, w, cin, cout, k, act)}: "
                                     f"rel err {rel:.3e} > {tol:.0e}")
            max_abs = max(max_abs, err)
            del got, ref
            bounds = k2_bounds(n, h, w, cin, cout, k, dtype, bias)
            kern = functools.partial(fused_conv2d_bias_act, x, wt, b, act, w_packed=wp)
            lib = _library_call(x, wt, b, act)
            kern_calls += [kern] * count
            lib_calls += [lib] * count
            t = {"ms": cuda_ms(kern),
                 "plain_ms": cuda_ms(lambda: plain_conv2d_bias_act(x, wt, b, act)),
                 "library_ms": cuda_ms(lib),
                 **{key: v for key, v in bounds.items() if key != "bound_by"}}
            for key, v in t.items():
                tot[key] += count * v
            tot[bounds["bound_by"]] += count * bounds["bound_ms"]
            shapes.append({"shape_nhwc_cin_cout_k": [n, h, w, cin, cout, k], "act": act,
                           "bias": bias, "count": count, "rel_err": rel, **t,
                           "bound_by": bounds["bound_by"]})
        # a whole forward's calls in order, back to back: the host enqueues
        # ahead of the card, so CUDA events around it read device time
        forward = {"forward_ms": cuda_ms(_in_order(kern_calls)),
                   "forward_library_ms": cuda_ms(_in_order(lib_calls))}
        library_kernels = sorted(_device_kernels(_in_order(lib_calls)))
        del kern_calls, lib_calls
        torch.cuda.empty_cache()
        per = {key: tot[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                         "cuda_core_bound_ms")
               if key in tot}
        per.update(forward)
        per["bound_by"] = "operations" if tot["operations"] >= tot["bytes"] else "bytes"
        ratios = {"ms_over_library": per["ms"] / per["library_ms"],
                  "forward_ms_over_library": per["forward_ms"] / per["forward_library_ms"]}
        acts = collections.Counter()
        for (*_, act, _bias), count in convs.items():
            acts[act or "none"] += count
        out[model] = {**per, "max_abs_err": max_abs}
        emit({"phase": f"kernel_forward_{'f32' if dtype == 'float32' else 'bf16'}",
              "model": model, "launches_by_act": dict(acts), "batch": next(iter(convs))[0],
              "convs": sum(convs.values()), "distinct_convs": len(convs),
              "per_forward": per, **ratios,
              "library_kernels": library_kernels, "shapes": shapes, "card": card})
    return out


def _in_order(calls):
    """One call that makes ``calls`` in order (a forward's convs)."""
    def run():
        for fn in calls:
            fn()
    return run


def phase_resnet50_predictor(card):
    """The ResNet-50 predictor's forward at batch 64 in float32 (random
    weights from the seed; steady state, as ``serve_predictor_benchmark``),
    for ``--k2-forward``: its 46 convs run K2's f32 route."""
    model = DeepcvModule(IMAGE_SHAPE, resnet_spec(50), device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED)).eval()
    pred = Predictor(model, batch_size=SERVE_BATCH, preprocess=_preprocess,
                     dtype=torch.float32, device=DEVICE)
    bench = pred.benchmark(batch=SERVE_BATCH, n_iters=10)
    emit({"phase": "resnet50_predictor_forward", "batch": SERVE_BATCH,
          "latency_ms": bench["latency_ms"], "img_per_s": bench["img_per_s"], "card": card})
    del model, pred
    torch.cuda.empty_cache()


def _preprocess(x):
    return normalize(to_tensor(x), IMAGENET_MEAN, IMAGENET_STD)


def _main_path_kernels(model, card):
    """The kernel's calls in one forward of ``model`` at the serving batch:
    each distinct (input shape, weight, bias, act) checked against the plain
    version and timed (CUDA events, and the profiler's device time, which
    host gaps do not reach); per-forward sums weighted by how often it
    occurs."""
    seen = collections.OrderedDict()

    def hook(mod, args):
        key = (tuple(args[0].shape), id(mod))
        seen[key] = mod

    convs = [m for m in model.modules() if isinstance(m, FusedConv2d)]
    handles = [m.register_forward_pre_hook(hook) for m in convs]
    try:
        x = torch.zeros((SERVE_BATCH, *model.input_shape), device=DEVICE)
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
    finally:
        for hnd in handles:
            hnd.remove()
    if len(seen) != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"{len(seen)} kernel convs per forward, expected "
                             f"{LAUNCHES_PER_FORWARD}")
    sigs = collections.Counter()
    first = {}
    for (shape, _), mod in seen.items():
        sig = (shape, tuple(mod.weight.shape), mod.bias is not None, mod.act)
        sigs[sig] += 1
        first.setdefault(sig, mod)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    tot = collections.Counter()
    max_abs = 0.0
    rows = []
    with torch.inference_mode():
        for sig, count in sigs.items():
            (n, cin, h, w), (cout, _, k, _), has_b, act = sig
            mod = first[sig]
            x = torch.randn((n, cin, h, w), generator=gen, device=DEVICE)
            x = x.contiguous(memory_format=torch.channels_last)
            wt, b = mod.weight, mod.bias
            got = fused_conv2d_bias_act(x, wt, b, act)
            ref = plain_conv2d_bias_act(x, wt, b, act)
            rel, err = _rel_err(got, ref)
            if not rel <= F32_TOL:
                raise AssertionError(f"main-path conv {sig}: rel err {rel:.3e}")
            max_abs = max(max_abs, err)
            kern = lambda: fused_conv2d_bias_act(x, wt, b, act)  # noqa: E731
            lib = _library_call(x, wt, b, act)
            device, how = device_ms_or_events(kern, None)
            library_device, library_how = device_ms_or_events(lib, None)
            t = {"ms": cuda_ms(kern), "device_ms": device,
                 "plain_ms": cuda_ms(lambda: plain_conv2d_bias_act(x, wt, b, act)),
                 "library_ms": cuda_ms(lib), "library_device_ms": library_device}
            bounds = k2_bounds(n, h, w, cin, cout, k, "float32", has_b)
            for key, v in (*t.items(), ("bound_ms", bounds["bound_ms"]),
                           ("cuda_core_bound_ms", bounds["cuda_core_bound_ms"])):
                tot[key] += count * v
            tot[bounds["bound_by"]] += count * bounds["bound_ms"]
            for key, h_ in (("device_ms_by", how), ("library_device_ms_by", library_how)):
                if h_ == BY_EVENTS:
                    tot[f"{key}_{BY_EVENTS}"] += 1
            rows.append({"shape_nhwc_cin_cout_k": [n, h, w, cin, cout, k],
                         "act": act, "count": count, "rel_err": rel, **t,
                         "device_ms_by": how, "library_device_ms_by": library_how, **bounds})
    emit({"phase": "main_path_kernels", "dtype": "float32", "batch": SERVE_BATCH,
          "signatures": rows, "per_forward": dict(tot), "card": card})
    return tot, max_abs


def _post_npy(host, port, arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/predict", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        body = resp.read()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"/predict answered {resp.status}: {body[:300]!r}")
    return np.load(io.BytesIO(body), allow_pickle=False), ms


def _get_json(host, port, path):
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"GET {path} answered {resp.status}")
    return json.loads(body)


def _bundle_models(spec, label):
    """Random seeded weights through a saved and loaded bundle: the model on
    the card and the same bundle on the CPU."""
    t0 = time.perf_counter()
    model = DeepcvModule(IMAGE_SHAPE, spec, device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        save_model_bundle(d, model)
        gpu_model = load_model_bundle(d, device=DEVICE)
        cpu_model = load_model_bundle(d, device="cpu")
    del model
    emit({"phase": "model", "spec": label, "input_shape": list(IMAGE_SHAPE),
          "params": gpu_model.capacity(), "device": str(gpu_model.device),
          "build_save_load_s": round(time.perf_counter() - t0, 3)})
    return gpu_model, cpu_model


def _serve_over_http(phase, gpu_model, cpu_model, counter, per_forward, card):
    """The main serving path: Predictor at batch 64 behind the HTTP server,
    four client threads; ``counter`` (a kernel wrapper) is set to 0 just
    before and read just after, and must show ``per_forward`` launches per
    forward. Every answer is held against the port's CPU path."""
    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 256, (n, *IMAGE_SHAPE), dtype=np.uint8)
              for n in REQUEST_SIZES]
    pred = Predictor(gpu_model, batch_size=SERVE_BATCH, preprocess=_preprocess,
                     dtype=torch.float32, device=DEVICE)
    server = InferenceServer(pred, port=0, max_batch=SERVE_BATCH, max_wait_ms=5.0,
                             input_shape=IMAGE_SHAPE)
    answers = {i: [] for i in range(len(images))}
    latencies, failures = [], []

    def client(i):
        try:
            for _ in range(ROUNDS):
                y, ms = _post_npy(server.host, server.port, images[i])
                answers[i].append(y)
                latencies.append(ms)
        except Exception as e:  # reported and re-raised by the main thread
            failures.append(f"client {i}: {e!r}")

    # the main path: counts read from zero, right around it
    counter.launches = 0
    pred.forwards = 0
    try:
        server.start_background()
        server.warmup()
        health = _get_json(server.host, server.port, "/healthz")
        threads = [threading.Thread(target=client, args=(i,), name=f"client{i}")
                   for i in range(len(images))]
        t_req = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HANG_LIMIT_S / 2)
        wall = time.perf_counter() - t_req
        stats = _get_json(server.host, server.port, "/stats")
    finally:
        server.close()
    launches, forwards = counter.launches, pred.forwards
    if any(t.is_alive() for t in threads) or failures:
        raise RuntimeError(f"requests failed: {failures or 'client thread hung'}")
    if not health.get("ok") or not health.get("ready"):
        raise AssertionError(f"/healthz: {health}")
    if launches != per_forward * forwards or forwards == 0:
        raise AssertionError(f"{launches} kernel launches for {forwards} forwards; "
                             f"expected {per_forward} per forward")

    cpu_pred = Predictor(cpu_model, batch_size=SERVE_BATCH, preprocess=_preprocess,
                         dtype=torch.float32, device="cpu")
    ref_all = cpu_pred(np.concatenate(images))
    # how far the argmax check is from a tie: top-2 gap over the logits' range
    top2 = np.sort(ref_all, axis=-1)[:, -2:]
    margin = float(((top2[:, 1] - top2[:, 0]) / np.ptp(ref_all, axis=-1)).min())
    worst_l2, off = 0.0, 0
    for i, imgs in enumerate(images):
        ref = ref_all[off:off + len(imgs)]
        off += len(imgs)
        for y in answers[i]:
            if y.shape != ref.shape or not np.isfinite(y).all():
                raise AssertionError(f"answer shape {y.shape} / finite check failed")
            rel = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
            worst_l2 = max(worst_l2, rel)
            if not rel <= SERVE_REL_L2:
                raise AssertionError(f"request {i}: rel L2 {rel:.3e} vs CPU")
            if not (y.argmax(-1) == ref.argmax(-1)).all():
                raise AssertionError(f"request {i}: argmax differs from CPU")
    n_req = len(REQUEST_SIZES) * ROUNDS
    n_img = ROUNDS * sum(REQUEST_SIZES)
    emit({"phase": phase, "requests": n_req, "images": n_img,
          "batches": stats.get("batches"), "max_coalesced": stats.get("max_coalesced"),
          "forwards": forwards, "kernel_launches": launches,
          "launches_per_forward": launches / forwards,
          "p50_ms": statistics.median(latencies), "server_p50_ms": stats.get("latency_p50_ms"),
          "img_per_s": n_img / wall, "rel_l2_vs_cpu": worst_l2, "tol": SERVE_REL_L2,
          "min_top2_margin": margin,
          "card": card})
    bench = pred.benchmark(batch=SERVE_BATCH, n_iters=10)
    emit({"phase": f"{phase}_predictor_benchmark", **bench, "card": card})
    return launches


def phase_serve(card):
    """ResNet-50 over HTTP; returns K2's kernels-line entry and the served
    model on the card and on the CPU (``serve_extras`` reuses them)."""
    gpu_model, cpu_model = _bundle_models(resnet_spec(50), "resnet_spec(50)")
    kern_tot, max_abs = _main_path_kernels(gpu_model, card)
    fused_conv2d_bias_act.launches_by_dtype = dict.fromkeys(
        fused_conv2d_bias_act.launches_by_dtype, 0)
    launches = _serve_over_http("serve", gpu_model, cpu_model, fused_conv2d_bias_act,
                                LAUNCHES_PER_FORWARD, card)
    # both counts also take the predictor benchmark's forwards after the run
    if fused_conv2d_bias_act.launches_by_dtype != {"float32": fused_conv2d_bias_act.launches,
                                                   "bfloat16": 0}:
        raise AssertionError(f"serve (float32) launched K2 by dtype "
                             f"{fused_conv2d_bias_act.launches_by_dtype}")
    return {"name": "fused_conv2d_bias_act", "route": "cuda",
            "source": "deepcv_tpu_torch/csrc/fused_conv2d_bias_act.cu",
            "replaces": "deepcv_tpu/ops/pallas/fused_layer.py:92",
            "launches": launches, "max_abs_err": max_abs,
            "ms": kern_tot["ms"], "plain_ms": kern_tot["plain_ms"],
            "bound_ms": kern_tot["bound_ms"],
            "bound_by": "operations" if kern_tot["operations"] >= kern_tot["bytes"] else "bytes",
            "cuda_core_bound_ms": kern_tot["cuda_core_bound_ms"],
            "library_ms": kern_tot["library_ms"],
            "device_ms": kern_tot["device_ms"], "library_device_ms": kern_tot["library_device_ms"],
            # signatures whose device time fell back to CUDA events
            "device_ms_by_cuda_events": int(kern_tot[f"device_ms_by_{BY_EVENTS}"]),
            "library_device_ms_by_cuda_events": int(kern_tot[f"library_device_ms_by_{BY_EVENTS}"]),
            "per": f"one forward of resnet_spec(50) at batch {SERVE_BATCH}, float32",
            "card": card}, (gpu_model, cpu_model)


# --------------------------------------------------------------------------- #
# K3, K4, K5: flash attention
# --------------------------------------------------------------------------- #

#: FLOPs per (B, T^2, Dh): the TPU kernels' cost estimates
#: (deepcv_tpu/ops/attention.py:173-175, :315-317, :330-332)
FLASH_FLOPS = {"fwd": 4, "dq": 5, "dkv": 7}


def flash_bound(kind, b, t, dh, dtype, tf32x3=False):
    """Least time on an H100 SXM: FLOPs at the type's peak, or each input
    read once and each output written once at 3.35 TB/s. ``tf32x3``: the
    operations of the f32 routes of K3, K4 and K5, three TF32 products per
    f32 FLOP at the TF32 tensor-core peak. Returns (ms, bound_by)."""
    item = 4 if dtype == "float32" else 2
    rows = b * t * dh
    mats_in, mats_out, stats = {"fwd": (3, 1, 1), "dq": (4, 1, 2), "dkv": (4, 2, 2)}[kind]
    nbytes = item * rows * (mats_in + mats_out) + 4 * b * t * stats
    flops = FLASH_FLOPS[kind] * b * t * t * dh
    t_ops = 3 * flops / PEAK_FLOPS["tf32"] if tf32x3 else flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _flash_case(gen, n, h, t, dh, dtype):
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn((n, h, t, dh), generator=gen, device=DEVICE)
                   .to(dt) for _ in range(4))
    return q, k, v, do


def _device_kernels(fn) -> collections.Counter:
    """The device kernels one call of ``fn`` launches, by name, with how
    often each runs, from torch.profiler (names only: a one-call window can
    lose a launch)."""
    fn()
    torch.cuda.synchronize()
    return collections.Counter({e.key: e.count for e in _kernel_records(_profile_calls(fn, 1))})


def _library_fwd_bwd(q, k, v, do):
    qi, ki, vi = (x.detach().requires_grad_() for x in (q, k, v))

    def call():
        qi.grad = ki.grad = vi.grad = None
        F.scaled_dot_product_attention(qi, ki, vi).backward(do)
    return call


def phase_flash_kernels(card):
    """Each kernel against its plain version; times and bounds per launch.
    Returns the per-launch rows of the two main-path shapes."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    rows = {}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for label, n, h, t, dh, dtypes in FLASH_CASES:
        for dtype in dtypes:
            tol = F32_TOL if dtype == "float32" else BF16_TOL
            q, k, v, do = _flash_case(gen, n, h, t, dh, dtype)
            o, lse = flash_attention_fwd(q, k, v)
            o_ref, lse_ref = plain_flash_fwd(q, k, v)
            delta = (do.float() * o_ref.float()).sum(-1)
            dq = flash_attention_bwd_dq(q, k, v, do, lse_ref, delta)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse_ref, delta)
            refs = {"o": o_ref, "lse": lse_ref,
                    "dq": plain_flash_bwd_dq(q, k, v, do, lse_ref, delta)}
            refs["dk"], refs["dv"] = plain_flash_bwd_dkv(q, k, v, do, lse_ref, delta)
            torch.cuda.synchronize()
            errs, abs_errs = {}, {}
            for name, got in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
                rel, err = _rel_err(got, refs[name])
                errs[name], abs_errs[name] = rel, err
                lim = F32_TOL if name == "lse" else tol
                if not (torch.isfinite(got.float()).all() and rel <= lim):
                    raise AssertionError(f"flash {name} {label} {dtype}: rel err "
                                         f"{rel:.3e} > {lim:.0e}")
            worst[dtype] = max(worst[dtype], max(errs.values()))
            del o, lse, dq, dk, dv, refs
            times = {
                "fwd": (cuda_ms(lambda: flash_attention_fwd(q, k, v)),
                        cuda_ms(lambda: plain_flash_fwd(q, k, v))),
                "dq": (cuda_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse_ref, delta)),
                       cuda_ms(lambda: plain_flash_bwd_dq(q, k, v, do, lse_ref, delta))),
                "dkv": (cuda_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse_ref, delta)),
                        cuda_ms(lambda: plain_flash_bwd_dkv(q, k, v, do, lse_ref, delta))),
            }
            lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            lib_fwd_bwd = cuda_ms(_library_fwd_bwd(q, k, v, do))
            row = {"phase": "flash_kernels", "case": label,
                   "shape_n_h_t_dh": [n, h, t, dh], "dtype": dtype,
                   "rel_err": errs, "max_abs_err": abs_errs, "tol": tol,
                   "library_fwd_ms": lib_fwd, "library_fwd_bwd_ms": lib_fwd_bwd,
                   "library_fwd_kernels": sorted(_device_kernels(
                       lambda: F.scaled_dot_product_attention(q, k, v))),
                   # the backward alone: dQ, dK and dV in one call, K4's and
                   # K5's work together
                   "library_bwd_ms": lib_fwd_bwd - lib_fwd,
                   "card": card}
            for kind, (ms, plain_ms) in times.items():
                f32 = dtype == "float32"
                bound_ms, bound_by = flash_bound(kind, n * h, t, dh, dtype, tf32x3=f32)
                row[kind] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by}
                if f32:   # the same work's bound on the CUDA cores
                    row[kind]["cuda_core_bound_ms"] = flash_bound(kind, n * h, t, dh, dtype)[0]
            emit(row)
            rows[(label, dtype)] = row
            del q, k, v, do, lse_ref, delta
            torch.cuda.empty_cache()
    emit({"phase": "flash_summary", "max_rel_err": worst,
          "tol": {"float32": F32_TOL, "bfloat16": BF16_TOL}, "card": card})
    return rows


def phase_k3_forward_f32(card):
    """K3's float32 route per ViT-B/16 serving forward (12 launches at batch
    64), checked against the plain version and timed beside SDPA's f32
    forward (CUDA events and profiler device time), and the ViT-B/16 flash
    predictor's forward at batch 64 in float32 (random weights from the
    seed; steady state, as ``vit_serve_predictor_benchmark``)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    q, k, v, _ = _flash_case(gen, SERVE_BATCH, VIT_HEADS, VIT_T, VIT_DH, "float32")
    o, lse = flash_attention_fwd(q, k, v)
    o_ref, lse_ref = plain_flash_fwd(q, k, v)
    errs = {"o": _rel_err(o, o_ref)[0], "lse": _rel_err(lse, lse_ref)[0]}
    if not max(errs.values()) <= F32_TOL:
        raise AssertionError(f"K3 f32 at the serving shape: rel err {errs}")
    kern = lambda: flash_attention_fwd(q, k, v)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    per = {"ms": VIT_BLOCKS * cuda_ms(kern), "device_ms": VIT_BLOCKS * device_ms(kern, None),
           "library_ms": VIT_BLOCKS * cuda_ms(lib),
           "library_device_ms": VIT_BLOCKS * device_ms(lib, None)}
    del q, k, v, o, lse, o_ref, lse_ref
    model = DeepcvModule(IMAGE_SHAPE, vit_spec("b_16", attn_impl="flash"), device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED)).eval()
    pred = Predictor(model, batch_size=SERVE_BATCH, preprocess=_preprocess,
                     dtype=torch.float32, device=DEVICE)
    bench = pred.benchmark(batch=SERVE_BATCH, n_iters=10)
    emit({"phase": "k3_forward_f32", "shape_n_h_t_dh": [SERVE_BATCH, VIT_HEADS, VIT_T, VIT_DH],
          "launches_per_forward": VIT_BLOCKS, "rel_err": errs, "per_forward": per,
          "ms_over_library": per["ms"] / per["library_ms"],
          "vit_b16_predictor_forward_ms": bench["latency_ms"], "card": card})
    del model, pred
    torch.cuda.empty_cache()


def phase_vit_serve(card):
    gpu_model, cpu_model = _bundle_models(vit_spec("b_16", attn_impl="flash"),
                                          "vit_spec('b_16', attn_impl='flash')")
    flash_attention_fwd.launches_by_dtype = dict.fromkeys(
        flash_attention_fwd.launches_by_dtype, 0)
    launches = _serve_over_http("vit_serve", gpu_model, cpu_model, flash_attention_fwd,
                                VIT_BLOCKS, card)
    # both counts also take the predictor benchmark's forwards after the run
    if flash_attention_fwd.launches_by_dtype != {"float32": flash_attention_fwd.launches,
                                                 "bfloat16": 0}:
        raise AssertionError(f"vit_serve (float32) launched K3 by dtype "
                             f"{flash_attention_fwd.launches_by_dtype}")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()
    return launches


FLASH_COUNTERS = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)


def _run_train_vit(label, epochs, *extra):
    """``run --pipeline=train_vit`` in this process with the flash kernels'
    counts set to 0 just before and read just after. Returns the store, the
    argv, the wall time, the counts by kernel and by dtype, and a CUDA event
    recorded after every step."""
    cut = {"train_resnet50.epochs": epochs, "train_resnet50.save_every_iters": 0,
           "train_resnet50.log_progress_every_iters": 1,
           "train_resnet50.output_path": str(_build.BUILD_DIR / label)}
    argv = ["--pipeline=train_vit", "--project-path", str(REPO), "--no-persist",
            "--params", ",".join(["vit_model.attn_impl:flash", *extra]
                                 + [f"{k}:{v}" for k, v in cut.items()])]
    for c in FLASH_COUNTERS:
        c.launches = 0
        c.launches_by_dtype = dict.fromkeys(c.launches_by_dtype, 0)
    with _step_events() as (ends, _):
        t0 = time.perf_counter()
        store = cli.run(argv)
        wall = time.perf_counter() - t0
    counts = {name: c.launches for name, c in zip(("K3", "K4", "K5"), FLASH_COUNTERS)}
    by_dtype = {name: dict(c.launches_by_dtype)
                for name, c in zip(("K3", "K4", "K5"), FLASH_COUNTERS)}
    return store, argv, wall, counts, by_dtype, ends


@contextlib.contextmanager
def _step_events():
    """A CUDA event recorded after every ``train_step`` inside the block, and
    cuDNN's (deterministic, benchmark) flags counted at every step."""
    ends, flags = [], collections.Counter()
    real_step = training.train_step

    def step(*a, **kw):
        flags[(torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)] += 1
        out = real_step(*a, **kw)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return out

    training.train_step = step
    try:
        yield ends, flags
    finally:
        training.train_step = real_step


def _vit_train_line(card, label, dtype, epochs, extra):
    """train_vit through the port's ``run``, in this process, so the kernels'
    counts read here are the run's. ``dtype`` is the route every flash launch
    must take: bfloat16 under the conf's autocast, float32 with
    :data:`F32_TRAIN_PARAMS` in ``extra``. Returns the run's line, its
    store, the launches, the step ms from the last epoch's throughput and
    the median step of the last epoch (CUDA events after each step)."""
    torch.cuda.reset_peak_memory_stats()
    store, argv, wall, counts, by_dtype, ends = _run_train_vit(label, epochs, *extra)
    k3, k4, k5 = counts["K3"], counts["K4"], counts["K5"]
    peak = torch.cuda.max_memory_allocated()
    h = store["train_results"]["history"]
    n_valid = len(store["datasets"]["validset"])
    batch = int(store["context"].params("train_resnet50.batch_size"))
    eval_bs = min(32 * batch, n_valid)
    val_forwards = len(h["valid"]) * math.ceil(n_valid / eval_bs)
    steps = h["steps"]
    losses = [e["main_loss"] for e in h["train"]]
    if steps == 0 or not np.isfinite(losses).all() or len(ends) != steps:
        raise AssertionError(f"{label}: {steps} steps ({len(ends)} timed), "
                             f"losses {losses[:4]}...")
    if (k4, k5) != (VIT_BLOCKS * steps, VIT_BLOCKS * steps) or \
            k3 != VIT_BLOCKS * (steps + val_forwards):
        raise AssertionError(f"{label} launches K3 {k3}, K4 {k4}, K5 {k5} for {steps} "
                             f"steps and {val_forwards} validation forwards")
    # every launch takes the dtype's route, on the tensor cores
    if any(d != {**dict.fromkeys(d, 0), dtype: n}
           for d, n in zip(by_dtype.values(), (k3, k4, k5))):
        raise AssertionError(f"{label} launches by dtype {by_dtype}, expected all {dtype}")
    tput = h["throughput_img_s"]
    step_ms = batch / tput[-1] * 1e3
    warm = _last_epoch_steps(ends, steps, epochs)
    median_ms = statistics.median(warm)
    line = {"phase": label, "argv": ["python", "-m", "deepcv_tpu_torch", "run", *argv],
            "dtype": dtype,
            "cut": {"epochs": f"10 -> {epochs}", "checkpoints": "off (save_every_iters 0)"},
            "batch": batch, "steps": steps, "train_images": len(store["datasets"]["trainset"]),
            "valid_images": n_valid, "first_loss": losses[0], "last_loss": losses[-1],
            "valid": h["valid"][-1], "throughput_img_s": tput,
            "step_ms": step_ms, "step_ms_median_last_epoch": median_ms,
            "step_ms_warm_range": [min(warm), max(warm)], "wall_s": wall,
            "parameters": store["model"].capacity(),
            "launches": {"K3": k3, "K4": k4, "K5": k5},
            "launches_by_dtype": by_dtype,
            "launches_per_step": {"K3": (k3 - VIT_BLOCKS * val_forwards) / steps,
                                  "K4": k4 / steps, "K5": k5 / steps},
            "validation_forwards": val_forwards,
            "peak_memory_gib": peak / 2 ** 30, "card": card}
    return line, store, {"K3": k3, "K4": k4, "K5": k5}, step_ms, median_ms


def phase_vit_train(card, label="vit_train", dtype="bfloat16", epochs=TRAIN_EPOCHS, extra=()):
    """:func:`_vit_train_line`'s run, its line emitted. Returns the
    launches, the step ms from the last epoch's throughput and the median
    step of the last epoch."""
    line, store, launches, step_ms, median_ms = _vit_train_line(card, label, dtype, epochs,
                                                                extra)
    emit(line)
    del store
    torch.cuda.empty_cache()
    return launches, step_ms, median_ms


def phase_vit_train_profile(card, step_ms, label="vit_train_profile",
                            extra=("train_resnet50.validate_every_epochs:1000",)):
    """Where a train_vit step's device time goes: one more epoch (``extra``
    may cut it), validation off, under torch.profiler (its host overhead
    makes that epoch's wall time no measure; the kernels' device times are),
    against the unprofiled step time ``step_ms``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        store, _, _, counts, _, _ = _run_train_vit(label, 1, *extra)
        torch.cuda.synchronize()
    h = store["train_results"]["history"]
    steps = h["steps"]
    if h["valid"] or counts != dict.fromkeys(("K3", "K4", "K5"), VIT_BLOCKS * steps):
        raise AssertionError(f"{label}: {counts} launches for {steps} steps, "
                             f"validation {h['valid']}")
    groups, top = _profile_groups(prof, VIT_PROFILE_GROUPS)
    upload = groups.pop("upload", 0.0)     # the dataset and weights, once per run
    busy = sum(groups.values()) / steps
    emit({"phase": label, "steps": steps,
          "device_ms_per_step": {g: ms / steps for g, ms in groups.most_common()},
          "upload_ms_per_run": upload,
          "device_busy_ms_per_step": busy, "step_ms_unprofiled": step_ms,
          "device_idle_share": 1.0 - busy / step_ms,
          "flash_share_of_step": {g: groups[g] / steps / step_ms for g in ("K3", "K4", "K5")},
          "top_kernels_ms_per_step": [[name[:160], ms / steps, cnt] for name, ms, cnt in top],
          "launches": counts, "card": card})
    del store, prof
    torch.cuda.empty_cache()


def phase_k45_f32(card):
    """K4's and K5's float32 routes at ViT-B/16's serving shape (12 launches
    each, batch 64), checked against the plain versions and timed beside
    SDPA's f32 backward (CUDA events and profiler device time); then
    train_vit in float32 at batch 256, two epochs of 8 steps, validation
    off: the last epoch's step time."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    shape = (SERVE_BATCH, VIT_HEADS, VIT_T, VIT_DH)
    q, k, v, do = _flash_case(gen, *shape, "float32")
    o, lse = plain_flash_fwd(q, k, v)
    delta = (do * o).sum(-1)
    got = (flash_attention_bwd_dq(q, k, v, do, lse, delta),
           *flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    refs = (plain_flash_bwd_dq(q, k, v, do, lse, delta),
            *plain_flash_bwd_dkv(q, k, v, do, lse, delta))
    errs = {name: _rel_err(g, r)[0] for name, g, r in zip(("dq", "dk", "dv"), got, refs)}
    if not max(errs.values()) <= F32_TOL:
        raise AssertionError(f"K4/K5 f32 at the serving shape: rel err {errs}")
    del got, refs
    per = {}
    for kind, fn in (("dq", lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta)),
                     ("dkv", lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta))):
        b = SERVE_BATCH * VIT_HEADS
        per[kind] = {"ms": VIT_BLOCKS * cuda_ms(fn), "device_ms": VIT_BLOCKS * device_ms(fn, None),
                     "bound_ms": VIT_BLOCKS * flash_bound(kind, b, VIT_T, VIT_DH, "float32",
                                                          tf32x3=True)[0],
                     "cuda_core_bound_ms": VIT_BLOCKS * flash_bound(kind, b, VIT_T, VIT_DH,
                                                                    "float32")[0]}
    lib_fwd = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    lib_fwd_bwd = _library_fwd_bwd(q, k, v, do)
    library = {"ms": VIT_BLOCKS * (cuda_ms(lib_fwd_bwd) - cuda_ms(lib_fwd)),
               "device_ms": VIT_BLOCKS * (device_ms(lib_fwd_bwd, None) - device_ms(lib_fwd, None))}
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    store, _, _, counts, by_dtype, _ = _run_train_vit(
        "k45_f32_train", 2, *F32_TRAIN_PARAMS, *SHORT_TRAIN_PARAMS)
    h = store["train_results"]["history"]
    steps = h["steps"]
    losses = [e["main_loss"] for e in h["train"]]
    if not np.isfinite(losses).all() or h["valid"] or any(
            d != {"float32": VIT_BLOCKS * steps, "bfloat16": 0} for d in by_dtype.values()):
        raise AssertionError(f"k45_f32 train: losses {losses[:4]}, launches {by_dtype}")
    emit({"phase": "k45_f32", "shape_n_h_t_dh": list(shape), "launches_per_step": VIT_BLOCKS,
          "rel_err": errs, "per_step": per,
          "k4_k5_ms": per["dq"]["ms"] + per["dkv"]["ms"],
          "k4_k5_device_ms": per["dq"]["device_ms"] + per["dkv"]["device_ms"],
          "library_bwd": library,
          "train_vit_f32": {"batch": TRAIN_BATCH, "steps": steps,
                            "throughput_img_s": h["throughput_img_s"],
                            "step_ms": TRAIN_BATCH / h["throughput_img_s"][-1] * 1e3},
          "card": card})
    del store
    torch.cuda.empty_cache()


def flash_kernel_lines(rows, serve_launches, train_launches, f32_train_launches,
                       vmoe_launches, card):
    """K3 per ViT-B/16 forward at the serving batch (f32), K4 and K5 per
    train step (bf16, batch 256): 12 launches each. Each entry's ``routes``
    give both dtypes' kernels: K3's f32 route per serving forward, K4's and
    K5's per ``vit_train_f32`` step (batch 256), all three bounded by their
    3xTF32 products with the CUDA-core bound beside it. The V-MoE path
    (``vmoe_train``, bf16, the same shapes) adds to the bf16 launches."""
    serve, train_row = rows[("vit_serve", "float32")], rows[("vit_train", "bfloat16")]
    f32_train = rows[("vit_train", "float32")]
    train_per = (f"one train_vit step at batch {TRAIN_BATCH}, bfloat16 (12 launches at "
                 f"N,H,T,Dh {train_row['shape_n_h_t_dh']})")
    f32_train_per = (f"one train_vit float32 step at batch {TRAIN_BATCH} (12 launches at "
                     f"N,H,T,Dh {f32_train['shape_n_h_t_dh']})")
    outs = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
    lines = []
    for name, kind, row, src, launches, per in (
            ("flash_attention_fwd", "fwd", serve, "deepcv_tpu/ops/attention.py:73",
             {"vit_serve": serve_launches, "vit_train": train_launches["K3"],
              "vit_train_f32": f32_train_launches["K3"], "vmoe_train": vmoe_launches["K3"]},
             f"one forward of vit_spec('b_16') at batch {SERVE_BATCH}, float32 "
             f"(12 launches of flash_fwd_f32tc_kernel at N,H,T,Dh "
             f"{serve['shape_n_h_t_dh']})"),
            ("flash_attention_bwd_dq", "dq", train_row, "deepcv_tpu/ops/attention.py:185",
             {"vit_train": train_launches["K4"], "vit_train_f32": f32_train_launches["K4"],
              "vmoe_train": vmoe_launches["K4"]},
             train_per),
            ("flash_attention_bwd_dkv", "dkv", train_row, "deepcv_tpu/ops/attention.py:222",
             {"vit_train": train_launches["K5"], "vit_train_f32": f32_train_launches["K5"],
              "vmoe_train": vmoe_launches["K5"]},
             train_per)):
        lines.append({
            "name": name, "route": "cuda", "source": "deepcv_tpu_torch/csrc/flash_attention.cu",
            "replaces": src, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(row["max_abs_err"][x] for x in outs[kind]),
            **_per_unit(row, kind), "per": per, "card": card})
    # both routes of each: float32 by 3xTF32 on the tensor cores (K3 per
    # serving forward, the entry's own numbers; K4, K5 per vit_train_f32
    # step) and bfloat16 on the tensor cores per train step (K4, K5: the
    # entries' own numbers)
    for line, kind, kern, k, f32_row, f32_launches, f32_per in (
            (lines[0], "fwd", "flash_fwd", "K3", serve,
             serve_launches + f32_train_launches["K3"],
             lines[0]["per"] + f"; also {f32_train_launches['K3']} launches in vit_train_f32"),
            (lines[1], "dq", "flash_bwd_dq", "K4", f32_train, f32_train_launches["K4"],
             f32_train_per),
            (lines[2], "dkv", "flash_bwd_dkv", "K5", f32_train, f32_train_launches["K5"],
             f32_train_per)):
        line["routes"] = {
            "float32": {"kernel": f"{kern}_f32tc_kernel (tensor cores, mma.sync, 3xTF32)",
                        "launches": f32_launches, **_per_unit(f32_row, kind),
                        "max_abs_err": max(f32_row["max_abs_err"][x] for x in outs[kind]),
                        "per": f32_per},
            "bfloat16": {"kernel": f"{kern}_tc_kernel (tensor cores, mma.sync)",
                         "launches": train_launches[k] + vmoe_launches[k],
                         "launches_by_path": {"vit_train": train_launches[k],
                                              "vmoe_train": vmoe_launches[k]},
                         **_per_unit(train_row, kind),
                         "max_abs_err": max(train_row["max_abs_err"][x] for x in outs[kind]),
                         "per": train_per}}
    return lines


def _per_unit(row, kind):
    """A flash_kernels row's per-launch numbers times the 12 launches of one
    ViT-B/16 forward or step. The library's time for K4 and for K5 is its
    whole backward, the one call that computes both kernels' work."""
    k = row[kind]
    out = {"ms": VIT_BLOCKS * k["ms"], "plain_ms": VIT_BLOCKS * k["plain_ms"],
           "bound_ms": VIT_BLOCKS * k["bound_ms"], "bound_by": k["bound_by"],
           "library_ms": VIT_BLOCKS * row["library_fwd_ms" if kind == "fwd"
                                          else "library_bwd_ms"]}
    if "cuda_core_bound_ms" in k:
        out["cuda_core_bound_ms"] = VIT_BLOCKS * k["cuda_core_bound_ms"]
    if kind == "fwd":
        out["library_kernels"] = row["library_fwd_kernels"]
    else:
        out["library_note"] = ("F.scaled_dot_product_attention's backward, one call for "
                               "dQ, dK and dV: K4's and K5's work together")
    return out


# --------------------------------------------------------------------------- #
# K1: fused augment + normalize, and the classifier's training paths
# --------------------------------------------------------------------------- #

def augment_bound(n, h, w):
    """Least time for K1's work on an H100 SXM: the uint8 images and five
    (N,) float32 factors read once, the float32 output written once, at
    3.35 TB/s; or AUG_OPS_PER_ELEMENT float32 operations per element at
    67 TFLOP/s. Returns (ms, bound_by)."""
    elems = n * h * w * 3
    t_bytes = (elems * (1 + 4) + 5 * 4 * n) / HBM_BYTES_PER_S
    t_ops = elems * AUG_OPS_PER_ELEMENT / PEAK_FLOPS["float32"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _aug_factors(gen, n):
    u = lambda: 0.6 + 0.8 * torch.rand((n,), generator=gen, device=DEVICE)
    return [u(), u(), u(), torch.exp(0.2 * torch.randn((n,), generator=gen, device=DEVICE))]


def phase_augment_kernel(card):
    """K1 against its plain version, noise off, in float32 and bfloat16 out,
    then the noise statistics; times per launch, by CUDA events and by the
    profiler's device time of the kernel alone. Returns the rows by shape."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    rows = {}
    for (n, h, w, c) in AUG_SHAPES:
        u8 = torch.randint(0, 256, (n, h, w, c), generator=gen, device=DEVICE,
                           dtype=torch.uint8)
        facs = _aug_factors(gen, n)
        ones = [torch.ones((n,), device=DEVICE)] * 4
        sigma = torch.full((n,), NOISE_SIGMA, device=DEVICE)
        seed = torch.tensor([7], device=DEVICE)
        errs = {}
        got = fused_augment_normalize(u8, *facs, None, CIFAR_MEAN, CIFAR_STD)
        ref = plain_fused_augment_normalize(u8, *facs, None, CIFAR_MEAN, CIFAR_STD)
        half = fused_augment_normalize(u8, *facs, None, CIFAR_MEAN, CIFAR_STD,
                                       out_dtype=torch.bfloat16)
        errs["random"] = (got - ref).abs().max().item()
        # bfloat16 out is the float32 result rounded once: at most half a
        # bf16 ulp (2^-8 of the value) from it, so within AUG_TOL of the plain
        # value once that half ulp is taken off
        errs["random_bf16_beyond_half_ulp"] = max(
            0.0, ((half.float() - ref).abs() - 2 ** -8 * ref.abs()).max().item())
        bf16_is_f32_rounded = bool(torch.equal(half, got.to(torch.bfloat16)))
        pure = normalize(to_tensor(u8), CIFAR_MEAN, CIFAR_STD)
        got = fused_augment_normalize(u8, *ones, None, CIFAR_MEAN, CIFAR_STD)
        errs["neutral"] = (got - pure).abs().max().item()
        half = fused_augment_normalize(u8, *ones, None, CIFAR_MEAN, CIFAR_STD,
                                       out_dtype=torch.bfloat16)
        errs["neutral_bf16_beyond_half_ulp"] = max(
            0.0, ((half.float() - pure).abs() - 2 ** -8 * pure.abs()).max().item())
        bf16_is_f32_rounded &= bool(torch.equal(half, got.to(torch.bfloat16)))
        torch.cuda.synchronize()
        for case, err in errs.items():
            if not err <= AUG_TOL:
                raise AssertionError(f"K1 vs plain {case} {(n, h, w, c)}: max abs err "
                                     f"{err:.3e} > {AUG_TOL:.0e}")
        if not bf16_is_f32_rounded:
            raise AssertionError(f"K1 {(n, h, w, c)}: bfloat16 out is not the float32 out "
                                 "rounded")
        del got, ref, half, pure
        bound_ms, bound_by = augment_bound(n, h, w)
        off = lambda: fused_augment_normalize(u8, *facs, None, CIFAR_MEAN,  # noqa: E731
                                              CIFAR_STD)
        on = lambda: fused_augment_normalize(u8, *facs, sigma, CIFAR_MEAN,  # noqa: E731
                                             CIFAR_STD, seed=seed)
        row = {"phase": "augment_kernel", "shape_nhwc": [n, h, w, c],
               "max_abs_err": errs, "tol": AUG_TOL, "bf16_is_f32_rounded": bf16_is_f32_rounded,
               "ms": cuda_ms(off), "ms_noise": cuda_ms(on),
               "device_ms": device_ms(off, 1),
               "device_ms_noise": device_ms(on, 1),
               "plain_ms": cuda_ms(lambda: plain_fused_augment_normalize(
                   u8, *facs, None, CIFAR_MEAN, CIFAR_STD)),
               "plain_ms_noise": cuda_ms(lambda: plain_fused_augment_normalize(
                   u8, *facs, sigma, CIFAR_MEAN, CIFAR_STD, seed=7)),
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
               "card": card}
        emit(row)
        rows[(n, h, w, c)] = row
        del u8, facs, ones, sigma
    torch.cuda.empty_cache()

    # noise: on a mid-grey batch, half the images at sigma, half at 0; with
    # mean 0 and std 1 the output minus the noise-off output is the noise,
    # never clipped at 128/255 +- 5 sigma. 6.3 M draws put the mean's std at
    # 4e-5 and the std's relative error near 3e-4.
    n, h, w, _ = AUG_SHAPES[0]
    grey = torch.full((n, h, w, 3), 128, dtype=torch.uint8, device=DEVICE)
    ones = [torch.ones((n,), device=DEVICE)] * 4
    sigma = torch.zeros((n,), device=DEVICE)
    sigma[: n // 2] = NOISE_SIGMA
    zero, one = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    clean = fused_augment_normalize(grey, *ones, None, zero, one)
    noisy = fused_augment_normalize(grey, *ones, sigma, zero, one, seed=11)
    again = fused_augment_normalize(grey, *ones, sigma, zero, one, seed=11)
    other = fused_augment_normalize(grey, *ones, sigma, zero, one,
                                    seed=torch.tensor([12], device=DEVICE))
    d = (noisy - clean)[: n // 2].double()
    stats = {"mean": d.mean().item(), "std": d.std().item(),
             "sigma0_max_abs": (noisy - clean)[n // 2:].abs().max().item(),
             "same_seed_equal": bool(torch.equal(noisy, again)),
             "other_seed_differs": bool(not torch.equal(noisy, other)),
             "other_seed_corr": float(torch.corrcoef(torch.stack(
                 [(noisy - clean)[: n // 2].flatten(), (other - clean)[: n // 2].flatten()]))[0, 1])}
    tol = {"mean": 5e-4, "std_rel": 5e-3, "corr": 5e-3}
    ok = (abs(stats["mean"]) <= tol["mean"]
          and abs(stats["std"] / NOISE_SIGMA - 1) <= tol["std_rel"]
          and stats["sigma0_max_abs"] == 0 and stats["same_seed_equal"]
          and stats["other_seed_differs"] and abs(stats["other_seed_corr"]) <= tol["corr"])
    emit({"phase": "augment_noise", "shape_nhwc": [n, h, w, 3], "sigma": NOISE_SIGMA,
          **stats, "tol": tol, "card": card})
    if not ok:
        raise AssertionError(f"K1 noise statistics out of bounds: {stats}")
    del grey, clean, noisy, again, other, d
    torch.cuda.empty_cache()
    return rows


class _K2Dtypes:
    """Records the dtypes of x, w and b at every call of the K2 wrapper made
    by ``FusedConv2d`` (the module's reference to it), for one run."""

    def __init__(self):
        self.seen = collections.Counter()
        self._real = port_nn.fused_conv2d_bias_act

    def __enter__(self):
        def spy(x, w, b=None, act=None, *, w_packed=None):
            if x.device.type == "cuda":
                self.seen[tuple(str(t.dtype).split(".")[-1]
                                for t in (x, w, b) if t is not None)] += 1
            return self._real(x, w, b, act, w_packed=w_packed)
        port_nn.fused_conv2d_bias_act = spy
        return self

    def __exit__(self, *exc):
        port_nn.fused_conv2d_bias_act = self._real


def _run_classifier(label, params, pipeline="train_image_classifier",
                    hp_key="train_image_classifier"):
    """``run --pipeline=<pipeline>`` (its training hp under ``hp_key``) in
    this process with the counts set to 0 just before and read just after.
    Returns the store, the argv, the wall time, the counts, the cuDNN flags
    seen at every step, and a CUDA event recorded after every step."""
    out_dir = _build.BUILD_DIR / label
    params = [*params, f"{hp_key}.save_every_iters:0", f"{hp_key}.output_path:{out_dir}"]
    argv = [f"--pipeline={pipeline}", "--project-path", str(REPO), "--no-persist",
            "--params", ",".join(params)]
    store, wall, counts, flags, step_ends = _counted(lambda: cli.run(argv))
    return store, argv, wall, counts, flags, step_ends


def _counted(run):
    """``run()`` with every kernel count set to 0 just before it and read
    just after it, and the peak memory reset. Returns its result, the wall
    time, the counts (K1, K2 in all, by dtype, by activation and by the
    dtypes of x, w and b at each call, the recipe's routes, the flash
    launches), the cuDNN flags seen at every step, and a CUDA event
    recorded after every step."""
    routes = PreprocessedDataset.batch_transform.routes
    torch.cuda.reset_peak_memory_stats()
    fused_augment_normalize.launches = 0
    fused_conv2d_bias_act.launches = 0
    fused_conv2d_bias_act.launches_by_dtype = dict.fromkeys(
        fused_conv2d_bias_act.launches_by_dtype, 0)
    fused_conv2d_bias_act.launches_by_act = dict.fromkeys(
        fused_conv2d_bias_act.launches_by_act, 0)
    for c in FLASH_COUNTERS:
        c.launches = 0
    routes_before = dict(routes)
    with _K2Dtypes() as k2_dtypes, _step_events() as (step_ends, flags):
        t0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - t0
    counts = {"K1": fused_augment_normalize.launches, "K2": fused_conv2d_bias_act.launches,
              "K2_by_dtype": dict(fused_conv2d_bias_act.launches_by_dtype),
              "K2_by_act": {k: v for k, v in fused_conv2d_bias_act.launches_by_act.items() if v},
              "routes": {k: routes[k] - routes_before[k] for k in routes},
              "flash": sum(c.launches for c in FLASH_COUNTERS),
              "K2_dtypes": {"/".join(k): v for k, v in k2_dtypes.seen.items()}}
    return out, wall, counts, flags, step_ends


def phase_classifier_train(card):
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark)
    store, argv, wall, counts, flags, _ = _run_classifier(
        "classifier_train", ["train_image_classifier.epochs:1",
                             "cifar10_preprocessing.split_dataset.validset_ratio:0.8"])
    after = (cudnn.deterministic, cudnn.benchmark)
    h = store["train_results"]["history"]
    steps = h["steps"]
    n_valid = len(store["datasets"]["validset"])
    batch = int(store["context"].params("train_image_classifier.batch_size"))
    val_forwards = len(h["valid"]) * math.ceil(n_valid / min(32 * batch, n_valid))
    losses = [e["main_loss"] for e in h["train"]]
    if steps == 0 or not np.isfinite(losses).all():
        raise AssertionError(f"classifier_train: {steps} steps, losses {losses[:4]}...")
    forwards = steps + val_forwards
    if counts["K2"] != CLASSIFIER_CONVS_PER_FORWARD * forwards or counts["K1"] != 0 \
            or counts["K2_by_dtype"] != {"float32": counts["K2"], "bfloat16": 0} \
            or any(counts["routes"].values()):
        raise AssertionError(f"classifier_train counts {counts} for {steps} steps and "
                             f"{val_forwards} validation forwards")
    if dict(flags) != {(True, False): steps} or after != before:
        raise AssertionError(f"cuDNN (deterministic, benchmark) during the run {dict(flags)}, "
                             f"before {before}, after {after}")
    tput = h["throughput_img_s"]
    emit({"phase": "classifier_train",
          "argv": ["python", "-m", "deepcv_tpu_torch", "run", *argv],
          "cut": {"epochs": "2 -> 1", "checkpoints": "off (save_every_iters 0)",
                  "train_images": "40,000 -> 10,000 (validset_ratio 0.2 -> 0.8)"},
          "batch": batch, "steps": steps,
          "data": store["datasets"]["trainset"].dataset.provenance,
          "train_images": len(store["datasets"]["trainset"]), "valid_images": n_valid,
          "first_loss": losses[0], "last_loss": losses[-1], "valid": h["valid"][-1],
          "throughput_img_s": tput, "step_ms": batch / tput[-1] * 1e3, "wall_s": wall,
          "launches": counts, "launches_per_forward": {"K2": counts["K2"] / forwards},
          "validation_forwards": val_forwards,
          "cudnn_during_run": {"deterministic": True, "benchmark": False, "steps": steps},
          "cudnn_before_after": [list(before), list(after)],
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card})
    del store
    torch.cuda.empty_cache()
    return counts


def _steady(tps):
    """bench.py's ``steady()``: the median of the epochs after the first two
    (after the first when there are fewer than four)."""
    warm = tps[2:] if len(tps) >= 4 else (tps[1:] if len(tps) > 1 else tps)
    return statistics.median(warm)


#: kernel-name fragments -> the group a profiled kernel's time is summed in
PROFILE_GROUPS = (("K1", ("fused_augment_normalize",)),
                  ("K2", ("fused_conv2d_bias_act",)),
                  ("cudnn_conv", ("cudnn", "conv", "xmma", "implicit_gemm", "wgrad", "dgrad",
                                  "sm90_", "nchw", "nhwc")),
                  ("group_norm", ("group_norm", "GroupNorm")),
                  ("optimizer", ("multi_tensor", "adam", "Adam")),
                  ("reduce", ("reduce",)),
                  ("upload", ("Memcpy HtoD",)),
                  ("copy", ("copy", "Memcpy", "memcpy", "Memset", "memset")),
                  ("elementwise", ("elementwise", "vectorized", "unrolled")))


#: PROFILE_GROUPS for a ViT step: the three flash kernels, the matmuls (and
#: the patch embedding's conv) in cuBLAS (its ``nvjet`` kernels) and cuDNN,
#: then the rest
VIT_PROFILE_GROUPS = (("K3", ("flash_fwd",)), ("K4", ("flash_bwd_dq",)),
                      ("K5", ("flash_bwd_dkv",)),
                      ("gemm_conv", ("nvjet", "gemm", "Gemm", "cutlass", "xmma", "sm90_",
                                     "cudnn")),
                      ("layer_norm", ("layer_norm", "LayerNorm", "GammaBeta")),
                      ("gelu", ("gelu", "Gelu", "GeLU")),
                      ("softmax_loss", ("softmax", "nll_loss", "cross_entropy")),
                      ("optimizer", ("multi_tensor", "sgd", "SGD")),
                      *((g, f) for g, f in PROFILE_GROUPS
                        if g in ("reduce", "upload", "copy", "elementwise")))


def _profile_groups(prof, table=PROFILE_GROUPS):
    """Device time (ms) of every kernel in a torch.profiler run, summed by
    the groups of ``table`` (the first group a name matches), and the ten
    largest kernels."""
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in _kernel_records(prof)]
    groups = collections.Counter()
    for name, ms, _ in kernels:
        group = next((g for g, frags in table if any(f in name for f in frags)), "other")
        groups[group] += ms
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return groups, top


def _augment_params(epochs):
    """bench.py config 1's settings for ``augment_train``, as ``--params``."""
    return [f"cifar10_preprocessing.augmentation_recipe:{BENCH_RECIPE}",
            "cifar10_preprocessing.split_dataset.validset_ratio:0.05",
            f"train_image_classifier.epochs:{epochs}",
            f"train_image_classifier.batch_size:{AUGMENT_BATCH}",
            "train_image_classifier.dtype:bfloat16",
            "train_image_classifier.optimizer:adamw",
            "train_image_classifier.optimizer_opts:{lr: 1.0e-3, betas: [0.9, 0.999], "
            "weight_decay: 1.0e-2}",
            "train_image_classifier.scheduler:null",
            "train_image_classifier.deterministic:false",
            "train_image_classifier.validate_every_epochs:1000",
            "train_image_classifier.log_grad_norm:false",
            "train_image_classifier.log_progress_every_iters:1000000",
            "train_image_classifier.handle_preemption:false"]


def _check_augment_run(label, store, counts):
    """Finite losses, no validation, one K1 launch a step with every batch
    on the K1 route, 5 bf16 K2 launches a step. Returns the history."""
    h = store["train_results"]["history"]
    steps = h["steps"]
    losses = [e["main_loss"] for e in h["train"]]
    if steps == 0 or h["valid"] or not np.isfinite(losses).all():
        raise AssertionError(f"{label}: {steps} steps, losses {losses}, "
                             f"validation {h['valid']}")
    bf16 = "bfloat16/bfloat16/bfloat16"
    if counts["K1"] != steps or counts["routes"] != {"K1": steps, "eager": 0} \
            or counts["K2"] != CLASSIFIER_CONVS_PER_FORWARD * steps \
            or counts["K2_dtypes"] != {bf16: CLASSIFIER_CONVS_PER_FORWARD * steps} \
            or counts["K2_by_dtype"] != {"float32": 0, "bfloat16": counts["K2"]}:
        raise AssertionError(f"{label} counts {counts} for {steps} steps")
    return h


def phase_augment_train(card, aug_rows, k2_rows):
    params = _augment_params(AUGMENT_EPOCHS)
    store, argv, wall, counts, _, _ = _run_classifier("augment_train", params)
    h = _check_augment_run("augment_train", store, counts)
    steps = h["steps"]
    losses = [e["main_loss"] for e in h["train"]]
    tput = h["throughput_img_s"]
    steady = _steady(tput)
    step_ms = AUGMENT_BATCH / steady * 1e3
    k1_row = aug_rows[(AUGMENT_BATCH, 32, 32, 3)]
    k2_ms = sum(cnt * k2_rows[(shape, "bfloat16")]["ms"]
                for shape, cnt in CLASSIFIER_CONVS.items())
    emit({"phase": "augment_train",
          "argv": ["python", "-m", "deepcv_tpu_torch", "run", *argv],
          "settings": "bench.py config 1 (recipe, validset_ratio 0.05, batch 4096, "
                      "bfloat16, AdamW lr 1e-3 betas (0.9, 0.999) wd 1e-2)",
          "cut": {"epochs": f"88 -> {AUGMENT_EPOCHS}",
                  "validation": "off", "checkpoints": "off"},
          "batch": AUGMENT_BATCH, "steps": steps,
          "data": store["datasets"]["trainset"].dataset.provenance,
          "train_images": len(store["datasets"]["trainset"]),
          "loss": losses[-1],
          "throughput_img_s": tput, "steady_img_s": steady, "step_ms": step_ms,
          "wall_s": wall, "launches": counts,
          "launches_per_step": {"K1": counts["K1"] / steps, "K2": counts["K2"] / steps},
          "k1_ms_per_step": k1_row["ms_noise"],
          "k1_device_ms_per_step": k1_row["device_ms_noise"], "k2_fwd_ms_per_step": k2_ms,
          "k1_share_of_step": k1_row["ms_noise"] / step_ms,
          "k2_share_of_step": k2_ms / step_ms,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card})
    del store
    torch.cuda.empty_cache()

    # where the step's device time goes: one more epoch under torch.profiler
    # (its host overhead makes that epoch's wall time no measure; the
    # kernels' device times are), against the unprofiled step time above
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        store, _, _, pcounts, _, _ = _run_classifier("augment_train_profile",
                                                     _augment_params(1))
        torch.cuda.synchronize()
    psteps = store["train_results"]["history"]["steps"]
    groups, top = _profile_groups(prof)
    upload = groups.pop("upload", 0.0)     # the dataset and weights, once per run
    busy = sum(groups.values()) / psteps
    emit({"phase": "augment_train_profile", "steps": psteps,
          "device_ms_per_step": {g: ms / psteps for g, ms in groups.most_common()},
          "upload_ms_per_run": upload,
          "device_busy_ms_per_step": busy, "step_ms_unprofiled": step_ms,
          "device_idle_share": 1.0 - busy / step_ms,
          "top_kernels_ms_per_step": [[name[:90], ms / psteps, cnt] for name, ms, cnt in top],
          "launches": pcounts, "card": card})
    del store, prof
    torch.cuda.empty_cache()
    return counts, {"steady_img_s": steady, "step_ms": step_ms}


def phase_k1_train(card):
    """``augment_train`` cut to 2 epochs (11 steps each), the last epoch's
    step time, and K1's device time a step from one more epoch under
    torch.profiler: the ``--k1`` mode's view of K1 on its path."""
    from torch.profiler import ProfilerActivity, profile
    store, argv, _, counts, _, _ = _run_classifier("k1_augment_train", _augment_params(2))
    h = _check_augment_run("k1_augment_train", store, counts)
    step_ms = AUGMENT_BATCH / h["throughput_img_s"][-1] * 1e3
    del store
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        store, _, _, pcounts, _, _ = _run_classifier("k1_augment_train_profile",
                                                     _augment_params(1))
        torch.cuda.synchronize()
    psteps = _check_augment_run("k1_augment_train_profile", store, pcounts)["steps"]
    groups, _ = _profile_groups(prof)
    emit({"phase": "k1_augment_train", "argv": ["python", "-m", "deepcv_tpu_torch", "run", *argv],
          "batch": AUGMENT_BATCH, "steps": h["steps"], "throughput_img_s": h["throughput_img_s"],
          "step_ms": step_ms, "launches": counts,
          "profiled_steps": psteps, "k1_device_ms_per_step": groups["K1"] / psteps,
          "device_ms_per_step": sum(groups.values()) / psteps, "card": card})
    del store, prof
    torch.cuda.empty_cache()


def _cifar_data() -> str:
    """Where the CIFAR-10 pixels of a run on ``data/01_raw`` come from: the
    synthetic stand-ins found there at the start (in a checkout, the tracked
    files), or, where a copy of the repository left them out, the ones the
    loader generates in their place."""
    names = [REPO / "data" / "01_raw" / f"cifar10_{s}_synthetic.npz" for s in ("train", "test")]
    if all(p.exists() for p in names):
        return ("synthetic CIFAR-10 stand-in read from data/01_raw/cifar10_{train,test}"
                "_synthetic.npz, present at the start of the run")
    return ("synthetic CIFAR-10 stand-in generated in this run by deepcv_tpu_torch.data."
            "datasets._synthetic_like (no data/01_raw/cifar10_*_synthetic.npz in this copy)")


def phase_wide_train(card, data):
    """The wide classifiers through the port's ``run``, in this process, at
    the conf's full width and hp (train_wide_classifier: batch 1024,
    bfloat16, AdamW lr 1e-3 wd 1e-2, its warm-up schedule, ``deterministic``)
    cut to 2 epochs and no checkpoints, on CIFAR-10 (``data``): finite
    losses, 6 K2 launches per forward (training and validation), all on
    bfloat16 inputs; the median step of the last epoch (CUDA events
    recorded after each step), img/s and peak memory. Returns the K2
    launches and the step ms of each pipeline."""
    bf16 = "bfloat16/bfloat16/bfloat16"
    launches, step_ms = 0, {}
    for pipeline in WIDE_PIPELINES:
        torch.cuda.empty_cache()
        store, argv, wall, counts, flags, ends = _run_classifier(
            f"wide_train_{pipeline}", [f"train_wide_classifier.epochs:{WIDE_EPOCHS}"],
            pipeline, "train_wide_classifier")
        h = store["train_results"]["history"]
        steps = h["steps"]
        n_valid = len(store["datasets"]["validset"])
        val_forwards = len(h["valid"]) * math.ceil(n_valid / min(32 * WIDE_BATCH, n_valid))
        forwards = steps + val_forwards
        losses = [e["main_loss"] for e in h["train"]]
        if steps == 0 or len(h["valid"]) != WIDE_EPOCHS or not np.isfinite(losses).all() \
                or not np.isfinite(h["valid"][-1]["valid_loss"]):
            raise AssertionError(f"{pipeline}: {steps} steps, losses {losses}, "
                                 f"validation {h['valid']}")
        if counts["K2"] != WIDE_CONVS_PER_FORWARD * forwards or counts["K1"] != 0 \
                or counts["K2_by_dtype"] != {"float32": 0, "bfloat16": counts["K2"]} \
                or counts["K2_dtypes"] != {bf16: counts["K2"]} \
                or any(counts["routes"].values()) or len(ends) != steps:
            raise AssertionError(f"{pipeline} counts {counts} for {steps} steps and "
                                 f"{val_forwards} validation forwards")
        per_epoch = steps // WIDE_EPOCHS
        warm = [ends[i].elapsed_time(ends[i + 1]) for i in range(steps - per_epoch, steps - 1)]
        step_ms[pipeline] = statistics.median(warm)
        launches += counts["K2"]
        model = store["model"]
        emit({"phase": "wide_train", "pipeline": pipeline,
              "argv": ["python", "-m", "deepcv_tpu_torch", "run", *argv],
              "cut": {"epochs": f"10 -> {WIDE_EPOCHS}", "checkpoints": "off"},
              "batch": WIDE_BATCH, "dtype": "bfloat16", "steps": steps,
              "data": f"{data}; train images sha256 " + hashlib.sha256(
                  store["datasets"]["trainset"].dataset.images.tobytes()).hexdigest()[:16],
              "train_images": len(store["datasets"]["trainset"]), "valid_images": n_valid,
              "parameters": model.capacity(),
              "loss": losses[-1], "valid": h["valid"][-1],
              "step_ms": step_ms[pipeline], "step_ms_warm_range": [min(warm), max(warm)],
              "img_per_s": WIDE_BATCH / step_ms[pipeline] * 1e3,
              "throughput_img_s": h["throughput_img_s"], "wall_s": wall,
              "launches": counts, "validation_forwards": val_forwards,
              "launches_per_forward": {"K2": counts["K2"] / forwards},
              "cudnn_deterministic_benchmark": {str(k): v for k, v in flags.items()},
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card})
        del store, model
    torch.cuda.empty_cache()
    return launches, step_ms


#: the groups of a profiled step's device time found by where a kernel was
#: launched from: a ``range::<group>`` profiler range (the forward of the
#: modules and functions :func:`_annotated_modules` puts in one) or the
#: backward of an op launched inside one (by autograd sequence number);
#: then, by the name of an event above the kernel, K2's backward
#: (:data:`K2_BACKWARD_NODE`: the plain version again in float32, cuDNN's
#: dgrad and wgrad) and the optimizer's step. The wide steps put the norms and the
#: weight-norm function in ranges, the zoo steps BatchNorm and every conv
#: that K2 does not take (depthwise, strided, the stems)
PROFILE_RANGE = "range::"
#: the autograd node of K2's launch (``fused_layer._FusedConvFn``)
K2_BACKWARD_NODE = "_FusedConvFnBackward"
WIDE_RANGES = ((port_nn.BatchNorm, "forward", "batch_norm"),
               (port_nn.GroupNorm, "forward", "group_norm"),
               (port_nn, "weight_norm", "weight_norm"))
WIDE_BACKWARD_GROUPS = (("K2_backward", K2_BACKWARD_NODE),
                        ("adamw", "Optimizer.step#AdamW.step"))
ZOO_RANGES = ((port_nn.BatchNorm, "forward", "batch_norm"),
              (port_nn.Conv2d, "forward", "depthwise_and_stem_convs"))
ZOO_BACKWARD_GROUPS = (("K2_backward", K2_BACKWARD_NODE),
                       ("sgd", "Optimizer.step#SGD.step"))
#: by kernel name, for the kernels launched from none of those
NAME_GROUPS = (("K2_forward", ("fused_conv2d_bias_act",)),
               ("pool", ("avg_pool",)),
               ("dense", ("gemm", "Gemm", "nvjet", "cutlass")),
               ("loss", ("softmax", "nll_loss", "cross_entropy")),
               *((g, f) for g, f in PROFILE_GROUPS
                 if g in ("reduce", "upload", "copy", "elementwise")))


@contextlib.contextmanager
def _annotated_modules(ranges):
    """Each (owner, attribute, group) of ``ranges`` (a module's forward or a
    function of ``port_nn``) run inside a profiler range ``range::<group>``."""
    from torch.profiler import record_function

    def ranged(fn, group):
        def call(*a, **kw):
            with record_function(PROFILE_RANGE + group):
                return fn(*a, **kw)
        return call
    with contextlib.ExitStack() as stack:
        for owner, attr, group in ranges:
            stack.enter_context(mock.patch.object(owner, attr, ranged(getattr(owner, attr),
                                                                      group)))
        yield


def _event_groups(events, backward_groups):
    """{id(event): group} for the profiler's CPU events launched in a
    ``range::`` range, in the backward of an op launched there (the autograd
    node with its sequence number), or below an event that
    ``backward_groups`` names; every event below a marked one takes its
    group."""
    groups, seq = {}, {}

    def mark(event, group):
        stack = [event]
        while stack:
            e = stack.pop()
            groups.setdefault(id(e), group)
            stack.extend(e.cpu_children)

    for e in events:
        if e.name.startswith(PROFILE_RANGE):
            group = e.name[len(PROFILE_RANGE):]
            mark(e, group)
            stack = [e]
            while stack:
                c = stack.pop()
                if c.sequence_nr >= 0:
                    seq[c.sequence_nr] = group
                stack.extend(c.cpu_children)
    for e in events:
        if "Backward" in e.name and e.sequence_nr in seq:
            mark(e, seq[e.sequence_nr])
        for group, fragment in backward_groups:
            if fragment in e.name:
                mark(e, group)
    return groups


def _own_kernels(event):
    """The kernels of a profiler event less those an enclosing event lists
    too: the profiler attaches a kernel to the op that launched it and
    again to a CUDA runtime event inside that launch (``Command Buffer
    Full`` when the launch queue is full, ``Lazy Function Loading``)."""
    if not event.kernels:
        return []
    above, parent = [], event.cpu_parent
    while parent is not None:
        above.extend(parent.kernels)
        parent = parent.cpu_parent
    return [k for k in event.kernels if k not in above]


def _range_profile_groups(prof, backward_groups, name_groups=NAME_GROUPS):
    """Device ms of a profiled run's kernels by group (:func:`_event_groups`,
    else ``name_groups``), the kernels by name (ms, launches), the same by
    (group, name), and K2's forward launches the profiler recorded. Every
    device record counts once: one that the profiler tied to no CPU event
    (it loses a launch's correlation now and then) takes its group by
    name. The device's copies of the CPU ranges (``range::...``,
    ``Optimizer.step#...``) are no kernels and count nowhere."""
    events = prof.events()
    marked = _event_groups(events, backward_groups)
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = {e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
    untied = collections.Counter((e.name, e.time_range.end - e.time_range.start)
                                 for e in on_device if e.name not in ranges
                                 and not getattr(e, "is_user_annotation", False))
    groups, kernels, by_group = collections.Counter(), {}, {}

    def add(group, name, us):
        groups[group] += us / 1e3
        for table, key in ((kernels, name), (by_group, (group, name))):
            ms, n = table.get(key, (0.0, 0))
            table[key] = (ms + us / 1e3, n + 1)

    def by_name(name):
        return next((g for g, frags in name_groups if any(f in name for f in frags)), "other")

    for e in events:
        for k in _own_kernels(e):
            add(marked.get(id(e)) or by_name(k.name), k.name, k.duration)
            untied[(k.name, k.duration)] -= 1
    for (name, us), n in untied.items():
        for _ in range(n):
            add(by_name(name), name, us)
    k2 = sum(n for name, (_, n) in kernels.items() if "fused_conv2d_bias_act" in name)
    return groups, kernels, by_group, k2


def phase_wide_train_profile(card, step_ms, tries=2):
    """Where a wide step's device time goes: one more epoch of each wide
    pipeline, validation off, under torch.profiler, with the norms and the
    weight-norm function in ranges (:func:`_annotated_modules`): device ms a
    step by group, the ten largest kernels and the device's idle share of
    the unprofiled step. The profiler must have recorded every K2 launch
    the wrapper counted, or the epoch is run again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    params = ["train_wide_classifier.epochs:1", "train_wide_classifier.validate_every_epochs:1000",
              KEYPOINT_VALID_RATIO]
    for pipeline in WIDE_PIPELINES:
        for _ in range(tries):
            torch.cuda.empty_cache()
            with _annotated_modules(WIDE_RANGES), \
                    profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                store, _, _, counts, _, _ = _run_classifier(
                    f"wide_train_profile_{pipeline}", params, pipeline, "train_wide_classifier")
                torch.cuda.synchronize()
            groups, kernels, _, k2 = _range_profile_groups(prof, WIDE_BACKWARD_GROUPS)
            if k2 == counts["K2"]:
                break
        else:
            raise AssertionError(f"{pipeline} profile: {k2} K2 launches recorded of "
                                 f"{counts['K2']} in each of {tries} tries")
        steps = store["train_results"]["history"]["steps"]
        if counts["K2"] != WIDE_CONVS_PER_FORWARD * steps:
            raise AssertionError(f"{pipeline} profile: counts {counts} for {steps} steps")
        upload = groups.pop("upload", 0.0)     # the dataset and weights, once per run
        busy = sum(groups.values()) / steps
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
        emit({"phase": "wide_train_profile", "pipeline": pipeline, "steps": steps,
              "device_ms_per_step": {g: ms / steps for g, ms in groups.most_common()},
              "upload_ms_per_run": upload, "device_busy_ms_per_step": busy,
              "step_ms_unprofiled": step_ms[pipeline],
              "device_idle_share": 1.0 - busy / step_ms[pipeline],
              "k2_backward_share_of_step": groups["K2_backward"] / steps / step_ms[pipeline],
              "top_kernels_ms_per_step": [[name[:90], ms / steps, n] for name, (ms, n) in top],
              "k2_launches_recorded": k2, "launches": counts, "card": card})
        del store, prof
    torch.cuda.empty_cache()


def _images_digest(store):
    """Where the run's images came from and a digest of the training pixels."""
    ds = store["datasets"]["trainset"].dataset
    return (f"{ds.provenance}; train images sha256 "
            + hashlib.sha256(ds.images.tobytes()).hexdigest()[:16])


def _last_epoch_steps(ends, steps, epochs):
    """The step times (ms) of the last epoch from a CUDA event recorded after
    every step: the intervals between its steps' ends."""
    per_epoch = steps // epochs
    return [ends[i].elapsed_time(ends[i + 1]) for i in range(steps - per_epoch, steps - 1)]


def phase_zoo_train(card):
    """The rest of the zoo through the port's ``run``, in this process, at
    full width with ``train_resnet50``'s hp (SGD lr 0.1, batch 256,
    bfloat16; DenseNet-121's peak is 32 GiB, so the batch is not cut) on the
    synthetic imagenet224 set,
    cut to :data:`ZOO_PIPELINES`' epochs, no checkpoints: finite losses, K2
    launches per forward (training and validation) by epilogue activation,
    every one bf16 in x and w (the zoo's convs have no bias), no flash
    launch; the median step of the last epoch (CUDA events after each step),
    img/s, peak memory, parameters (torchvision's, :data:`ZOO_PARAMETERS`).
    Returns K2's launches and the step ms by pipeline."""
    launches, step_ms = {}, {}
    for pipeline, (epochs, per_act) in ZOO_PIPELINES.items():
        torch.cuda.empty_cache()
        store, argv, wall, counts, _, ends = _run_classifier(
            f"zoo_train_{pipeline}", [f"train_resnet50.epochs:{epochs}"], pipeline,
            "train_resnet50")
        batch = int(store["context"].params("train_resnet50.batch_size"))
        h = store["train_results"]["history"]
        steps = h["steps"]
        n_valid = len(store["datasets"]["validset"])
        val_forwards = len(h["valid"]) * math.ceil(n_valid / min(32 * batch, n_valid))
        forwards = steps + val_forwards
        losses = [e["main_loss"] for e in h["train"]]
        if steps == 0 or len(h["valid"]) != epochs or not np.isfinite(losses).all() \
                or not np.isfinite(list(h["valid"][-1].values())).all():
            raise AssertionError(f"{pipeline}: {steps} steps, losses {losses}, "
                                 f"validation {h['valid']}")
        k2 = counts["K2"]
        if k2 != sum(per_act.values()) * forwards \
                or counts["K2_by_act"] != {a: n * forwards for a, n in per_act.items()} \
                or counts["K2_by_dtype"] != {"float32": 0, "bfloat16": k2} \
                or counts["K2_dtypes"] != ({"bfloat16/bfloat16": k2} if k2 else {}) \
                or counts["K1"] != 0 or counts["flash"] != 0 or any(counts["routes"].values()) \
                or len(ends) != steps or store["model"].capacity() != ZOO_PARAMETERS[pipeline]:
            raise AssertionError(f"{pipeline} counts {counts} for {steps} steps and "
                                 f"{val_forwards} validation forwards")
        warm = _last_epoch_steps(ends, steps, epochs)
        step_ms[pipeline] = statistics.median(warm)
        launches[pipeline] = k2
        model = store["model"]
        emit({"phase": "zoo_train", "pipeline": pipeline,
              "argv": ["python", "-m", "deepcv_tpu_torch", "run", *argv],
              "cut": {"epochs": f"10 -> {epochs}", "checkpoints": "off (save_every_iters 0)"},
              "batch": batch, "dtype": "bfloat16", "steps": steps,
              "data": _images_digest(store),
              "train_images": len(store["datasets"]["trainset"]), "valid_images": n_valid,
              "parameters": model.capacity(), "loss": losses[-1], "valid": h["valid"][-1],
              "step_ms": step_ms[pipeline], "step_ms_warm_range": [min(warm), max(warm)],
              "img_per_s": batch / step_ms[pipeline] * 1e3,
              "throughput_img_s": h["throughput_img_s"], "wall_s": wall,
              "launches": counts, "validation_forwards": val_forwards,
              "launches_per_forward": {"K2": k2 / forwards,
                                       "K2_by_act": {a: n / forwards
                                                     for a, n in counts["K2_by_act"].items()}},
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card})
        del store, model
    torch.cuda.empty_cache()
    return launches, step_ms


def phase_zoo_train_profile(card, step_ms, k2_forward, tries=2):
    """Where a ``train_mobilenet_v2`` step's device time goes: one more
    epoch cut to 8 steps (:data:`SHORT_TRAIN_PARAMS`; sorting the events
    of a full epoch takes a minute), validation off, under torch.profiler,
    with BatchNorm and the
    convs K2 does not take in ranges (:data:`ZOO_RANGES`): device ms a step
    by group (K2's forward; K2's backward; the depthwise and stem convs,
    forward and backward; BatchNorm, forward and backward; SGD; pools, the
    dense head, the loss, copies, elementwise), the ten largest kernels, the
    device's idle share of the unprofiled step and K2's forward share of
    it (``k2_forward``: its per-forward ms from ``kernel_forward_bf16``,
    ``forward_ms``).
    The profiler must have recorded every K2 launch the wrapper counted, or
    the epoch is run again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    pipeline = "train_mobilenet_v2"
    params = ["train_resnet50.epochs:1", *SHORT_TRAIN_PARAMS]
    per_forward = sum(ZOO_PIPELINES[pipeline][1].values())
    for _ in range(tries):
        torch.cuda.empty_cache()
        with _annotated_modules(ZOO_RANGES), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            store, _, wall, counts, _, _ = _run_classifier(
                f"zoo_train_profile_{pipeline}", params, pipeline, "train_resnet50")
            torch.cuda.synchronize()
        groups, kernels, _, k2 = _range_profile_groups(prof, ZOO_BACKWARD_GROUPS)
        if k2 == counts["K2"]:
            break
    else:
        raise AssertionError(f"{pipeline} profile: {k2} K2 launches recorded of "
                             f"{counts['K2']} in each of {tries} tries")
    steps = store["train_results"]["history"]["steps"]
    if counts["K2"] != per_forward * steps:
        raise AssertionError(f"{pipeline} profile: counts {counts} for {steps} steps")
    upload = groups.pop("upload", 0.0)     # the dataset and weights, once per run
    busy = sum(groups.values()) / steps
    ms = step_ms[pipeline]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "zoo_train_profile", "pipeline": pipeline, "steps": steps,
          "device_ms_per_step": {g: v / steps for g, v in groups.most_common()},
          "upload_ms_per_run": upload, "device_busy_ms_per_step": busy,
          "step_ms_unprofiled": ms, "device_idle_share": 1.0 - busy / ms,
          "share_of_step": {g: v / steps / ms for g, v in groups.most_common()},
          "k2_forward_share_of_step_by_kernel_forward": k2_forward["forward_ms"] / ms,
          "top_kernels_ms_per_step": [[name[:90], v / steps, n] for name, (v, n) in top],
          "k2_launches_recorded": k2, "launches": counts, "wall_s": wall, "card": card})
    del store, prof
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# V-MoE: bench.py config 13's routing on train_vit
# --------------------------------------------------------------------------- #

#: bench.py config 13 (bench.py:1215-1224) as ``--params`` of train_vit:
#: ViT-B/16 with 8 experts on every 2nd block (6 of 12), top-1, routed in
#: groups of 4 images (788 = 4 x 197 tokens); train_resnet50's hp, whose
#: moe_aux_weight is the default 0.01 (bench.py's)
VMOE_PARAMS = ("vit_model.moe_experts:8", "vit_model.moe_every:2", "vit_model.moe_k:1",
               "vit_model.moe_group_size:788")
VMOE_EXPERTS, VMOE_LAYERS = 8, 6
VMOE_PARAMETERS = 284_946_664        # ViT-B/16's 86,567,656 + 6 x 33,063,168
#: the card-against-CPU check of one V-MoE forward: batch, the logits' rel
#: L2 bound (both float32, TF32 off), the share of routing choices that may
#: differ (an argmax near a tie may flip) and what counts as a near-tie (the
#: top two router probabilities closer than this, on the CPU in float64)
VMOE_CHECK_BATCH = 8
VMOE_REL_L2, VMOE_FLIP_SHARE, VMOE_NEAR_TIE = 1e-3, 1e-3, 1e-5
#: profiler ranges around MoEMlp's four stages (forward; the backward of
#: each op launched there by autograd sequence numbers)
VMOE_RANGES = ((MoEMlp, "route", "moe_router_topk"), (MoEMlp, "dispatch", "moe_dispatch"),
               (MoEMlp, "experts", "moe_experts"), (MoEMlp, "combine", "moe_combine"))
GEMM_FRAGMENTS = ("nvjet", "gemm", "Gemm", "cutlass", "xmma", "sm90_")
#: by kernel name, for the kernels launched outside those ranges
VMOE_NAME_GROUPS = (("K3", ("flash_fwd",)), ("K4", ("flash_bwd_dq",)),
                    ("K5", ("flash_bwd_dkv",)),
                    ("gemm_outside_experts", GEMM_FRAGMENTS),
                    *((g, f) for g, f in VIT_PROFILE_GROUPS
                      if g in ("layer_norm", "gelu", "softmax_loss")),
                    *((g, f) for g, f in PROFILE_GROUPS
                      if g in ("reduce", "upload", "copy", "elementwise")))
VMOE_BACKWARD_GROUPS = (("sgd", "Optimizer.step#SGD.step"),)


def phase_vmoe_train(card, dense_step_ms):
    """train_vit with bench.py config 13's routing (:data:`VMOE_PARAMS`),
    flash attention, batch 256, bf16, one epoch and its validation: the
    parameter count, finite losses and ``moe_aux`` terms in (0, E], K3, K4
    and K5 12 launches a step (K3 also 12 a validation forward), all
    bfloat16; the median step against ``vit_train``'s (``dense_step_ms``,
    the same median) as bench.py's ``moe_over_dense``. Each MoE layer's
    share of dropped routing choices is read after the run from the
    routing its last forward kept (the last validation batch), so that the
    timed steps carry no extra work."""
    line, store, launches, _, step_ms = _vit_train_line(card, "vmoe_train", "bfloat16", 1,
                                                        VMOE_PARAMS)
    model = store["model"]
    layers = {n: m for n, m in model.named_modules() if isinstance(m, MoEMlp)}
    aux = [e.get("moe_aux") for e in store["train_results"]["history"]["train"]]
    if model.capacity() != VMOE_PARAMETERS or len(layers) != VMOE_LAYERS:
        raise AssertionError(f"vmoe_train: {model.capacity()} parameters, MoE layers "
                             f"{sorted(layers)}")
    if len(aux) != line["steps"] or not all(a is not None and np.isfinite(a)
                                            and 0.0 < a <= VMOE_EXPERTS for a in aux):
        raise AssertionError(f"vmoe_train: moe_aux {aux}")
    layer = next(iter(layers.values()))
    line.update({"moe_aux": {"first": aux[0], "last": aux[-1], "min": min(aux),
                             "max": max(aux), "mean": statistics.fmean(aux)},
                 "routing": {"experts": layer.num_experts, "k": layer.k,
                             "group_size_tokens": layer.group_size,
                             "capacity_factor": layer.capacity_factor,
                             "last_forward_groups": list(layer.routing[1].shape[:2])},
                 "dropped_share_by_layer_last_validation_forward": {
                     n: (~m.routing[1]).float().mean().item() for n, m in layers.items()},
                 "vit_train_step_ms": dense_step_ms,
                 "moe_over_dense": dense_step_ms / step_ms})
    emit(line)
    del store, model, layers, layer
    torch.cuda.empty_cache()
    return launches, step_ms


def phase_vmoe_train_profile(card, step_ms, tries=2):
    """Where a V-MoE step's device time goes: 8 more steps
    (:data:`SHORT_TRAIN_PARAMS`), validation off, under torch.profiler, with
    MoEMlp's stages in ranges (:data:`VMOE_RANGES`): device ms a step by
    group (K3, K4, K5; the experts' GEMMs and the rest of their range;
    routing: router and top-k, dispatch, combine; GEMMs outside the
    experts, layer norms, GELU, the loss, SGD, copies, elementwise), the ten
    largest kernels and the device's idle share of the unprofiled median
    step ``step_ms``. The profiler must record every flash launch the
    wrappers counted, or the run is profiled again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.empty_cache()
        with _annotated_modules(VMOE_RANGES), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            store, _, wall, counts, by_dtype, _ = _run_train_vit(
                "vmoe_train_profile", 1, *VMOE_PARAMS, *SHORT_TRAIN_PARAMS)
            torch.cuda.synchronize()
        groups, kernels, by_group, _ = _range_profile_groups(prof, VMOE_BACKWARD_GROUPS,
                                                             VMOE_NAME_GROUPS)
        flash = sum(n for name, (_, n) in kernels.items() if "flash_" in name)
        if flash == sum(counts.values()):
            break
    else:
        raise AssertionError(f"vmoe_train_profile: {flash} flash launches recorded of "
                             f"{sum(counts.values())} in each of {tries} tries")
    steps = store["train_results"]["history"]["steps"]
    if store["train_results"]["history"]["valid"] or \
            counts != dict.fromkeys(("K3", "K4", "K5"), VIT_BLOCKS * steps):
        raise AssertionError(f"vmoe_train_profile: {counts} for {steps} steps")
    upload = groups.pop("upload", 0.0)     # the dataset and weights, once per run
    # the experts' range: its two batched GEMMs (forward and backward) and
    # the rest (GELU, the weights' bf16 casts, bias sums)
    experts = groups.pop("moe_experts", 0.0)
    groups["moe_expert_gemms"] = sum(v for (g, name), (v, _) in by_group.items()
                                     if g == "moe_experts"
                                     and any(f in name for f in GEMM_FRAGMENTS))
    groups["moe_expert_gelu_casts"] = experts - groups["moe_expert_gemms"]
    busy = sum(groups.values()) / steps
    routing = sum(groups[g] for g in ("moe_router_topk", "moe_dispatch", "moe_combine")) / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "vmoe_train_profile", "steps": steps,
          "device_ms_per_step": {g: v / steps for g, v in groups.most_common()},
          "moe_routing_ms_per_step": routing,
          "flash_ms_per_step": sum(groups[g] for g in ("K3", "K4", "K5")) / steps,
          "upload_ms_per_run": upload, "device_busy_ms_per_step": busy,
          "step_ms_unprofiled": step_ms, "device_idle_share": 1.0 - busy / step_ms,
          "share_of_step": {g: v / steps / step_ms for g, v in groups.most_common()},
          "top_kernels_ms_per_step": [[name[:120], v / steps, n] for name, (v, n) in top],
          "moe_kernels_ms_per_step": {
              g: [[name[:100], v / steps, n] for (gg, name), (v, n) in
                  sorted(by_group.items(), key=lambda kv: -kv[1][0]) if gg == g][:4]
              for g in ("moe_router_topk", "moe_dispatch", "moe_combine", "moe_experts")},
          "flash_launches_recorded": flash, "launches": counts,
          "launches_by_dtype": by_dtype, "wall_s": wall, "card": card})
    del store, prof
    torch.cuda.empty_cache()


def phase_vmoe_cpu_check(card):
    """One V-MoE forward (bench.py config 13's model, flash, eval) on the
    card against the CPU path: float32, TF32 off, batch 8, the same
    weights. The logits' rel L2 within :data:`VMOE_REL_L2`; fewer than
    :data:`VMOE_FLIP_SHARE` of the routing choices differ, with the count
    of near-ties (top two router probabilities within
    :data:`VMOE_NEAR_TIE`, from the CPU run's inputs to each layer); K3 12
    float32 launches."""
    hp = vit_spec("b_16", attn_impl="flash", moe_experts=VMOE_EXPERTS, moe_every=2, moe_k=1,
                  moe_group_size=788)
    t0 = time.perf_counter()
    cpu = DeepcvModule(IMAGE_SHAPE, hp, device="cpu").eval()
    gpu = DeepcvModule(IMAGE_SHAPE, hp, device="meta").to_empty(device=DEVICE).eval()
    gpu.load_state_dict(cpu.state_dict())
    build_s = time.perf_counter() - t0
    x = torch.from_numpy(np.random.default_rng(SEED + 18).normal(
        size=(VMOE_CHECK_BATCH, *IMAGE_SHAPE)).astype(np.float32))
    inputs = {}
    hooks = [m.register_forward_pre_hook(lambda mod, args: inputs.__setitem__(mod, args[0]))
             for m in cpu.modules() if isinstance(m, MoEMlp)]
    k3 = flash_attention_fwd.launches_by_dtype["float32"]
    with torch.no_grad():
        got = gpu(x.to(DEVICE)).cpu()
        t0 = time.perf_counter()
        ref = cpu(x)
        cpu_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    k3 = flash_attention_fwd.launches_by_dtype["float32"] - k3
    rel_l2 = ((got - ref).norm() / ref.norm()).item()
    layers = {}
    for (name, mg), mc in zip(((n, m) for n, m in gpu.named_modules() if isinstance(m, MoEMlp)),
                              (m for m in cpu.modules() if isinstance(m, MoEMlp))):
        e_gpu, kept_gpu = (t.cpu() for t in mg.routing)
        e_cpu, kept_cpu = mc.routing
        xs = inputs[mc].double().reshape(*e_cpu.shape[:2], -1)
        top2 = torch.softmax(xs @ mc.router.double(), -1).topk(2, -1).values
        layers[name] = {"choices": e_cpu.numel(), "differ": int((e_gpu != e_cpu).sum()),
                        "kept_differ": int((kept_gpu != kept_cpu).sum()),
                        "near_ties": int((top2[..., 0] - top2[..., 1] < VMOE_NEAR_TIE).sum()),
                        "dropped_share": float((~kept_cpu).float().mean())}
    choices = sum(v["choices"] for v in layers.values())
    differ = sum(v["differ"] for v in layers.values())
    line = {"phase": "vmoe_cpu_check", "batch": VMOE_CHECK_BATCH, "dtype": "float32",
            "tf32": False, "rel_l2": rel_l2, "bound_rel_l2": VMOE_REL_L2,
            "routing_choices": choices, "routing_differ": differ,
            "routing_differ_share": differ / choices, "bound_differ_share": VMOE_FLIP_SHARE,
            "near_ties": sum(v["near_ties"] for v in layers.values()), "by_layer": layers,
            "k3_float32_launches": k3, "logits_finite": bool(torch.isfinite(got).all()),
            "build_s": build_s, "cpu_forward_s": cpu_s, "card": card}
    emit(line)
    if not (rel_l2 <= VMOE_REL_L2 and differ < VMOE_FLIP_SHARE * choices
            and k3 == VIT_BLOCKS and line["logits_finite"] and len(layers) == VMOE_LAYERS):
        raise AssertionError(f"vmoe_cpu_check failed: {line}")
    del cpu, gpu
    torch.cuda.empty_cache()


def _forwards(h, n_valid, batch):
    """A run's forwards: its steps and its validation batches."""
    return h["steps"] + len(h["valid"]) * math.ceil(n_valid / min(32 * batch, n_valid))


def phase_pipeline_runs(card, phase, runs, data=None, models=None):
    """The pipelines ``runs`` (:class:`PipelineRun`) through the port's
    ``run``, in this process, TF32 off, no checkpoints: finite training
    values, finite validation metrics within their range, the models'
    parameters, exactly the row's K2 launches a training and a validation
    forward (none for a row without K2 convs), all in its dtype in x, w and
    b, no K1 and no flash launch; the median step of the last epoch (CUDA
    events recorded after each step) and the wall time of each validation
    pass, its metrics included. ``data`` names the pixels where the
    catalog's set is not synthetic. ``models``, a dict, receives each
    trained model and its datasets by label. Returns the K2 launches and
    the step ms of each run by label."""
    launches, step_ms = {}, {}
    for run in runs:
        torch.cuda.empty_cache()
        with _validation_walls() as val_walls:
            store, argv, wall, counts, _, ends = _run_classifier(
                f"{phase}_{run.label}", list(run.params), run.pipeline, run.pipeline)
        h = store["train_results"]["history"]
        steps = h["steps"]
        batch = int(store["context"].params(f"{run.pipeline}.batch_size"))
        n_valid = len(store["datasets"]["validset"])
        forwards = _forwards(h, n_valid, batch)
        losses = [e["main_loss"] for e in h["train"]]
        valid = h["valid"][-1] if h["valid"] else {}
        model = store["model"]
        if steps == 0 or not np.isfinite([v for e in h["train"] for v in e.values()]).all() \
                or not valid or not all(0.0 <= valid.get(m, np.nan) <= top
                                        for m, top in run.metrics.items()) \
                or not np.isfinite(list(valid.values())).all() \
                or model.capacity() != run.parameters or len(val_walls) != len(h["valid"]):
            raise AssertionError(f"{phase} {run.pipeline}: {steps} steps, losses {losses}, "
                                 f"validation {h['valid']}, {model.capacity()} parameters, "
                                 f"{len(val_walls)} validation passes timed")
        k2 = counts["K2"]
        if k2 != sum(run.k2_by_act.values()) * forwards \
                or counts["K2_by_dtype"] != {"float32": 0, "bfloat16": 0, run.dtype: k2} \
                or counts["K2_by_act"] != {a: n * forwards for a, n in run.k2_by_act.items()} \
                or counts["K2_dtypes"] != ({"/".join([run.dtype] * 3): k2} if k2 else {}) \
                or counts["K1"] or counts["flash"] or len(ends) != steps:
            raise AssertionError(f"{phase} {run.pipeline} counts {counts} for {steps} steps "
                                 f"and {forwards - steps} validation forwards")
        warm = _last_epoch_steps(ends, steps, run.epochs)
        step_ms[run.label] = statistics.median(warm)
        launches[run.label] = k2
        emit({"phase": phase, "pipeline": run.pipeline,
              "argv": ["python", "-m", "deepcv_tpu_torch", "run", *argv],
              "cut": {"epochs": "none (the conf's)", "checkpoints": "off", **run.cut},
              "batch": batch, "dtype": run.dtype, "tf32": False, "steps": steps,
              "data": data or _images_digest(store),
              "train_images": len(store["datasets"]["trainset"]), "valid_images": n_valid,
              "parameters": model.capacity(), "loss": losses, "valid": h["valid"],
              "step_ms": step_ms[run.label], "step_ms_warm_range": [min(warm), max(warm)],
              "img_per_s": batch / step_ms[run.label] * 1e3,
              "throughput_img_s": h["throughput_img_s"], "validation_pass_s": val_walls,
              "wall_s": wall, "launches": counts, "validation_forwards": forwards - steps,
              "launches_per_forward": {"K2": k2 / forwards},
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card})
        if models is not None:
            models[run.label] = (model, store["datasets"])
        del store, model
    torch.cuda.empty_cache()
    return launches, step_ms


def _unet_datasets(n):
    """``generate_segmentation_dataset`` at UNET_SIZE, split as the seg
    preprocessing splits (a fifth for validation), ``to_tensor``."""
    raw = seg_pipeline.generate_segmentation_dataset(n=n, image_size=UNET_SIZE, seed=0)
    return preprocess({"trainset": raw}, {"seed": 0, "transforms": ["to_tensor"],
                                          "split_dataset": {"validset_ratio": 0.2}})


def phase_unet_train(card):
    """``create_segmenter(datasets, unet_spec())`` and ``train_segmenter``,
    as bench.py config 12 drives them, at full width (:data:`UNET_HP`:
    256x256, batch 32, bf16, AdamW, one_cycle, 2 epochs, validation after
    the last): 7,849,700 parameters, 19 K2 launches a training and a
    validation forward, all bf16 in x and w, finite losses and mIoU; the
    median step of the last epoch (CUDA events), img/s, peak memory.
    Returns the K2 launches and the step ms."""
    t0 = time.perf_counter()
    datasets = _unet_datasets(UNET_IMAGES)
    data_s = time.perf_counter() - t0
    model = seg_pipeline.create_segmenter(datasets, unet_spec(), device=DEVICE)
    hp = {**UNET_HP, "output_path": str(_build.BUILD_DIR / "unet_train")}
    torch.cuda.empty_cache()
    out, wall, counts, _, ends = _counted(
        lambda: seg_pipeline.train_segmenter(datasets, model, hp))
    h = out["history"]
    steps, n_valid = h["steps"], len(datasets["validset"])
    forwards = _forwards(h, n_valid, UNET_BATCH)
    losses = [e["main_loss"] for e in h["train"]]
    valid = h["valid"][-1] if h["valid"] else {}
    if steps == 0 or not np.isfinite(losses).all() or not valid \
            or not np.isfinite([valid["valid_loss"], valid["valid_mean_iou"]]).all() \
            or model.capacity() != UNET_PARAMETERS:
        raise AssertionError(f"unet_train: {steps} steps, losses {losses}, validation "
                             f"{h['valid']}, {model.capacity()} parameters")
    want = UNET_CONVS_PER_FORWARD * forwards
    if counts["K2"] != want or counts["K2_by_dtype"] != {"float32": 0, "bfloat16": want} \
            or counts["K2_dtypes"] != {"bfloat16/bfloat16": want - forwards,
                                       "bfloat16/bfloat16/bfloat16": forwards} \
            or counts["K1"] or counts["flash"] or len(ends) != steps:
        raise AssertionError(f"unet_train counts {counts} for {steps} steps and "
                             f"{forwards - steps} validation forwards")
    warm = _last_epoch_steps(ends, steps, UNET_EPOCHS)
    step_ms = statistics.median(warm)
    emit({"phase": "unet_train", "model": "unet_spec() + create_segmenter's head",
          "hp": UNET_HP, "cut": {"depth": "none", "data": f"{UNET_IMAGES} synthetic images",
                                 "epochs": UNET_EPOCHS, "checkpoints": "off"},
          "image_size": UNET_SIZE, "batch": UNET_BATCH, "steps": steps,
          "data": f"generate_segmentation_dataset(seed=0); train images sha256 " + hashlib.sha256(
              datasets["trainset"].dataset.images.tobytes()).hexdigest()[:16],
          "data_s": data_s, "train_images": len(datasets["trainset"]), "valid_images": n_valid,
          "parameters": model.capacity(), "loss": losses, "valid": h["valid"],
          "step_ms": step_ms, "step_ms_warm_range": [min(warm), max(warm)],
          "img_per_s": UNET_BATCH / step_ms * 1e3, "throughput_img_s": h["throughput_img_s"],
          "wall_s": wall, "launches": counts, "validation_forwards": forwards - steps,
          "launches_per_forward": {"K2": counts["K2"] / forwards},
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card})
    del model, out, datasets
    torch.cuda.empty_cache()
    return counts["K2"], step_ms


#: a U-Net step's groups found by profiler ranges (and the backward of what
#: runs in them): group norm, the decoder's resize, the encoder's max pools,
#: the links (dense_link's concatenation and its casts), the loss, the
#: metrics train_step computes on every batch
UNET_RANGES = ((port_nn.GroupNorm, "forward", "group_norm"),
               (port_nn.Interpolate, "forward", "resize"),
               (MaxPool, "forward", "max_pool"),
               (ForwardCallback, "__call__", "dense_link"),
               (seg_pipeline, "segmentation_loss", "loss"),
               (seg_pipeline, "pixel_accuracy", "metrics"),
               (seg_pipeline, "mean_iou", "metrics"))
UNET_BACKWARD_GROUPS = (("K2_backward", K2_BACKWARD_NODE),
                        ("adamw", "Optimizer.step#AdamW.step"))


#: seconds unet_train_profile's process may take: its data, a warm-up step,
#: up to three profiled epochs of 8 steps and their sorting
UNET_PROFILE_PROCESS_S = 300


def phase_unet_train_profile(card, step_ms):
    """:func:`unet_train_profile` in a process of its own
    (``chip_smoke.py --unet-profile STEP_MS CARD``), its lines passed on: in
    this process, after the earlier phases' profiles, the profiler has lost
    device records of a U-Net epoch (149 of its 152 K2 launches, twice in a
    row), and in a fresh one it has not."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--unet-profile",
                           repr(step_ms), card], capture_output=True, text=True,
                          timeout=UNET_PROFILE_PROCESS_S, cwd=REPO)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    sys.stderr.write(proc.stderr)
    sys.stderr.flush()
    if proc.returncode != 0:
        raise AssertionError(f"unet_train_profile: its process exited {proc.returncode}")


def unet_train_profile(card, step_ms, tries=3):
    """Where a U-Net step's device time goes: after one unprofiled step (the
    kernels' loading, cuDNN's search), a fresh model trained for
    :data:`UNET_PROFILE_STEPS` steps (one epoch of that many batches of
    unet_train's images, validation off) under torch.profiler, with
    :data:`UNET_RANGES`: device ms a step by group (K2's forward, K2's
    backward, group norm, the resize, max pool, the links, the loss and
    metrics, AdamW, copies, the rest), the ten largest kernels and the
    device's idle share of unet_train's unprofiled step ``step_ms``. The
    profiler must have recorded every K2 launch the wrapper counted, or the
    epoch is run again, up to ``tries`` times (``profiled_epochs``: how many
    it took)."""
    from torch.profiler import ProfilerActivity, profile
    datasets = _unet_datasets(UNET_IMAGES)
    train = datasets["trainset"]

    def first(n):
        return {"trainset": PreprocessedDataset(train.dataset.subset(np.arange(n)),
                                                train.transform),
                "validset": datasets["validset"]}

    hp = {**UNET_HP, "epochs": 1, "validate_every_epochs": 1000,
          "output_path": str(_build.BUILD_DIR / "unet_train_profile")}
    warm = first(UNET_BATCH)
    seg_pipeline.train_segmenter(warm, seg_pipeline.create_segmenter(warm, unet_spec(),
                                                                     device=DEVICE), hp)
    sub = first(UNET_PROFILE_STEPS * UNET_BATCH)
    for run in range(1, tries + 1):
        model = seg_pipeline.create_segmenter(sub, unet_spec(), device=DEVICE)
        torch.cuda.empty_cache()
        with _annotated_modules(UNET_RANGES), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, counts, _, _ = _counted(lambda: seg_pipeline.train_segmenter(sub, model, hp))
            torch.cuda.synchronize()
        groups, kernels, _, k2 = _range_profile_groups(prof, UNET_BACKWARD_GROUPS)
        if k2 == counts["K2"]:
            break
    else:
        raise AssertionError(f"unet_train_profile: {k2} K2 launches recorded of "
                             f"{counts['K2']} in each of {tries} tries")
    steps = UNET_PROFILE_STEPS
    if counts["K2"] != UNET_CONVS_PER_FORWARD * steps:
        raise AssertionError(f"unet_train_profile: counts {counts} for {steps} steps")
    upload = groups.pop("upload", 0.0)     # the dataset, once per run
    busy = sum(groups.values()) / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "unet_train_profile", "steps": steps,
          "device_ms_per_step": {g: ms / steps for g, ms in groups.most_common()},
          "upload_ms_per_run": upload, "device_busy_ms_per_step": busy,
          "step_ms_unprofiled": step_ms, "device_idle_share": 1.0 - busy / step_ms,
          "k2_backward_share_of_step": groups["K2_backward"] / steps / step_ms,
          "top_kernels_ms_per_step": [[name[:90], ms / steps, n] for name, (ms, n) in top],
          "k2_launches_recorded": k2, "profiled_epochs": run, "launches": counts,
          "card": card})


def phase_dense_cpu_check(card):
    """One float32 forward (eval, TF32 off, batch 8, the same weights) of
    the conf's HRNet segmenter at 32x32 and of the U-Net segmenter at 64x64
    on the card against the CPU path: within rel L2 :data:`SERVE_REL_L2`,
    with 1 and 19 float32 K2 launches."""
    conf = conf_hp("semantic_segmentation_model")
    for name, hp, size, per_forward in (("hrnet_segmenter", conf, 32, 1),
                                        ("unet", unet_spec(), 64, UNET_CONVS_PER_FORWARD)):
        sets = {"trainset": PreprocessedDataset(ArrayDataset(
            np.zeros((1, size, size, 3), np.uint8), np.zeros((1, size, size), np.int32),
            classes=list(seg_pipeline.SEG_CLASSES)))}
        cpu = seg_pipeline.create_segmenter(sets, hp, device="cpu").eval()
        gpu = seg_pipeline.create_segmenter(sets, hp, device=DEVICE).eval()
        gpu.load_state_dict(cpu.state_dict())
        x = torch.from_numpy(np.random.default_rng(SEED + 19).normal(
            size=(8, size, size, 3)).astype(np.float32))
        k2 = fused_conv2d_bias_act.launches_by_dtype["float32"]
        with torch.no_grad():
            got = gpu(x.to(DEVICE)).cpu()
        k2 = fused_conv2d_bias_act.launches_by_dtype["float32"] - k2
        with torch.no_grad():
            ref = cpu(x)
        rel_l2 = ((got - ref).norm() / ref.norm()).item()
        line = {"phase": "dense_cpu_check", "model": name, "batch": 8, "image_size": size,
                "dtype": "float32", "tf32": False, "rel_l2": rel_l2,
                "bound_rel_l2": SERVE_REL_L2, "k2_float32_launches": k2,
                "finite": bool(torch.isfinite(got).all()), "card": card}
        emit(line)
        if not (rel_l2 <= SERVE_REL_L2 and k2 == per_forward and line["finite"]):
            raise AssertionError(f"dense_cpu_check failed: {line}")
        del cpu, gpu
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _validation_walls():
    """The wall seconds of every validation pass of a ``train()`` inside the
    block: from the model's ``eval()`` to its ``train()`` after it (the
    device synchronised at both), the pass's forwards, losses and metrics,
    mAP included."""
    real = torch.nn.Module.train
    walls, started = [], []

    def train(self, mode=True):
        # a module's train() toggles its children too, and a model of several
        # DeepcvModules (the autoencoder) toggles each: the first to leave
        # training starts the pass, the first back ends it
        if bool(mode) != self.training and bool(mode) == bool(started):
            torch.cuda.synchronize()
            if mode:
                walls.append(time.perf_counter() - started.pop())
            else:
                started.append(time.perf_counter())
        return real(self, mode)

    torch.nn.Module.train = train
    try:
        yield walls
    finally:
        torch.nn.Module.train = real


def _fpn_datasets(n):
    """bench.py config 12's detection data: ``generate_shapes_dataset_fpn``
    at FPN_SIZE with grids FPN_GRIDS (seed 0), a 0.05 validation split,
    ``to_tensor``."""
    raw = det_pipeline.generate_shapes_dataset_fpn(n=n, image_size=FPN_SIZE, grids=FPN_GRIDS,
                                                   seed=0)
    return preprocess({"trainset": raw}, {"seed": 0, "split_dataset": {"validset_ratio": 0.05},
                                          "transforms": ["to_tensor"]})


def phase_fpn_train(card):
    """Config 12's FPN detector through the port's
    ``generate_shapes_dataset_fpn``, ``preprocess``, ``create_fpn_detector``
    and ``train_fpn_detector`` at full size (:data:`FPN_HP`: 8,192 64x64
    images, batch 512, bf16, AdamW, 4 epochs; validation after the last):
    221,064 parameters, 4 K2 launches a training and a validation forward,
    all bf16 in x, w and b, finite losses and map50; the median step of the
    last epoch (CUDA events), img/s, peak memory, the validation pass's
    wall. Returns the K2 launches and the step ms."""
    t0 = time.perf_counter()
    datasets = _fpn_datasets(FPN_IMAGES)
    data_s = time.perf_counter() - t0
    model = det_pipeline.create_fpn_detector(datasets, FPN_BACKBONE, device=DEVICE)
    hp = {**FPN_HP, "output_path": str(_build.BUILD_DIR / "fpn_train")}
    torch.cuda.empty_cache()
    with _validation_walls() as val_walls:
        out, wall, counts, _, ends = _counted(
            lambda: det_pipeline.train_fpn_detector(datasets, model, hp))
    h = out["history"]
    steps, n_valid = h["steps"], len(datasets["validset"])
    forwards = _forwards(h, n_valid, FPN_BATCH)
    losses = [e["main_loss"] for e in h["train"]]
    valid = h["valid"][-1] if h["valid"] else {}
    if steps == 0 or not np.isfinite(losses).all() or not valid \
            or not np.isfinite([valid["valid_loss"], valid["valid_map50"]]).all() \
            or model.capacity() != FPN_PARAMETERS:
        raise AssertionError(f"fpn_train: {steps} steps, losses {losses}, validation "
                             f"{h['valid']}, {model.capacity()} parameters")
    want = FPN_CONVS_PER_FORWARD * forwards
    if counts["K2"] != want or counts["K2_by_dtype"] != {"float32": 0, "bfloat16": want} \
            or counts["K2_dtypes"] != {"bfloat16/bfloat16/bfloat16": want} \
            or counts["K2_by_act"] != {"relu": want} \
            or counts["K1"] or counts["flash"] or len(ends) != steps:
        raise AssertionError(f"fpn_train counts {counts} for {steps} steps and "
                             f"{forwards - steps} validation forwards")
    warm = _last_epoch_steps(ends, steps, FPN_EPOCHS)
    step_ms = statistics.median(warm)
    emit({"phase": "fpn_train", "model": "bench.py config 12's FPN detector "
                                         "(create_fpn_detector, fpn_channels 64)",
          "hp": FPN_HP, "cut": {"depth": "none", "validation": "after the last epoch "
                                                               "(bench.py: off), for map50",
                                "checkpoints": "off"},
          "image_size": FPN_SIZE, "grids": FPN_GRIDS, "batch": FPN_BATCH, "steps": steps,
          "data": "generate_shapes_dataset_fpn(seed=0); train images sha256 " + hashlib.sha256(
              datasets["trainset"].dataset.images.tobytes()).hexdigest()[:16],
          "data_s": data_s, "train_images": len(datasets["trainset"]), "valid_images": n_valid,
          "parameters": model.capacity(), "loss": losses, "valid": h["valid"],
          "step_ms": step_ms, "step_ms_warm_range": [min(warm), max(warm)],
          "img_per_s": FPN_BATCH / step_ms * 1e3, "throughput_img_s": h["throughput_img_s"],
          "validation_pass_s": val_walls, "wall_s": wall, "launches": counts,
          "validation_forwards": forwards - steps,
          "launches_per_forward": {"K2": counts["K2"] / forwards},
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card})
    del model, out, datasets
    torch.cuda.empty_cache()
    return counts["K2"], step_ms


#: an FPN detector step's groups found by profiler ranges (and the backward
#: of what runs in them): the FPN's convs (plain F.conv2d, cuDNN), its
#: nearest resize, the focal loss, the metrics train_step computes
FPN_RANGES = ((port_nn.Conv2d, "forward", "fpn_convs"),
              (port_nn, "interpolate", "nearest_resize"),
              (det_pipeline, "detection_loss_focal", "focal_loss"),
              (det_pipeline, "objectness_accuracy", "metrics"))
FPN_BACKWARD_GROUPS = (("K2_backward", K2_BACKWARD_NODE),
                       ("adamw", "Optimizer.step#AdamW.step"))


def phase_fpn_train_profile(card, step_ms):
    """:func:`fpn_train_profile` in a process of its own
    (``chip_smoke.py --fpn-profile STEP_MS CARD``), as unet_train_profile
    runs (a fresh process keeps every device record), its lines passed on."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--fpn-profile",
                           repr(step_ms), card], capture_output=True, text=True,
                          timeout=FPN_PROFILE_PROCESS_S, cwd=REPO)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    sys.stderr.write(proc.stderr)
    sys.stderr.flush()
    if proc.returncode != 0:
        raise AssertionError(f"fpn_train_profile: its process exited {proc.returncode}")


def fpn_train_profile(card, step_ms, tries=3):
    """Where an FPN detector step's device time goes: after one unprofiled
    step, a fresh model trained for :data:`FPN_PROFILE_STEPS` steps of
    fpn_train's data (validation off) under torch.profiler with
    :data:`FPN_RANGES`: device ms a step by group (K2's forward and
    backward, the FPN's cuDNN convs, the nearest resize, the focal loss,
    the metrics, AdamW, copies, the rest), the ten largest kernels and the
    device's idle share of fpn_train's unprofiled step ``step_ms``. The
    profiler must have recorded every K2 launch the wrapper counted, or the
    run is repeated, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    datasets = _fpn_datasets(FPN_IMAGES)
    train = datasets["trainset"]

    def first(n):
        return {"trainset": PreprocessedDataset(train.dataset.subset(np.arange(n)),
                                                train.transform),
                "validset": datasets["validset"]}

    hp = {**FPN_HP, "epochs": 1, "validate_every_epochs": 1000,
          "output_path": str(_build.BUILD_DIR / "fpn_train_profile")}
    warm = first(FPN_BATCH)
    det_pipeline.train_fpn_detector(warm, det_pipeline.create_fpn_detector(
        warm, FPN_BACKBONE, device=DEVICE), hp)
    sub = first(FPN_PROFILE_STEPS * FPN_BATCH)
    for run in range(1, tries + 1):
        model = det_pipeline.create_fpn_detector(sub, FPN_BACKBONE, device=DEVICE)
        torch.cuda.empty_cache()
        with _annotated_modules(FPN_RANGES), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, counts, _, _ = _counted(lambda: det_pipeline.train_fpn_detector(sub, model, hp))
            torch.cuda.synchronize()
        groups, kernels, _, k2 = _range_profile_groups(prof, FPN_BACKWARD_GROUPS)
        if k2 == counts["K2"]:
            break
    else:
        raise AssertionError(f"fpn_train_profile: {k2} K2 launches recorded of "
                             f"{counts['K2']} in each of {tries} tries")
    steps = FPN_PROFILE_STEPS
    if counts["K2"] != FPN_CONVS_PER_FORWARD * steps:
        raise AssertionError(f"fpn_train_profile: counts {counts} for {steps} steps")
    upload = groups.pop("upload", 0.0)     # the dataset, once per run
    busy = sum(groups.values()) / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "fpn_train_profile", "steps": steps,
          "device_ms_per_step": {g: ms / steps for g, ms in groups.most_common()},
          "upload_ms_per_run": upload, "device_busy_ms_per_step": busy,
          "step_ms_unprofiled": step_ms, "device_idle_share": 1.0 - busy / step_ms,
          "top_kernels_ms_per_step": [[name[:90], ms / steps, n] for name, (ms, n) in top],
          "k2_launches_recorded": k2, "profiled_runs": run, "launches": counts,
          "card": card})


def _match_chain(encoder, img_a, img_b, k):
    """bench.py config 4's chain: encode both images, dense unit-norm
    descriptors, the top-k keypoints of each map's mean |activation|, their
    descriptors, per-pair mutual nearest neighbours. Returns (keypoints a,
    keypoints b, matches, valid)."""
    fa, fb = encoder(img_a).float(), encoder(img_b).float()
    da = kp_pipeline.extract_dense_descriptors(fa)
    db = kp_pipeline.extract_dense_descriptors(fb)
    ka, _ = kp_pipeline.extract_keypoints(fa.abs().mean(-1), k=k)
    kb, _ = kp_pipeline.extract_keypoints(fb.abs().mean(-1), k=k)
    w, c = fa.shape[2], da.shape[-1]
    sa = da.gather(1, (ka[..., 0] * w + ka[..., 1])[..., None].expand(-1, -1, c))
    sb = db.gather(1, (kb[..., 0] * w + kb[..., 1])[..., None].expand(-1, -1, c))
    return (ka, kb, *kp_pipeline.match_descriptors(sa, sb, mutual=True))


def _adalam_all(ka, kb, matches, valid, gumbel):
    """filter_matches_adalam on every pair with the given Gumbel draws."""
    return torch.stack([kp_pipeline.filter_matches_adalam(
        ka[i], kb[i], matches[i], valid[i], gumbel=gumbel[i].to(ka.device))
        for i in range(len(ka))])


def phase_keypoints_match(card):
    """bench.py config 4 in the port: the conf's encoder at 64x64 in bf16
    eval, 64 pairs (``img_b = img_a + 0.02 noise``), K = 256: pairs/s of the
    whole chain (:func:`_match_chain`) over 20 iterations by CUDA events, 1
    K2 launch an encoder forward; ``filter_matches_adalam`` on the first
    pair and its surviving share. Then the same chain in float32 on the card
    and on the CPU (same weights and inputs): the keypoints, and the matched
    indices and validity, agree for at least 99 %, and so do the AdaLAM
    masks of every pair given the same Gumbel draws. Config 4's classical
    half is ``classical_match``. Returns the bf16 K2 launches and the
    pairs/s."""
    hp = conf_hp("keypoints_encoder_model")
    shape = (MATCH_SIZE, MATCH_SIZE, 3)
    encoder = DeepcvModule(shape, hp, device=DEVICE, dtype="bfloat16").eval()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    img_a = torch.rand((MATCH_PAIRS, *shape), generator=gen, device=DEVICE)
    img_b = img_a + 0.02 * torch.randn(img_a.shape, generator=gen, device=DEVICE)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed():
        start.record()
        for i in range(MATCH_ITERS):
            out = _match_chain(encoder, img_a, img_b + i * 1e-3, MATCH_K)
        end.record()
        torch.cuda.synchronize()
        return out

    with torch.no_grad():
        _match_chain(encoder, img_a, img_a, MATCH_K)
        torch.cuda.synchronize()
        (ka, kb, matches, valid), _, counts, _, _ = _counted(timed)
        t0 = time.perf_counter()
        kept = kp_pipeline.filter_matches_adalam(ka[0], kb[0], matches[0], valid[0])
        torch.cuda.synchronize()
        adalam_ms = (time.perf_counter() - t0) * 1e3
    ms = start.elapsed_time(end)
    launches = counts["K2"]
    if launches != 2 * MATCH_ITERS or counts["K2_by_dtype"] != {"float32": 0,
                                                                "bfloat16": launches} \
            or counts["K1"] or counts["flash"]:
        raise AssertionError(f"keypoints_match: counts {counts} for {2 * MATCH_ITERS} "
                             "encoder forwards")

    # the float32 chain on the card against the CPU
    cpu_enc = DeepcvModule(shape, hp, device="cpu").eval()
    gpu_enc = DeepcvModule(shape, hp, device=DEVICE).eval()
    gpu_enc.load_state_dict(cpu_enc.state_dict())
    xa, xb = img_a[:8].cpu(), img_b[:8].cpu()
    with torch.no_grad():
        got = _match_chain(gpu_enc, xa.to(DEVICE), xb.to(DEVICE), MATCH_K)
        ref = _match_chain(cpu_enc, xa, xb, MATCH_K)
        gumbel = -torch.log(-torch.log(torch.rand(
            (len(xa), min(32, MATCH_K), 16, MATCH_K),
            generator=torch.Generator().manual_seed(SEED + 5)).clamp(1e-12, 1 - 1e-7)))
        mask_got = _adalam_all(*got, gumbel).cpu()
        mask_ref = _adalam_all(*ref, gumbel)
    got = [t.cpu() for t in got]
    same_kp = float(((got[0] == ref[0]).all(-1) & (got[1] == ref[1]).all(-1)).float().mean())
    same_match = float(((got[2] == ref[2]) & (got[3] == ref[3])).float().mean())
    same_mask = float((mask_got == mask_ref).float().mean())
    line = {"phase": "keypoints_match", "config": "bench.py config 4 (bench.py:256-341)",
            "encoder": "conf keypoints_encoder_model at 64x64x3, bf16, eval",
            "encoder_parameters": encoder.capacity(), "pairs": MATCH_PAIRS,
            "keypoints_per_image": MATCH_K, "iterations": MATCH_ITERS,
            "ms_per_iteration": ms / MATCH_ITERS, "pairs_per_s": MATCH_PAIRS * MATCH_ITERS
            / ms * 1e3, "launches": counts,
            "k2_launches_per_encoder_forward": launches / (2 * MATCH_ITERS),
            "mutual_matches_share_first_pair": float(valid[0].float().mean()),
            "adalam_first_pair": {"valid": int(valid[0].sum()), "kept": int(kept.sum()),
                                  "surviving_share": float(kept.sum() / valid[0].sum().clamp(
                                      min=1)), "wall_ms": adalam_ms},
            "cpu_check": {"pairs": len(xa), "dtype": "float32", "tf32": False,
                          "keypoints_agree": same_kp, "matches_agree": same_match,
                          "adalam_masks_agree": same_mask, "bound": MATCH_AGREE},
            "card": card}
    emit(line)
    if not min(same_kp, same_match, same_mask) >= MATCH_AGREE:
        raise AssertionError(f"keypoints_match CPU check failed: {line}")
    del encoder, cpu_enc, gpu_enc
    torch.cuda.empty_cache()
    return launches, line["pairs_per_s"]


def phase_video_cpu_check(card, models):
    """One float32 forward (eval, TF32 off, batch 8 of the validation set)
    of each trained video model on the card against a copy on the CPU
    (within rel L2 :data:`SERVE_REL_L2`, no K2 launch); then ``flow_warp``
    and ``interpolate_frames`` on the flow set's pairs with the trained flow
    model's flow, on the card against the CPU (within ``VIDEO_OP_TOL``)."""
    for label, (gpu, datasets) in models.items():
        valid = datasets["validset"]
        x = valid.batch_transform(torch.from_numpy(
            valid.dataset.images[:VIDEO_CHECK_BATCH]).to(DEVICE), augment=False)
        cpu = copy.deepcopy(gpu).cpu().eval()
        k2 = fused_conv2d_bias_act.launches
        with torch.no_grad():
            got = gpu.eval()(x).cpu()
            ref = cpu(x.cpu())
        k2 = fused_conv2d_bias_act.launches - k2
        rel_l2 = ((got - ref).norm() / ref.norm()).item()
        line = {"phase": "video_cpu_check", "model": label, "class": type(gpu).__name__,
                "batch": VIDEO_CHECK_BATCH, "input_shape": list(x.shape[1:]),
                "dtype": "float32", "tf32": False, "rel_l2": rel_l2,
                "bound_rel_l2": SERVE_REL_L2, "k2_launches": k2,
                "finite": bool(torch.isfinite(got).all()), "card": card}
        emit(line)
        if not (rel_l2 <= SERVE_REL_L2 and k2 == 0 and line["finite"]):
            raise AssertionError(f"video_cpu_check failed: {line}")
        if label == "flow":
            with torch.no_grad():
                flow = gpu(x)
            a, b = x[..., :3], x[..., 3:]
            errs = {}
            for name, fn in (("flow_warp", lambda a, b, f: video_pipeline.flow_warp(b, f)),
                             ("interpolate_frames", lambda a, b, f:
                              video_pipeline.interpolate_frames(a, b, flow=f))):
                on_card = fn(a, b, flow).cpu()
                on_cpu = fn(a.cpu(), b.cpu(), flow.cpu())
                errs[name] = (on_card - on_cpu).abs().max().item()
            line = {"phase": "video_cpu_check", "ops": errs, "bound_abs": VIDEO_OP_TOL,
                    "flow_range": [flow.min().item(), flow.max().item()],
                    "pairs": VIDEO_CHECK_BATCH, "image_size": list(a.shape[1:3]), "card": card}
            emit(line)
            if not all(e <= VIDEO_OP_TOL for e in errs.values()):
                raise AssertionError(f"video_cpu_check failed: {line}")
    models.clear()
    torch.cuda.empty_cache()


def tracking_clip(frames=TRACK_FRAMES, objects=TRACK_OBJECTS, rows=TRACK_ROWS, seed=SEED,
                  frame_wh=TRACK_FRAME_WH):
    """A synthetic detection clip: ``objects`` horizontal lanes 22 px apart
    (12x16 boxes, so no two boxes ever overlap), each holding one object
    after another: born at a random x, moving at a constant velocity of up
    to 3 px a frame (bouncing at the frame's edges) with 0.5 px of position
    jitter, living 100-500 frames, then a gap of 5-40 frames; 5 % of the
    detections dropped. Each frame's detections sit in ``rows`` padded rows
    in a shuffled order. Returns (F, rows, 4) float32 xyxy boxes, the (F,
    rows) bool mask and the (F, rows) int32 ground-truth identities."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((frames, rows, 4), np.float32)
    mask = np.zeros((frames, rows), bool)
    gt_ids = np.zeros((frames, rows), np.int32)
    width = frame_wh[0] - 12
    alive = [[] for _ in range(frames)]          # (identity, x, y) a frame
    next_id = 0
    for lane in range(objects):
        y = 20.0 + 22.0 * lane
        t = int(rng.integers(0, 60))
        while t < frames:
            life = int(rng.integers(100, 501))
            x, v = rng.uniform(0, width), rng.uniform(-3.0, 3.0)
            for f in range(t, min(frames, t + life)):
                alive[f].append((next_id, x, y))
                x += v
                if not 0.0 <= x <= width:
                    v, x = -v, min(max(x, 0.0), float(width))
            next_id += 1
            t += life + int(rng.integers(5, 41))
    for f, objs in enumerate(alive):
        order = rng.permutation(rows)[:len(objs)]
        for row, (ident, x, y) in zip(order, objs):
            jx, jy = rng.normal(0.0, 0.5, 2)
            boxes[f, row] = (x + jx, y + jy, x + jx + 12.0, y + jy + 16.0)
            mask[f, row] = rng.uniform() >= 0.05
            gt_ids[f, row] = ident
    return torch.from_numpy(boxes), torch.from_numpy(mask), torch.from_numpy(gt_ids)


def phase_tracking(card):
    """``track_sequence`` (max_tracks 128) and ``mot_metrics`` on
    :func:`tracking_clip`, on the card and on the CPU: the ids equal on every
    row, the counts equal, MOTA within ``MOTA_TOL``; frames/s of each (the
    card's after 20 warm-up frames). The ground truth is every object alive
    in a frame, dropped detections included (they count as misses)."""
    boxes, mask, gt_ids = tracking_clip()
    gt_mask = boxes.abs().sum(-1) > 0
    n_ids = int(gt_ids.max()) + 1
    track = functools.partial(tracking_pipeline.track_sequence, max_tracks=TRACK_SLOTS)
    dev = [t.to(DEVICE) for t in (boxes, mask, gt_ids, gt_mask)]
    track(dev[0][:20], dev[1][:20])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = track(dev[0], dev[1])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = track(boxes, mask)
    cpu_s = time.perf_counter() - t0
    got = got.cpu()
    differ = (got != ref).any(-1).nonzero()
    t0 = time.perf_counter()
    m_got = tracking_pipeline.mot_metrics(dev[0], dev[2], dev[3], dev[0], got.to(DEVICE), dev[1],
                                          max_gt_ids=n_ids)
    m_got = {k: v.item() for k, v in m_got.items()}
    metrics_card_s = time.perf_counter() - t0
    m_ref = {k: v.item() for k, v in tracking_pipeline.mot_metrics(
        boxes, gt_ids, gt_mask, boxes, ref, mask, max_gt_ids=n_ids).items()}
    line = {"phase": "tracking", "frames": len(boxes), "frame_wh": list(TRACK_FRAME_WH),
            "lanes": TRACK_OBJECTS, "objects": n_ids, "rows": TRACK_ROWS,
            "max_tracks": TRACK_SLOTS, "detections": int(mask.sum()),
            "ground_truth": int(gt_mask.sum()),
            "ids_equal": not len(differ),
            "first_frame_apart": int(differ[0, 0]) if len(differ) else None,
            "tracks_born": int(ref.max()) + 1, "card_s": card_s, "cpu_s": cpu_s,
            "frames_per_s": len(boxes) / card_s, "cpu_frames_per_s": len(boxes) / cpu_s,
            "mot_metrics_card_s": metrics_card_s, "metrics": m_got, "cpu_metrics": m_ref,
            "card": card}
    emit(line)
    counts_equal = all(m_got[k] == m_ref[k] for k in m_ref if k != "mota")
    if len(differ) or not counts_equal or abs(m_got["mota"] - m_ref["mota"]) > MOTA_TOL \
            or not (ref[mask] >= 0).all():
        raise AssertionError(f"tracking failed: {line}")


# --------------------------------------------------------------------------- #
# int8_conv and w8a8 serving (bench.py config 8), MC-dropout, ensembles
# --------------------------------------------------------------------------- #

INT8_TOP_S = 1979e12       # H100 SXM, dense int8 on the tensor cores
INT8_BATCH = {"wide": 4096, "resnet50": 256}
INT8_SHAPE = {"wide": (32, 32, 3), "resnet50": IMAGE_SHAPE}
INT8_PER_FORWARD = {"wide": 6, "resnet50": 53}
INT8_CALIB = {"wide": 256, "resnet50": 64}          # bench.py's calibration images
INT8_DRAWS = 5                                      # bench.py's alternating draws
INT8_TIMER_ITERS = 3                                # cut from bench.py's 40
INT8_AGREE = 512                                    # bench.py's agreement rows, min(512, B)
INT8_CPU_CHECK = {"wide": 64, "resnet50": 8}        # rows of the f32 card-vs-CPU check
INT8_TIE_TOL = 2e-2        # int8 forwards past a rounding tie (the CPU tests' bound)
#: beyond the two models' convs: a depthwise 3x3 (MobileNet's, the dp4a
#: route) and a ragged one (odd sizes, 5 -> 7 channels); then edge shapes of
#: the tensor-core route: pixels not a multiple of the 128-pixel tile, 72
#: and 8 output channels, 3 input channels at 7x7 and at 3x3 (A byte by
#: byte), dilation 2, a 1-d and a 3-d conv, and K = 3 x 3 x 512 = 4,608
#: with every code at -127 (the largest int32 sum, 127^2 x 4,608)
INT8_EXTRA_CONVS = {"depthwise": (256, 56, 56, 144, 144, 3, 1, 1, 144),
                    "ragged": (7, 13, 29, 5, 7, 3, 2, 1, 1),
                    "pixels_ragged": (3, 13, 17, 64, 128, 3, 1, 1, 1),
                    "cout_72": (4, 28, 28, 64, 72, 3, 1, 1, 1),
                    "cout_8": (4, 28, 28, 64, 8, 3, 1, 1, 1),
                    "cin_3_7x7": (8, 224, 224, 3, 64, 7, 2, 3, 1),
                    "cin_3_3x3": (64, 32, 32, 3, 64, 3, 1, 1, 1),
                    "dilation_2": dict(n=8, spatial=(28, 28), cin=64, cout=64, k=(3, 3),
                                       stride=1, pad=2, dil=2),
                    "conv1d": dict(n=16, spatial=(100,), cin=64, cout=96, k=(5,), stride=2,
                                   pad=2),
                    "conv3d": dict(n=4, spatial=(8, 14, 14), cin=32, cout=64, k=(3, 3, 3),
                                   stride=1, pad=1),
                    "k4608_all_min": dict(n=4, spatial=(7, 7), cin=512, cout=512, k=(3, 3),
                                          stride=1, pad=1, fill=-127)}
QAT_PARAMS = ("wide_classifier_model.quantize:int8_qat", "train_wide_classifier.epochs:1",
              "train_wide_classifier.validate_every_epochs:2",
              "cifar10_preprocessing.split_dataset.validset_ratio:0.6")
QAT_STEPS = 19             # 20,000 of CIFAR-10's 50,000 images at batch 1024
MC_SAMPLES = 4
ENSEMBLE_TOL = 1e-5
STACK_TOL = 1e-4           # stacker weights after 300 Adam steps, card vs CPU


def _int8_case(case):
    """A conv of the int8 tables as a dict: n, spatial, cin, cout, k, stride,
    pad, dil, groups and fill (None: random codes); a 9-tuple (N, H, W, Cin,
    Cout, k, stride, padding, groups) is a square 2-d conv."""
    if isinstance(case, dict):
        return {"stride": 1, "pad": 0, "dil": 1, "groups": 1, "fill": None, **case}
    n, h, w, cin, cout, k, stride, pad, groups = case
    return {"n": n, "spatial": (h, w), "cin": cin, "cout": cout, "k": (k, k),
            "stride": stride, "pad": pad, "dil": 1, "groups": groups, "fill": None}


def _int8_out_spatial(c):
    rank = len(c["spatial"])
    return conv_output_shape(c["spatial"], c["k"], (c["stride"],) * rank, (c["pad"],) * rank,
                             (c["dil"],) * rank)


def _int8_ops(case):
    c = _int8_case(case)
    return 2.0 * c["n"] * math.prod(_int8_out_spatial(c)) * c["cout"] \
        * (c["cin"] // c["groups"]) * math.prod(c["k"])


def int8_conv_bound(case, out_bytes=2):
    """Least time of one int8 conv on an H100 SXM: int8 operations at the
    tensor cores' dense peak, or the bytes (int8 in, ``out_bytes`` out, the
    scales) at the memory rate. Returns (ms, bound_by)."""
    c = _int8_case(case)
    pix_out = c["n"] * math.prod(_int8_out_spatial(c))
    nbytes = c["n"] * math.prod(c["spatial"]) * c["cin"] \
        + c["cout"] * (c["cin"] // c["groups"]) * math.prod(c["k"]) \
        + pix_out * c["cout"] * out_bytes + 4 * (c["cout"] + 1)
    t_ops, t_bytes = _int8_ops(c) / INT8_TOP_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _int8_serve_hp(name):
    if name == "wide":
        hp = copy.deepcopy(dict(conf_hp("wide_classifier_model")))
        hp["architecture"][-1]["fully_connected"]["out_features"] = 10
        return hp
    return resnet_spec(50, num_classes=1000, pool_kernel=7)


def int8_model_convs(name):
    """(N, H, W, Cin, Cout, k, stride, padding, groups) -> count of one int8
    forward at config 8's batch, from a forward on the meta device."""
    model = DeepcvModule(INT8_SHAPE[name], _int8_serve_hp(name), device="meta",
                         quantize="int8")
    convs = collections.Counter()

    def hook(mod, args):
        n, cin, h, w = args[0].shape
        cout, _, k, _ = mod.weight.shape
        convs[(n, h, w, cin, cout, k, mod.stride[0], mod.padding[0], mod.groups)] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, port_nn.Conv2d) and m.quant is not None]
    with torch.no_grad():
        model(torch.empty((INT8_BATCH[name], *INT8_SHAPE[name]), device="meta"))
    for hnd in handles:
        hnd.remove()
    if sum(convs.values()) != INT8_PER_FORWARD[name]:
        raise AssertionError(f"{name}: {sum(convs.values())} int8 convs a forward")
    return convs


def _int8_row(gen, case, count=1):
    """One int8_conv shape: the kernel against its plain version (int32 sums
    and the bf16 output bit-equal), the route it took and its tile, CUDA-event
    times of the kernel (bf16 out, and its ``return_acc`` launch), of the
    plain version and of the bf16 ``F.conv*d`` at the same shape, and the
    bound; at a 1x1, stride-1, ungrouped conv also ``torch._int_mm`` on the
    same codes, (N H W, C) against (C, O), whose int32 sums must equal the
    kernel's."""
    c = _int8_case(case)
    n, sp, cin, cout, k, groups = c["n"], c["spatial"], c["cin"], c["cout"], c["k"], c["groups"]
    rank = len(sp)
    xq = torch.randint(-127, 128, (n, cin, *sp), generator=gen, device=DEVICE, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, cin // groups, *k), generator=gen, device=DEVICE,
                       dtype=torch.int8)
    if c["fill"] is not None:
        xq.fill_(c["fill"])
        wq.fill_(c["fill"])
    if rank > 1:
        xq = xq.contiguous(memory_format=torch.channels_last if rank == 2
                           else torch.channels_last_3d)
    s_act = torch.rand((), generator=gen, device=DEVICE) * 0.05
    s_w = torch.rand((cout,), generator=gen, device=DEVICE) * 0.01
    args = (xq, wq, s_act, s_w, c["stride"], c["pad"], c["dil"], groups)
    route, _, _, ints = launch_args(xq.shape, wq.shape, (c["stride"],) * rank,
                                    (c["pad"],) * rank, (c["dil"],) * rank, groups)
    by_route = dict(int8_conv.launches_by_route)
    acc = int8_conv(*args, return_acc=True)
    ref_acc = plain_int8_conv(*args, return_acc=True)
    if not torch.equal(acc, ref_acc):
        raise AssertionError(f"int8_conv {c}: int32 sums differ from the plain version in "
                             f"{int((acc != ref_acc).sum())} places")
    acc_max = int(acc.abs().max())
    one_by_one = k == (1,) * rank and c["stride"] == 1 and c["pad"] == 0 and groups == 1
    int_mm = {}
    if one_by_one:
        a2 = xq.movedim(1, -1).reshape(-1, cin)
        b2 = wq.reshape(cout, cin).contiguous().t()
        if not torch.equal(torch._int_mm(a2, b2), acc.movedim(1, -1).reshape(-1, cout)):
            raise AssertionError(f"int8_conv {c}: torch._int_mm's int32 sums differ")
        int_mm = {"int_mm_ms": cuda_ms(lambda: torch._int_mm(a2, b2), iters=5, warmup=2)}
    del acc, ref_acc
    y = int8_conv(*args, out_dtype=torch.bfloat16)
    ref = plain_int8_conv(*args, out_dtype=torch.bfloat16)
    err = float((y.float() - ref.float()).abs().max())
    if err != 0.0 or not torch.equal(y, ref):
        raise AssertionError(f"int8_conv {c}: bf16 output differs by {err}")
    del y, ref
    want = {r: by_route[r] + 2 * (r == route) for r in by_route}
    if int8_conv.launches_by_route != want:
        raise AssertionError(f"int8_conv {c}: launches by route {int8_conv.launches_by_route}, "
                             f"expected {want}")
    xb = xq.to(torch.bfloat16)
    wb = wq.to(torch.bfloat16)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[rank]
    # timed with the weight packed once, as a layer keeps it
    packed = pack_weight_for(wq, groups)
    ms = cuda_ms(lambda: int8_conv(*args, out_dtype=torch.bfloat16, w_packed=packed),
                 iters=5, warmup=1)
    acc_ms = cuda_ms(lambda: int8_conv(*args, return_acc=True, w_packed=packed),
                     iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: plain_int8_conv(*args, out_dtype=torch.bfloat16),
                       iters=1, warmup=0)
    bf16_ms = cuda_ms(lambda: conv(xb, wb, None, c["stride"], c["pad"], c["dil"], groups),
                      iters=5, warmup=2)
    bound_ms, bound_by = int8_conv_bound(c)
    del xq, wq, xb, wb, packed
    row = {"case": {key: c[key] for key in ("n", "spatial", "cin", "cout", "k", "stride",
                                            "pad", "dil", "groups")},
           "count": count, "route": route, "acc_equal": True, "max_abs_err": err,
           "ms": ms, "acc_ms": acc_ms, **int_mm, "plain_ms": plain_ms,
           "bf16_conv_ms": bf16_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "top_s": _int8_ops(c) / (ms * 1e-3) / 1e12}
    if route == "tensor_core":
        row.update(kpad=ints[0], bn=ints[1])
    if c["fill"] is not None:
        row.update(fill=c["fill"], max_abs_acc=acc_max)
    return row


def phase_int8_kernel(card):
    """int8_conv against its plain version at the shapes config 8 serves:
    the wide classifier's six 3x3 convs at batch 4096 and ResNet-50's
    distinct convs at batch 256 (both read from a meta-device int8
    forward), then INT8_EXTRA_CONVS; per-forward sums by count, and at
    ResNet-50's 1x1 stride-1 shapes ``torch._int_mm`` against the kernel's
    ``return_acc`` launch."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    out = {}
    for name in ("wide", "resnet50"):
        rows = [_int8_row(gen, case, count) for case, count in int8_model_convs(name).items()]
        tot = {key: sum(r["count"] * r[key] for r in rows)
               for key in ("ms", "acc_ms", "plain_ms", "bf16_conv_ms", "bound_ms")}
        by_ops = sum(r["count"] * r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        tot["bound_by"] = "operations" if by_ops >= tot["bound_ms"] / 2 else "bytes"
        tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        tot["launches"] = sum(r["count"] for r in rows)
        tot["launches_by_route"] = {r: sum(row["count"] for row in rows if row["route"] == r)
                                    for r in int8_conv.launches_by_route}
        tot["top_s"] = sum(r["count"] * _int8_ops(r["case"]) for r in rows) \
            / (tot["ms"] * 1e-3) / 1e12
        mm = [r for r in rows if "int_mm_ms" in r]
        tot["one_by_one"] = {"shapes": len(mm), "convs": sum(r["count"] for r in mm),
                             **{key: sum(r["count"] * r[key] for r in mm)
                                for key in ("int_mm_ms", "acc_ms", "ms", "bound_ms")}}
        out[name] = tot
        emit({"phase": "int8_kernel", "model": name, "batch": INT8_BATCH[name],
              "out_dtype": "bfloat16", "signatures": rows, "per_forward": tot, "card": card})
        torch.cuda.empty_cache()
    extra = {k: _int8_row(gen, case) for k, case in INT8_EXTRA_CONVS.items()}
    emit({"phase": "int8_kernel", "model": "extra", "out_dtype": "bfloat16", "rows": extra,
          "card": card})
    torch.cuda.empty_cache()
    return out


def _int8_inputs(model, x):
    """The model's output on ``x`` and each int8 op's input to it, {op
    name: (op, input)} in the order the ops ran."""
    seen = {}
    hooks = [op.register_forward_pre_hook(
        lambda m, a, q=q: seen.__setitem__(q, (m, a[0].detach())))
        for q, op in model.named_modules() if getattr(op, "quant", None) is not None]
    with torch.inference_mode():
        out = model(x)
    for hnd in hooks:
        hnd.remove()
    return out, seen


def int8_tie_flips(ref_inputs, got_inputs):
    """Activation codes of each int8 op on two paths, each from its own
    input to the op (:func:`_int8_inputs`). In the first op where any
    differ, every difference must be one code step at a rounding tie of the
    reference input (|x / s - k - 1/2| < 1e-3); the ops after it see inputs
    that the flip moved. Returns the count of differing codes over all ops,
    the first op where any differ (None) and its count."""
    flips, first, first_n = 0, None, 0
    for q, (op, xr) in ref_inputs.items():
        s = op.quant.act_scale
        cr, sr = activation_codes(xr, s)
        cg = activation_codes(got_inputs[q][1], s)[0].cpu()
        diff = cr != cg
        n = int(diff.sum())
        if n and first is None:
            first, first_n = q, n
            step = int((cr.int() - cg.int()).abs().max())
            ratio = xr.double()[diff] / float(sr)
            off = float(((ratio - ratio.trunc()).abs() - 0.5).abs().max())
            if step != 1 or not off < 1e-3:
                raise AssertionError(f"int8 card vs CPU: {n} codes of op {q} differ by up "
                                     f"to {step} steps, {off:.3e} from a rounding tie")
        flips += n
    return flips, first, first_n


def int8_cpu_check(gpu_model, cpu_model, x):
    """One float32 int8 forward on the card against the CPU path (the same
    weights and scales). Each int8 op is first run on the card on the CPU
    path's own input to it: its output must equal the CPU op's (the same
    codes, exact int32 sums, the same rescale). Then the codes of each op
    on either path, each from its own input (:func:`int8_tie_flips`): the
    first op where any differ may differ only by one step at a rounding
    tie, where the two paths' inputs, a few ulps apart after their float ops
    (batch norm, pools), fall on either side of k + 1/2. With no flipped
    code the forwards agree within SERVE_REL_L2; past a flip within
    INT8_TIE_TOL, with the top-1 class equal on 95 % of the rows."""
    ref, ref_inputs = _int8_inputs(cpu_model, x.cpu())
    got, got_inputs = _int8_inputs(gpu_model, x.to(DEVICE))
    got = got.cpu()
    op_err = 0.0
    with torch.inference_mode():
        for q, (op, xin) in ref_inputs.items():
            yout = op(xin)
            diff = (got_inputs[q][0](xin.to(DEVICE)).cpu().float() - yout.float()).abs().max()
            op_err = max(op_err, float(diff))
    flips, first, first_n = int8_tie_flips(ref_inputs, got_inputs)
    rel = float((got - ref).norm() / ref.norm())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    tol = SERVE_REL_L2 if flips == 0 else INT8_TIE_TOL
    if op_err != 0.0 or list(got_inputs) != list(ref_inputs) or not rel <= tol \
            or (flips and agree < 0.95):
        raise AssertionError(f"int8 f32 card vs CPU: ops differ by {op_err}, {flips} codes "
                             f"flipped (first in {first}), forward rel L2 {rel:.3e} "
                             f"(tol {tol}), top-1 agreement {agree}")
    return {"ops": len(ref_inputs), "op_max_abs_err": op_err, "code_flips": flips,
            "first_flip_op": first, "first_op_flips": first_n, "rel_l2": rel,
            "top1_agreement": agree, "tol": tol}


def _route_delta(before):
    """int8_conv's launches by route since the counts were ``before``."""
    return {r: int8_conv.launches_by_route[r] - before[r] for r in before}


def _timer(fn, x):
    """bench.py's timer: one call, a host sync, then ``INT8_TIMER_ITERS``
    calls and a sync; seconds a call."""
    n = INT8_TIMER_ITERS
    with torch.inference_mode():
        float(fn(x).float().sum())
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn(x)
        float(r.float().sum())
    return (time.perf_counter() - t0) / n


def phase_int8_serve(card, data):
    """bench.py config 8 (``bench_serving_int8``) for ``wide`` and
    ``resnet50``: the bf16 model from the seed, static scales calibrated on
    its first images, the int8 build; 5 alternating draws of bf16 and int8
    (3 calls each, cut from 40), the median ratio, img/s and the top-1
    agreement on min(512, B) rows; int8_conv counted from 0 over those calls
    (6 and 53 a forward) and one counted forward with K2 at 0; one float32
    int8 forward on the card against the CPU path. Then a short QAT
    fine-tune of the wide classifier, calibrated and served int8. Returns
    the launches counted on each path and their sum by route, every one on
    the tensor cores."""
    launches, by_route = {}, dict.fromkeys(INT8_ROUTES, 0)
    for name in ("wide", "resnet50"):
        shape, batch = INT8_SHAPE[name], INT8_BATCH[name]
        hp = _int8_serve_hp(name)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        mf = DeepcvModule(shape, hp, device=DEVICE, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(SEED)).eval()
        x = torch.randn((batch, *shape), generator=gen, device=DEVICE).to(torch.bfloat16)
        t0 = time.perf_counter()
        scales = calibrate_int8_scales(mf, [x[:INT8_CALIB[name]].float()])
        calib_s = time.perf_counter() - t0
        ms = mf.with_options(quantize="int8", quantize_scales=scales)
        int8_conv.launches, fused_conv2d_bias_act.launches = 0, 0
        before = dict(int8_conv.launches_by_route)
        with torch.inference_mode():
            ms(x)
        torch.cuda.synchronize()
        one = {"int8_conv": int8_conv.launches, "K2": fused_conv2d_bias_act.launches,
               "int8_conv_by_route": _route_delta(before)}
        if one != {"int8_conv": INT8_PER_FORWARD[name], "K2": 0,
                   "int8_conv_by_route": {"tensor_core": INT8_PER_FORWARD[name], "dp4a": 0}}:
            raise AssertionError(f"int8 {name} forward launched {one}")
        int8_conv.launches = 0
        ratios, t_bf, t_i8 = [], [], []
        for _ in range(INT8_DRAWS):
            a, b = _timer(mf, x), _timer(ms, x)
            t_bf.append(a)
            t_i8.append(b)
            ratios.append(a / b)
        agree_n = min(INT8_AGREE, batch)
        with torch.inference_mode():
            yf, ys = mf(x[:agree_n]), ms(x[:agree_n])
        agree = float((yf.argmax(-1) == ys.argmax(-1)).float().mean())
        int8_forwards = INT8_DRAWS * (INT8_TIMER_ITERS + 1) + 1
        if int8_conv.launches != INT8_PER_FORWARD[name] * int8_forwards \
                or not torch.isfinite(ys.float()).all():
            raise AssertionError(f"int8 {name}: {int8_conv.launches} launches for "
                                 f"{int8_forwards} forwards, finite {bool(torch.isfinite(ys.float()).all())}")
        launches[name] = int8_conv.launches + one["int8_conv"]
        routes = _route_delta(before)
        if routes != {"tensor_core": launches[name], "dp4a": 0}:
            raise AssertionError(f"int8 {name}: {launches[name]} launches, by route {routes}")
        for r in by_route:
            by_route[r] += routes[r]
        # float32 on the card against the CPU path, the same weights and scales
        n_cpu = INT8_CPU_CHECK[name]
        g32 = ms.with_options(dtype=None)
        c32 = DeepcvModule(shape, hp, device="cpu", quantize="int8", quantize_scales=scales,
                           generator=torch.Generator().manual_seed(SEED))
        cpu_check = int8_cpu_check(g32, c32, x[:n_cpu].float())
        ratios.sort()
        emit({"phase": "int8_serve", "model": name, "batch": batch,
              "input_shape": list(shape), "metric": "int8_static_serving_speedup",
              "value": ratios[INT8_DRAWS // 2],
              "unit": f"x vs bf16 (median of {INT8_DRAWS} alternating draws)",
              "ratio_spread": [ratios[0], ratios[-1]],
              "bf16_img_s": batch / statistics.median(t_bf),
              "int8_img_s": batch / statistics.median(t_i8),
              "bf16_ms": statistics.median(t_bf) * 1e3, "int8_ms": statistics.median(t_i8) * 1e3,
              "top1_agreement": agree, "agreement_rows": agree_n,
              "calibration_images": INT8_CALIB[name], "calibration_s": calib_s,
              "scales": len(scales), "one_forward_launches": one,
              "int8_conv_launches": launches[name],
              "f32_card_vs_cpu": {"rows": n_cpu, **cpu_check},
              "cut": {"timer_iters": f"40 -> {INT8_TIMER_ITERS}"}, "data": "synthetic normal",
              "card": card})
        del mf, ms, g32, c32, x, yf, ys
        torch.cuda.empty_cache()
    launches["qat"] = _qat_fine_tune(card, data)
    by_route["tensor_core"] += launches["qat"]
    return launches, by_route


def _qat_fine_tune(card, data):
    """``run --pipeline=train_wide_classifier`` with ``quantize: int8_qat``
    (batch 1024, bf16), cut to one epoch of 19 steps and no validation; the
    trained weights calibrated on 256 validation images and served int8 in
    bf16 against the QAT model's own fake-quant forward on 1,024."""
    store, argv, wall, counts, _, _ = _run_classifier(
        "int8_qat", list(QAT_PARAMS), "train_wide_classifier", "train_wide_classifier")
    h = store["train_results"]["history"]
    losses = [e["main_loss"] for e in h["train"]]
    if h["steps"] != QAT_STEPS or not np.isfinite(losses).all() or counts["K2"] != 0:
        raise AssertionError(f"QAT: {h['steps']} steps, losses {losses}, counts {counts}")
    model = store["model"].eval()
    valid = store["datasets"]["validset"]
    with torch.inference_mode():
        xs = valid.batch_transform(torch.from_numpy(valid.dataset.images[:1024]).to(DEVICE),
                                   augment=False)
    scales = calibrate_int8_scales(model.with_options(quantize=None), [xs[:256].float()])
    served = model.with_options(quantize="int8", quantize_scales=scales)
    with torch.inference_mode():
        int8_conv.launches = 0
        tc_before = int8_conv.launches_by_route["tensor_core"]
        y8 = served(xs)
        launches = int8_conv.launches
        tc_launches = int8_conv.launches_by_route["tensor_core"] - tc_before
        yq = model(xs)
    labels = torch.as_tensor(np.asarray(valid.dataset.targets[:1024]), device=DEVICE)
    agree = float((y8.argmax(-1) == yq.argmax(-1)).float().mean())
    if launches != INT8_PER_FORWARD["wide"] or tc_launches != launches \
            or not torch.isfinite(y8.float()).all():
        raise AssertionError(f"QAT int8 serve: {launches} launches, {tc_launches} on the "
                             "tensor cores")
    emit({"phase": "int8_serve", "model": "wide_qat",
          "argv": ["python", "-m", "deepcv_tpu_torch", "run", *argv],
          "cut": {"epochs": "10 -> 1", "train_images": "50,000 -> 20,000 (validset_ratio 0.6)",
                  "validation": "off"},
          "steps": h["steps"], "loss": losses[-1], "wall_s": wall, "dtype": "bfloat16",
          "data": data, "serve_dtype": "bfloat16", "scales": len(scales),
          "int8_vs_qat_top1_agreement": agree,
          "int8_accuracy": float((y8.argmax(-1) == labels).float().mean()),
          "qat_accuracy": float((yq.argmax(-1) == labels).float().mean()),
          "int8_conv_launches": launches, "card": card})
    del store, model, served
    torch.cuda.empty_cache()
    return launches


def _wide_f32(seed, **hp_extra):
    """The conf's wide classifier hp (10 classes, ``hp_extra`` merged) and a
    generator for its weights."""
    hp = copy.deepcopy(dict(conf_hp("wide_classifier_model")))
    hp["architecture"][-1]["fully_connected"]["out_features"] = 10
    hp.update(hp_extra)
    return hp, torch.Generator().manual_seed(seed)


def phase_serve_extras(card, serve_models):
    """``python -m deepcv_tpu_torch predict`` in this process on the serve
    phase's ResNet-50 weights (as a bundle), float and ``--quantize int8
    --calibrate 64``, held to ``Predictor`` on the same weights, with K2 at
    46 launches for each (the float forward; the int8 run's float
    calibration forward, its int8 forward none) and int8_conv at 0 and 53;
    MC-dropout of the wide classifier with dropout 0.2 on the card (std > 0,
    running statistics unchanged, 6 K2 launches a forward); a two-member
    ``EnsemblePredictor`` and a ``StackedEnsemble`` fit on the card against
    the CPU path, 6 K2 launches a member forward."""
    gpu_model, _ = serve_models
    rng = np.random.default_rng(SEED + 22)
    images = rng.integers(0, 256, (SERVE_BATCH, *IMAGE_SHAPE), dtype=np.uint8)
    norm = ",".join(map(str, IMAGENET_MEAN)) + "/" + ",".join(map(str, IMAGENET_STD))
    rows = {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        save_model_bundle(d, gpu_model)
        np.save(Path(d) / "x.npy", images)
        pred = Predictor(gpu_model, batch_size=SERVE_BATCH, preprocess=_preprocess,
                         device=DEVICE)
        with torch.inference_mode():
            cal = _preprocess(torch.from_numpy(images).to(DEVICE)).float()
        scales = calibrate_int8_scales(gpu_model, [cal])
        refs = {"float": pred(images),
                "int8": Predictor(gpu_model.with_options(quantize="int8", quantize_scales=scales),
                                  batch_size=SERVE_BATCH, preprocess=_preprocess,
                                  device=DEVICE)(images)}
        for mode, extra in (("float", []), ("int8", ["--quantize", "int8", "--calibrate",
                                                     str(SERVE_BATCH)])):
            out = Path(d) / f"{mode}.npy"
            int8_conv.launches, fused_conv2d_bias_act.launches = 0, 0
            before = dict(int8_conv.launches_by_route)
            t0 = time.perf_counter()
            rc = cli.main(["predict", "--bundle", d, "--input", str(Path(d) / "x.npy"),
                           "--output", str(out), "--batch-size", str(SERVE_BATCH),
                           "--to-tensor", "--normalize", norm, "--device", DEVICE, *extra])
            wall = time.perf_counter() - t0
            got = np.load(out)
            rel = float(np.linalg.norm(got - refs[mode]) / np.linalg.norm(refs[mode]))
            want = INT8_PER_FORWARD["resnet50"] if mode == "int8" else 0
            k2 = fused_conv2d_bias_act.launches
            routes = _route_delta(before)
            if rc != 0 or not rel <= 1e-5 or int8_conv.launches != want \
                    or routes != {"tensor_core": want, "dp4a": 0} \
                    or k2 != LAUNCHES_PER_FORWARD:
                raise AssertionError(f"predict {mode}: rc {rc}, rel {rel:.3e}, "
                                     f"{int8_conv.launches} int8_conv ({routes}) and {k2} "
                                     "K2 launches")
            rows[mode] = {"rel_l2_vs_predictor": rel, "int8_conv_launches": int8_conv.launches,
                          "int8_conv_by_route": routes,
                          "K2_launches": k2, "wall_s": wall,
                          "top1_agreement_vs_float": float(
                              (got.argmax(-1) == refs["float"].argmax(-1)).mean())}
    predict_launches = rows["int8"]["int8_conv_launches"]
    predict_k2 = rows["float"]["K2_launches"] + rows["int8"]["K2_launches"]
    emit({"phase": "serve_extras", "part": "predict", "bundle": "resnet_spec(50), serve's weights",
          "images": SERVE_BATCH, "rows": rows, "tol": 1e-5, "card": card})
    # MC-dropout on the card
    hp, gen = _wide_f32(SEED + 1, dropout_prob=0.2)
    model = DeepcvModule((32, 32, 3), hp, device=DEVICE, generator=gen).eval()
    before = {k: v.clone() for k, v in model.named_buffers()}
    x = rng.integers(0, 256, (256, 32, 32, 3), dtype=np.uint8)
    mc = Predictor(model, batch_size=256, preprocess=to_tensor, device=DEVICE)
    fused_conv2d_bias_act.launches = 0
    mean, std = mc.predict_with_uncertainty(x, n_samples=MC_SAMPLES, seed=SEED)
    k2 = fused_conv2d_bias_act.launches
    unchanged = all(torch.equal(v, before[k]) for k, v in model.named_buffers())
    if not (std > 0).mean() > 0.9 or not unchanged or k2 != 6 * MC_SAMPLES \
            or not np.isfinite(mean).all():
        raise AssertionError(f"MC-dropout: std>0 share {(std > 0).mean()}, buffers unchanged "
                             f"{unchanged}, {k2} K2 launches")
    emit({"phase": "serve_extras", "part": "mc_dropout", "model": "wide classifier, dropout 0.2",
          "images": 256, "samples": MC_SAMPLES, "std_positive_share": float((std > 0).mean()),
          "mean_std": float(std.mean()), "running_stats_unchanged": unchanged,
          "K2_launches": k2, "card": card})
    # a two-member ensemble, card against CPU
    members, cpu_members = ([DeepcvModule((32, 32, 3), _wide_f32(SEED + s)[0], device=dev,
                                          generator=_wide_f32(SEED + s)[1]).eval()
                             for s in (2, 3)] for dev in (DEVICE, "cpu"))
    xe = x[:64]
    labels = rng.integers(0, 10, len(xe))
    fused_conv2d_bias_act.launches = 0
    got = EnsemblePredictor(members, batch_size=64, preprocess=to_tensor, device=DEVICE)(xe)
    ref = EnsemblePredictor(cpu_members, batch_size=64, preprocess=to_tensor, device="cpu")(xe)
    err = float(np.abs(got - ref).max())
    stacked = StackedEnsemble(members, batch_size=64, preprocess=to_tensor, device=DEVICE)
    loss = stacked.fit(xe, labels)
    cpu_stacked = StackedEnsemble(cpu_members, batch_size=64, preprocess=to_tensor,
                                  device="cpu")
    cpu_loss = cpu_stacked.fit(xe, labels)
    ens_k2 = fused_conv2d_bias_act.launches
    w_err = max(float((stacked._stack_params[k].cpu() - v).abs().max())
                for k, v in cpu_stacked._stack_params.items())
    on_card = all(v.device.type == "cuda" for v in stacked._stack_params.values())
    if not (err <= ENSEMBLE_TOL and w_err <= STACK_TOL and on_card) \
            or ens_k2 != 6 * len(members) * 2:
        raise AssertionError(f"ensemble card vs CPU: max abs {err:.3e}, stacker weights "
                             f"{w_err:.3e} (on the card {on_card}), {ens_k2} K2 launches")
    emit({"phase": "serve_extras", "part": "ensemble", "members": 2, "mode": "prob",
          "images": len(xe), "max_abs_err_vs_cpu": err, "tol": ENSEMBLE_TOL,
          "stacked_fit": {"steps": 300, "loss": loss, "cpu_loss": cpu_loss,
                          "weights_max_abs_err_vs_cpu": w_err, "tol": STACK_TOL},
          "K2_launches": ens_k2, "card": card})
    del model, members, cpu_members, stacked, cpu_stacked
    torch.cuda.empty_cache()
    return {"int8_conv": predict_launches,
            "int8_conv_by_route": rows["int8"]["int8_conv_by_route"],
            "K2_predict": predict_k2, "K2_mc_dropout": k2,
            "K2_ensemble": ens_k2}


def int8_kernel_line(rows, launches_by_path, launches_by_route, card):
    """``int8_conv``'s entry: launches on the main path (config 8's serving,
    the QAT serve, ``predict --quantize int8``) in all and by route, every
    one on the tensor cores; times per wide and per ResNet-50 forward; no
    PyTorch call computes an int8 conv on CUDA, but at a 1x1, stride-1,
    ungrouped one ``torch._int_mm`` computes the same int32 sums, timed
    against the kernel's ``return_acc`` launch at ResNet-50's 33 (the wide
    classifier has none)."""
    wide, res = rows["wide"], rows["resnet50"]
    launches = sum(launches_by_path.values())
    if launches_by_route != {"tensor_core": launches, "dp4a": 0}:
        raise AssertionError(f"int8_conv main path: {launches} launches, by route "
                             f"{launches_by_route}")
    return {"name": "int8_conv", "route": "cuda", "source": "deepcv_tpu_torch/csrc/int8_conv.cu",
            "replaces": "deepcv_tpu/compression.py:184 (port-only: XLA's int8 conv in the JAX "
                        "package, no TPU kernel)",
            "launches": launches, "launches_by_path": launches_by_path,
            "launches_by_route": launches_by_route,
            "max_abs_err": max(wide["max_abs_err"], res["max_abs_err"]),
            "ms": wide["ms"], "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
            "bound_by": wide["bound_by"], "library_ms": None,
            "bf16_conv2d_ms": wide["bf16_conv_ms"], "top_s": wide["top_s"],
            "per": "one wide classifier int8 forward's 6 convs at batch 4096, 32x32, bf16 "
                   "out (int8_kernel), all on int8_conv_tc_kernel; library_ms null: no "
                   "PyTorch call computes an int8 conv on CUDA and the wide classifier has "
                   "no 1x1; bf16_conv2d_ms is the bf16 F.conv2d at the same shapes",
            "resnet50": {**{k: res[k] for k in ("ms", "acc_ms", "plain_ms", "bound_ms",
                                                "bound_by", "top_s", "launches",
                                                "launches_by_route")},
                         "bf16_conv2d_ms": res["bf16_conv_ms"],
                         "library_ms_1x1": res["one_by_one"]["int_mm_ms"],
                         "acc_ms_1x1": res["one_by_one"]["acc_ms"],
                         "one_by_one": res["one_by_one"]},
            "resnet50_per": "one resnet_spec(50) int8 forward's 53 convs at batch 256, "
                            "224x224, bf16 out; library_ms_1x1: torch._int_mm at its 33 1x1 "
                            "stride-1 convs (12 shapes) against acc_ms_1x1, the kernel's "
                            "return_acc launches at the same shapes (both int32 out)",
            "card": card}


def k1_kernel_line(aug_rows, launches_by_path, card):
    row = aug_rows[(AUGMENT_BATCH, 32, 32, 3)]
    return {"name": "fused_augment_normalize", "route": "cuda",
            "source": "deepcv_tpu_torch/csrc/fused_augment.cu",
            "replaces": "deepcv_tpu/ops/pallas/fused_augment.py:40",
            "launches": sum(launches_by_path.values()), "launches_by_path": launches_by_path,
            "max_abs_err": row["max_abs_err"]["random"],
            "ms": row["ms_noise"], "device_ms": row["device_ms_noise"],
            "device_ms_noise_off": row["device_ms"], "plain_ms": row["plain_ms_noise"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "per": f"one augment_train step: one launch at N,H,W,C {row['shape_nhwc']}, "
                   "noise on, float32 out (device_ms: the kernel's device time, profiler)",
            "card": card}


def k2_routes(line, forward_bf16, forward_f32, bf16_launches, dense_head):
    """K2's entry in the kernels line gains both routes, both on the tensor
    cores: float32 by 3xTF32 (serving ResNet-50, ``classifier_train`` and
    ``dense_train``: the entry's own numbers, per ResNet-50 forward, its
    bound by 3xTF32 with the CUDA-core one beside it, per classifier_train
    forward at batch 32, and the dense head's one launch a forward at batch
    64, ``dense_head``, the kernel phase's row; ``detect_train``: per
    forward of each of the conf's detectors at batch 64; and per forward of
    the conf's autoencoder in its own float32, keypoints_train's f32 row) and
    bfloat16 (``augment_train``: per image_classifier forward at batch
    4096; ``wide_train``: per wide classifier forward at batch 1024;
    ``zoo_train``: per MobileNetV2, MobileNetV3-Large and DenseNet-121
    forward at batch 256; ``unet_train``: per U-Net segmenter forward at
    batch 32, 256x256; ``fpn_train``: per config 12 FPN detector forward at
    batch 512, 64x64; ``keypoints_train``: per autoencoder forward at batch
    32; ``keypoints_match``: per encoder forward at batch 64, 64x64; and
    per ResNet-50 forward at batch 64, the bf16 shape set no main path runs
    yet)."""
    f32_launches = line["launches"] - bf16_launches
    line["launches_by_dtype"] = {"float32": f32_launches, "bfloat16": bf16_launches}
    line["routes"] = {
        "float32": {"kernel": f"{K2_F32_KERNEL}<BN, EXT_ACT> (tensor cores, mma.sync, "
                              "3xTF32)",
                    "launches": f32_launches,
                    **{k: line[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                            "bound_by", "cuda_core_bound_ms", "library_ms",
                                            "library_device_ms", "max_abs_err", "per")},
                    "resnet50_forward": {**forward_f32["resnet_spec(50)"],
                                         "per": f"one resnet_spec(50) forward's 46 stride-1 "
                                                f"convs at batch {SERVE_BATCH}, float32, "
                                                "random inputs (kernel_forward_f32)"},
                    "classifier_train": {**forward_f32["image_classifier"],
                                         "per": "one image_classifier forward at "
                                                "classifier_train's batch 32, float32 "
                                                "(5 launches)"},
                    "dense_train": {**{k: dense_head[k] for k in (
                        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                        "max_rel_err": max(dense_head["rel_err"].values()),
                        "per": "the dense head's one launch a forward at dense_train's "
                               "batch 64: 1x1, 32 -> 4 channels on 8x8 maps, float32 "
                               "(kernel phase, with bias and relu)"},
                    "detect_train": {
                        "single": {**forward_f32["object_detector"],
                                   "per": "one forward of the conf's single-grid detector "
                                          f"at detect_train's batch {DETECT_BATCH}, "
                                          f"{DETECT_SIZE}x{DETECT_SIZE}, float32: 3 3x3 "
                                          "with relu, the 1x1 head (32 -> 8) without"},
                        "fpn": {**forward_f32["fpn_detector_conf"],
                                "per": "one forward of the conf's FPN detector's 4 backbone "
                                       f"convs at detect_train's batch {DETECT_BATCH}, "
                                       f"{DETECT_SIZE}x{DETECT_SIZE}, float32, relu"}},
                    "keypoint_autoencoder": {
                        **forward_f32["keypoint_autoencoder"],
                        "per": f"one forward of the conf's autoencoder at batch "
                               f"{KEYPOINT_BATCH}, 32x32, in the conf's float32 "
                               "(keypoints_train's float32 row)"}},
        "bfloat16": {"kernel": f"{K2_TC_KERNEL}<BN, EXT_ACT> (tensor cores, mma.sync)",
                     "launches": bf16_launches,
                     **forward_bf16["image_classifier"],
                     "per": f"one image_classifier forward at batch {AUGMENT_BATCH}, "
                            "bfloat16 (5 launches)",
                     "wide_classifier": {**forward_bf16["wide_classifier"],
                                         "per": f"one wide classifier forward's "
                                                f"{WIDE_CONVS_PER_FORWARD} convs at batch "
                                                f"{WIDE_BATCH}, bfloat16, leaky_relu "
                                                "(wide_train)"},
                     "resnet50": {**forward_bf16["resnet_spec(50)"],
                                  "per": f"one resnet_spec(50) forward's 46 stride-1 convs "
                                         f"at batch {SERVE_BATCH}, bfloat16 (no main path "
                                         "runs it)"},
                     "mobilenet_v2": {**forward_bf16["mobilenet_v2"],
                                      "per": f"one MobileNetV2 forward's 34 1x1 convs at "
                                             f"batch {TRAIN_BATCH}, bfloat16, relu6 on 17, no "
                                             "bias (zoo_train)"},
                     "mobilenet_v3": {**forward_bf16["mobilenet_v3"],
                                      "per": f"one MobileNetV3-Large forward's 30 1x1 convs "
                                             f"at batch {TRAIN_BATCH}, bfloat16, hard_swish "
                                             "on 10, relu on 5 (zoo_train)"},
                     "densenet_121": {**forward_bf16["densenet_121"],
                                      "per": f"one DenseNet-121 forward's 119 convs at batch "
                                             f"{TRAIN_BATCH}, bfloat16, no activation, no "
                                             "bias (zoo_train's model)"},
                     "fpn_detector": {**forward_bf16["fpn_detector"],
                                      "per": f"one config 12 FPN detector forward's "
                                             f"{FPN_CONVS_PER_FORWARD} backbone convs at batch "
                                             f"{FPN_BATCH}, {FPN_SIZE}x{FPN_SIZE}, bfloat16, "
                                             "relu and bias (fpn_train)"},
                     "keypoint_autoencoder": {
                         **forward_bf16["keypoint_autoencoder"],
                         "per": f"one autoencoder forward's 3 convs at batch "
                                f"{KEYPOINT_BATCH}, 32x32, bfloat16: 2 with relu, the "
                                "16 -> 3 before its sigmoid (keypoints_train)"},
                     "keypoint_encoder": {
                         **forward_bf16["keypoint_encoder"],
                         "per": f"one encoder forward's conv at batch {MATCH_PAIRS}, "
                                f"{MATCH_SIZE}x{MATCH_SIZE}, bfloat16, relu "
                                "(keypoints_match)"},
                     "unet": {**forward_bf16["unet"],
                              "per": f"one U-Net segmenter forward's "
                                     f"{UNET_CONVS_PER_FORWARD} convs at batch {UNET_BATCH}, "
                                     f"{UNET_SIZE}x{UNET_SIZE}, bfloat16: 18 3x3 with relu "
                                     "and no bias, the 1x1 head with bias (unet_train)"}}}


# --------------------------------------------------------------------------- #
# The rest of augmentation and the classical-vision modules
# --------------------------------------------------------------------------- #

AUG_OPS_SHAPE = (4096, 32, 32, 3)      # bench.py config 2's batch
#: PIL-exact ops, card vs CPU: one u8 level on at most this share of pixels
AUG_FLIP_SHARE = 1e-3
FULL_TRAIN_VALID_RATIO = 0.6           # 20,000 training images: 4 steps at 4096
#: ``augment_full_train``'s runs: (label, recipe from the conf or None for
#: bench.py config 1's, extra training hp, route, training forwards a step)
FULL_TRAIN_RUNS = (
    ("basic", "basic_augmentation", (), "eager", 1),
    ("augmix_jsd", "augmix_augmentation",
     ("train_image_classifier.augmix_jsd:{weight: 12.0, views: 2}",), "eager", 3),
    ("mixing", None, ("train_image_classifier.mixup_alpha:0.2",
                      "train_image_classifier.cutmix_alpha:1.0"), "K1", 1))
GEOMETRY_TOL = 1e-4                    # frames and panoramas, card vs CPU
#: homographies, card vs CPU: the largest distance between the two
#: projections of the points, in pixels (the RANSAC threshold is 2)
GEOMETRY_PX = 0.05
#: the panorama's seam: values whose blend weight flips with a homography
#: GEOMETRY_PX apart
GEOMETRY_SEAM_SHARE = 1e-2
VIDEO_FRAMES, VIDEO_BATCH = 96, 32


def _level_flips(got, ref):
    """Card against CPU on the u8 grid: the most levels apart, and the share
    of values one level or more apart."""
    d = (got.float().cpu() - ref.float()).abs() * 255.0
    return float(d.max()), float((d > 0.5).float().mean())


def _aug_op_row(name, kind, gpu_fn, cpu_fn):
    """One op on the card (median of CUDA events) and on the CPU (one call)
    on the same inputs and draws, held to its bound: PIL-exact ops at most
    one u8 level on ``AUG_FLIP_SHARE`` of the values, float ones within
    ``AUG_TOL``, mixes of PIL-exact chains within a level's weight."""
    got = gpu_fn()
    t0 = time.perf_counter()
    ref = cpu_fn()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if isinstance(got, tuple):
        got, ref = got[0], ref[0]
    row = {"op": name, "kind": kind, "ms": cuda_ms(gpu_fn, iters=10, warmup=2),
           "cpu_ms": cpu_ms, "shape": list(got.shape)}
    if kind == "pil":
        row["max_levels"], row["flip_share"] = _level_flips(got, ref)
        ok = row["max_levels"] <= 1.0 + 1e-3 and row["flip_share"] <= AUG_FLIP_SHARE
    else:
        d = (got.float().cpu() - ref.float()).abs()
        row["max_abs_err"] = float(d.max())
        row["share_over_tol"] = float((d > AUG_TOL).float().mean())
        bound = 1.0 / 255 + AUG_TOL if kind == "pil_mix" else AUG_TOL
        ok = row["max_abs_err"] <= bound and (kind != "pil_mix"
                                              or row["share_over_tol"] <= AUG_FLIP_SHARE)
        if kind == "mask":            # box edges from exp/sqrt: whole pixels may move
            ok = row["share_over_tol"] <= AUG_FLIP_SHARE
    row["ok"] = bool(ok)
    return row


def phase_augment_ops(card):
    """Every AugMix op, the geometric and colour transforms, AugMix,
    RandAugment, random erasing, mixup and CutMix at 4096x32x32x3 on the
    card against the CPU on the same images and the same draws (made on the
    CPU), with the u8-level flips counted and each op's ms by CUDA events."""
    from deepcv_tpu_torch.data import augmentation as aug
    from deepcv_tpu_torch.data import transforms as T
    n, h, w, c = AUG_OPS_SHAPE
    rng = np.random.default_rng(SEED + 20)
    x_cpu = torch.from_numpy(rng.integers(0, 256, AUG_OPS_SHAPE, dtype=np.uint8)) \
        .float().div_(255.0)
    x_gpu = x_cpu.to(DEVICE)
    g = torch.Generator().manual_seed(SEED + 21)

    def both(fn, *args):
        gargs = [a.to(DEVICE) if isinstance(a, torch.Tensor) else a for a in args]
        return (lambda: fn(x_gpu, *gargs)), (lambda: fn(x_cpu, *args))

    rows = []
    for name, op in aug.OPS.items():
        values = op.param(aug._levels(n, g, 7.0), aug._signs(n, g), h, w)
        rows.append(_aug_op_row(name, "pil", *both(op.apply, values)))
    m = torch.from_numpy(rng.normal(0, 0.3, (n, 2, 3)).astype(np.float32))
    m[:, 0, 0] += 1
    m[:, 1, 1] += 1
    m[:, :, 2] *= 8
    theta = T.draw_rotate(n, g, 45.0)
    tx, ty = T.draw_translate(n, g, 0.2, h, w)
    top, left = T.draw_crop(n, g, h + 6, w + 6, (h, w))
    chosen = T.draw_flip(n, g, 0.5)
    jitter = T.draw_color_jitter(n, g, 0.4, 0.3, 0.2, 0.1)
    float_ops = [
        ("resize_24", lambda x: T.resize(x, 24)),
        ("center_crop_24", lambda x: T.center_crop(x, 24)),
        ("pad_4_reflect", lambda x: T.pad(x, 4, "reflect")),
        ("adjust_hue", lambda x, f: T.adjust_hue(x, f), T.uniform(n, g, -0.5, 0.5)),
        ("color_jitter", lambda x: T.apply_color_jitter(
            x, {k: v.to(x.device) for k, v in jitter.items()})),
        ("affine_transform", lambda x, mm: T.affine_transform(x, mm), m),
        ("random_rotate", lambda x, t: T.affine_transform(x, T.rotate_matrices(t, h, w)),
         theta),
        ("random_translate", lambda x, a, b: T.affine_transform(
            x, T.translate_matrices(a, b, h, w)), tx, ty),
        ("random_scale", lambda x, s: T.affine_transform(x, T.scale_matrices(s, h, w)),
         T.uniform(n, g, 0.8, 1.2)),
        ("random_crop_pad3", lambda x, a, b: T.crop(T.pad(x, 3), a, b, (h, w)), top, left),
        ("random_horizontal_flip", lambda x, f: T.flip(x, f, 2), chosen)]
    for name, fn, *args in float_ops:
        rows.append(_aug_op_row(name, "float", *both(fn, *args)))
    rows.append(_aug_op_row("affine_transform_pil_exact", "pil", *both(
        lambda x, mm: T.affine_transform(x, mm, pil_exact_u8=True), m)))
    mix = aug.draw_augment_and_mix(n, h, w, g, severity=3, width=3, depth=-1, alpha=1.0)
    rows.append(_aug_op_row("augment_and_mix", "pil_mix", *both(
        lambda x, *d: aug.augment_and_mix_apply(x, *d), mix["ws"], mix["m"],
        mix["depths"], mix["op_idx"], mix["values"])))
    choice, values = aug.draw_rand_augment(n, h, w, g, 2, 5.0)
    rows.append(_aug_op_row("rand_augment", "pil", *both(aug.rand_augment_apply, choice,
                                                         values)))
    choice, values = aug.draw_rand_augment(n, h, w, g, 1, 10.0)
    rows.append(_aug_op_row("trivial_augment", "pil", *both(aug.rand_augment_apply, choice,
                                                            values)))
    er = aug.draw_random_erasing(AUG_OPS_SHAPE, g)
    rows.append(_aug_op_row("random_erasing", "mask", *both(
        lambda x, *d: aug.random_erasing_apply(x, *d), er["gate"], er["area"], er["log_r"],
        er["uy"], er["ux"], er["fill"])))
    rows.append(_aug_op_row("mixup", "float", *both(aug.mixup_apply,
                                                    *aug.draw_mixup(n, g, 0.2))))
    rows.append(_aug_op_row("cutmix", "float", *both(aug.cutmix_apply,
                                                     *aug.draw_cutmix(n, h, w, g, 1.0))))
    bad = [r for r in rows if not r["ok"]]
    emit({"phase": "augment_ops", "shape": list(AUG_OPS_SHAPE),
          "bounds": {"pil": f"<= 1 u8 level on <= {AUG_FLIP_SHARE} of values",
                     "float": AUG_TOL, "pil_mix": f"<= 1/255 + {AUG_TOL}",
                     "mask": f"<= {AUG_FLIP_SHARE} of values over {AUG_TOL}"},
          "draws": "on the CPU, the same for both", "tf32": False, "rows": rows,
          "card": card})
    if bad:
        raise AssertionError(f"augment_ops: card and CPU disagree on {bad}")
    torch.cuda.empty_cache()


def _recipe_param(name):
    """``cifar10_preprocessing.augmentation_recipe`` set to the conf's recipe
    ``name`` (JSON is flow YAML), or to bench.py config 1's."""
    if name is None:
        return f"cifar10_preprocessing.augmentation_recipe:{BENCH_RECIPE}"
    recipes = {k: v for d in conf_hp("augmentations_recipes") for k, v in d.items()}
    return f"cifar10_preprocessing.augmentation_recipe:{json.dumps(recipes[name])}"


def phase_augment_full_train(card):
    """``train_image_classifier`` at bench.py config 1's settings (batch
    4096, bf16) with the conf's ``basic_augmentation`` (eager route:
    posterize and the geometric steps), with ``augmix_augmentation`` plus
    ``augmix_jsd`` (two AugMix views a step, each a forward), and with
    config 1's recipe plus mixup and CutMix (K1 route, one Bernoulli draw a
    batch between them): one epoch of 4 steps each. Each run's routes and
    K1 and K2 launches must be the path's. Returns K2's launches by run."""
    launches = {}
    for label, recipe, extra, route, forwards in FULL_TRAIN_RUNS:
        params = [p for p in _augment_params(1) if "augmentation_recipe" not in p
                  and "validset_ratio" not in p]
        params += [_recipe_param(recipe),
                   f"cifar10_preprocessing.split_dataset.validset_ratio:"
                   f"{FULL_TRAIN_VALID_RATIO}", *extra]
        store, argv, wall, counts, _, step_ends = _run_classifier(
            f"augment_full_train_{label}", params)
        h = store["train_results"]["history"]
        steps = h["steps"]
        last = h["train"][-1]
        bf16 = "bfloat16/bfloat16/bfloat16"
        want_k2 = CLASSIFIER_CONVS_PER_FORWARD * steps * forwards
        want_routes = {"K1": steps if route == "K1" else 0,
                       "eager": steps if route == "eager" else 0}
        ok = (steps > 0 and not h["valid"] and np.isfinite(last["main_loss"])
              and counts["routes"] == want_routes and counts["K1"] == want_routes["K1"]
              and counts["K2"] == want_k2 and counts["K2_dtypes"].get(bf16, 0) == want_k2
              and sum(counts["K2_dtypes"].values()) == want_k2
              and (label != "augmix_jsd" or np.isfinite(last.get("jsd_consistency", np.nan))))
        step_ms = [a.elapsed_time(b) for a, b in zip(step_ends, step_ends[1:])]
        line = {"phase": "augment_full_train", "run": label,
                "argv": ["python", "-m", "deepcv_tpu_torch", "run", *argv],
                "recipe": recipe or "bench.py config 1", "extra_hp": list(extra),
                "batch": AUGMENT_BATCH, "steps": steps,
                "cut": {"epochs": "-> 1", "train_images": f"validset_ratio "
                        f"{FULL_TRAIN_VALID_RATIO}", "validation": "off",
                        "checkpoints": "off"},
                "train_images": len(store["datasets"]["trainset"]),
                "losses": {k: v for k, v in last.items() if k != "step"},
                "step_ms": step_ms, "median_step_ms": statistics.median(step_ms)
                if step_ms else None, "wall_s": wall, "launches": counts,
                "k2_launches_per_step": counts["K2"] / steps,
                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card}
        emit(line)
        if not ok:
            raise AssertionError(f"augment_full_train {label}: want routes {want_routes}, "
                                 f"K2 {want_k2} bf16: {line}")
        launches[label] = counts["K2"]
        del store
        torch.cuda.empty_cache()
    return launches


def phase_classical_match(card, learned_pairs_s):
    """bench.py config 4's classical half (bench.py:306-338) in the port:
    Harris, NMS top-k (K 256), orientations, 256 BRIEF tests and Hamming
    matching by one ``bmm`` for 64 pairs of 64x64 images at once (the
    learned half's inputs), pairs/s over 20 iterations by CUDA events beside
    ``keypoints_match``'s learned pairs/s. Then 8 pairs on the card against
    the CPU: keypoints and matches agree for at least ``MATCH_AGREE``, and a
    descriptor bit differs only where the CPU's two samples are within 1e-5."""
    from deepcv_tpu_torch.pipelines import classical_features as cf
    shape = (MATCH_SIZE, MATCH_SIZE, 3)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    img_a = torch.rand((MATCH_PAIRS, *shape), generator=gen, device=DEVICE)
    img_b = img_a + 0.02 * torch.randn(img_a.shape, generator=gen, device=DEVICE)
    matcher = cf.orb_matcher(k=MATCH_K, n_tests=256)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    matcher(img_a, img_a)
    torch.cuda.synchronize()
    start.record()
    for i in range(MATCH_ITERS):
        out = matcher(img_a, img_b + i * 1e-3)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    pairs_s = MATCH_PAIRS * MATCH_ITERS / ms * 1e3

    xa, xb = img_a[:8].cpu(), img_b[:8].cpu()
    got = [t.cpu() for t in matcher(xa.to(DEVICE), xb.to(DEVICE))]
    ref = matcher(xa, xb)
    same_kp = ((got[0] == ref[0]).all(-1) & (got[1] == ref[1]).all(-1))
    same_match = float(((got[2] == ref[2]) & (got[3] == ref[3])).float().mean())
    gray = xa.mean(-1)
    ca, da, _ = cf.detect_and_describe(xa, k=MATCH_K)
    gca, gda, _ = cf.detect_and_describe(xa.to(DEVICE), k=MATCH_K)
    theta = cf.intensity_orientations(gray, ca)
    vals = cf.orb_test_values(gray, ca, theta)
    rows = (gca.cpu() == ca).all(-1)
    flipped = (gda.cpu() != da) & rows[..., None]
    gap = (vals[..., 0] - vals[..., 1]).abs()
    flips = int(flipped.sum())
    wide_flips = int((flipped & (gap >= 1e-5)).sum())
    line = {"phase": "classical_match", "config": "bench.py config 4, classical half "
            "(bench.py:306-338)", "pairs": MATCH_PAIRS, "image_shape": list(shape),
            "keypoints_per_image": MATCH_K, "tests": 256, "iterations": MATCH_ITERS,
            "ms_per_iteration": ms / MATCH_ITERS, "pairs_per_s": pairs_s,
            "learned_pairs_per_s": learned_pairs_s,
            "learned_vs_classical": learned_pairs_s / pairs_s,
            "mutual_matches_share": float(out[3].float().mean()),
            "cpu_check": {"pairs": len(xa), "keypoints_agree": float(same_kp.float().mean()),
                          "matches_agree": same_match, "bound": MATCH_AGREE,
                          "descriptor_bits_compared": int(rows.sum()) * 256,
                          "bits_flipped": flips, "bits_flipped_with_gap_over_1e-5": wide_flips},
            "launches": "none (no kernel on this path)", "card": card}
    emit(line)
    if not (float(same_kp.float().mean()) >= MATCH_AGREE and same_match >= MATCH_AGREE
            and wide_flips == 0):
        raise AssertionError(f"classical_match CPU check failed: {line}")


def _texture(gen, shape, blur=5):
    """A smooth random texture (H, W, 3) in [0, 1] on ``gen``'s device."""
    x = torch.rand((1, 3, shape[0] + blur - 1, shape[1] + blur - 1), generator=gen,
                   device=gen.device)
    return F.avg_pool2d(x, blur, stride=1)[0].permute(1, 2, 0).contiguous()


def _reproj_px(h_got, h_ref, pts):
    """The largest distance, in pixels, between the projections of (N, 2)
    (x, y) points by two homographies."""
    p = torch.cat([pts.double().cpu(), torch.ones(len(pts), 1, dtype=torch.float64)], 1)

    def proj(h):
        q = p @ h.double().cpu().T
        return q[:, :2] / q[:, 2:]
    return float((proj(h_got) - proj(h_ref)).norm(dim=-1).max())


def phase_geometry(card):
    """``stitch_pair`` (two 128x128 views, 64 pixels of overlap, K 128),
    ``ransac_homography`` (4,096 correspondences, a quarter outliers, 128
    hypotheses of 6), ``stabilize_video`` (64 jittered 128x128 frames) and
    ``remove_watermark`` (64 frames) on the card against the CPU, the RANSAC
    point sets drawn once on the CPU for both: the homographies' projections
    within ``GEOMETRY_PX`` pixels, the inliers equal, the frames within
    ``GEOMETRY_TOL``, the panoramas too but for the seam, where the blend
    weight flips (``GEOMETRY_SEAM_SHARE``); ms by CUDA events."""
    from deepcv_tpu_torch.pipelines import geometry as geo
    gen = torch.Generator().manual_seed(SEED + 30)
    rows = {}

    def timed(name, gpu_fn, cpu_fn, check):
        got = gpu_fn()
        t0 = time.perf_counter()
        ref = cpu_fn()
        cpu_ms = (time.perf_counter() - t0) * 1e3
        rows[name] = {"ms": cuda_ms(gpu_fn, iters=5, warmup=1), "cpu_ms": cpu_ms,
                      **check(got, ref)}

    base = _texture(gen, (128, 192))
    a, b = base[:, :128], base[:, 64:]
    sets = geo.ransac_sets(128, None, gen)

    corners = torch.tensor([[0.0, 0.0], [127.0, 0.0], [0.0, 127.0], [127.0, 127.0]])

    def stitch_check(got, ref):
        d = (got[0].cpu() - ref[0]).abs()
        return {"reproj_px": _reproj_px(got[1], ref[1], corners),
                "inliers_equal": bool(torch.equal(got[2].cpu(), ref[2])),
                "inliers": int(ref[2].sum()), "pano_max_err": float(d.max()),
                "pano_share_over_tol": float((d > GEOMETRY_TOL).float().mean())}
    timed("stitch_pair", lambda: geo.stitch_pair(a.to(DEVICE), b.to(DEVICE), k=128, sets=sets),
          lambda: geo.stitch_pair(a, b, k=128, sets=sets), stitch_check)

    n = 4096
    pa = torch.rand((n, 2), generator=gen) * 512
    hm = torch.tensor([[1.05, 0.02, 3.0], [0.01, 0.98, -2.0], [1e-4, 2e-4, 1.0]])
    ph = torch.cat([pa, torch.ones(n, 1)], 1) @ hm.T
    pb = ph[:, :2] / ph[:, 2:]
    pb[3 * n // 4:] += (torch.rand((n // 4, 2), generator=gen) - 0.5) * 80
    rsets = geo.ransac_sets(n, None, gen)

    def ransac_check(got, ref):
        return {"reproj_px": _reproj_px(got[0], ref[0], pa),
                "inliers_equal": bool(torch.equal(got[1].cpu(), ref[1])),
                "inliers": int(ref[1].sum())}
    timed("ransac_homography", lambda: geo.ransac_homography(
        pa.to(DEVICE), pb.to(DEVICE), sets=rsets), lambda: geo.ransac_homography(
        pa, pb, sets=rsets), ransac_check)

    big = _texture(gen, (160, 160))
    shifts = torch.randint(-4, 5, (64, 2), generator=gen).tolist()
    clip = torch.stack([torch.roll(big, s, (0, 1))[16:144, 16:144] for s in shifts])

    def stab_check(got, ref):
        return {"trajectory_equal": bool(torch.equal(got[1].cpu(), ref[1])),
                "frames_max_err": float((got[0].cpu() - ref[0]).abs().max())}
    timed("stabilize_video", lambda: geo.stabilize_video(clip.to(DEVICE)),
          lambda: geo.stabilize_video(clip), stab_check)

    frames = torch.rand((64, 128, 128, 3), generator=gen)
    alpha = torch.zeros(128, 128)
    alpha[20:60, 30:100] = 0.5
    frames = (1 - alpha[..., None]) * frames + alpha[..., None] * torch.tensor([0.9, 0.2, 0.4])

    def wm_check(got, ref):
        return {"max_err": max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref)),
                "matte_pixels": int((ref[1] > 0).sum())}
    timed("remove_watermark", lambda: geo.remove_watermark(frames.to(DEVICE)),
          lambda: geo.remove_watermark(frames), wm_check)
    ok = (rows["stitch_pair"]["reproj_px"] <= GEOMETRY_PX
          and rows["stitch_pair"]["inliers_equal"]
          and rows["stitch_pair"]["pano_share_over_tol"] <= GEOMETRY_SEAM_SHARE
          and rows["ransac_homography"]["reproj_px"] <= GEOMETRY_PX
          and rows["ransac_homography"]["inliers_equal"]
          and rows["stabilize_video"]["trajectory_equal"]
          and rows["stabilize_video"]["frames_max_err"] <= GEOMETRY_TOL
          and rows["remove_watermark"]["max_err"] <= GEOMETRY_TOL)
    emit({"phase": "geometry", "rows": rows, "bounds": {
        "reproj_px": GEOMETRY_PX, "frames": GEOMETRY_TOL, "pano_seam_share": GEOMETRY_SEAM_SHARE},
        "tf32": False,
          "launches": "none (no kernel on this path)", "card": card})
    if not ok:
        raise AssertionError(f"geometry: card and CPU disagree: {rows}")


def phase_video_predict(card):
    """A 96-frame 32x32 clip written as .y4m (C420jpeg), then ``python -m
    deepcv_tpu_torch predict --input clip.y4m`` on the card and on the CPU
    (the conf's image_classifier, random weights, as a bundle; batch 32,
    float32, 5 K2 launches a forward), and ``process_video`` over the
    clip's frames streamed from the file, on the card and on the CPU: all
    within ``SERVE_REL_L2``. Returns K2's launches on the card."""
    from deepcv_tpu_torch.data.video_io import iter_y4m, process_video, write_y4m
    hp = conf_hp("image_classifier_model")
    hp["architecture"][-1]["fully_connected"]["out_features"] = 10
    torch.manual_seed(SEED + 40)
    cpu_model = DeepcvModule((32, 32, 3), hp, device="cpu").eval()
    gpu_model = DeepcvModule((32, 32, 3), hp, device=DEVICE).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(SEED + 41)
    clip = rng.integers(0, 256, (VIDEO_FRAMES, 32, 32, 3), dtype=np.uint8)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        d = Path(d)
        path = d / "clip.y4m"
        write_y4m(path, clip)
        save_model_bundle(d / "bundle", cpu_model)
        outs, walls = {}, {}
        for dev in (DEVICE, "cpu"):
            argv = ["predict", "--bundle", str(d / "bundle"), "--input", str(path),
                    "--output", str(d / f"{dev}.npy"), "--to-tensor",
                    "--batch-size", str(VIDEO_BATCH), "--device", dev]
            rc, wall, counts, _, _ = _counted(lambda: cli.main(argv))
            if rc != 0:
                raise AssertionError(f"video_predict: predict on {dev} exited {rc}")
            outs[dev], walls[dev] = np.load(d / f"{dev}.npy"), wall
            if dev == DEVICE:
                predict_counts = counts

        def stream(model, dev):
            def fn(x):
                with torch.no_grad():
                    return model(to_tensor(x))
            return process_video(iter_y4m(path)[1], fn, batch_size=VIDEO_BATCH, device=dev)

        pv_gpu, pv_wall, pv_counts, _, _ = _counted(lambda: stream(gpu_model, DEVICE))
        pv_cpu = stream(cpu_model, "cpu")

    def rel(got, ref):
        return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))

    forwards = math.ceil(VIDEO_FRAMES / VIDEO_BATCH)
    want = CLASSIFIER_CONVS_PER_FORWARD * forwards
    line = {"phase": "video_predict", "frames": VIDEO_FRAMES, "frame_shape": [32, 32, 3],
            "chroma": "420jpeg", "batch": VIDEO_BATCH,
            "model": "conf image_classifier_model, 10 classes, random weights, float32",
            "predict": {"rel_l2_card_vs_cpu": rel(outs[DEVICE], outs["cpu"]),
                        "wall_s": walls, "launches": predict_counts},
            "process_video": {"rel_l2_card_vs_cpu": rel(pv_gpu, pv_cpu),
                              "rel_l2_vs_predict": rel(pv_gpu, outs[DEVICE]),
                              "wall_s": pv_wall, "frames_per_s": VIDEO_FRAMES / pv_wall,
                              "launches": pv_counts},
            "bound_rel_l2": SERVE_REL_L2, "tf32": False, "card": card}
    emit(line)
    if not (line["predict"]["rel_l2_card_vs_cpu"] <= SERVE_REL_L2
            and line["process_video"]["rel_l2_card_vs_cpu"] <= SERVE_REL_L2
            and line["process_video"]["rel_l2_vs_predict"] <= SERVE_REL_L2
            and predict_counts["K2"] == want and pv_counts["K2"] == want
            and predict_counts["K2_by_dtype"]["float32"] == want):
        raise AssertionError(f"video_predict failed (want {want} f32 K2 launches each): {line}")
    return predict_counts["K2"] + pv_counts["K2"]


# --------------------------------------------------------------------------- #
# The training runtime: the streaming input path, the optimizers, the update
# chain, remat, UDA and partial runs
# --------------------------------------------------------------------------- #

#: bench.py config 7 (``bench_streaming``): 131,072 random-walk 32x32x3
#: images in a memmap, validset_ratio 0.03, batch 4096, bfloat16, 2 epochs,
#: AdamW lr 1e-3, no validation, no checkpoints, wire compression off
STREAM_IMAGES, STREAM_BATCH = 131_072, 4096
STREAM_HP = {"epochs": 2, "batch_size": STREAM_BATCH, "optimizer_opts": {"lr": 1e-3},
             "save_every_iters": 0, "log_progress_every_iters": 1_000_000,
             "validate_every_epochs": 1000, "seed": 0, "dtype": "bfloat16",
             "handle_preemption": False, "wire_compression": False,
             "device_resident_dataset": False}
STREAM_CPU_STEPS = 2          # first steps held against the CPU path
#: bench.py config 7's wire codec (its ``run(codec)``): 3-bit codes, deltas
#: along W
STREAM_WIRE = {"bits": 3, "axis": -2}
#: the wire-feed microbenchmark's timed draws (bench.py's ``feed``: 3)
STREAM_FEED_REPS = 5
#: the runtime runs' trainset: 4 steps of 4,096 (config 1's batch)
RUNTIME_VALID_RATIO = 0.67
RUNTIME_BASE = {"epochs": 1, "batch_size": AUGMENT_BATCH, "dtype": "bfloat16",
                "optimizer": "adamw", "save_every_iters": 0, "log_progress_every_iters": 1,
                "optimizer_opts": {"lr": 1e-3, "betas": [0.9, 0.999], "weight_decay": 1e-2},
                "validate_every_epochs": 1000, "handle_preemption": False, "seed": SEED}
#: (label, hp overrides, K2 launches a training step)
RUNTIME_RUNS = (
    ("opt_adamw", {}, 5),
    ("opt_adam", {"optimizer": "adam", "optimizer_opts": {"lr": 1e-3}}, 5),
    ("opt_sgd", {"optimizer": "sgd", "optimizer_opts": {"lr": 0.05, "momentum": 0.9,
                                                         "nesterov": True}}, 5),
    ("opt_rmsprop", {"optimizer": "rmsprop", "optimizer_opts": {"lr": 1e-3}}, 5),
    ("opt_lamb", {"optimizer": "lamb", "optimizer_opts": {"lr": 1e-3, "weight_decay": 1e-2}}, 5),
    ("opt_lars", {"optimizer": "lars", "optimizer_opts": {"lr": 0.1}}, 5),
    ("opt_adafactor", {"optimizer": "adafactor", "optimizer_opts": {"lr": 1e-2}}, 5),
    ("opt_lion", {"optimizer": "lion", "optimizer_opts": {"lr": 1e-4, "weight_decay": 0.1}}, 5),
    ("opt_muon", {"optimizer": "muon", "optimizer_opts": {"lr": 0.02, "weight_decay": 1e-2}}, 5),
    ("opt_schedule_free_adamw", {"optimizer": "schedule_free_adamw", "validate_every_epochs": 1,
                                 "optimizer_opts": {"lr": 1e-3, "warmup_steps": 2}}, 5),
    ("clip", {"gradient_clip_norm": 1.0}, 5),
    ("accumulation", {"grad_accumulation_steps": 4}, 5),
    ("ema", {"ema_decay": 0.999, "ema_eval": True, "validate_every_epochs": 1,
             "log_param_histograms": True}, 5),
    ("freeze_lr_scales", {"freeze_params": "_submodule_0_conv2d",
                          "lr_scales": {"fully_connected": 1.0, ".*": 0.1}}, 5),
    ("remat_true", {"remat": True}, 10),
    ("remat_dots", {"remat": "dots"}, 5),
    ("with_replacement", {"sampling": "with_replacement"}, 5),
    ("uda", {"uda": {"weight": 1.0, "ops": ["autocontrast", "equalize", "posterize",
                                             "solarize"]}}, 10),
    ("sched_constant", {"scheduler": {"type": "constant", "kwargs": {"value": 1e-3}}}, 5),
    ("sched_cosine", {"scheduler": {"type": "cosine",
                                    "kwargs": {"init_value": 1e-3, "decay_steps": 4}}}, 5),
    ("sched_warmup_cosine", {"scheduler": {"type": "warmup_cosine", "kwargs": {
        "peak_value": 1e-3, "warmup_steps": 1, "decay_steps": 4}}}, 5),
    ("sched_exponential", {"scheduler": {"type": "exponential", "kwargs": {
        "init_value": 1e-3, "transition_steps": 2, "decay_rate": 0.5}}}, 5))
#: each optimizer's one step on the card against the CPU's on the same
#: gradients, float32 with TF32 off: the largest difference of the updated
#: parameters relative to max|update|; for torch's own Adam and AdamW
#: (:data:`FMA_ROUNDED`) the difference past one float32 ulp of the parameter
OPT_UPDATE_TOL = 1e-5
#: the optimizers whose card kernel rounds the parameter otherwise (an FMA)
#: than the CPU's: a parameter near 1 holds a 1e-3 step only to 6e-8, 6e-5
#: of it
FMA_ROUNDED = ("adam", "adamw")
#: the runs runtime_train traces in a process of its own (remat's two modes
#: and the same run without remat): device ms a step by group, image_classifier's
#: group norms in a range, the model's forward inside
#: ``range::remat_recompute`` where the backward pass recomputes it
REMAT_PROFILED = ("opt_adamw", "remat_true", "remat_dots")
REMAT_RANGES = ((port_nn.GroupNorm, "forward", "group_norm"),)
REMAT_BACKWARD_GROUPS = (("K2_backward", K2_BACKWARD_NODE),
                         ("adamw", "Optimizer.step#AdamW.step"))
RUNTIME_RUNS_BY_LABEL = {label: extra for label, extra, _ in RUNTIME_RUNS}
RUNTIME_OPTIMIZERS = {label[4:]: extra.get("optimizer_opts", RUNTIME_BASE["optimizer_opts"])
                      for label, extra, _ in RUNTIME_RUNS if label.startswith("opt_")}


class _StopAfter(Exception):
    pass


class _HistogramSink:
    """A logger that keeps the names ``log_param_histograms`` hands it."""

    def __init__(self):
        self.names = []

    def log_metrics(self, *_a, **_k):
        pass

    def log_histogram(self, name, values, step):
        self.names.append(name)


def _classifier(data, device, dtype="bfloat16", state=None):
    from deepcv_tpu_torch.pipelines.classification import create_model

    model = create_model(data, {**conf_hp("image_classifier_model"), "dtype": dtype},
                         device=device)
    if state is not None:
        model.load_state_dict(state)
    return model


def _stream_memmap(d: Path, n: int):
    """bench.py config 7's images: random walks (steps U[-3, 3]) snaking
    across each image's 1,024 pixels per channel, reflected into [0, 255],
    written in chunks of 16,384 into ``x.npy``; labels U[0, 10) in
    ``y.npy``; both from ``default_rng(0)``."""
    from numpy.lib.format import open_memmap

    imgs = open_memmap(d / "x.npy", mode="w+", dtype=np.uint8, shape=(n, 32, 32, 3))
    rng = np.random.default_rng(0)
    for s in range(0, n, 16384):
        k = min(n, s + 16384) - s
        steps = rng.integers(-3, 4, (k, 32 * 32, 3)).astype(np.int16)
        walk = np.cumsum(steps, axis=1) + rng.integers(0, 256, (k, 1, 3))
        imgs[s:s + k] = np.abs(walk % 510 - 255).astype(np.uint8).reshape(k, 32, 32, 3)
    imgs.flush()
    np.save(d / "y.npy", rng.integers(0, 10, (n,)).astype(np.int32))


def _first_losses(hp, data, device, state, steps):
    """The main losses of the first ``steps`` steps of ``train(hp)`` from
    the weights ``state``."""
    events, losses = training.TrainingEvents(), []

    def on_step(state, metrics):
        losses.append(float(metrics["main_loss"]))
        if len(losses) >= steps:
            raise _StopAfter

    events.on(training.TrainingEvents.ITERATION_COMPLETED, on_step)
    try:
        training.train(hp, _classifier(data, device, state=state), cross_entropy_loss, data,
                       events=events)
    except _StopAfter:
        pass
    return losses


def _h2d_probe(batch: np.ndarray):
    """One batch's host-to-device copy, median of 10 CUDA-event timed
    copies: from pinned memory (``non_blocking``) and from pageable memory."""
    pinned = torch.from_numpy(batch).pin_memory()
    pageable = torch.from_numpy(batch.copy())
    dev = torch.empty(pinned.shape, dtype=pinned.dtype, device=DEVICE)
    out = {}
    for label, src in (("pinned", pinned), ("pageable", pageable)):
        ms = cuda_ms(lambda: dev.copy_(src, non_blocking=True), iters=10, warmup=2)
        out[label] = {"ms": ms, "mb_s": batch.nbytes / ms / 1e3,
                      "img_s_allowed": len(batch) / ms * 1e3}
    if not torch.equal(dev.cpu(), pageable):
        raise AssertionError("stream_train: the copied batch differs from the host's")
    return out


def _feed_img_s(put, batch: int) -> float:
    """bench.py config 7's wire-feed microbenchmark (bench.py:646-666): images
    a second through ``put()`` (a batch to the card), each draw closed by a
    reduction read back to the host; the median of STREAM_FEED_REPS draws
    after two warm ones."""
    ts = []
    for i in range(2 + STREAM_FEED_REPS):
        t0 = time.perf_counter()
        float(put().to(torch.int32).sum())
        if i >= 2:
            ts.append(time.perf_counter() - t0)
    return batch / statistics.median(ts)


def _host_ms(fn, reps: int = 8):
    """Median host milliseconds of ``fn()`` and every draw."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), ts


def phase_stream_train(card):
    from deepcv_tpu_torch.data.datasets import load_dataset
    from deepcv_tpu_torch.data.pipeline import BatchIterator, unwrap_dataset, wire_stats
    from deepcv_tpu_torch.data.wirecodec import device_decode, encode_u8, wire_bytes
    from deepcv_tpu_torch.runtime import NativeBatchLoader, gather_batch

    d = _build.BUILD_DIR / "stream_train_data"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _stream_memmap(d, STREAM_IMAGES)
    gen_s = time.perf_counter() - t0
    raw = load_dataset({"type": "memmap", "images_path": str(d / "x.npy"),
                        "targets_path": str(d / "y.npy")})
    data = preprocess({"trainset": raw}, {"seed": 0, "split_dataset": {"validset_ratio": 0.03},
                                          "transforms": ["to_tensor"]})
    train_images = len(data["trainset"])
    split = unwrap_dataset(data["trainset"])
    if not isinstance(split.images, np.memmap):
        raise AssertionError("stream_train: the split is no memmap view")
    init = {k: v.clone() for k, v in _classifier(data, DEVICE).state_dict().items()}
    _, h_auto = training.train(dict(STREAM_HP, epochs=0, device_resident_dataset="auto"),
                               _classifier(data, DEVICE, state=init), cross_entropy_loss, data)
    if h_auto["input_path"] != "streaming":
        raise AssertionError(f"stream_train: auto took the {h_auto['input_path']} path")

    # the host gather of a batch from the memmap (numpy's, and the C++
    # library's threaded one on the same indices), the C++ loader's
    # hand-over of a batch it gathered ahead, and the copy of one batch
    it = BatchIterator(data["trainset"], STREAM_BATCH, shuffle=True, seed=0).epoch(0)
    gathers = []
    for _ in range(8):
        t0 = time.perf_counter()
        xb, _ = next(it)
        gathers.append((time.perf_counter() - t0) * 1e3)
    order = np.random.default_rng(0).permutation(train_images)
    idx = iter(order[i * STREAM_BATCH:(i + 1) * STREAM_BATCH] for i in range(8))
    native_gather_ms, native_gathers = _host_ms(lambda: gather_batch(split.images, next(idx)))
    loader = NativeBatchLoader(split.images, split.targets, STREAM_BATCH, depth=3, seed=0)
    try:
        if not np.shares_memory(loader.images, split.images):
            raise AssertionError("stream_train: the C++ loader copied the memmap")
        next(loader)
        time.sleep(0.2)                          # the ring full again
        handover_ms, _ = _host_ms(lambda: next(loader), reps=3)
    finally:
        loader.close()
    xb = np.ascontiguousarray(xb)
    h2d = _h2d_probe(xb)

    # the wire codec on a batch: host encode, wire bytes, the decode on the
    # card bit-equal to the host batch, and bench.py's feed microbenchmark
    encode_ms, encodes = _host_ms(lambda: encode_u8(xb, **STREAM_WIRE))
    payload = encode_u8(xb, **STREAM_WIRE)
    if payload is None:
        raise AssertionError("stream_train: the codec shipped config 7's batch raw")
    decoded = device_decode(payload, DEVICE)
    if decoded.device.type != torch.device(DEVICE).type \
            or not torch.equal(decoded.cpu(), torch.from_numpy(xb)):
        raise AssertionError("stream_train: the batch decoded on the card differs from the "
                             "host's")
    feed = {"raw": _feed_img_s(lambda: torch.from_numpy(xb).to(DEVICE), STREAM_BATCH),
            "coded": _feed_img_s(lambda: device_decode(payload, DEVICE), STREAM_BATCH)}

    runs = {}
    for label, resident, extra in (("streaming", False, {}),
                                   ("streaming_codec", False, {"wire_compression": STREAM_WIRE}),
                                   ("resident", True, {})):
        model = _classifier(data, DEVICE, state=init)
        wire_stats.clear()
        (_, h), wall, counts, _, _ = _counted(lambda: training.train(
            dict(STREAM_HP, device_resident_dataset=resident, **extra), model,
            cross_entropy_loss, data))
        steps = h["steps"]
        losses = [e["main_loss"] for e in h["train"]]
        bf16 = "bfloat16/bfloat16/bfloat16"
        path = "resident" if resident else "streaming"
        loader_ok = resident or h.get("host_loader") == "native"
        wire_ok = (wire_stats["coded"] == steps and wire_stats["raw"] == 0) if extra \
            else not wire_stats
        if h["input_path"] != path or steps != 2 * (train_images // STREAM_BATCH) \
                or not np.isfinite(losses).all() or h["valid"] or not loader_ok \
                or not wire_ok or counts["K2"] != CLASSIFIER_CONVS_PER_FORWARD * steps \
                or any(k != bf16 for k in counts["K2_dtypes"]):
            raise AssertionError(f"stream_train {label}: path {h['input_path']}, loader "
                                 f"{h.get('host_loader')}, {steps} steps, losses {losses}, "
                                 f"wire {dict(wire_stats)}, counts {counts}")
        runs[label] = {"steps": steps, "throughput_img_s": h["throughput_img_s"],
                       "steady_img_s": _steady(h["throughput_img_s"]), "wall_s": wall,
                       "loss": losses[-1], "launches": counts,
                       "host_loader": h.get("host_loader"), "wire": collections.Counter(wire_stats),
                       "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del model
        torch.cuda.empty_cache()

    # the first steps on the card against the CPU path, on the same batches,
    # and the codec run's against the raw run's
    gpu = _first_losses(dict(STREAM_HP), data, DEVICE, init, STREAM_CPU_STEPS)
    cpu = _first_losses(dict(STREAM_HP), data, "cpu", {k: v.cpu() for k, v in init.items()},
                        STREAM_CPU_STEPS)
    coded = _first_losses(dict(STREAM_HP, wire_compression=STREAM_WIRE), data, DEVICE, init,
                          STREAM_CPU_STEPS)
    rel = [abs(g - c) / max(1.0, abs(c)) for g, c in zip(gpu, cpu)]
    rel_codec = [abs(g - c) / max(1.0, abs(g)) for g, c in zip(gpu, coded)]
    if len(rel) != STREAM_CPU_STEPS or max(rel) > BF16_TOL or \
            len(rel_codec) != STREAM_CPU_STEPS or max(rel_codec) > BF16_TOL:
        raise AssertionError(f"stream_train: card losses {gpu} vs CPU {cpu}, codec {coded}")
    s, c, r = runs["streaming"], runs["streaming_codec"], runs["resident"]
    wire_per_img = c["wire"]["wire_bytes"] / (c["wire"]["coded"] * STREAM_BATCH)
    emit({"phase": "stream_train",
          "settings": "bench.py config 7: memmap of 131,072 random-walk 32x32x3 images, "
                      "validset_ratio 0.03, transforms [to_tensor], image_classifier bf16, "
                      "batch 4096, 2 epochs, AdamW lr 1e-3, device_resident_dataset false, "
                      "no validation; native_loader auto (the C++ loader); raw, then wire "
                      f"compression {STREAM_WIRE}; then resident",
          "data_bytes": STREAM_IMAGES * 3072, "data_gen_s": gen_s, "train_images": train_images,
          "auto_path_on_memmap": h_auto["input_path"], "host_loader": s["host_loader"],
          "steps": s["steps"], "throughput_img_s": s["throughput_img_s"],
          "steady_img_s": s["steady_img_s"], "step_ms": STREAM_BATCH / s["steady_img_s"] * 1e3,
          "codec": {"steady_img_s": c["steady_img_s"],
                    "throughput_img_s": c["throughput_img_s"], "wall_s": c["wall_s"],
                    "over_raw": c["steady_img_s"] / s["steady_img_s"],
                    "batches_coded": c["wire"]["coded"], "batches_raw": c["wire"]["raw"],
                    "wire_bytes_per_img": wire_per_img, "wire_ratio": 3072.0 / wire_per_img,
                    "host_encode_ms_per_batch": c["wire"]["encode_s"] * 1e3 / c["steps"],
                    "launches": c["launches"]},
          "wire_probe": {"host_encode_ms": encode_ms, "host_encode_ms_draws": encodes,
                         "wire_bytes_per_img": wire_bytes(payload) / STREAM_BATCH,
                         "decoded_equal": True, "feed_img_s": feed,
                         "feed_coded_over_raw": feed["coded"] / feed["raw"]},
          "resident": {k: r[k] for k in ("throughput_img_s", "steady_img_s", "wall_s",
                                         "peak_memory_gib")},
          "streaming_over_resident": s["steady_img_s"] / r["steady_img_s"],
          "host_gather_ms_per_batch": statistics.median(gathers), "host_gather_ms": gathers,
          "native_gather_ms_per_batch": native_gather_ms, "native_gather_ms": native_gathers,
          "native_loader_handover_ms": handover_ms,
          "h2d_copy_per_batch": h2d, "batch_mb": STREAM_BATCH * 3072 / 1e6,
          "wall_s": s["wall_s"], "loss": s["loss"], "launches": s["launches"],
          "launches_resident": r["launches"],
          "launches_per_step": {"K2": s["launches"]["K2"] / s["steps"]},
          "validation_forwards": 0,
          "first_losses": {"card": gpu, "cpu": cpu, "max_rel": max(rel), "codec": coded,
                           "codec_max_rel_to_raw": max(rel_codec), "tol": BF16_TOL},
          "peak_memory_gib": s["peak_memory_gib"], "card": card})
    for p in d.iterdir():
        p.unlink()
    d.rmdir()
    return {"streaming": s["launches"]["K2"], "codec": c["launches"]["K2"],
            "resident": r["launches"]["K2"]}


def _optimizer_update_check(name, opts, model):
    """One step of optimizer ``name`` on the card and on the CPU from the
    same float32 parameters and gradients. Returns (max |u_card - u_cpu| /
    max |u_cpu|, the same past one float32 ulp of the parameter)."""
    gen = torch.Generator().manual_seed(SEED)
    named = [(n, p.detach().float().cpu()) for n, p in model.named_parameters()]
    grads = [torch.randn(p.shape, generator=gen) * 0.01 for _, p in named]
    after = []
    for dev in ("cpu", DEVICE):
        params = [(n, torch.nn.Parameter(p.to(dev).clone())) for n, p in named]
        opt = training.build_optimizer(name, opts, params)
        for (_, p), g in zip(params, grads):
            p.grad = g.to(dev).clone()
        opt.step()
        after.append([p.detach().cpu() for _, p in params])
    top = max(float((a - p0).abs().max()) for a, (_, p0) in zip(after[0], named))
    diff = [(b - a).abs() for a, b in zip(*after)]
    ulp = [torch.nextafter(a.abs(), torch.tensor(float("inf"))) - a.abs() for a in after[0]]
    raw = max(float(d.max()) for d in diff)
    past_ulp = max(float((d - u).clamp(min=0).max()) for d, u in zip(diff, ulp))
    return raw / top, past_ulp / top


@contextlib.contextmanager
def _recompute_range():
    """The model's forward inside ``range::remat_recompute`` where the
    backward pass runs it (remat's recomputation)."""
    from torch.profiler import record_function
    forward = DeepcvModule.forward

    def ranged(self, *a, **kw):
        if torch._C._current_graph_task_id() == -1:
            return forward(self, *a, **kw)
        with record_function(PROFILE_RANGE + "remat_recompute"):
            return forward(self, *a, **kw)
    with mock.patch.object(DeepcvModule, "forward", ranged):
        yield


REMAT_PROFILE_PROCESS_S = 300


def phase_remat_profile(card):
    """:func:`remat_train_profile` in a process of its own
    (``chip_smoke.py --remat-profile CARD``), its lines passed on: in this
    process, after the earlier phases' profiles, the profiler has lost one
    of a run's 20 K2 records (twice in a row), as it lost U-Net's."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--remat-profile",
                           card], capture_output=True, text=True,
                          timeout=REMAT_PROFILE_PROCESS_S, cwd=REPO)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    sys.stderr.write(proc.stderr)
    sys.stderr.flush()
    if proc.returncode != 0:
        raise AssertionError(f"remat_train_profile: its process exited {proc.returncode}")


def remat_train_profile(card, tries=3, margin_s=0.5):
    """Each run of :data:`REMAT_PROFILED` once unprofiled (its step ms;
    cuDNN's plans) and once under torch.profiler, with ``margin_s`` of idle
    time at each end of the window (:func:`_profile_calls` says why):
    device ms a step by group, K2's launches recorded against the count,
    and the device's idle share of the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile
    _, run = _runtime_runs()
    out = {}
    for label in REMAT_PROFILED:
        extra = RUNTIME_RUNS_BY_LABEL[label]
        _, _, _, _, _, ends = run(label, extra, _HistogramSink())
        step_ms = statistics.median(s.elapsed_time(e) for s, e in zip(ends, ends[1:]))
        for _ in range(tries):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            with _annotated_modules(REMAT_RANGES), _recompute_range(), \
                    profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(margin_s)
                model, (_, h), _, counts, _, _ = run(label, extra, _HistogramSink())
                torch.cuda.synchronize()
                time.sleep(margin_s)
            groups, kernels, _, k2 = _range_profile_groups(prof, REMAT_BACKWARD_GROUPS)
            if k2 == counts["K2"]:
                break
        else:
            raise AssertionError(f"runtime_train {label} profile: {k2} K2 launches recorded "
                                 f"of {counts['K2']} in each of {tries} tries")
        steps = h["steps"]
        upload = groups.pop("upload", 0.0)
        busy = sum(groups.values()) / steps
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        out[label] = {
            "steps": steps, "device_ms_per_step": {g: v / steps for g, v in groups.most_common()},
            "upload_ms_per_run": upload, "device_busy_ms_per_step": busy,
            "step_ms_unprofiled": step_ms, "device_idle_share": 1.0 - busy / step_ms,
            "top_kernels_ms_per_step": [[n[:90], v / steps, c] for n, (v, c) in top],
            "k2_launches_recorded": k2, "k2_launches": counts["K2"]}
        del model, prof
    emit({"phase": "runtime_train_profile", "profiles": out, "card": card})


def _runtime_runs():
    """The runtime runs' data and ``run(label, extra, sink)``: a fresh
    image_classifier from one seeded init trained under ``_counted``;
    returns the model and ``_counted``'s result."""
    from deepcv_tpu_torch.data.datasets import load_dataset

    raw = load_dataset({"type": "cifar10", "train": True})
    data = preprocess({"trainset": raw, "testset": load_dataset({"type": "cifar10",
                                                                 "train": False})},
                      {"seed": 0, "split_dataset": {"validset_ratio": RUNTIME_VALID_RATIO},
                       "transforms": ["to_tensor"]})
    unlabeled = np.asarray(data["validset"].dataset.images[:AUGMENT_BATCH])
    init = {k: v.clone() for k, v in _classifier(data, DEVICE).state_dict().items()}

    def run(label, extra, sink):
        hp = {**RUNTIME_BASE, **extra,
              "output_path": str(_build.BUILD_DIR / "runtime_train"), "run_dir": label}
        datasets = dict(data)
        if "uda" in extra:
            datasets["unlabeledset"] = ArrayDataset(unlabeled, np.zeros(len(unlabeled), np.int64))
        model = _classifier(data, DEVICE, state=init)
        out = _counted(lambda: training.train(hp, model, cross_entropy_loss, datasets,
                                              loggers=[sink]))
        return (model, *out)
    return data, run


def phase_runtime_train(card):
    data, run = _runtime_runs()
    rows, launches = {}, {}
    for label, extra, k2_per_step in RUNTIME_RUNS:
        sink = _HistogramSink()
        model, (state, h), wall, counts, _, ends = run(label, extra, sink)
        n_params = len(list(model.parameters()))
        if len(sink.names) != (n_params * len(h["valid"]) if "log_param_histograms" in extra
                               else 0):
            raise AssertionError(f"runtime_train {label}: {len(sink.names)} histograms for "
                                 f"{n_params} parameters and {len(h['valid'])} validations")
        steps = h["steps"]
        n_valid = len(data["validset"])
        val_forwards = len(h["valid"]) * math.ceil(n_valid / min(32 * AUGMENT_BATCH, n_valid))
        losses = [e["main_loss"] for e in h["train"]]
        if steps == 0 or not np.isfinite(losses).all() \
                or counts["K2"] != k2_per_step * steps + CLASSIFIER_CONVS_PER_FORWARD * val_forwards:
            raise AssertionError(f"runtime_train {label}: {steps} steps, losses {losses}, "
                                 f"{val_forwards} validation forwards, counts {counts}")
        step_ms = [s.elapsed_time(e) for s, e in zip(ends, ends[1:])]
        rows[label] = {"steps": steps, "losses": losses, "wall_s": wall,
                       "step_ms": statistics.median(step_ms) if step_ms else None,
                       "k2_per_step": (counts["K2"] - CLASSIFIER_CONVS_PER_FORWARD
                                       * val_forwards) / steps,
                       "validation_forwards": val_forwards,
                       "valid": h["valid"][-1] if h["valid"] else None,
                       "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if label == "accumulation":
            rows[label]["optimizer_updates"] = state.updates
        if label == "ema":
            rows[label]["param_histograms"] = len(sink.names)
            rows[label]["ema_minus_params_max"] = max(
                float((state.ema[n] - p.detach()).abs().max())
                for n, p in model.named_parameters())
        launches[label] = counts["K2"]
        del model, state
        torch.cuda.empty_cache()
    model = _classifier(data, "cpu", dtype="float32")
    checks = {name: _optimizer_update_check(name, opts, model)
              for name, opts in RUNTIME_OPTIMIZERS.items()}
    updates = {k: v[0] for k, v in checks.items()}
    past_ulp = {k: v[1] for k, v in checks.items()}
    held = {k: past_ulp[k] if k in FMA_ROUNDED else updates[k] for k in updates}
    if not all(v <= OPT_UPDATE_TOL for v in held.values()) or len(updates) != 10:
        raise AssertionError(f"runtime_train: card updates off the CPU's {updates} "
                             f"(past one ulp {past_ulp})")
    emit({"phase": "runtime_train",
          "settings": f"image_classifier bf16 at bench.py config 1's batch {AUGMENT_BATCH} on "
                      f"the CIFAR-10 stand-in, validset_ratio {RUNTIME_VALID_RATIO} (4 steps "
                      "an epoch), 1 epoch a run, config 1's AdamW unless the run says "
                      "otherwise; validation only where the run needs it (ema_eval, the "
                      "schedule-free evaluation point)",
          "runs": rows, "optimizer_update_rel_err": updates,
          "optimizer_update_rel_err_past_one_ulp": past_ulp, "tol": OPT_UPDATE_TOL,
          "past_one_ulp_held_for": list(FMA_ROUNDED),
          "card": card})
    phase_remat_profile(card)
    return launches


def phase_partial_run(card):
    """``run --to-nodes preprocess``, ``--only-nodes create_model`` (the
    datasets from the cache) and ``--from-nodes train`` (both from the
    cache) of train_image_classifier, in a project whose conf is the
    repository's; the first loss equals a full run's."""
    project = _build.BUILD_DIR / "partial_project"
    shutil.rmtree(project, ignore_errors=True)
    (project / "conf").mkdir(parents=True)
    (project / "conf" / "base").symlink_to(REPO / "conf" / "base")
    params = ",".join(["train_image_classifier.epochs:1", "train_image_classifier.batch_size:256",
                       "cifar10_preprocessing.split_dataset.validset_ratio:0.9",
                       "train_image_classifier.save_every_iters:0",
                       "train_image_classifier.log_progress_every_iters:1",
                       f"train_image_classifier.output_path:{_build.BUILD_DIR / 'partial_run'}"])
    base = ["--pipeline=train_image_classifier", "--project-path", str(project),
            "--device", DEVICE, "--params", params]
    t0 = time.perf_counter()
    full = cli.run([*base, "--no-persist"])
    full_s = time.perf_counter() - t0
    walls = {}
    stores = {}
    for label, flags in (("to_preprocess", ["--to-nodes", "preprocess"]),
                         ("only_create_model", ["--only-nodes", "create_model"]),
                         ("from_train", ["--from-nodes", "train"])):
        t0 = time.perf_counter()
        if label == "from_train":
            stores[label], walls[label], counts, _, _ = _counted(lambda: cli.run([*base, *flags]))
        else:
            stores[label] = cli.run([*base, *flags])
            walls[label] = time.perf_counter() - t0
    cache = project / "data" / "02_intermediate" / "train_image_classifier"
    cached = sorted(p.name for p in cache.iterdir())
    hf = full["train_results"]["history"]
    hr = stores["from_train"]["train_results"]["history"]
    lf, lr = ([e["main_loss"] for e in h["train"]] for h in (hf, hr))
    n_valid = len(full["datasets"]["validset"])
    val_forwards = len(hr["valid"]) * math.ceil(n_valid / min(32 * 256, n_valid))
    if "train_results" in stores["to_preprocess"] or "model" in stores["to_preprocess"] \
            or cached != ["datasets.pkl", "model.pkl"] or len(lr) != len(lf) \
            or abs(lr[0] - lf[0]) > 1e-6 * max(1.0, abs(lf[0])) or not np.isfinite(lr).all() \
            or counts["K2"] != CLASSIFIER_CONVS_PER_FORWARD * (hr["steps"] + val_forwards):
        raise AssertionError(f"partial_run: cache {cached}, losses {lr[:3]} vs {lf[:3]}, "
                             f"counts {counts}")
    runs = sorted((Path.cwd() / "data" / "04_training" / "experiments" /
                   "train_image_classifier").iterdir(), key=lambda p: p.stat().st_mtime)
    meta = json.loads((runs[-1] / "meta.json").read_text())
    logged = (runs[-1] / "metrics.jsonl").read_text().splitlines()
    if meta.get("status") != "FINISHED" or meta["tags"].get("pipeline") != \
            "train_image_classifier" or len(logged) < len(lr):
        raise AssertionError(f"partial_run: tracker {runs[-1]}: {meta}, {len(logged)} records")
    emit({"phase": "partial_run",
          "argv": ["python", "-m", "deepcv_tpu_torch", "run", *base],
          "flags": ["--to-nodes preprocess", "--only-nodes create_model",
                    "--from-nodes train"],
          "cached": cached, "walls_s": walls, "full_run_s": full_s, "steps": hr["steps"],
          "first_loss": {"from_cache": lr[0], "full": lf[0]},
          "last_loss": {"from_cache": lr[-1], "full": lf[-1]},
          "tracker": {"dir": str(runs[-1].relative_to(Path.cwd())), "status": meta["status"],
                      "metrics_records": len(logged), "tags": sorted(meta["tags"])},
          "launches": counts, "card": card})
    shutil.rmtree(project, ignore_errors=True)
    return counts["K2"]


# --------------------------------------------------------------------------- #
# Search: the CLI's search, bench.py config 5's runner, NAS, the LR finder
# --------------------------------------------------------------------------- #

SEARCH_TRIALS = 4
#: the conf's image_classifier space's three domains (model:dropout_prob,
#: model:batch_norm.momentum, training:optimizer_opts.lr) and bench.py
#: config 1's batch and one epoch as one-value choices
SEARCH_DOMAINS = ("model:dropout_prob", "model:batch_norm.momentum",
                  "training:optimizer_opts.lr")
SEARCH_VALID_RATIO = 0.05              # config 1's split (_augment_params)
HP_SEARCH_TRIALS = 4                   # bench.py config 5 (bench_hp_search)
CONFIG5_SPEC = {"act_fn": "relu", "batch_norm": {"affine": True, "eps": 1e-5, "momentum": 0.1},
                "architecture": [
                    {"conv2d": {"kernel_size": [3, 3], "out_channels": 16, "padding": 1}},
                    {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
                    {"conv2d": {"kernel_size": [3, 3], "out_channels": 32, "padding": 1}},
                    {"flatten": {}},
                    {"fully_connected": {"out_features": 10, "act_fn": None,
                                         "batch_norm": None}}]}
CONFIG5_CONVS_PER_FORWARD = 2
NAS_VALID_RATIO = 0.8                  # 10,000 of CIFAR-10's 50,000 to train on
NAS_BATCH = 512
NAS_CLASSIC_TRIALS = 3
NAS_ALGORITHMS = ("darts", "spos", "proxylessnas", "enas")
#: K2 convs a forward: the fixed classifier's 11, the supernet's 13 (every
#: candidate of mutable_layer_1 runs)
NAS_FIXED_CONVS, NAS_SUPERNET_CONVS = 11, 13
NAS_MUTABLE = "_submodule_0_nested/mutable_layer_1"
NAS_CHECK_BATCH = 64
LR_FIND_STEPS, LR_FIND_BATCH = 100, 4096


def nas_classifier_hp(common_width=None):
    """The conf's ``larger_backbone`` nested in a classifier with
    ``image_classifier_model``'s act_fn and batch_norm and a 10-class head.
    ``common_width`` puts ``mutable_layer_1``'s three candidates (3x3, 5x5,
    7x7) at one width: the conf's 32, 16 and 8 channels cannot be summed by
    a supernet's mixture, in either package."""
    models = {k: v for entry in load_yaml(REPO / "conf" / "base" / "parameters.yml")["models"]
              for k, v in entry.items()}
    backbone = copy.deepcopy(models["larger_backbone"])
    if common_width:
        for entry in backbone["architecture"]:
            for cand in entry.get("_nas_layer_choice", {}).get("_candidates", []):
                cand["conv2d"]["out_channels"] = common_width
    clf = conf_hp("image_classifier_model")
    return {"act_fn": clf["act_fn"], "batch_norm": dict(clf["batch_norm"]),
            "architecture": [{"_nested_deepcvmodule": backbone}, {"flatten": {}},
                             {"fully_connected": {"out_features": 10}}]}


class _Histories:
    """The histories of every ``train()`` the classification pipeline runs
    inside the block."""

    def __init__(self):
        from deepcv_tpu_torch.pipelines import classification
        self._mod, self.runs = classification, []

    def __enter__(self):
        real = self._mod.train_fn

        def spy(*args, **kwargs):
            state, h = real(*args, **kwargs)
            self.runs.append(h)
            return state, h
        self._real, self._mod.train_fn = real, spy
        return self

    def __exit__(self, *exc):
        self._mod.train_fn = self._real


def _val_forwards(h, n_valid, batch):
    return len(h["valid"]) * math.ceil(n_valid / min(32 * batch, n_valid))


def phase_search(card):
    """``python -m deepcv_tpu_torch search --pipeline train_image_classifier``
    in this process: TPE over the conf's three domains with config 1's batch
    and one epoch as one-value choices, 4 trials, each a whole pipeline run
    with bench.py config 1's recipe and settings (K1 each step, 5 bf16 K2
    launches a forward)."""
    d = _build.BUILD_DIR / "search"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    conf_space = json.loads((REPO / "conf" / "base" / "hp_search_spaces" /
                             "image_classifier_hp_search_space.json").read_text())
    space = {**{k: conf_space[k] for k in SEARCH_DOMAINS},
             "training:batch_size": {"_type": "choice", "_value": [AUGMENT_BATCH]},
             "training:epochs": {"_type": "choice", "_value": [1]}}
    (d / "space.json").write_text(json.dumps(space, indent=1))
    # config 1's settings but its epochs and batch (the space's) and with a
    # validation pass (the trial's value)
    params = [p for p in _augment_params(1)
              if not p.startswith(("train_image_classifier.epochs:",
                                   "train_image_classifier.batch_size:",
                                   "train_image_classifier.validate_every_epochs:"))]
    params.append(f"train_image_classifier.output_path:{d / 'runs'}")
    argv = ["search", "--pipeline=train_image_classifier", "--space", str(d / "space.json"),
            "--trials", str(SEARCH_TRIALS), "--tuner", "tpe", "--project-path", str(REPO),
            "--output-dir", str(d / "hp_search"), "--device", DEVICE,
            "--params", ",".join(params)]
    out = io.StringIO()
    with _Histories() as hists, contextlib.redirect_stdout(out):
        rc, wall, counts, _, _ = _counted(lambda: cli.main(argv))
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    summary = json.loads((d / "hp_search" / "summary.json").read_text())
    trials = summary["trials"]
    n_valid = round(SEARCH_VALID_RATIO * 50000)
    steps = sum(h["steps"] for h in hists.runs)
    forwards = steps + sum(_val_forwards(h, n_valid, AUGMENT_BATCH) for h in hists.runs)
    bf16 = "bfloat16/bfloat16/bfloat16"
    values = [t["value"] for t in trials]
    if rc != 0 or len(trials) != SEARCH_TRIALS or len(hists.runs) != SEARCH_TRIALS \
            or any(v is None or not 0.0 <= v <= 1.0 for v in values) \
            or any(not np.isfinite([e["main_loss"] for e in h["train"]]).all()
                   for h in hists.runs) \
            or summary["best"]["params"] != line["best_params"] \
            or any(t["params"]["training:batch_size"] != AUGMENT_BATCH for t in trials):
        raise AssertionError(f"search: rc {rc}, trials {trials}, printed {line}")
    if counts["K1"] != steps or counts["routes"] != {"K1": steps, "eager": 0} \
            or counts["K2"] != CLASSIFIER_CONVS_PER_FORWARD * forwards \
            or counts["K2_dtypes"] != {bf16: counts["K2"]}:
        raise AssertionError(f"search counts {counts} for {steps} steps, {forwards} forwards")
    emit({"phase": "search",
          "argv": ["python", "-m", "deepcv_tpu_torch", *argv], "space": space,
          "data": _cifar_data(),
          "trials": [{"trial": t["trial"], "params": t["params"], "value": t["value"],
                      "seconds": t["seconds"], "steps": h["steps"],
                      "step_ms": AUGMENT_BATCH / h["throughput_img_s"][-1] * 1e3,
                      "first_loss": h["train"][0]["main_loss"] if h["train"] else None}
                     for t, h in zip(trials, hists.runs)],
          "best": {"trial": summary["best"]["trial"], "value": summary["best"]["value"],
                   "params": summary["best"]["params"]},
          "summary_json": str((d / "hp_search" / "summary.json").relative_to(REPO)),
          "total_seconds": summary["total_seconds"], "wall_s": wall,
          "launches": {"K1": counts["K1"], "K2": counts["K2"]},
          "launches_per_forward": {"K2": counts["K2"] / forwards}, "steps": steps,
          "card": card})
    return counts


def phase_hp_search(card):
    """bench.py config 5 (``bench_hp_search``) on the port: 4 random trials
    of its spec-built CNN, 1,024 synthetic 16x16 images, batch 128, bf16,
    ``runtime_lr: true``; the trial seconds and first-to-fastest ratio."""
    from deepcv_tpu_torch.data.datasets import load_dataset
    from deepcv_tpu_torch.hyperparams import HyperparameterSpace
    from deepcv_tpu_torch.search import SearchRunner, sample_search_space

    raw = load_dataset("synthetic", n=1024, image_shape=(16, 16, 3), seed=0)
    data = preprocess({"trainset": raw}, {"seed": 0, "split_dataset": {"validset_ratio": 0.1},
                                          "transforms": ["to_tensor"]})
    d = _build.BUILD_DIR / "hp_search"
    shutil.rmtree(d, ignore_errors=True)
    base_hp = {"epochs": 1, "batch_size": 128, "optimizer_opts": {"lr": 1e-3},
               "save_every_iters": 0, "log_progress_every_iters": 1_000_000,
               "eval_batch_multiplier": 1, "output_path": str(d / "runs"),
               "dtype": "bfloat16", "handle_preemption": False, "runtime_lr": True}
    space = HyperparameterSpace.from_nni_json({
        "training:optimizer_opts.lr": {"_type": "loguniform", "_value": [1e-4, 1e-2]}})
    times, hists = [], []

    def trial_fn(params, trial):
        m_hp, t_hp = sample_search_space(params, CONFIG5_SPEC, base_hp)
        model = DeepcvModule((16, 16, 3), m_hp, dtype="bfloat16", device=DEVICE)
        t0 = time.perf_counter()
        _, h = training.train(t_hp, model, cross_entropy_loss, data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        hists.append(h)
        trial.report_final_result(h["valid"][-1]["valid_accuracy"])

    summary, wall, counts, _, _ = _counted(lambda: SearchRunner(
        space, trial_fn, tuner="random", max_trials=HP_SEARCH_TRIALS,
        output_dir=d / "bench_hp_search", seed=0).run())
    n_valid = len(data["validset"])
    eval_bs = min(base_hp["batch_size"] * base_hp["eval_batch_multiplier"], n_valid)
    forwards = sum(h["steps"] + len(h["valid"]) * math.ceil(n_valid / eval_bs) for h in hists)
    if len(times) != HP_SEARCH_TRIALS or any(t["value"] is None for t in summary["trials"]) \
            or counts["K2"] != CONFIG5_CONVS_PER_FORWARD * forwards \
            or counts["K2_by_dtype"] != {"float32": 0, "bfloat16": counts["K2"]}:
        raise AssertionError(f"hp_search: times {times}, trials {summary['trials']}, "
                             f"counts {counts} for {forwards} forwards")
    emit({"phase": "hp_search", "config": "bench.py config 5 (bench_hp_search)",
          "trials": HP_SEARCH_TRIALS, "lrs": [t["params"]["training:optimizer_opts.lr"]
                                              for t in summary["trials"]],
          "values": [t["value"] for t in summary["trials"]], "trial_s": times,
          "first_to_fastest": times[0] / min(times[1:]),
          "ratio_measures": "no XLA compile exists here: the first trial's extra time is "
                            "its first-call costs at these shapes (allocator growth, the "
                            "cuBLAS and cuDNN heuristics of new shapes) in a process that "
                            "already loaded CUDA and built K2; cudnn.benchmark is off, so "
                            "no autotuning",
          "steps": [h["steps"] for h in hists], "wall_s": wall,
          "launches": {"K2": counts["K2"]}, "data": "synthetic (1,024 16x16 images)",
          "card": card})
    return counts


def _nas_data():
    """CIFAR-10 at 32x32 with the conf's transforms, 10,000 images to train
    on (validset_ratio 0.2 -> 0.8, as classifier_train cuts it)."""
    from deepcv_tpu_torch.pipelines import ProjectContext

    ctx = ProjectContext(REPO, device=DEVICE)
    pp = copy.deepcopy(ctx.params("cifar10_preprocessing"))
    pp["split_dataset"] = {**pp.get("split_dataset", {}), "validset_ratio": NAS_VALID_RATIO}
    return preprocess({"trainset": ctx.load_catalog_entry("cifar10_train"),
                       "testset": ctx.load_catalog_entry("cifar10_test")}, pp)


def _nas_hp(d, label, **kw):
    return {"epochs": 1, "batch_size": NAS_BATCH, "optimizer": "adamw",
            "optimizer_opts": {"lr": 1e-3, "weight_decay": 1e-2}, "dtype": "bfloat16",
            "save_every_iters": 0, "log_progress_every_iters": 1_000_000,
            "handle_preemption": False, "seed": SEED, "output_path": str(d / label), **kw}


def _rel_l2(got, ref):
    return float(torch.linalg.vector_norm(got.float() - ref.float())
                 / torch.linalg.vector_norm(ref.float()))


def _fixed_from_supernet(supernet, hp, arch):
    """The fixed model of ``arch`` on the supernet's weights."""
    from deepcv_tpu_torch.search.nas import apply_fixed_architecture, fixed_state_dict

    fixed = apply_fixed_architecture((32, 32, 3), hp, arch, device=DEVICE)
    fixed.load_state_dict(fixed_state_dict(supernet, arch))
    return fixed.eval()


def phase_nas(card):
    """Classic NAS over the conf's larger_backbone classifier (3 sampled
    fixed architectures through SearchRunner, 1 epoch each at batch 512) and
    single-shot NAS (darts, spos, proxylessnas, enas) on the same classifier
    with mutable_layer_1's candidates at a common 32 channels, CIFAR-10
    32x32, bf16, 10,000 training images; then the card checks: the supernet's
    f32 forward against the CPU path, the forced-arch supernet against the
    fixed model of its export on the chosen candidate's weights, and the
    exported architecture as a NAS bundle served once."""
    from deepcv_tpu_torch.hyperparams import HyperparameterSpace
    from deepcv_tpu_torch.search import SearchRunner
    from deepcv_tpu_torch.search.nas import (apply_fixed_architecture, candidate_costs,
                                             list_mutables, sample_architecture,
                                             single_shot_neural_architecture_search)

    d = _build.BUILD_DIR / "nas"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    data = _nas_data()
    data_s = time.perf_counter() - t0
    n_valid = len(data["validset"])
    hp_fixed, hp_super = nas_classifier_hp(), nas_classifier_hp(common_width=32)
    rng = np.random.default_rng(SEED)
    classic = []

    def trial_fn(params, trial):
        arch = sample_architecture(hp_fixed, rng=rng)
        model = apply_fixed_architecture((32, 32, 3), hp_fixed, arch, dtype="bfloat16",
                                         device=DEVICE)
        _, h = training.train(_nas_hp(d, f"classic{trial.trial_id}"), model,
                              cross_entropy_loss, data)
        classic.append({"arch": arch, "capacity": model.capacity(), "steps": h["steps"],
                        "step_ms": NAS_BATCH / h["throughput_img_s"][-1] * 1e3,
                        "valid_accuracy": h["valid"][-1]["valid_accuracy"],
                        "forwards": h["steps"] + _val_forwards(h, n_valid, NAS_BATCH)})
        trial.report_final_result(h["valid"][-1]["valid_accuracy"])

    space = HyperparameterSpace.from_nni_json(
        {"training:optimizer_opts.lr": {"_type": "choice", "_value": [1e-3]}})
    summary, classic_wall, classic_counts, _, _ = _counted(lambda: SearchRunner(
        space, trial_fn, tuner="random", max_trials=NAS_CLASSIC_TRIALS,
        output_dir=d / "classic", seed=SEED).run())
    want = NAS_FIXED_CONVS * sum(c["forwards"] for c in classic)
    if len(classic) != NAS_CLASSIC_TRIALS or classic_counts["K2"] != want \
            or classic_counts["K2_by_dtype"] != {"float32": 0, "bfloat16": want} \
            or any(t["value"] is None for t in summary["trials"]):
        raise AssertionError(f"nas classic: {summary['trials']}, counts {classic_counts}, "
                             f"want {want} K2 launches")
    launches = {"classic": classic_counts["K2"]}
    single = {}
    supernets = {}
    evals = {"darts": 0, "spos": 3 * 2, "proxylessnas": 0, "enas": 8}
    for algorithm in NAS_ALGORITHMS:
        (arch, state, h), wall, counts, _, _ = _counted(
            lambda: single_shot_neural_architecture_search(
                (32, 32, 3), hp_super, _nas_hp(d, algorithm), cross_entropy_loss, data,
                algorithm=algorithm, arch_export_path=d / f"{algorithm}.json",
                dtype="bfloat16", device=DEVICE))
        forwards = h["steps"] + _val_forwards(h, n_valid, NAS_BATCH) + evals[algorithm]
        logits = {k: v.detach().float().cpu().tolist()
                  for k, v in state.model.arch_parameters().items()}
        if set(arch) != set(list_mutables(hp_super)) or counts["K2"] != \
                NAS_SUPERNET_CONVS * forwards or \
                counts["K2_by_dtype"] != {"float32": 0, "bfloat16": counts["K2"]} or \
                not np.isfinite([e["main_loss"] for e in h["train"]]).all() \
                or json.loads((d / f"{algorithm}.json").read_text()) != arch:
            raise AssertionError(f"nas {algorithm}: arch {arch}, counts {counts} for "
                                 f"{forwards} forwards, history {h['train'][-1:]}")
        single[algorithm] = {"arch": arch, "steps": h["steps"],
                             "step_ms": NAS_BATCH / h["throughput_img_s"][-1] * 1e3,
                             "valid_accuracy": h["valid"][-1]["valid_accuracy"],
                             "arch_logits": logits, "wall_s": wall, "forwards": forwards,
                             **({"controller": h["controller"]} if "controller" in h else {})}
        launches[algorithm] = counts["K2"]
        supernets[algorithm] = (arch, state.model)

    # the card checks, float32, TF32 off
    arch, supernet = supernets["darts"]
    supernet = supernet.with_options(dtype=None).eval()
    cpu = DeepcvModule((32, 32, 3), hp_super, nas_mode="supernet", device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in supernet.state_dict().items()})
    x = data["validset"].batch_transform(torch.from_numpy(
        data["validset"].dataset.images[:NAS_CHECK_BATCH]).to(DEVICE), augment=False)
    (vs_cpu, vs_fixed, bundle_err), check_wall, check_counts, _, _ = _counted(
        lambda: _nas_checks(supernet, cpu, hp_super, arch, x, d))
    if vs_cpu > SERVE_REL_L2 or vs_fixed > SERVE_REL_L2 or bundle_err > SERVE_REL_L2 \
            or check_counts["K2"] != 2 * NAS_SUPERNET_CONVS + 2 * NAS_FIXED_CONVS \
            or check_counts["K2_by_dtype"] != {
                "float32": 2 * NAS_SUPERNET_CONVS + 2 * NAS_FIXED_CONVS, "bfloat16": 0}:
        raise AssertionError(f"nas checks: supernet vs CPU {vs_cpu}, forced vs fixed "
                             f"{vs_fixed}, bundle {bundle_err}, counts {check_counts}")
    launches["checks"] = check_counts["K2"]
    costs = candidate_costs(supernet)
    emit({"phase": "nas", "data": _cifar_data(), "data_s": data_s,
          "train_images": len(data["trainset"]), "valid_images": n_valid,
          "batch": NAS_BATCH, "dtype": "bfloat16",
          "cut": {"train_images": "40,000 -> 10,000 (validset_ratio 0.2 -> 0.8)",
                  "epochs": "1 per trial and per supernet"},
          "supernet_widths": "mutable_layer_1's candidates at a common 32 channels (3x3, "
                             "5x5, 7x7): the conf's 32, 16 and 8 cannot be summed by a "
                             "mixture (both packages refuse that supernet)",
          "classic": {"trials": classic, "wall_s": classic_wall,
                      "best": summary["best"]["trial"]},
          "single_shot": single, "candidate_costs": costs,
          "checks": {"supernet_f32_vs_cpu_rel_l2": vs_cpu,
                     "forced_vs_fixed_rel_l2": vs_fixed, "bundle_rel_l2": bundle_err,
                     "bound": SERVE_REL_L2, "arch": arch, "batch": NAS_CHECK_BATCH,
                     "wall_s": check_wall},
          "launches": launches,
          "launches_per_forward": {"fixed": NAS_FIXED_CONVS, "supernet": NAS_SUPERNET_CONVS},
          "card": card})
    return launches


def _nas_checks(supernet, cpu, hp_super, arch, x, d):
    """(supernet f32 on the card vs the CPU, forced-arch supernet vs the fixed
    model, the NAS bundle's served output vs the fixed model), each a rel L2."""
    with torch.no_grad():
        got = supernet(x)
        ref = cpu(x.cpu())
        forced = supernet.with_forced_arch(arch)(x)
        fixed = _fixed_from_supernet(supernet, hp_super, arch)
        want = fixed(x)
        bundle = save_model_bundle(d / "bundle", fixed)
        served = Predictor(load_model_bundle(bundle, device=DEVICE), batch_size=len(x),
                           device=DEVICE)(x.cpu().numpy())
    return _rel_l2(got.cpu(), ref), _rel_l2(forced, want), \
        _rel_l2(torch.from_numpy(served), want.cpu())


def phase_lr_find(card):
    """``python -m deepcv_tpu_torch lr-find --pipeline train_image_classifier
    --steps 100 --batch-size 4096`` in this process: the suggested LRs, the
    CSV (the card's machine has no matplotlib), 5 K2 launches a step."""
    d = _build.BUILD_DIR / "lr_find"
    shutil.rmtree(d, ignore_errors=True)
    argv = ["lr-find", "--pipeline", "train_image_classifier", "--steps", str(LR_FIND_STEPS),
            "--batch-size", str(LR_FIND_BATCH), "--project-path", str(REPO),
            "--out", str(d / "lr_range_test.png"), "--device", DEVICE]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, wall, counts, _, _ = _counted(lambda: cli.main(argv))
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    curve = Path(res["curve"])
    rows = curve.read_text().splitlines() if curve.suffix == ".csv" else []
    steps = res["steps"]
    if rc != 0 or not curve.exists() or not 0 < res["best_lr"] < 10 \
            or (rows and len(rows) != steps + 1) \
            or counts["K2"] != CLASSIFIER_CONVS_PER_FORWARD * steps or counts["K1"] != 0 \
            or counts["K2_by_dtype"] != {"float32": counts["K2"], "bfloat16": 0}:
        raise AssertionError(f"lr_find: rc {rc}, {res}, {len(rows)} csv rows, counts {counts}")
    emit({"phase": "lr_find", "argv": ["python", "-m", "deepcv_tpu_torch", *argv],
          "best_lr": res["best_lr"], "suggested": res["suggested"], "steps": steps,
          "stopped_early": steps < LR_FIND_STEPS, "curve": str(curve.relative_to(REPO)),
          "curve_rows": len(rows) - 1 if rows else None, "wall_s": wall,
          "step_ms": wall / max(1, steps) * 1e3, "data": _cifar_data(),
          "launches": {"K2": counts["K2"], "K2_by_dtype": counts["K2_by_dtype"]},
          "card": card})
    return counts


# --------------------------------------------------------------------------- #
# The data plane: the learned lossless codec, SinGAN, WFC, viz
# --------------------------------------------------------------------------- #

#: bench.py config 14 (``bench_codec``) at its TPU settings: the first 4,096
#: CIFAR-10 training images, the last 32 held out and all 32 coded; hidden
#: 48, 600 steps at batch 64, lr 3e-3, ``coding_batch`` 32
CODEC_IMAGES, CODEC_HELD_OUT, CODEC_HIDDEN = 4096, 32, 48
CODEC_STEPS, CODEC_BATCH, CODEC_LR = 600, 64, 3e-3
#: the card's model bits per subpixel against the CPU path's, same weights
CODEC_BPD_TOL = 1e-4
#: the video codec written to and read from a .dvv container: clips of a
#: square moving over a gradient, 32x32, fitted briefly
DVV_CLIPS, DVV_FRAMES, DVV_HIDDEN, DVV_STEPS = 4, 8, 16, 100
#: SinGAN at ``train_singan``'s defaults (3 scales, 300 steps a scale, 32
#: features) on one 64x64 image; WFC's batch of tilemaps
SINGAN_SIZE, SINGAN_VARIANTS = 64, 8
SINGAN_STEPS = 300           # train_singan's steps_per_scale
WFC_GRID, WFC_MAPS = (32, 32), 16
#: the WFC exemplar: sea (0), coast (1) and land (2); land never touches sea
WFC_EXEMPLAR = np.array([[0, 0, 1, 2, 2], [0, 1, 1, 2, 2], [1, 1, 2, 2, 2], [0, 1, 1, 1, 2],
                         [0, 0, 1, 2, 2]], dtype=np.int32)


def _moving_clips(n, t, size=32, seed=SEED):
    """Clips of a bright 6x6 square moving one pixel a frame over a
    horizontal gradient."""
    rng = np.random.default_rng(seed)
    base = np.broadcast_to(np.linspace(40, 120, size, dtype=np.float32)[None, :, None],
                           (size, size, 3))
    clips = np.empty((n, t, size, size, 3), np.uint8)
    for i in range(n):
        y, x = rng.integers(0, size - 6 - t, 2)
        for f in range(t):
            frame = base.copy()
            frame[y + f:y + f + 6, x + f:x + f + 6] = 220
            clips[i, f] = frame.astype(np.uint8)
    return clips


def phase_codec(card):
    """bench.py config 14 on the card, then the video codec through .dvv."""
    from deepcv_tpu_torch.codec import LosslessCodec, LosslessVideoCodec
    from deepcv_tpu_torch.data.datasets import load_dataset
    from deepcv_tpu_torch.data.video_io import read_dvv, write_dvv

    raw = load_dataset("cifar10", root=str(REPO / "data" / "01_raw"), train=True)
    imgs = np.asarray(raw.images[:CODEC_IMAGES], np.uint8)
    train_imgs, test_imgs = imgs[:-CODEC_HELD_OUT], imgs[-CODEC_HELD_OUT:]
    shape = tuple(imgs.shape[1:])
    codec = LosslessCodec(shape, n_scales=2, hidden=CODEC_HIDDEN, seed=0,
                          coding_batch=CODEC_HELD_OUT, device=DEVICE)
    t0 = time.perf_counter()
    history = codec.fit(train_imgs, steps=CODEC_STEPS, batch_size=CODEC_BATCH, lr=CODEC_LR,
                        seed=0)
    fit_s = time.perf_counter() - t0
    codec.encode_batch(test_imgs)                           # warm
    t0 = time.perf_counter()
    blobs = codec.encode_batch(test_imgs)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = codec.decode_batch(blobs)
    t_dec = time.perf_counter() - t0
    lossless = int((decoded == test_imgs).reshape(len(test_imgs), -1).all(1).sum())
    report = codec.evaluate(test_imgs, n_code=CODEC_HELD_OUT)
    # the same weights on the CPU path: its rate, and whether its streams are
    # the card's (not promised: a stream decodes on the device kind that coded it)
    cpu = LosslessCodec(shape, n_scales=2, hidden=CODEC_HIDDEN, seed=0,
                        coding_batch=CODEC_HELD_OUT, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in codec.model.state_dict().items()})
    bpd_card, bpd_cpu = codec.bits_per_dim(test_imgs), cpu.bits_per_dim(test_imgs)
    rel = abs(bpd_card - bpd_cpu) / bpd_cpu
    same_streams = sum(a == b for a, b in zip(cpu.encode_batch(test_imgs[:4]), blobs[:4]))

    clips = _moving_clips(DVV_CLIPS, DVV_FRAMES)
    video = LosslessVideoCodec(shape, n_scales=2, hidden=DVV_HIDDEN, seed=0,
                               coding_batch=DVV_FRAMES, device=DEVICE)
    t0 = time.perf_counter()
    video.fit(clips[:-1], steps=DVV_STEPS, batch_size=16, seed=0)
    path = _build.BUILD_DIR / "codec_clips.dvv"
    written = write_dvv(path, clips, video)
    back = read_dvv(path, video)
    dvv_s = time.perf_counter() - t0
    video_report = video.evaluate(clips[-1:], n_code=1)
    dvv_bytes = path.stat().st_size
    path.unlink()
    px = CODEC_HELD_OUT * shape[0] * shape[1]
    line = {"phase": "codec",
            "settings": "bench.py config 14 (bench_codec), its TPU settings: 4,064 training "
                        "and 32 held-out 32x32x3 images, n_scales 2, hidden 48, 600 steps at "
                        "batch 64, lr 3e-3, coding_batch 32; TF32 off, cuDNN deterministic",
            "data": _cifar_data(), "provenance": raw.provenance,
            "fit_s": fit_s, "fit_steps_s": CODEC_STEPS / fit_s,
            "loss_first": history[0], "loss_last": history[-1],
            "model_bits_per_dim": report["bits_per_dim"],
            "coded_bits_per_dim": report["coded_bits_per_dim"],
            "vs_raw": 8.0 / report["coded_bits_per_dim"],
            "coded_bytes_mean": report["coded_bytes_mean"],
            "png_bytes_mean": report.get("png_bytes_mean"), "vs_png": report.get("vs_png"),
            "png": "stdlib writer (zlib level 9, per-row least-sum filter)",
            "encode_s": t_enc, "decode_s": t_dec, "encode_px_s": px / t_enc,
            "decode_px_s": px / t_dec, "lossless": f"{lossless}/{CODEC_HELD_OUT}",
            "native_coder": codec.native_coder,
            "cpu_check": {"bits_per_dim_card": bpd_card, "bits_per_dim_cpu": bpd_cpu,
                          "rel": rel, "tol": CODEC_BPD_TOL,
                          "cpu_streams_equal_card": f"{same_streams}/4"},
            "dvv": {"clips": written, "frames": DVV_FRAMES, "bytes": dvv_bytes,
                    "raw_bytes": int(clips.nbytes), "roundtrip": bool(np.array_equal(back, clips)),
                    "fit_write_read_s": dvv_s, **video_report},
            "card": card}
    emit(line)
    if lossless != CODEC_HELD_OUT or not codec.native_coder or not rel <= CODEC_BPD_TOL \
            or not line["dvv"]["roundtrip"] or not np.isfinite(history).all():
        raise AssertionError(f"codec failed: {line}")


def _structured_image(size=SINGAN_SIZE):
    """A 64x64 image of gradients, stripes and a checker, as uint8."""
    y, x = np.mgrid[0:size, 0:size] / (size - 1)
    img = np.stack([x, 0.5 + 0.5 * np.sin(6 * np.pi * y),
                    ((np.floor(x * 8) + np.floor(y * 8)) % 2) * 0.6 + 0.2], -1)
    return (img * 255).astype(np.uint8)


def phase_data_gen(card):
    """SinGAN at ``train_singan``'s defaults, WFC's tilemaps and a texture,
    and a viz grid, on the card."""
    from deepcv_tpu_torch.data import wfc
    from deepcv_tpu_torch.data.singan import SinGAN, train_singan
    from deepcv_tpu_torch.data.viz import make_grid

    img = _structured_image()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, hist = train_singan(img, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    singan_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    samples = model.sample(n=SINGAN_VARIANTS, start_scale=1, generator=gen)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    rec = model.reconstruct()
    # the fixed-noise reconstruction on the CPU path, the same generators
    cpu_model = SinGAN([copy.deepcopy(g).cpu() for g in model.generators], model.noise_amps,
                       model.shapes, model.features, model.rec_z0.cpu(), model.channels)
    rec_rel = float(torch.linalg.vector_norm(rec.cpu() - cpu_model.reconstruct())
                    / torch.linalg.vector_norm(cpu_model.reconstruct()))
    rec_rmse = float(torch.sqrt(((rec[0].cpu() - torch.from_numpy(img) / 255.0) ** 2).mean()))
    grid = make_grid(samples, n_cols=4)

    adj, weights = wfc.adjacency_from_exemplar(WFC_EXEMPLAR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = wfc.sample_tilemaps(adj, weights, WFC_GRID, WFC_MAPS, gen, device=DEVICE)
    wfc_s = time.perf_counter() - t0
    valid = sum(wfc.validate_tilemap(m, adj) for m in maps)
    t0 = time.perf_counter()
    texture = wfc.generate_texture(img.astype(np.float32) / 255.0, (16, 16), gen, tile_size=4,
                                   max_tiles=12, seed=0, device=DEVICE)
    texture_s = time.perf_counter() - t0
    line = {"phase": "data_gen",
            "singan": {"settings": "train_singan's defaults (3 scales, 300 steps a scale, 32 "
                                   "features, lr 5e-4, rec_weight 10) on one 64x64 image",
                       "shapes": model.shapes, "train_s": singan_s,
                       "steps_s": len(model.shapes) * SINGAN_STEPS / singan_s,
                       "scales": hist["scales"],
                       "sample_s": sample_s, "variants": list(samples.shape),
                       "recon_rmse": rec_rmse, "recon_card_vs_cpu_rel_l2": rec_rel,
                       "bound_rel_l2": SERVE_REL_L2},
            "wfc": {"grid": list(WFC_GRID), "maps": WFC_MAPS, "valid": valid,
                    "distinct": len({m.tobytes() for m in maps}), "wall_s": wfc_s,
                    "texture_shape": list(texture.shape), "texture_s": texture_s},
            "viz_grid": list(grid.shape), "card": card}
    emit(line)
    ok_scales = all(np.isfinite([s["g_loss_last"], s["rec_last"]]).all()
                    and s["rec_last"] < s["rec_first"] for s in hist["scales"])
    if not ok_scales or not rec_rel <= SERVE_REL_L2 or valid != WFC_MAPS \
            or tuple(samples.shape) != (SINGAN_VARIANTS, SINGAN_SIZE, SINGAN_SIZE, 3) \
            or not bool(torch.isfinite(samples).all()) or texture.shape != (64, 64, 3) \
            or grid.shape != (-(-SINGAN_VARIANTS // 4) * (SINGAN_SIZE + 2) + 2,
                              min(4, SINGAN_VARIANTS) * (SINGAN_SIZE + 2) + 2, 3):
        raise AssertionError(f"data_gen failed: {line}")


# --------------------------------------------------------------------------- #
# Active learning, boosting, Reptile and the tooling
# --------------------------------------------------------------------------- #

AL_POOL, AL_INIT, AL_ACQUIRE, AL_ROUNDS, AL_MC = 4096, 1024, 512, 3, 8
AL_VALID, AL_SCORE_BATCH = 2048, 512
BOOST_IMAGES, BOOST_ROUNDS, BOOST_STEPS, BOOST_BATCH = 10_000, 3, 100, 256
BOOST_LR = 0.02
#: the share of boosting's labels replaced by uniform draws (seeded)
BOOST_LABEL_NOISE = 0.2
BOOST_CHECK_IMAGES, BOOST_CHECK_STEPS, BOOST_CHECK_BATCH = 256, 3, 32
#: the card-vs-CPU checks' step sizes: at the runs' own (0.02 with momentum,
#: Reptile's inner 0.05) these few steps of the wide classifier amplify f32's
#: sum-order differences between cuDNN and the CPU past 1e-4 (the whole
#: vector 8.6e-5 and 1.7e-4 on an H100); a stale packed weight still moves
#: the parameters by a share of their update
BOOST_CHECK_LR, META_CHECK_INNER_LR = 0.005, 0.005
#: card vs CPU after the same SGD or Reptile steps (relative to max|ref|)
TRAIN_CHECK_RTOL = 1e-4
META_TRAIN_CLASSES, META_PER_CLASS, META_WAY, META_SHOT, META_QUERIES = 6, 200, 4, 5, 5
META_STEPS, META_BATCH, META_INNER, META_EPISODES = 50, 4, 5, 5
#: the card-vs-CPU check: 2 meta-steps of 2 episodes and 3 inner steps
META_CHECK_STEPS, META_CHECK_BATCH, META_CHECK_INNER = 2, 2, 3
TOOLING_BATCH, TOOLING_ITERS = 1024, 3
TOOLING_PROCESS_S = 300
WIDE_GN_FLOPS_PER_IMAGE = 305_610_752


@functools.lru_cache(maxsize=1)
def _cifar10_train():
    """The catalog's CIFAR-10 training set (uint8 NHWC, int64 labels)."""
    from deepcv_tpu_torch.pipelines import ProjectContext

    return ProjectContext(REPO, device=DEVICE).load_catalog_entry("cifar10_train")


def _cifar_normalized(images: np.ndarray) -> np.ndarray:
    """uint8 NHWC -> the conf's to_tensor + normalize, float32 on the host."""
    return ((images.astype(np.float32) / 255.0 - np.asarray(CIFAR_MEAN, np.float32))
            / np.asarray(CIFAR_STD, np.float32))


def _wide_gn_hp(classes):
    hp = copy.deepcopy(conf_hp("wide_classifier_gn_model"))
    hp["architecture"][-1]["fully_connected"]["out_features"] = classes
    return hp


def _max_rel_params(got: torch.nn.Module, ref: torch.nn.Module) -> float:
    ref_sd = ref.state_dict()
    return max(float((t.double().cpu() - ref_sd[k].double()).abs().max()
                     / max(float(ref_sd[k].double().abs().max()), 1e-30))
               for k, t in got.state_dict().items())


def _rel_l2_params(got: torch.nn.Module, ref: torch.nn.Module) -> float:
    """||got - ref|| / ||ref|| over all of the models' tensors at once."""
    ref_sd = ref.state_dict()
    diff = sum(float((t.double().cpu() - ref_sd[k].double()).square().sum())
               for k, t in got.state_dict().items())
    return math.sqrt(diff / sum(float(t.double().square().sum()) for t in ref_sd.values()))


def phase_active_learning(card):
    """``active_learning_loop`` on the card with the conf's classifier and
    training hp; the scoring forwards' K2 launches counted apart."""
    from deepcv_tpu_torch.data.preprocess import parse_transforms_specification
    from deepcv_tpu_torch.data.training_metadata import MetaTracker
    from deepcv_tpu_torch.train import active_learning as al
    from deepcv_tpu_torch.train.loggers import ExperimentTracker

    d = _build.BUILD_DIR / "active_learning"
    shutil.rmtree(d, ignore_errors=True)
    raw = _cifar10_train()
    tf = parse_transforms_specification(conf_hp("cifar10_preprocessing")["transforms"])
    pool = PreprocessedDataset(raw.subset(np.arange(AL_POOL), name="al_pool"), tf)
    valid = PreprocessedDataset(raw.subset(np.arange(AL_POOL, AL_POOL + AL_VALID),
                                           name="al_valid"), tf)
    model_hp = copy.deepcopy(conf_hp("image_classifier_model"))
    model_hp["architecture"][-1]["fully_connected"].update(out_features=10, dropout_prob=0.1)
    training_hp = {**conf_hp("train_image_classifier"), "output_path": str(d / "runs"),
                   "save_every_iters": 0, "log_progress_every_iters": 1_000_000,
                   "handle_preemption": False}
    scoring = {"forwards": 0, "K2": 0}
    real_score = al.mc_class_probabilities

    def counted_score(model, pool_, indices, **kw):
        before = fused_conv2d_bias_act.launches
        out = real_score(model, pool_, indices, **kw)
        scoring["K2"] += fused_conv2d_bias_act.launches - before
        scoring["forwards"] += kw["n_samples"] * math.ceil(len(indices) / kw["batch_size"])
        return out

    with mock.patch.object(al, "mc_class_probabilities", counted_score):
        res, wall, counts, _, _ = _counted(lambda: al.active_learning_loop(
            (32, 32, 3), model_hp, training_hp, cross_entropy_loss,
            {"poolset": pool, "validset": valid}, rounds=AL_ROUNDS,
            acquire_per_round=AL_ACQUIRE, init_labeled=AL_INIT, acquisition="bald",
            n_mc=AL_MC, seed=SEED, score_batch_size=AL_SCORE_BATCH, device=DEVICE))
    rounds = res["rounds"]
    batch, epochs = int(training_hp["batch_size"]), int(training_hp["epochs"])
    train_forwards = sum(epochs * (r["n_labeled"] // batch) for r in rounds)
    val_forwards = AL_ROUNDS * epochs * math.ceil(AL_VALID / min(32 * batch, AL_VALID))
    forwards = train_forwards + val_forwards + scoring["forwards"]
    seen = set(int(i) for i in np.sort(np.setdiff1d(res["labeled_indices"], np.concatenate(
        [r["acquired"] for r in rounds]))))
    fresh = []
    for r in rounds[:-1]:
        acquired = set(r["acquired"])
        fresh.append(len(acquired) == AL_ACQUIRE and not acquired & seen)
        seen |= acquired
    if len(rounds) != AL_ROUNDS or [r["n_labeled"] for r in rounds] != \
            [AL_INIT + AL_ACQUIRE * k for k in range(AL_ROUNDS)] or not all(fresh) \
            or rounds[-1]["acquired"] or len(seen) != AL_INIT + AL_ACQUIRE * (AL_ROUNDS - 1) \
            or not all(np.isfinite(r["valid_loss"]) for r in rounds):
        raise AssertionError(f"active_learning rounds: {rounds}")
    if counts["K2"] != CLASSIFIER_CONVS_PER_FORWARD * forwards \
            or scoring["K2"] != CLASSIFIER_CONVS_PER_FORWARD * scoring["forwards"] \
            or counts["K2_by_dtype"] != {"float32": counts["K2"], "bfloat16": 0}:
        raise AssertionError(f"active_learning counts {counts}, scoring {scoring}, "
                             f"{forwards} forwards")

    # card vs CPU: the last model with dropout off, in f32, on the rest of the pool
    check_hp = copy.deepcopy(model_hp)
    check_hp["architecture"][-1]["fully_connected"]["dropout_prob"] = 0.0
    state = {k: v.detach().cpu() for k, v in res["model"].state_dict().items()}
    gpu = DeepcvModule((32, 32, 3), check_hp, device=DEVICE)
    cpu = DeepcvModule((32, 32, 3), check_hp, device="cpu")
    gpu.load_state_dict(state)
    cpu.load_state_dict(state)
    rest = np.setdiff1d(np.arange(AL_POOL), res["labeled_indices"])
    kw = dict(n_samples=1, batch_size=AL_SCORE_BATCH, seed=SEED)
    p_gpu = al.mc_class_probabilities(gpu, pool, rest, **kw)
    p_cpu = al.mc_class_probabilities(cpu, pool, rest, **kw)
    prob_err = float(np.abs(p_gpu - p_cpu).max())
    s_gpu, s_cpu = (al.acquisition_scores(p, "entropy") for p in (p_gpu, p_cpu))
    top_gpu, top_cpu = (set(np.argsort(s)[::-1][:AL_ACQUIRE].tolist()) for s in (s_gpu, s_cpu))
    kth = np.sort(s_cpu)[::-1][AL_ACQUIRE - 1]
    tie = F32_TOL * float(np.abs(s_cpu).max())
    untied = [i for i in top_gpu ^ top_cpu if abs(s_cpu[i] - kth) > tie]
    if not prob_err <= F32_TOL or untied:
        raise AssertionError(f"active_learning card vs CPU: probabilities {prob_err}, top-"
                             f"{AL_ACQUIRE} differ at untied {untied[:8]}")

    store = d / "experiments"
    for r in rounds:
        tr = ExperimentTracker(root=str(store), experiment="active_learning",
                               run_name=f"round_{r['round']}")
        tr.log_params({"acquisition": "bald", "n_mc": AL_MC, "pool": AL_POOL,
                       "n_labeled": r["n_labeled"], "training": training_hp})
        tr.log_metrics({k: v for k, v in r.items() if k.startswith("valid_")}, step=r["round"])
        tr.end_run()
    meta = MetaTracker(d / "metadataset")
    meta.store(MetaTracker.experiment_from_training(
        res["model"], training_hp, res["history"],
        PreprocessedDataset(raw.subset(res["labeled_indices"]), tf)))
    emit({"phase": "active_learning", "model": "image_classifier_model (head dropout 0.1)",
          "pool": AL_POOL, "rounds": [{k: v for k, v in r.items() if k != "acquired"}
                                      for r in rounds],
          "acquired_per_round": [len(r["acquired"]) for r in rounds],
          "forwards": {"train": train_forwards, "validation": val_forwards,
                       "scoring": scoring["forwards"]},
          "launches": {"K2": counts["K2"], "K2_scoring": scoring["K2"],
                       "K2_by_dtype": counts["K2_by_dtype"]},
          "launches_per_forward": {"K2": counts["K2"] / forwards},
          "cpu_check": {"images": len(rest), "max_abs_prob_err": prob_err,
                        "tol": F32_TOL, "top_k": AL_ACQUIRE,
                        "top_k_differ": len(top_gpu ^ top_cpu), "untied": len(untied)},
          "metadataset": meta.scaling_triplets(), "tracker_store": str(store.relative_to(REPO)),
          "wall_s": wall, "data": _cifar_data(), "card": card})
    return counts, store


def phase_boosting(card):
    """SAMME on the wide classifier (group norm), f32, on the card; then the
    card's first SGD steps against the CPU's."""
    from deepcv_tpu_torch.train import boosting

    raw = _cifar10_train()
    images = _cifar_normalized(raw.images[:BOOST_IMAGES])
    labels = np.asarray(raw.targets[:BOOST_IMAGES], np.int64)
    # the stand-in's classes are separable: noisy labels keep every member
    # imperfect, so SAMME runs its rounds instead of stopping at a perfect one
    rng = np.random.default_rng(SEED)
    noisy = rng.random(BOOST_IMAGES) < BOOST_LABEL_NOISE
    labels[noisy] = rng.integers(0, 10, int(noisy.sum()))
    hp = _wide_gn_hp(10)
    model = DeepcvModule((32, 32, 3), hp, device=DEVICE)
    (ens, hist), wall, counts, _, _ = _counted(lambda: boosting.adaboost_train(
        model, images, labels, rounds=BOOST_ROUNDS, num_classes=10,
        inner_steps=BOOST_STEPS, batch_size=BOOST_BATCH, lr=BOOST_LR, seed=SEED))
    k = len(ens.members)
    # a round stopped at chance trained and predicted but kept no member
    ran = k + (k < BOOST_ROUNDS and hist["err"][-1] > 1e-8)
    chunks = math.ceil(BOOST_IMAGES / 512)
    forwards = ran * (BOOST_STEPS + chunks) + chunks * sum(r + 1 for r in range(k))
    if len(hist["err"]) != k or not 1 <= k <= BOOST_ROUNDS \
            or not all(0 < a <= boosting.ALPHA_CAP for a in ens.alphas) \
            or not all(0 <= e < 0.9 for e in hist["err"]):
        raise AssertionError(f"boosting: {hist}")
    if counts["K2"] != WIDE_CONVS_PER_FORWARD * forwards \
            or counts["K2_by_dtype"] != {"float32": counts["K2"], "bfloat16": 0}:
        raise AssertionError(f"boosting counts {counts} for {forwards} forwards")

    # card vs CPU: round 0's init and index batches, 3 steps at batch 32
    init_seed, batch_seed = boosting._round_seeds(SEED, 0)
    init = DeepcvModule((32, 32, 3), hp, device="cpu",
                        generator=torch.Generator().manual_seed(init_seed)).state_dict()
    gen = torch.Generator().manual_seed(batch_seed)
    n = BOOST_CHECK_IMAGES
    index_batches = [torch.randint(0, n, (BOOST_CHECK_BATCH,), generator=gen)
                     for _ in range(BOOST_CHECK_STEPS)]
    fitted = {}
    for dev in (DEVICE, "cpu"):
        m = DeepcvModule((32, 32, 3), hp, device=dev)
        m.load_state_dict(init)
        x = torch.from_numpy(images[:n]).to(dev)
        y = torch.from_numpy(labels[:n]).to(dev)
        w = torch.full((n,), 1.0 / n, device=dev)
        boosting._train_round(m, x, y, w, index_batches, lr=BOOST_CHECK_LR, momentum=0.9,
                              generator=torch.Generator(device=dev))
        _, err, alpha = boosting._reweight(w, boosting._predict(m, None, x, 512), y, 10)
        fitted[dev] = (m, float(err), float(alpha))
    (g, g_err, g_alpha), (c, c_err, c_alpha) = fitted[DEVICE], fitted["cpu"]
    # the whole parameter vector, as reptile_cpu_check (why: its docstring);
    # a tensor-wise error read 4.5e-6 and 1.2e-2 in two calls on one H100
    param_rel, tensor_rel = _rel_l2_params(g, c), _max_rel_params(g, c)
    err_rel = abs(g_err - c_err) / abs(c_err)
    alpha_rel = abs(g_alpha - c_alpha) / abs(c_alpha)
    if not max(param_rel, err_rel, alpha_rel) <= TRAIN_CHECK_RTOL:
        raise AssertionError(f"boosting card vs CPU: params rel L2 {param_rel} (largest "
                             f"tensor-wise {tensor_rel}), err {g_err} vs "
                             f"{c_err}, alpha {g_alpha} vs {c_alpha}")
    emit({"phase": "boosting", "model": "wide_classifier_gn_model, float32",
          "images": BOOST_IMAGES, "label_noise": BOOST_LABEL_NOISE, "rounds": k,
          "inner_steps": BOOST_STEPS,
          "batch": BOOST_BATCH, "err": hist["err"], "alpha": hist["alpha"],
          "vote_accuracy": hist["vote_accuracy"], "forwards": forwards,
          "launches": {"K2": counts["K2"], "K2_by_dtype": counts["K2_by_dtype"]},
          "launches_per_forward": {"K2": counts["K2"] / forwards},
          "step_ms_incl_eval": wall / (k * BOOST_STEPS) * 1e3,
          "cpu_check": {"steps": BOOST_CHECK_STEPS, "batch": BOOST_CHECK_BATCH, "images": n,
                        "lr": BOOST_CHECK_LR,
                        "rel_l2_param_err": param_rel, "max_tensor_rel_err": tensor_rel,
                        "err": [g_err, c_err],
                        "alpha": [g_alpha, c_alpha], "tol": TRAIN_CHECK_RTOL},
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "wall_s": wall, "data": _cifar_data(), "card": card})
    return counts


def reptile_cpu_check(hp, init, images, labels, kw):
    """2 meta-steps (of 2 episodes and 3 inner steps at
    ``META_CHECK_INNER_LR``) on the card and on the CPU from the same
    parameters and episodes: the relative L2 error of the
    whole parameter vector, and the largest tensor-wise one. The first is
    the check: the conv biases ahead of group norm stay near 0 and take
    noise-level gradients, so a tensor-wise error reads their noise (a 1e-6
    nudge of the init moves them 1e-2 in 2 meta-steps on the CPU), while a
    stale packed weight moves the whole vector."""
    from deepcv_tpu_torch.train import meta_learning as meta

    fitted = []
    for dev in (DEVICE, "cpu"):
        m = DeepcvModule((32, 32, 3), hp, device=dev)
        m.load_state_dict(init)
        meta.reptile_train(m, images, labels, meta_steps=META_CHECK_STEPS,
                           **{**kw, "meta_batch": META_CHECK_BATCH,
                              "inner_steps": META_CHECK_INNER,
                              "inner_lr": META_CHECK_INNER_LR})
        fitted.append(m)
    return _rel_l2_params(*fitted), _max_rel_params(*fitted)


def phase_meta_learning(card):
    """Reptile on the wide classifier with a 4-way head, then adaptation to
    the held-out classes; the card's first meta-steps against the CPU's."""
    from deepcv_tpu_torch.train import meta_learning as meta

    raw = _cifar10_train()
    labels_all = np.asarray(raw.targets, np.int64)
    pick = np.concatenate([np.flatnonzero(labels_all == c)[:META_PER_CLASS] for c in range(10)])
    images, labels = _cifar_normalized(raw.images[np.sort(pick)]), labels_all[np.sort(pick)]
    train_mask = labels < META_TRAIN_CLASSES
    hp = _wide_gn_hp(META_WAY)
    model = DeepcvModule((32, 32, 3), hp, device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED))
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    kw = dict(n_way=META_WAY, k_shot=META_SHOT, q_queries=META_QUERIES, meta_batch=META_BATCH,
              inner_steps=META_INNER, inner_lr=0.05, meta_lr=0.5, meta_lr_final=0.05,
              seed=SEED)
    sx, sy, qx, qy = meta.sample_episodes(images[~train_mask], labels[~train_mask],
                                          n_way=META_WAY, k_shot=META_SHOT,
                                          q_queries=META_QUERIES, n_episodes=META_EPISODES,
                                          rng=np.random.default_rng(SEED))

    def run():
        _, hist = meta.reptile_train(model, images[train_mask], labels[train_mask],
                                     meta_steps=META_STEPS, **kw)
        accs = [meta.episode_accuracy(meta.adapt(model, sx[e], sy[e], steps=META_INNER,
                                                 lr=0.05), qx[e], qy[e])
                for e in range(META_EPISODES)]
        return hist, accs

    (hist, accs), wall, counts, _, _ = _counted(run)
    forwards = META_STEPS * META_BATCH * (META_INNER + 1) + META_EPISODES * (META_INNER + 1)
    if len(hist["query_accuracy"]) != META_STEPS \
            or not all(0.0 <= a <= 1.0 for a in [*hist["query_accuracy"], *accs]):
        raise AssertionError(f"meta_learning: {hist}, {accs}")
    if counts["K2"] != WIDE_CONVS_PER_FORWARD * forwards \
            or counts["K2_by_dtype"] != {"float32": counts["K2"], "bfloat16": 0}:
        raise AssertionError(f"meta_learning counts {counts} for {forwards} forwards")

    param_rel, tensor_rel = reptile_cpu_check(hp, init, images[train_mask],
                                              labels[train_mask], kw)
    if not param_rel <= TRAIN_CHECK_RTOL:
        raise AssertionError(f"meta_learning card vs CPU: params rel L2 {param_rel} "
                             f"(largest tensor-wise {tensor_rel})")
    emit({"phase": "meta_learning", "model": f"wide_classifier_gn_model, {META_WAY}-way head",
          "classes": {"meta_train": META_TRAIN_CLASSES, "held_out": 10 - META_TRAIN_CLASSES,
                      "images_per_class": META_PER_CLASS},
          "settings": {"meta_steps": META_STEPS, **{k: v for k, v in kw.items()
                                                    if k != "seed"}},
          "query_accuracy_first5": hist["query_accuracy"][:5],
          "query_accuracy_last5": hist["query_accuracy"][-5:],
          "held_out_accuracy": accs, "held_out_mean": float(np.mean(accs)),
          "forwards": forwards,
          "launches": {"K2": counts["K2"], "K2_by_dtype": counts["K2_by_dtype"]},
          "launches_per_forward": {"K2": counts["K2"] / forwards},
          "meta_step_ms": wall / META_STEPS * 1e3,
          "cpu_check": {"meta_steps": META_CHECK_STEPS, "meta_batch": META_CHECK_BATCH,
                        "inner_steps": META_CHECK_INNER, "inner_lr": META_CHECK_INNER_LR,
                        "rel_l2_param_err": param_rel,
                        "max_tensor_rel_err": tensor_rel,
                        "tol": TRAIN_CHECK_RTOL},
          "wall_s": wall, "data": _cifar_data(), "card": card})
    return counts


def phase_tooling_process(card, tracker_store):
    """:func:`phase_tooling` in a process of its own (``chip_smoke.py
    --tooling CARD STORE``), its lines passed on; returns its launch
    counts. Late in the whole run the profiler kept 14 of the traced step's
    18 K2 records in each of 3 tries, as it lost U-Net's and the FPN's (the
    profiles of those run in processes of their own too)."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tooling", card,
                           str(tracker_store)], capture_output=True, text=True,
                          timeout=TOOLING_PROCESS_S, cwd=REPO)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    sys.stderr.write(proc.stderr)
    sys.stderr.flush()
    if proc.returncode != 0:
        raise AssertionError(f"tooling: its process exited {proc.returncode}")
    line = next(json.loads(ln) for ln in reversed(proc.stdout.splitlines())
                if ln.startswith('{"phase": "tooling"'))
    return line["launches"]


def phase_tooling(card, tracker_store):
    """``profiling`` on the card (op breakdown, FLOPs, MFU, determinism), the
    dashboard over ``tracker_store`` and the docs build."""
    from deepcv_tpu_torch import profiling
    from deepcv_tpu_torch.dashboard import DashboardServer, scan_runs
    from deepcv_tpu_torch.docs_build import build_docs

    raw = _cifar10_train()
    x = torch.from_numpy(_cifar_normalized(raw.images[:TOOLING_BATCH])).to(DEVICE)
    model = DeepcvModule((32, 32, 3), _wide_gn_hp(10), device=DEVICE, dtype="bfloat16")

    def fwd_bwd(xb):
        model.zero_grad(set_to_none=True)
        model(xb).float().square().mean().backward()

    def forward(xb):
        with torch.no_grad():
            return model(xb)

    def run():
        for tries in range(1, 4):
            rows = profiling.profile_op_breakdown(fwd_bwd, x, iters=TOOLING_ITERS, top=0,
                                                  log_dir=str(_build.BUILD_DIR / "profile"))
            k2 = [r for r in rows if "fused_conv2d_bias_act" in r["op"]]
            if sum(r["count"] for r in k2) == WIDE_CONVS_PER_FORWARD * TOOLING_ITERS:
                break
        flops = profiling.model_flops(model, batch_size=TOOLING_BATCH)
        model.eval()
        mfu = profiling.mfu_report(forward, x, flops=flops["flops"], n=20)
        det = profiling.check_determinism(forward, x)
        model.train()
        return rows, k2, tries, flops, mfu, det

    (rows, k2, tries, flops, mfu, det), wall, counts, _, _ = _counted(run)
    k2_profiled = sum(r["count"] for r in k2)
    forwards = tries * (1 + TOOLING_ITERS) + (1 + 20) + 2
    if k2_profiled != WIDE_CONVS_PER_FORWARD * TOOLING_ITERS \
            or flops["flops_per_image"] != WIDE_GN_FLOPS_PER_IMAGE or det != 0.0 \
            or mfu["device_kind"] != torch.cuda.get_device_name(0) \
            or counts["K2"] != WIDE_CONVS_PER_FORWARD * forwards \
            or counts["K2_by_dtype"] != {"float32": 0, "bfloat16": counts["K2"]}:
        raise AssertionError(f"tooling: K2 rows {k2}, flops {flops}, determinism {det}, "
                             f"mfu {mfu}, counts {counts} for {forwards} forwards")
    server = DashboardServer(tracker_store, port=0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        conn.request("GET", "/")
        resp = conn.getresponse()
        index = resp.read().decode()
        conn.close()
    finally:
        server.stop()
    runs = scan_runs(tracker_store)
    if resp.status != 200 or not runs or any(r["run_id"] not in index for r in runs):
        raise AssertionError(f"dashboard: status {resp.status}, {len(runs)} runs")
    pages = build_docs(out_dir=str(_build.BUILD_DIR / "docs"), root=str(REPO))
    emit({"phase": "tooling", "model": "wide_classifier_gn_model, bfloat16",
          "batch": TOOLING_BATCH,
          "op_breakdown": {"iters": TOOLING_ITERS, "tries": tries, "top": rows[:10],
                           "K2_rows": k2, "K2_count": k2_profiled,
                           "K2_ms": sum(r["total_ms"] for r in k2)},
          "model_flops": flops, "mfu": mfu, "determinism_max_dev": det,
          "dashboard": {"status": resp.status, "runs": len(runs)},
          "docs_pages": len(pages),
          "launches": {"K2": counts["K2"], "K2_by_dtype": counts["K2_by_dtype"]},
          "wall_s": wall, "card": card})
    return counts


class _Walls:
    """Wall seconds of each phase of a run, by the phase's name."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def main() -> int:
    faulthandler.dump_traceback_later(HANG_LIMIT_S, exit=True)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--k2-forward"]:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        card = phase_device()
        phase_kernel_forward(card, "bfloat16")
        phase_kernel_forward(card, "float32")
        phase_resnet50_predictor(card)
        return 0
    if sys.argv[1:] == ["--k3-forward"]:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        phase_k3_forward_f32(phase_device())
        return 0
    if sys.argv[1:] == ["--k45-f32"]:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        phase_k45_f32(phase_device())
        return 0
    if sys.argv[1:] == ["--k1"]:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        card = phase_device()
        phase_build(("fused_augment", "fused_conv2d_bias_act"))
        phase_augment_kernel(card)
        phase_k1_train(card)
        return 0
    if sys.argv[1:2] == ["--unet-profile"] and len(sys.argv) == 4:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        unet_train_profile(sys.argv[3], float(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--fpn-profile"] and len(sys.argv) == 4:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        fpn_train_profile(sys.argv[3], float(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--remat-profile"] and len(sys.argv) == 3:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        remat_train_profile(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--tooling"] and len(sys.argv) == 4:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        phase_tooling(sys.argv[2], Path(sys.argv[3]))
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    # references in true float32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    walls = _Walls()
    card = walls("device", phase_device)
    data = _cifar_data()
    walls("build", phase_build)
    # K1's device times first: after the train phases' long profiles the
    # profiler has kept only half of K1's launches in a window, every time
    aug_rows = walls("augment_kernel", phase_augment_kernel, card)
    k2_rows = walls("kernel", phase_kernel, card)
    flash_rows = walls("flash_kernels", phase_flash_kernels, card)
    k2_line, serve_models = walls("serve", phase_serve, card)
    int8_rows = walls("int8_kernel", phase_int8_kernel, card)
    int8_launches, int8_by_route = walls("int8_serve", phase_int8_serve, card, data)
    extras = walls("serve_extras", phase_serve_extras, card, serve_models)
    int8_by_route = {r: n + extras["int8_conv_by_route"][r] for r, n in int8_by_route.items()}
    del serve_models
    serve_launches = walls("vit_serve", phase_vit_serve, card)
    train_launches, vit_step_ms, vit_median_ms = walls("vit_train", phase_vit_train, card)
    walls("vit_train_profile", phase_vit_train_profile, card, vit_step_ms,
          "vit_train_profile", SHORT_TRAIN_PARAMS)
    vmoe_launches, vmoe_step_ms = walls("vmoe_train", phase_vmoe_train, card, vit_median_ms)
    walls("vmoe_train_profile", phase_vmoe_train_profile, card, vmoe_step_ms)
    walls("vmoe_cpu_check", phase_vmoe_cpu_check, card)
    f32_train_launches, f32_step_ms, _ = walls("vit_train_f32", phase_vit_train, card,
                                               "vit_train_f32", "float32", 1, F32_TRAIN_PARAMS)
    walls("vit_train_f32_profile", phase_vit_train_profile, card, f32_step_ms,
          "vit_train_f32_profile", (*F32_TRAIN_PARAMS, *SHORT_TRAIN_PARAMS))
    classifier_counts = walls("classifier_train", phase_classifier_train, card)
    augment_counts, _ = walls("augment_train", phase_augment_train, card, aug_rows, k2_rows)
    wide_launches, wide_step_ms = walls("wide_train", phase_wide_train, card, data)
    walls("wide_train_profile", phase_wide_train_profile, card, wide_step_ms)
    zoo_launches, zoo_step_ms = walls("zoo_train", phase_zoo_train, card)
    walls("zoo_train_profile", phase_zoo_train_profile, card, zoo_step_ms,
          k2_rows["forward_bf16"]["mobilenet_v2"])
    dense_launches, _ = walls("dense_train", phase_pipeline_runs, card, "dense_train",
                              DENSE_RUNS)
    unet_launches, unet_step_ms = walls("unet_train", phase_unet_train, card)
    walls("unet_train_profile", phase_unet_train_profile, card, unet_step_ms)
    walls("dense_cpu_check", phase_dense_cpu_check, card)
    detect_launches, _ = walls("detect_train", phase_pipeline_runs, card, "detect_train",
                               DETECT_RUNS)
    fpn_launches, fpn_step_ms = walls("fpn_train", phase_fpn_train, card)
    walls("fpn_train_profile", phase_fpn_train_profile, card, fpn_step_ms)
    keypoint_launches = walls("keypoints_train", phase_pipeline_runs, card,
                              "keypoints_train", KEYPOINT_RUNS, data)[0]
    match_launches, learned_pairs_s = walls("keypoints_match", phase_keypoints_match, card)
    video_models = {}
    video_launches = walls("video_train", phase_pipeline_runs, card, "video_train",
                           VIDEO_RUNS, None, video_models)[0]
    walls("video_cpu_check", phase_video_cpu_check, card, video_models)
    walls("tracking", phase_tracking, card)
    walls("augment_ops", phase_augment_ops, card)
    full_launches = walls("augment_full_train", phase_augment_full_train, card)
    walls("classical_match", phase_classical_match, card, learned_pairs_s)
    walls("geometry", phase_geometry, card)
    video_launches_f32 = walls("video_predict", phase_video_predict, card)
    stream_launches = walls("stream_train", phase_stream_train, card)
    runtime_launches = walls("runtime_train", phase_runtime_train, card)
    partial_launches = walls("partial_run", phase_partial_run, card)
    search_counts = walls("search", phase_search, card)
    hp_search_counts = walls("hp_search", phase_hp_search, card)
    nas_launches = walls("nas", phase_nas, card)
    lr_find_counts = walls("lr_find", phase_lr_find, card)
    walls("codec", phase_codec, card)
    walls("data_gen", phase_data_gen, card)
    al_counts, al_store = walls("active_learning", phase_active_learning, card)
    boost_counts = walls("boosting", phase_boosting, card)
    meta_counts = walls("meta_learning", phase_meta_learning, card)
    tooling_counts = walls("tooling", phase_tooling_process, card, al_store)
    k2_line["launches_by_path"] = {"serve": k2_line["launches"],
                                   "classifier_train": classifier_counts["K2"],
                                   "augment_train": augment_counts["K2"],
                                   "wide_train": wide_launches,
                                   **{f"zoo_train:{p}": n for p, n in zoo_launches.items()},
                                   **{f"dense_train:{t}": n for t, n in dense_launches.items()},
                                   "unet_train": unet_launches,
                                   **{f"detect_train:{k}": n for k, n in detect_launches.items()},
                                   "fpn_train": fpn_launches,
                                   **{f"keypoints_train:{k}": n
                                      for k, n in keypoint_launches.items()},
                                   "keypoints_match": match_launches,
                                   **{f"video_train:{k}": n for k, n in video_launches.items()},
                                   "serve_extras:predict": extras["K2_predict"],
                                   "serve_extras:mc_dropout": extras["K2_mc_dropout"],
                                   "serve_extras:ensemble": extras["K2_ensemble"],
                                   **{f"augment_full_train:{k}": n
                                      for k, n in full_launches.items()},
                                   "video_predict": video_launches_f32,
                                   "stream_train": stream_launches["streaming"],
                                   "stream_train:codec": stream_launches["codec"],
                                   "stream_train:resident": stream_launches["resident"],
                                   **{f"runtime_train:{k}": n
                                      for k, n in runtime_launches.items()},
                                   "partial_run": partial_launches,
                                   "search": search_counts["K2"],
                                   "hp_search": hp_search_counts["K2"],
                                   **{f"nas:{k}": n for k, n in nas_launches.items()},
                                   "lr_find": lr_find_counts["K2"],
                                   "active_learning": al_counts["K2"],
                                   "boosting": boost_counts["K2"],
                                   "meta_learning": meta_counts["K2"],
                                   "tooling": tooling_counts["K2"]}
    k2_line["launches"] = sum(k2_line["launches_by_path"].values())
    k2_routes(k2_line, k2_rows["forward_bf16"], k2_rows["forward_f32"],
              augment_counts["K2"] + wide_launches + sum(zoo_launches.values())
              + unet_launches + fpn_launches + keypoint_launches["autoencoder"]
              + match_launches + sum(full_launches.values()) + sum(stream_launches.values())
              + sum(runtime_launches.values()) + search_counts["K2"]
              + hp_search_counts["K2"]
              + sum(n for k, n in nas_launches.items() if k != "checks")
              + tooling_counts["K2"],
              k2_rows[(DENSE_KERNEL_CASES[0][0], "float32")])
    emit({"phase": "walls", "wall_s": walls.seconds, "card": card})
    emit({"kernels": [k1_kernel_line(aug_rows, {"augment_train": augment_counts["K1"],
                                                "search": search_counts["K1"]}, card), k2_line,
                      *flash_kernel_lines(flash_rows, serve_launches, train_launches,
                                          f32_train_launches, vmoe_launches, card),
                      int8_kernel_line(int8_rows, {
                          **{f"int8_serve:{k}": n for k, n in int8_launches.items()},
                          "serve_extras:predict": extras["int8_conv"]}, int8_by_route, card)]})
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
