#!/usr/bin/env python
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. device    - card name and power limit (nvidia-smi), torch / CUDA
               versions; TF32 off for matmuls and convolutions
               (utils.env.set_tf32, as every entry point sets it from the
               config's tf32 key, off by default).
2. build     - compiles the hand-written kernels (csrc/*.cu), one nvcc per
               source, all started together.
3. kernels   - each kernel against its plain PyTorch version on the card, at
               the main path's shapes and at ragged ones: the pairwise pair
               (K1/K2; also box bitmasks at kernel 3 / dilation 2, 3 / 1
               and 5 / 1, den exactly, the same bits from a second call),
               the MSDA pair (one launch a layer each way, at one
               Box2Mask encoder layer's full shapes and three ragged layer
               cases; the backward also against autograd through the plain
               forward, and whether two backward runs give the same bits),
               the LCM forward and adjoint (with the identity
               <A x, y> = <x, A^T y>; the ring kernel at the main shape, a
               short last channel group, 6 and 8 bands; the generic kernel
               past the ring's limit and for another offset set; 0 and 1
               rounds; a shape past both limits must raise); errors, times
               and each kernel's bound, and the LCM pair against the
               one-block-a-plane kernels (tools/baselines/) in turns.
4. slice     - BoxInst R-50-FPN 1x at full width (random init from a seed)
               trained for 5 SGD steps through tools/train_torch.py on
               seeded synthetic 800x1333 images; the pairwise kernels'
               launch counts over that run must equal the step count.
   pairwise main path - K1/K2 at the inputs of the slice's last pairwise
               call (the sampled GTs' box bitmasks): against the plain
               version, the inputs' coverage (weighted pixels, passing
               gates, live (instance, tile) items), times beside the dense
               and the live bound, and the one-block-a-tile kernels
               (tools/baselines/pairwise_tiles.cu) timed against them in
               turns at these and at the random inputs.
5. reference - a small CondInst's loss dict on the card (kernels) against
               the same weights and batch on the CPU (plain versions), in
               fp32 (as every card-vs-CPU phase).
6. box2mask  - Box2Mask R-50 LSJ at full width trained for 5 AdamW steps
               through tools/train_torch.py on seeded synthetic 1024x1024
               images; the MSDA and LCM kernels' launch counts over that run
               must equal their per-step counts (MSDA: one forward and one
               backward an encoder layer) times the step count. The
               Hungarian match goes through the LSA kernel (csrc/lsa.cu),
               one launch a step for all 10 x 2 problems, with scipy's
               linear_sum_assignment replaced by a function that raises;
               the tree filter's two trees an image through the grid MST
               kernel (csrc/mst.cu), one launch a step. Each step's time is
               printed beside its live GT count.
7. box2mask reference - a small Box2Mask's loss dict on the card against the
               CPU.
8. swin kernels - the Swin window attention pair K5/K6 against its plain
               versions (alone, through its registered torch op, and K6
               against autograd through the plain forward) at Swin-L's
               stage-0 (shifted) and stage-2 shapes, Swin-T's stage 0 and 2
               at 1024x1024 and batch 4 (N = 49, padded maps, shifted),
               windows 14 and 16 at Swin-L's stage 2 (N = 196 and 256: K6
               adds dS into its partial slice), Swin-T's window 7 at 224 and
               a ragged small case; times at the timed shapes beside the
               bound (at the fp32 rate, and with the products in 3xTF32 on
               the tensor cores) and beside torch's
               scaled_dot_product_attention as a yardstick. The kernels
               JSON rows carry stage 0; stage 2 rides beside it.
9. swin-l    - Box2Mask Swin-L LSJ at full width trained for 5 AdamW steps
               through tools/train_torch.py on seeded synthetic 1024x1024
               images, batch 1 (the LSA kernel once a step, scipy refused);
               then MaskFormer.predict on one image (K5 only, no K6), its
               output through format_detection and the RLE codec.
10. swin reference - a small Box2Mask on a tiny Swin (window 4, odd maps,
               shifted blocks): loss dict and backbone gradients on the card
               against the CPU.
10b. swin-l recipe - Box2Mask Swin-L LSJ at full width and depth, batch 1,
               4 AdamW steps through tools/train_torch.py with the train
               loop's other pieces: LayerDecayOptimizerConstructor over the
               shipped custom keys (num_layers 12, rate 0.9), a cosine LR
               with a linear warmup of 2 steps, EMAHook, MemoryProfilerHook
               and ProfilerHook (steps 2-3): each param group's LR at each
               step equals the schedule times its lr_mult, the EMA equals
               the parameters after step 1 only (its update's ms printed),
               the trace of step 3 names K5 and K6, a memory line a step.
11. crf kernel - the DiscoBox CRF fixed point K7 against its plain version,
               bit for bit, at the main path's shape (2, 128, 200, 336), its
               transpose and ragged shapes (odd maps in 8 bands, K = 1, 5
               and 13, three images, a plane without a target, one touching
               every border, 0 and 1 rounds; a shape past the limit must
               raise); time, bound, plain time, and against the
               one-block-a-plane kernel in turns.
11b. lsa kernel - the linear sum assignment kernel (no pl.pallas_call:
               it replaces boxinstseg_tpu/ops/lsa.py:24 solve_lsa, which
               the JAX Box2Mask step runs on the device) against its plain
               version, assignments and step counts equal element for
               element, at the Box2Mask R-50 step's own costs (20, K, 100)
               with their live counts, at a crowded (20, 100, 100) and at
               integer costs with many exact ties; each total cost scipy's
               optimum within rel 1e-6; its time, the augmenting steps the
               inputs took (all, and in the longest problem), the bound,
               the plain version's time and, in turns with the kernel, the
               scipy path's (copy, host solve, copy back). Its report is a
               JSON line of its own before the kernels line.
12. discobox - DiscoBox R-50 3x at full width (the shipped config with
               ts_cfg.start_iter=2) trained for 5 SGD steps through
               tools/train_torch.py on seeded synthetic 800x1333 images,
               batch 2, in bf16 autocast (the config's fp16 key): K7
               launches once a step, the teacher's forward runs
               in the steps after start_iter only, and the EMA replica
               equals the student up to start_iter and differs after; the
               median step time without and with the teacher apart.
13. discobox reference - a small DiscoBox with the correspondence loss and
               the gates forced open, two teacher-student steps on the card
               against the CPU: logs, the object bank and the parameters.
14. boxinst predict - the slice's checkpoint through init_detector, then
               CondInst.predict on one synthetic 800x1333 image (batch 1,
               score_thr 0: 100 detections): shapes, finite values, and
               the predict, format_detection and RLE times (median of 3
               after 1 warm-up).
15. predict reference - a small CondInst's predict on the card against the
               CPU, valid slots at the CPU tests' tolerances.
16. eval     - tools/test_torch.py's main at full width on 8 synthetic
               800x1333 images with RLE ground truth (the slice's
               checkpoint): the native RLE codec built, cv2 never imported,
               images/s split into format, RLE, COCOeval and the rest; the
               ground truth as detections must read bbox and segm mAP 1.
17. discobox predict - the trained DiscoBox's predict under its bf16 policy
               (score_thr and filter_thr 0: 100 detections), times as in 14.
18. boxlevelset - BoxLevelset R-50 3x at full width (random init from a
               seed) trained for 5 AdamW steps through tools/train_torch.py
               on seeded synthetic 800x1333 images, batch 2, fp32, a
               checkpoint every 2 steps with the newest 2 kept (steps 4 and
               5 must be left); a resume from step 4 must run one step and
               leave _iter 5; the grid MST kernel once a step in both runs.
               Then the checkpoint through init_detector and
               predict on one 800x1333 image, format_detection and RLE,
               times as in 14, the card's formatting against the CPU's.
19. boxlevelset reference - a small BoxLevelSet's loss dict and predict on
               the card against the CPU.
19b. mst kernel - the grid MST kernel (no pl.pallas_call: it replaces
               boxinstseg_tpu/ops/mst.py:501 grid_mst_device, which the JAX
               BoxLevelset and Box2Mask steps run on the device) against its
               plain version on the card and scipy's MST on the host
               (tests/mst_witness.py), parent and depth equal element for
               element, at the Box2Mask R-50 and BoxLevelset R-50 steps' own
               weights (2 x 2 trees of 96x96 each), flat-block ties at 8
               trees (Swin-T's batch 4) and distinct random weights under a
               binding depth cap; Boruvka rounds and tree heights; the
               kernel's, the plain version's and the old host path's (copy,
               scipy, copy back) times in turns, the bound. Its report is a
               JSON line of its own before the kernels line.
20. files    - 8 JPEGs (cv2.imwrite, synthetic_image scenes at 800x1333
               and 1333x800) and a COCO json with polygon ground truth:
               BoxInst R-50 1x and BoxLevelset R-50 3x at full width, each
               through its shipped train pipeline unchanged (file reading,
               Resize, GenerateBoxMask's BitmapMasks.resize for
               BoxLevelset) via CocoDataset and TrainLoader: the loader's
               images/s alone over 8 batches, 2 steps each with data_time
               beside the step time (the pairwise kernels launched in
               BoxInst's); then BoxInst's checkpoint through
               tools/test_torch.py (bbox segm, batch 1; the polygons
               decoded for the segm ground truth).
20b. condinst - fully supervised CondInst R-50-FPN 1x at full width: the
               BoxInst config with boxinst_enabled False, a CondInstSegmHead
               on P3 and the masks loaded (CONDINST_OPTS), 5 SGD steps at
               batch 2 through tools/train_torch.py on the JPEGs (polygon
               masks at stride 1): K1/K2 launched 0 times, the median step
               and its spread, peak memory, data_time beside the batch's
               copy to the card; predict on one JPEG; a small supervised
               CondInst's loss dict on the card against the CPU.
21. ddp      - data parallelism (boxinstseg_tpu_torch.parallel), in child
               processes: tools/train_torch.py --launcher pytorch with
               RANK=0 WORLD_SIZE=1 over NCCL, BoxInst at full width, batch
               2, 4 steps from the JPEGs, in turns with the same run
               without a launcher, each in a fresh process (none, pytorch,
               pytorch, none; medians of steps 2-4); two gloo ranks on the
               one card at batch 1 against one process at batch 2 on two
               JPEGs with 1 and 6 boxes, from the same weights: each step's
               losses (rtol 1e-4), the averaged gradient's norm (1e-3) and
               the BN running statistics (1e-4); run_evaluation of the
               files phase's checkpoint at batch 1 (score_thr 0: 100
               detections an image) in two gloo ranks and in one fresh
               process, each allowed EVAL_MEMORY_FRACTION of the card (so
               that cuDNN keeps the same engines in all three): rank 0's
               gathered per-image results (masks too) and metrics equal
               the one process's, rank 1 returns {}. The phase first returns this process's cached
               memory to the card and prints the card's memory.
21b. ddp swin-l - Box2Mask Swin-L at full width, two gloo ranks on the one
               card at batch 1 against one process at batch 2 on the two
               JPEGs, 2 SGD steps: losses (rtol 1e-4) and grad norm (1e-3),
               K5/K6 launched in every process.
21c. public surface - the port's demos and tools on the card:
               demo/image_demo_torch.py on a JPEG of the files phase with its
               BoxInst checkpoint (score_thr 0: 100 detections); the video
               demo (batch 1) and the batched one (batch 4, a decode
               thread, pinned copies) over an 8-frame MJPG video of the
               landscape JPEGs, frame by frame: each detection paired with
               one of the same label, box within 1e-3 px and score within
               rtol 1e-4 (two whose scores tie so may trade places or
               stand in for each other), the scores equal within rtol 1e-4
               place by place, the same masks but at pixels whose score lies
               within 1e-4 of the threshold; frames/s of each. BoxInst
               exported (tools/deployment/export_model_torch.py,
               torch.export) from the slice's checkpoint at 800x1344,
               batch 1, then tools/deployment/test_torch.py on the eval
               phase's images: the eval phase's metrics. Box2Mask R-50 and
               Swin-L exported from seed 0 at 1024x1024: the graph holds
               one boxinstseg::msda_forward an encoder layer (6) and, for
               Swin-L, one boxinstseg::window_attention a block (24); the
               loaded program launches K4f and K5 that many times, and its
               outputs (and BoxInst's) equal the eager model's within the
               kernels' tolerance; export seconds and .pt2 MB. DiscoBox
               R-50 exported from seed 0 at 800x1344 under its fp16 key,
               which the export does not apply: the loaded program equals
               eager fp32 predict.
               tools/analysis_tools/benchmark_torch.py (BoxInst and
               Box2Mask R-50 predict, BoxInst --train at batch 2: medians,
               min, max, peak GiB, the card) and get_flops_torch.py (the
               three; their parameter counts those of the exported models).
21d. inventory - after condinst, the backbone and neck inventory at full
               width, random init from seed 0, seeded synthetic 800x1333
               images at batch 2: DiscoBox X-101-DCN (the R-101 config with
               ResNeXt-101 64x4d and deformable v1 tower convs) 5 SGD
               steps in bf16 (the config's fp16 key), ts_cfg.start_iter=2,
               K7 once a step, the steps without and with the teacher's
               forward apart (median, min, max), peak memory, then predict
               on one image at batch 1; BoxLevelset R-50 with DCNv2 towers
               and feature convs, 2 AdamW steps in fp32, then predict;
               one DCNv2 layer at (2, 256, 200, 336) -> 256 against the
               plain nn.Conv2d, forward + backward, beside its bound;
               BoxInst R-50 1x with ResNetV1d-50, ResNeSt-50,
               DetectoRS_ResNet-50, PVTv2-b2, PVT v1, PAFPN, FPN_CARAFE and
               FPN on_input, 2 SGD steps each, K1/K2 once a step; then
               every new module's tiny version on the card against the CPU
               (fp32, TF32 off): outputs and input gradients, and the DCN
               layers' weight gradients.
21e. zoo     - every module of the last inventory slice on the card and on
               the CPU from the same inputs, at the shapes of the mmdet
               model that uses it (the model is printed with each check):
               RetinaNet R-50 anchors at 800x1344 (201,600) and
               max_iou_assign on them against 100 GT slots at batch 2,
               SSD300 and YOLOv3-608 anchors (and responsible flags), ATSS
               and TOOD on 22,400 anchors, SimOTA at YOLOX-s 640x640 (8,400
               points, 80 classes), hungarian_bbox_assign at DETR's 100
               queries x 100 slots (the LSA kernel), the samplers at RPN's
               256 and R-CNN's 512, the focal-family, IoU and regression
               losses and their gradients on (44,800, 80) and (44,800, 4),
               Seesaw at LVIS (1,024 x 1,205), PISA at (1,024, 81), the
               softmax CE and accuracy, the AE loss at CornerNet's 128 x
               128, MaskFormer R-50's pixel decoders at 800x1333 batch 2,
               merge_aug_masks over a flip pair of 100 masks at 800x1333,
               Mask2Former's 12,544 uncertain points, CenterNet's (2, 80,
               128, 128) gaussian targets, DropBlock and the bricks. Random
               modules take the same CPU-drawn uniforms on both devices.
               Outputs within REF_ATOL x max(1, max |cpu|) + REF_RTOL x
               |cpu|, integer and boolean outputs equal; the card's ms.
21f. ops     - the loss path's kernels as registered torch ops
               (boxinstseg::pairwise_forward / pairwise_backward,
               lcm_forward / lcm_adjoint, crf_mean_field, solve_lsa,
               grid_mst):
               torch.library.opcheck of each on the card at small shapes;
               each op against its plain version at the main path's
               shapes (the kernels' tolerances), its time through the op
               beside its wrapper's, in turns, and beside PERF.md's table;
               the small CondInst's forward and loss exported on the card
               (apis.export.export_loss), run and differentiated: one K1
               and one K2 launch, losses equal to eager.
21g. configs - every shipped config not run as shipped before (the 17 of
               SHIPPED_UNRUN: BoxInst R-101 1x / 3x, R-50 3x and the three
               VOC configs; BoxLevelset R-101 and the three VOC configs;
               DiscoBox R-101 and the two VOC configs; Box2Mask R-101, the
               two VOC configs and Swin-T window 7) at full width and depth
               from random init (seed 0), in its own precision, built from
               its shipped file with only the runner (2 iterations), the
               log interval (1) and the seeded synthetic dataset at its
               train pipeline's size and its own samples_per_gpu: each
               step's ms, peak GiB, live GT count and hand-kernel launches
               (exactly config_kernels': K1/K2 for BoxInst, K7 for
               DiscoBox, MSDA, LCM, LSA and the MST for Box2Mask, K5/K6 once
               a block on Swin-T, the MST for BoxLevelset), the losses
               finite; then
               predict at batch 1 on its test canvas, outputs finite.
21h. voc cli - BoxInst R-50 1x VOC and Box2Mask R-50 VOC through
               tools/train_torch.py (2 steps) and tools/test_torch.py
               --eval segm (batch 1) on the files phase's JPEGs relabelled
               into PascalVOCDataset's 20 classes in a cocostyle json:
               finite metrics.

Every training phase logs every step (log_config.interval=1), so that each
step's logged time ends in a device sync, and runs without evaluation
(--no-validate). The device phase also says which of PIL, imageio and
libnvjpeg the machine has. Phases 1-19 never import cv2; 20-21c and 21h
read the JPEGs with it.

Prints the LSA and MST report lines, the configs line (each config's step
ms and the hand kernels' launches over the configs phase), a JSON line with
one entry per kernel, the card's nvidia-smi line, and as its last line
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --cudnn-log DIR

runs every phase as above and has cuDNN log its API calls (level 3) in the
ddp phase's evaluation processes, one gzip file a process under DIR, each
side's name in it (one process, or rank r of 2), beside each process's
free card memory before and after its evaluation.

    python3 chip_smoke.py --cards 4

runs only the device and build phases and then data parallelism over 4
cards (nccl, one process a card): tools/dist_train_torch.sh (torchrun over
tools/train_torch.py --launcher pytorch) over 1 and 4 ranks in turns (step
time, images/s), 4 ranks at batch 1
against one process at batch 4 (losses, gradient norm, BN statistics), and
a 4-rank evaluation against one process; then each card's nvidia-smi line
and the ok line.
"""
import contextlib
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CUDNN_LOG_DIR = None               # --cudnn-log
CUDNN_LOG_BYTES = 200 * 2**20      # of each process's cuDNN log, kept
CONFIG = os.path.join(ROOT, 'configs/boxinst/boxinst_r50_fpn_1x_coco.py')
B2M_CONFIG = os.path.join(ROOT,
                          'configs/box2mask/box2mask_r50_lsj_8x2_50e_coco.py')
SWIN_CONFIG = os.path.join(
    ROOT, 'configs/box2mask/box2mask_swin-l-p4-w12-384-lsj_8x1_50e_coco.py')
DISCO_CONFIG = os.path.join(
    ROOT, 'configs/discobox/discobox_solov2_coco_r50_fpn_3x.py')
BOXLS_CONFIG = os.path.join(
    ROOT, 'configs/boxlevelset/box_levelset_coco_r50_fpn_3x.py')
STEPS = 5
# every training phase: an iteration runner of STEPS steps whose log reads
# the losses after every step, so that each step ends in a device sync and
# its logged time is the step's (PERF.md section 2)
TRAIN_OPTS = ['runner.type=IterBasedRunner', f'runner.max_iters={STEPS}',
              'log_config.interval=1']
MAIN_SHAPE = (2, 64, 200, 336)     # B, K=topk_per_img, 800/4, 1344/4
RAGGED_SHAPES = ((1, 3, 37, 53), (2, 5, 37, 53))
VALUE_RTOL = 1e-5                  # fp32, summation order
# on the unnormalised gradient d(num)/d(logits), whose entries are O(1);
# through autograd it is divided by max(den, 1), and so is GRAD_ATOL
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5
REF_RTOL, REF_ATOL = 1e-4, 1e-6    # cuDNN vs CPU conv summation order
# the LSA kernel's input sets: the problems of a Box2Mask step (10 decoder
# outputs x batch 2), at its own costs and at (20, 100, 100)
LSA_PROBLEMS = 20

# one encoder layer of Box2Mask's pixel decoder (R-50 and Swin-L LSJ):
# batch 2, 8 heads, 32 channels a head, 4 points, the levels at strides 32,
# 16, 8 of the 1024x1024 canvas in the decoder's order; L = S = 21,504
MSDA_B, MSDA_HEADS, MSDA_D, MSDA_P = 2, 8, 32, 4
MSDA_LEVELS = ((32, 32), (64, 64), (128, 128))
# layer cases (batch, heads, D, P, levels, queries, spread) on odd maps:
# the encoder's own queries (None) and random ones on the fast pair's D 32
# and P 4; D 48 and P 3 on two levels (the generic pair); samples spread up
# to `spread` map widths outside
MSDA_RAGGED = ((1, 3, 32, 4, ((13, 7), (7, 4), (4, 2)), None, 0),
               (1, 3, 32, 4, ((13, 7), (7, 4), (4, 2)), 37, 0.6),
               (2, 1, 48, 3, ((5, 11), (3, 6)), 19, 1.5))
LCM_MAIN = (2, 80, 96, 96)         # B, 10 outputs x 8 GT slots, tf_size
# (shape, dilations, rounds): odd maps and maps smaller than the offsets;
# a channel count that leaves a short last channel group; six bands with a
# short last one; eight bands (the ring kernel's limit at W 96) and one row
# more (the generic kernel); a non-ring offset set (dilations 1 and 2, the
# generic kernel); 0 and 1 rounds
LCM_RAGGED = (((1, 3, 37, 53), (2,), 10), ((2, 5, 3, 5), (2,), 10),
              ((2, 83, 96, 96), (2,), 10), ((1, 3, 130, 100), (2,), 10),
              ((1, 2, 208, 96), (2,), 10), ((1, 2, 209, 96), (2,), 10),
              ((1, 3, 37, 53), (1, 2), 10), ((1, 3, 37, 53), (2,), 0),
              ((1, 3, 37, 53), (2,), 1))
LCM_TOO_BIG = (1, 1, 400, 96)      # beyond both kernels: must raise
LCM_ITERS = 10
# MSDA and LCM kernels against their plain versions: atol is 1e-5 of the
# reference's largest entry (1e-5 at least), rtol 1e-4. fp32 sums in
# another order, and the MSDA d(value) with float atomics in an order that
# changes from run to run; d(loc) carries the map's width or height as a
# factor, so a fixed atol would not scale with it.
KERNEL_ATOL, KERNEL_RTOL = 1e-5, 1e-4
# Swin window attention (K5/K6) at (hp, wp, window, shift, images, heads,
# head dim, random region ids): Swin-L at 1024x1024, stage 0 (a shifted
# block, 484 windows of 144 tokens, 6 heads) and stage 2 (36 windows, 24
# heads); Swin-T (the configs phase's box2mask_swin-t) at 1024x1024 and its
# batch of 4, stage 0 (256 tokens a side padded to 259: 4 x 37 x 37 windows
# of 49, 3 heads) and stage 2 (64 padded to 70: 4 x 100 windows, 12 heads),
# both shifted; windows 14 and 16 at Swin-L's stage-2 map and heads (N =
# 196 and 256, where K6 adds dS straight into its partial slice); Swin-T's
# window 7 at 224x224; a ragged small case with three region ids. K5 and K6
# are held to KERNEL_ATOL / KERNEL_RTOL; dbias sums the windows in a fixed
# order (no atomics).
SWIN_MAIN = {'stage 0': (264, 264, 12, 6, 1, 6, 32, 0),
             'stage 2': (72, 72, 12, 0, 1, 24, 32, 0),
             'Swin-T stage 0': (259, 259, 7, 3, 4, 3, 32, 0),
             'Swin-T stage 2': (70, 70, 7, 3, 4, 12, 32, 0),
             'window 14': (70, 70, 14, 7, 1, 24, 32, 0),
             'window 16': (64, 64, 16, 8, 1, 24, 32, 0)}
SWIN_RAGGED = {'Swin-T window 7': (56, 56, 7, 3, 2, 3, 32, 0),
               'ragged': (8, 12, 4, 0, 2, 2, 8, 3)}
SWIN_REF_RTOL = 1e-3   # backbone gradients card vs CPU, relative L2 error
# K7 at DiscoBox's shape (batch 2, max_pos 128, the 800x1344 canvas at
# stride 4), its transpose, and ragged shapes; it must equal the plain
# version bit for bit (exact products summed in the same order)
CRF_MAIN = (2, 128, 200, 336)
# (shape, rounds, a full-map target plane): the transpose; odd maps in 8
# bands with a short last one; K = 1, 5 and 13 (plane groups of 8 with a
# short last one); three images; a target plane touching every border; 0
# and 1 rounds
CRF_SHAPES = (((2, 128, 336, 200), 10, False), ((1, 1, 37, 53), 10, False),
              ((1, 5, 37, 53), 10, False), ((3, 5, 37, 53), 10, False),
              ((2, 13, 37, 53), 10, True), ((1, 5, 37, 53), 0, False),
              ((1, 5, 37, 53), 1, True))
CRF_TOO_BIG = (1, 1, 1200, 1200)   # more than 8 bands: must raise
CRF_ITERS = 10
DISCO_START_ITER = 2
# DiscoBox R-50: a tensor of each of these parts must change in training
DISCO_PARTS = ('backbone.layer2.', 'neck.', 'bbox_head.kernel_convs.',
               'bbox_head.solo_cate.', 'mask_feat_head.')
# the evaluation phases: score_thr 0 keeps max_per_img detections an image
# on the briefly trained models, and the test set is synthetic
EVAL_OPTS = ['model.test_cfg.score_thr=0',
             'data.test.type=SyntheticEvalDataset']
EVAL_IMAGES = 8
# the files phase: JPEGs in both orientations, in pairs (a batch of 2 is
# one orientation), read through the shipped train and test pipelines
FILE_SHAPES = ((800, 1333), (800, 1333), (1333, 800), (1333, 800)) * 2
FILES_STEPS = 2
LOADER_BATCHES = 8
# the ddp phase: two 800x1333 JPEGs with 1 and 6 boxes; a rank takes one
PAIR_BOXES = (1, 6)
DDP_STEPS = 4                      # the NCCL world of one (median of 2-4)
DDP_LOSS_RTOL = 1e-4               # 2 gloo ranks vs one process, the card
DDP_GRAD_RTOL = 1e-3
DDP_BN_RTOL, DDP_BN_ATOL = 1e-4, 1e-6
DDP_LIMIT = 900                    # seconds for one set of child processes
# each evaluation process of the ddp and cards phases may hold this share
# of its card (T3): the 2 gloo ranks share the one card, and without a cap
# one rank and the lone process each reserved 31.2 GiB at their peak (the
# workspace of the engine cuDNN's heuristics put first) while the other
# rank, left less free memory, ran another engine for one convolution and
# its masks moved; PyTorch keeps only the engines whose workspace it can
# allocate, so under one cap every side keeps the same ones
EVAL_MEMORY_FRACTION = 0.25
CARD_BOXES = (1, 6, 3, 8, 2, 5, 4, 7)  # the cards phase's images, a rank each
ADJOINT_RTOL = 1e-5                # <A x, y> vs <x, A^T y>, float64 sums
# the public surface phase: the demos on the files phase's landscape JPEGs
# (an 8-frame video of them, batch 4 in the accelerated demo; paired
# detections agree within BOX_ATOL px and SCORE_RTOL, masks but at pixels
# whose score lies within MASK_NEAR of the threshold), the exports'
# canvases, the benchmark's timed iterations
VIDEO_FRAMES, VIDEO_BATCH = 8, 4
BOX_ATOL = 1e-3
SCORE_RTOL = 1e-4  # batch 1 vs 4: scores this close (relative) may trade
                   # places; the phase prints how far apart batch 1 and 4
                   # put a score and how close neighbouring scores lie
MASK_NEAR = 1e-4   # as the eval tests: a mask may flip this near 0.5
BOXINST_CANVAS = (800, 1344)
B2M_CANVAS = (1024, 1024)
BENCH_ITERS = 10

# the least time of a kernel: bytes over the memory rate or operations over
# the fp32 rate (NVIDIA H100 SXM data sheet, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12            # dense tensor-core rate
# operations a kernel does per unit of work, counted from its source
# (a transcendental counts as one): per (pixel, instance) for the pairwise
# pair (two log-sigmoids, then per offset a pair log-prob, a logaddexp and
# the weighted sum; K2 adds the pair probability and the gradient terms),
# per kept sample for MSDA (four corners times a multiply-add per channel,
# plus the corner weights; the backward adds the row-dots), per pixel, round
# and offset for LCM (a multiply-add)
K1_OPS, K2_OPS = 90, 120

REPLACES = {
    'pairwise_forward': 'boxinstseg_tpu/ops/pallas_kernels.py:32',
    'pairwise_backward': 'boxinstseg_tpu/ops/pallas_kernels.py:119',
    'msda_forward': 'boxinstseg_tpu/ops/msda_pallas.py:274',
    'msda_backward': 'boxinstseg_tpu/ops/msda_pallas.py:397',
    'lcm_forward': 'boxinstseg_tpu/ops/pallas_kernels.py:380',
    'lcm_adjoint': 'boxinstseg_tpu/ops/pallas_kernels.py:380',
    'swin_attention_forward': 'boxinstseg_tpu/ops/swin_attention.py:93',
    'swin_attention_backward': 'boxinstseg_tpu/ops/swin_attention.py:116',
    'crf_mean_field': 'boxinstseg_tpu/ops/pallas_kernels.py:220',
}
SOURCES = {
    'pairwise_forward': 'boxinstseg_tpu_torch/csrc/pairwise.cu',
    'pairwise_backward': 'boxinstseg_tpu_torch/csrc/pairwise.cu',
    'msda_forward': 'boxinstseg_tpu_torch/csrc/msda.cu',
    'msda_backward': 'boxinstseg_tpu_torch/csrc/msda.cu',
    'lcm_forward': 'boxinstseg_tpu_torch/csrc/lcm.cu',
    'lcm_adjoint': 'boxinstseg_tpu_torch/csrc/lcm.cu',
    'swin_attention_forward': 'boxinstseg_tpu_torch/csrc/swin_attention.cu',
    'swin_attention_backward': 'boxinstseg_tpu_torch/csrc/swin_attention.cu',
    'crf_mean_field': 'boxinstseg_tpu_torch/csrc/crf.cu',
}
# the one-block-per-plane K3 and K7 and the one-block-a-tile K1 / K2,
# timed against the kernels in turns
BASELINES = {'lcm': os.path.join(ROOT, 'tools/baselines/lcm_per_plane.cu'),
             'crf': os.path.join(ROOT, 'tools/baselines/crf_per_plane.cu'),
             'pairwise': os.path.join(ROOT,
                                      'tools/baselines/pairwise_tiles.cu')}


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def phase(name):
    print(f'== {name}', flush=True)


def load_tool(name):
    """``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound(nbytes, ops):
    """The least time (ms) for moving ``nbytes`` and doing ``ops`` fp32
    operations, and which of the two bounds it."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def bound_3xtf32(nbytes, product_ops, other_ops):
    """The least time (ms) of a kernel whose products run in 3xTF32 on the
    tensor cores (three TF32 products each) and its other operations at
    the fp32 rate, or of its bytes."""
    t_ops = 1e3 * (3 * product_ops / TF32_OPS_PER_S
                   + other_ops / FP32_OPS_PER_S)
    return max(1e3 * nbytes / HBM_BYTES_PER_S, t_ops)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def synthetic_image(rng, h, w, n=None):
    """A uint8 BGR image of flat 32x32 colour blocks with ``n`` (by default
    1-8) solid-colour boxes on top, and the boxes (n, 4) xyxy."""
    import numpy as np
    blocks = rng.randint(0, 256, (h // 32 + 1, w // 32 + 1, 3))
    img = np.repeat(np.repeat(blocks, 32, 0), 32, 1)[:h, :w]
    img = np.ascontiguousarray(img, dtype=np.uint8)
    n = rng.randint(1, 9) if n is None else n
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        bw = rng.randint(32, min(400, w))
        bh = rng.randint(32, min(300, h))
        x1 = rng.randint(0, w - bw)
        y1 = rng.randint(0, h - bh)
        boxes[i] = (x1, y1, x1 + bw, y1 + bh)
        img[y1:y1 + bh, x1:x1 + bw] = rng.randint(0, 256, 3)
    return img, boxes


class SyntheticBoxDataset:
    """Seeded stand-in for CocoDataset with the interface TrainLoader uses
    (``flag``, ``__len__``, ``prepare(idx, rng, scale)``).

    Each sample is a uint8 BGR image of ``img_h`` x ``img_w`` made of flat
    32x32 colour blocks with 1-8 solid-colour boxes on top (flat regions
    give the colour-similarity gates something to pass), sent through the
    config's train pipeline after the file-loading and resize steps, which
    the synthesis replaces (for BoxInst: RandomFlip, Normalize, Pad,
    DefaultFormatBundle and Collect; Box2Mask adds GenerateBoxMask,
    RandomCrop and FilterAnnotations). No cv2 is needed."""

    SKIP = ('LoadImageFromFile', 'LoadAnnotations', 'Resize')

    def __init__(self, pipeline, num_classes=80, length=16, img_h=800,
                 img_w=1333, **unused):
        from boxinstseg_tpu_torch.data.pipelines import Compose
        import numpy as np
        self.pipeline = Compose([t for t in pipeline
                                 if t['type'] not in self.SKIP])
        self.num_classes = num_classes
        self.length = length
        self.img_h, self.img_w = img_h, img_w
        self.flag = np.ones(length, np.uint8)     # all landscape

    def __len__(self):
        return self.length

    def prepare(self, idx, rng, scale=None):
        img, boxes = synthetic_image(rng, self.img_h, self.img_w)
        n = len(boxes)
        results = dict(img=img, img_shape=img.shape, ori_shape=img.shape,
                       gt_bboxes=boxes,
                       gt_labels=rng.randint(0, self.num_classes, n),
                       bbox_fields=['gt_bboxes'], mask_fields=[], rng=rng)
        return self.pipeline(results)


class SyntheticEvalDataset:
    """Seeded stand-in for CocoDataset in test mode, with the interface
    ``run_evaluation`` uses (``flag``, ``__len__``, ``prepare(idx)``,
    ``coco``, ``img_ids``, ``cat_ids``, ``evaluate``).

    Each image is one of ``synthetic_image``'s at the test scale, sent
    through the config's test pipeline without its file-loading and resize
    steps (RandomFlip, Normalize, Pad, ImageToTensor, Collect). The ground
    truth is the painted boxes with their filled rectangles as masks,
    written as RLE (the polygon fill needs cv2)."""

    SKIP = ('LoadImageFromFile', 'Resize')

    def __init__(self, pipeline, num_classes=80, length=8, img_h=800,
                 img_w=1333, seed=0, **unused):
        import numpy as np
        from boxinstseg_tpu_torch.data.coco_api import COCO, rle_encode
        from boxinstseg_tpu_torch.data.pipelines import Compose
        steps = []
        for t in pipeline:
            if t['type'] == 'MultiScaleFlipAug':
                t = dict(t, transforms=[x for x in t['transforms']
                                        if x['type'] not in self.SKIP])
            if t['type'] not in self.SKIP:
                steps.append(t)
        self.pipeline = Compose(steps)
        rng = np.random.RandomState(seed)
        self.images, images, anns = [], [], []
        for i in range(length):
            img, boxes = synthetic_image(rng, img_h, img_w)
            self.images.append(img)
            images.append(dict(id=i + 1, height=img_h, width=img_w))
            for box, label in zip(boxes.astype(int),
                                  rng.randint(0, num_classes, len(boxes))):
                x1, y1, x2, y2 = (int(v) for v in box)
                mask = np.zeros((img_h, img_w), np.uint8)
                mask[y1:y2, x1:x2] = 1
                anns.append(dict(
                    id=len(anns) + 1, image_id=i + 1,
                    category_id=int(label) + 1, iscrowd=0,
                    bbox=[x1, y1, x2 - x1, y2 - y1],
                    area=(x2 - x1) * (y2 - y1),
                    segmentation=rle_encode(mask)))
        self.coco = COCO(dataset=dict(
            images=images, annotations=anns,
            categories=[dict(id=c + 1, name=str(c))
                        for c in range(num_classes)]))
        self.img_ids = [im['id'] for im in images]
        self.cat_ids = list(range(1, num_classes + 1))
        self.flag = np.ones(length, np.uint8)

    def __len__(self):
        return len(self.images)

    def prepare(self, idx, rng=None, scale=None):
        img = self.images[idx]
        return self.pipeline(dict(img=img, img_shape=img.shape,
                                  ori_shape=img.shape, bbox_fields=[],
                                  mask_fields=[]))

    def ground_truth_results(self):
        """The ground truth as detections of score 1, per image."""
        import numpy as np
        out = []
        for i in self.img_ids:
            anns = self.coco.load_anns(self.coco.get_ann_ids(img_ids=[i]))
            out.append(dict(
                bboxes=np.array([[a['bbox'][0], a['bbox'][1],
                                  a['bbox'][0] + a['bbox'][2],
                                  a['bbox'][1] + a['bbox'][3], 1.0]
                                 for a in anns]),
                labels=np.array([a['category_id'] - 1 for a in anns]),
                masks=[a['segmentation'] for a in anns]))
        return out

    def evaluate(self, results, metric=('bbox', 'segm'), **unused):
        from boxinstseg_tpu_torch.core.eval import evaluate_coco
        return evaluate_coco(self.coco, self.img_ids, self.cat_ids, results,
                             [metric] if isinstance(metric, str)
                             else list(metric))


def cuda_ms(fn, iters=20):
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(what, got, want):
    """Max abs error of a kernel's output against its plain version, within
    KERNEL_ATOL * max(1, max |want|) + KERNEL_RTOL * |want|; fails on a
    reference too small to make the check meaningful."""
    import torch
    ref = want.abs().max().item()
    if not ref > 0.1:
        fail(f'{what}: plain reference max {ref}: check is vacuous')
    diff = (got - want).abs()
    err = diff.max().item()
    tol = KERNEL_ATOL * max(ref, 1.0) + KERNEL_RTOL * want.abs()
    if not bool(torch.isfinite(got).all()) or not bool((diff <= tol).all()):
        fail(f'{what}: kernel differs from plain: max abs err {err} '
             f'(max |ref| {ref})')
    return err


def kernel_inputs(shape, gen):
    import torch
    b, k, h, w = shape
    x = torch.randn(shape, generator=gen, device='cuda') * 2
    sim = torch.rand((b, 8, h, w), generator=gen, device='cuda')
    bm = (torch.rand(shape, generator=gen, device='cuda') > 0.5).float()
    valid = torch.rand((b, k), generator=gen, device='cuda') > 0.2
    valid[0, -1] = False
    return x, sim, bm, valid


@contextlib.contextmanager
def capture_pairwise_inputs():
    """Keep the inputs of the last ``boxinstseg::pairwise_forward`` call
    of ``boxinst_pairwise_loss``, detached (references: no copies in the
    timed steps; nothing writes them in place), and its (color_thresh,
    kernel_size, dilation)."""
    from boxinstseg_tpu_torch.ops import pairwise as pw
    forward = pw.pairwise_forward_op
    kept = {}

    def recorded(mask_logits, color_sim, bitmasks, valid, *cfg):
        kept['inputs'] = tuple(t.detach().float() for t in (
            mask_logits, color_sim, bitmasks)) + (valid.detach(),)
        kept['cfg'] = cfg
        return forward(mask_logits, color_sim, bitmasks, valid, *cfg)
    pw.pairwise_forward_op = recorded
    try:
        yield kept
    finally:
        pw.pairwise_forward_op = forward


def pairwise_coverage(x, sim, bm, valid, thresh=0.3, kernel_size=3,
                      dilation=2):
    """What the pairwise kernels' inputs ask of them: the share of weighted
    (instance, pixel)s, of passing gates, of the (instance, tile) items
    that K1 and K2 must visit (``pairwise.live_tiles``), and of the logits
    within r of a weighted pixel; and the live bytes. K1: the bitmask read
    whole (its vote), the gates, the logits near a weight. K2, led by K1's
    live map as on the main path: the map, the gates, the logits and the
    bitmask near a weight, the gradient written whole."""
    import torch
    import torch.nn.functional as F
    from boxinstseg_tpu_torch.ops import pairwise as pw
    r = kernel_size // 2 * dilation
    b, k, h, w = x.shape
    wmap = ((bm != 0) & valid[..., None, None]).float()
    near = F.max_pool2d(wmap.reshape(b * k, 1, h, w), 2 * r + 1, 1, r)
    n_near = int(near.sum().item())
    cov = dict(
        weighted=wmap.mean().item(),
        gates=(sim >= thresh).float().mean().item(),
        k1_tile=pw.live_tiles(bm, valid, 0, 0, 0).float().mean().item(),
        k1=pw.live_tiles(bm, valid, 0, r, r).float().mean().item(),
        k2=pw.live_tiles(bm, valid, r, r, r).float().mean().item(),
        near=n_near / x.numel())
    live_map = b * k * -(-h // pw.TILE_H) * -(-w // pw.TILE_W)
    cov['k1_live_bytes'] = nbytes(bm, sim, valid) + 4 * n_near + 8
    cov['k2_live_bytes'] = (live_map + nbytes(sim, valid) + 8 * n_near
                            + nbytes(x) + 4)
    cov['near_pixels'] = n_near
    print(f'coverage of {tuple(x.shape)}: weighted pixels '
          f'{cov["weighted"]:.4f}, gates passing {cov["gates"]:.4f}, '
          f'(instance, tile) items live for K1 {cov["k1"]:.4f} (the tile '
          f'alone {cov["k1_tile"]:.4f}), for K2 (tile and halo) '
          f'{cov["k2"]:.4f}; logits within {r} of a weight '
          f'{cov["near"]:.4f}')
    return cov


def box_inputs(shape, kernel_size, gen):
    """Pairwise inputs with box bitmasks, six instances an image: a box
    inside one 8x32 tile, a frame touching every border, an empty instance,
    an invalid one (with a box), the whole plane, and a box across tiles;
    logits up to |x| ~ 16, gates for a stencil of ``kernel_size``."""
    import torch
    b, _, h, w = shape
    x = torch.randn(shape, generator=gen, device='cuda') * 4
    sim = torch.rand((b, kernel_size ** 2 - 1, h, w), generator=gen,
                     device='cuda')
    bm = torch.zeros(shape, device='cuda')
    valid = torch.ones(shape[:2], dtype=torch.bool, device='cuda')
    bm[:, 0, 9:14, 35:min(60, w)] = 1
    bm[:, 1, [0, h - 1]] = 1
    bm[:, 1, :, [0, w - 1]] = 1
    bm[:, 3, 2:h - 3, 1:w // 2] = 1
    valid[:, 3] = False
    bm[:, 4] = 1
    bm[:, 5, 3:22, 5:45] = 1
    return x, sim, bm, valid


def check_pairwise(tag, x, sim, bm, valid, cfg=(0.3, 3, 2)):
    """K1/K2 against the plain version: through ``boxinst_pairwise_loss``
    (the registered ops) against the plain loss and its analytic gradient
    through the normaliser, K1's den exactly, K2 alone on the unnormalised
    gradient, and both giving the same bits in a second call. Returns
    (value error, gradient error)."""
    import torch
    from boxinstseg_tpu_torch.ops import pairwise as pw
    one = torch.ones(1, device='cuda')
    xk = x.clone().requires_grad_(True)
    vk = pw.boxinst_pairwise_loss(xk, sim, bm, valid, *cfg)
    vk.backward()
    sums = torch.stack(pw.pairwise_forward_cuda(x, sim, bm, valid, *cfg))
    g_kernel = pw.pairwise_grad_cuda(x, sim, bm, valid, one, *cfg)
    g_plain = pw.pairwise_grad_plain(x, sim, bm, valid, *cfg)
    num, den = pw.pairwise_num_den_plain(x, sim, bm, valid, *cfg)
    vp = num / den.clamp(min=1.0)
    xp_grad = g_plain * (1.0 / den.clamp(min=1.0))
    same = (torch.equal(sums, torch.stack(pw.pairwise_forward_cuda(
        x, sim, bm, valid, *cfg))) and torch.equal(
        g_kernel, pw.pairwise_grad_cuda(x, sim, bm, valid, one, *cfg)))
    torch.cuda.synchronize()
    inv_den = 1.0 / max(den.item(), 1.0)
    v_err = abs(vk.item() - vp.item())
    g_err = (g_kernel - g_plain).abs().max().item()
    g_max = g_plain.abs().max().item()
    print(f'{tag}: value kernel {vk.item():.9g} plain {vp.item():.9g} abs '
          f'err {v_err:.3g}; den {sums[1].item():.0f} plain '
          f'{den.item():.0f}; unnormalised grad max abs err {g_err:.3g} '
          f'(max |grad| {g_max:.3g}); through autograd '
          f'{(xk.grad - xp_grad).abs().max().item():.3g} (x 1/den '
          f'{inv_den:.3g}); same bits in a second call: {same}')
    if not math.isfinite(vk.item()) or v_err > VALUE_RTOL * abs(vp.item()):
        fail(f'K1 value {vk.item()} vs plain {vp.item()} at {tag}')
    if abs(sums[1].item() - den.item()) > VALUE_RTOL * den.item():
        fail(f'K1 den {sums[1].item()} vs plain {den.item()} at {tag}')
    if not g_max > 0.1:
        fail(f'plain gradient max {g_max} at {tag}: check is vacuous')
    if not torch.allclose(g_kernel, g_plain, atol=GRAD_ATOL, rtol=GRAD_RTOL):
        fail(f'K2 gradient differs from plain at {tag}: {g_err}')
    if not torch.allclose(xk.grad, xp_grad, atol=GRAD_ATOL * inv_den,
                          rtol=GRAD_RTOL):
        fail(f'K2 through autograd differs from plain at {tag}')
    if not same:
        fail(f'K1 / K2 gave other bits in a second call at {tag}')
    return v_err, g_err


def pairwise_entries(x, sim, bm, valid, scale, lib=None):
    """Calls of K1 and K2's C entries on these inputs with their buffers
    made once (no checks, no allocation, no launch count): the kernels'
    device time, where the wrappers' host work would exceed it. K1 keeps
    its live map and K2 takes it, as on the main path. ``lib``: a library
    built from a variant of csrc/pairwise.cu (default: the package's)."""
    import torch
    from boxinstseg_tpu_torch.ops import pairwise as pw
    lib = lib or pw._lib()
    b, k, h, w = x.shape
    grad = torch.empty_like(x)
    fwd = pw._launch_args(x, sim, bm, valid, 0.3, 3, 2)
    bwd = pw._launch_args(x, sim, bm, valid, 0.3, 3, 2, grad)
    part = torch.empty(2 * lib.pairwise_forward_blocks(b, k, h, w),
                       device='cuda')
    out = torch.empty(2, device='cuda')
    live = torch.empty(lib.pairwise_live_items(b, k, h, w),
                       dtype=torch.uint8, device='cuda')
    ins = [t.data_ptr() for t in (x, sim, bm, valid)]

    def forward():
        err = lib.pairwise_forward(*ins, part.data_ptr(), out.data_ptr(),
                                   live.data_ptr(), *fwd)
        if err:
            fail(f'K1: CUDA error {err}')
        return out

    def backward():
        err = lib.pairwise_backward(*ins, scale.data_ptr(), grad.data_ptr(),
                                    live.data_ptr(), *bwd)
        if err:
            fail(f'K2: CUDA error {err}')
        return grad
    forward()
    return forward, backward


def time_pairwise(x, sim, bm, valid, baseline=None):
    """Times (ms) of K1 and K2 on these inputs: 'ms' through the wrappers
    (checks, allocation, launch), as every kernel's row is timed;
    'device_ms' of their C entries alone (the kernels' device time); with
    ``baseline`` (the library of ``load_baseline('pairwise')``) each C
    entry against the one-block-a-tile kernels' in turns, whose four times
    come back under 'turns'."""
    import torch
    from boxinstseg_tpu_torch.ops import pairwise as pw
    _, den = pw.pairwise_num_den_plain(x, sim, bm, valid)
    scale = torch.full((1,), 1.0 / max(den.item(), 1.0), device='cuda')
    new = dict(zip(('pairwise_forward', 'pairwise_backward'),
                   pairwise_entries(x, sim, bm, valid, scale)))
    wrappers = {'pairwise_forward': lambda: pw.pairwise_forward_cuda(
                    x, sim, bm, valid),
                'pairwise_backward': lambda: pw.pairwise_grad_cuda(
                    x, sim, bm, valid, scale)}
    out = {name: dict(ms=cuda_ms(wrappers[name]),
                      device_ms=cuda_ms(new[name])) for name in new}
    if baseline is not None:
        old = dict(zip(new, pairwise_baseline(baseline, x, sim, bm, valid,
                                              scale)))
        for name in new:
            out[name]['turns'] = in_turns(f'{name} at {tuple(x.shape)}',
                                          old[name], new[name])
    return out


def pairwise_bounds(x, sim, bm, valid):
    """Dense bounds (each input read once, each output written once) of
    K1 and K2, and the live bounds of these inputs (pairwise_coverage),
    as ``bound`` dicts."""
    cov = pairwise_coverage(x, sim, bm, valid)
    near = cov['near_pixels']
    return cov, {
        'pairwise_forward': (bound(nbytes(x, sim, bm, valid) + 8,
                                   K1_OPS * x.numel()),
                             bound(cov['k1_live_bytes'], K1_OPS * near)),
        'pairwise_backward': (bound(nbytes(x, sim, bm, valid, x),
                                    K2_OPS * x.numel()),
                              bound(cov['k2_live_bytes'], K2_OPS * near))}


def phase_kernels():
    """K1/K2 against the plain version at the main path's shape with
    random inputs (every tile live), ragged shapes and box bitmasks at the
    main path's stencil and two generic ones; times at the random inputs
    (the main-path inputs come after the slice)."""
    import torch
    from boxinstseg_tpu_torch.ops import pairwise as pw
    gen = torch.Generator(device='cuda').manual_seed(0)
    report = {}
    for shape in (MAIN_SHAPE,) + RAGGED_SHAPES:
        x, sim, bm, valid = kernel_inputs(shape, gen)
        v_err, g_err = check_pairwise(f'{shape}', x, sim, bm, valid)
        if shape == MAIN_SHAPE:
            times = time_pairwise(x, sim, bm, valid)
            _, bounds = pairwise_bounds(x, sim, bm, valid)
            for name, err in (('pairwise_forward', v_err),
                              ('pairwise_backward', g_err)):
                report[name] = dict(random_max_abs_err=err,
                                    random_ms=times[name]['ms'],
                                    random_device_ms=times[name][
                                        'device_ms'],
                                    random_bound_ms=bounds[name][0][
                                        'bound_ms'])
    for kernel_size, dilation in ((3, 2), (3, 1), (5, 1)):
        for shape in ((2, 6, 37, 53), (1, 6, 16, 64)):
            check_pairwise(f'boxes {shape}, kernel {kernel_size}, dilation '
                           f'{dilation}', *box_inputs(shape, kernel_size,
                                                      gen),
                           (0.3, kernel_size, dilation))
    x, sim, bm, valid = kernel_inputs(MAIN_SHAPE, gen)
    report['pairwise_forward']['plain_ms'] = cuda_ms(
        lambda: pw.pairwise_num_den_plain(x, sim, bm, valid))
    report['pairwise_backward']['plain_ms'] = cuda_ms(
        lambda: pw.pairwise_grad_plain(x, sim, bm, valid))
    for name, r in report.items():
        print(f'{name} at {MAIN_SHAPE}, random inputs: kernel '
              f'{r["random_ms"]:.4f} ms (device time of its C entry '
              f'{r["random_device_ms"]:.4f}), plain {r["plain_ms"]:.4f} ms, '
              f'dense bound {r["random_bound_ms"]:.4f} ms')
    return report


def phase_pairwise_main_path(kept, report):
    """K1/K2 at the inputs of the slice's last pairwise call (box bitmasks
    of the sampled GTs, the synthetic images' gates): against the plain
    version, their coverage, and times beside the dense and live bounds;
    then both input sets against the one-block-a-tile kernels in turns.
    Fills the JSON rows: ms, max_abs_err and bound_ms (the live bound) of
    the main-path inputs, the random inputs' beside them."""
    import torch
    x, sim, bm, valid = kept['inputs']
    if kept['cfg'] != (0.3, 3, 2):
        fail(f'the slice called the pairwise loss with {kept["cfg"]}')
    v_err, g_err = check_pairwise(f'main-path inputs {tuple(x.shape)}', x,
                                  sim, bm, valid)
    cov, bounds = pairwise_bounds(x, sim, bm, valid)
    baseline = load_baseline('pairwise')
    times = time_pairwise(x, sim, bm, valid, baseline)
    gen = torch.Generator(device='cuda').manual_seed(0)
    random = time_pairwise(*kernel_inputs(MAIN_SHAPE, gen),
                           baseline=baseline)
    for name, err in (('pairwise_forward', v_err),
                      ('pairwise_backward', g_err)):
        dense, live = bounds[name]
        r = report[name]
        r.update(max_abs_err=err, ms=times[name]['ms'], library_ms=None,
                 **live, dense_bound_ms=dense['bound_ms'],
                 baseline_turns_ms=times[name]['turns'],
                 random_baseline_turns_ms=random[name]['turns'],
                 coverage=cov['k1' if name == 'pairwise_forward' else 'k2'])
        r['device_ms'] = times[name]['device_ms']
        print(f'{name} at the main-path inputs: kernel {r["ms"]:.4f} ms '
              f'(device time of its C entry {r["device_ms"]:.4f}), live '
              f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}), dense bound '
              f'{r["dense_bound_ms"]:.4f} ms; random inputs '
              f'{r["random_ms"]:.4f} ms ({r["random_device_ms"]:.4f})')
    return report


def msda_layer_inputs(b, heads, d, p, levels, l, spread, gen):
    """One encoder layer's inputs to ``ms_deform_attn``. ``l`` None: the
    encoder's queries, one per position of every level with its reference
    point at the grid centre, sampling at the init bias (1-4 cells along
    each head's direction) plus unit noise, with the weights of a softmax
    over random logits. Else ``l`` random reference points whose samples
    spread up to ``spread`` map widths outside every level."""
    import torch
    from boxinstseg_tpu_torch.models.utils.transformer import \
        msda_offset_bias_init
    dev = 'cuda'
    nl = len(levels)
    s = sum(h * w for h, w in levels)
    size = torch.tensor([[w, h] for h, w in levels], device=dev,
                        dtype=torch.float32)[:, None]          # (nl, 1, 2)
    if l is None:
        refs = []
        for h, w in levels:
            ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
            xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
            refs.append(torch.stack(torch.meshgrid(xs, ys, indexing='xy'),
                                    -1).reshape(-1, 2))
        ref = torch.cat(refs)[None].expand(b, s, 2).contiguous()
        l = s
        bias = torch.from_numpy(msda_offset_bias_init(heads, nl, p)).to(dev)
        offsets = bias.reshape(heads, nl, p, 2) + torch.randn(
            (b, l, heads, nl, p, 2), generator=gen, device=dev)
    else:
        ref = torch.rand((b, l, 2), generator=gen, device=dev)
        loc = torch.rand((b, l, heads, nl, p, 2), generator=gen,
                         device=dev) * (1 + 2 * spread) - spread
        offsets = (loc - ref[:, :, None, None, None]) * size
    attn = torch.softmax(torch.randn((b, l, heads, nl * p), generator=gen,
                                     device=dev), -1)
    return (torch.randn((b, s, heads, d), generator=gen, device=dev), ref,
            offsets.contiguous(), attn.reshape(b, l, heads, nl, p),
            torch.randn((b, l, heads * d), generator=gen, device=dev))


def msda_kept(levels, ref, offsets):
    """The number of samples that count (``floor(x)`` in [-1, w-1] and
    ``floor(y)`` in [-1, h-1]), computed as the plain version does."""
    import torch
    kept = 0
    for lvl, (h, w) in enumerate(levels):
        lx = ref[:, :, None, None, 0] + offsets[:, :, :, lvl, :, 0] / w
        ly = ref[:, :, None, None, 1] + offsets[:, :, :, lvl, :, 1] / h
        x0 = torch.floor(lx * w - 0.5)
        y0 = torch.floor(ly * h - 0.5)
        kept += int(((x0 >= -1) & (x0 <= w - 1) & (y0 >= -1)
                     & (y0 <= h - 1)).sum().item())
    return kept


def check_msda(tag, levels, value, ref, offsets, attn, grad):
    """The MSDA kernel pair against ``ms_deform_attn``'s plain version: the
    forward, the backward against the plain backward and against autograd
    through the plain forward, both through the registered op
    ``boxinstseg::msda_forward`` and its autograd; whether two
    backward runs give the same bits. Returns the forward and backward max
    abs errors and the largest difference between two backward runs."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    import torch
    from boxinstseg_tpu_torch.ops import msda
    out_k = msda.msda_forward_cuda(value, levels, ref, offsets, attn)
    out_p = msda.ms_deform_attn_plain(value, levels, ref, offsets, attn)
    f_err = compare(f'MSDA forward {tag}', out_k, out_p)
    grads_k = msda.msda_backward_cuda(value, levels, ref, offsets, attn,
                                      grad)
    leaves = [t.clone().requires_grad_(True) for t in (value, offsets, attn)]
    grads_p = torch.autograd.grad(msda.ms_deform_attn_plain(
        leaves[0], levels, ref, leaves[1], leaves[2]), leaves, grad)
    grads_a = torch.autograd.grad(msda.ms_deform_attn_plain(
        leaves[0], levels, ref, leaves[1], leaves[2],
        sample=msda.msda_forward_plain), leaves, grad)
    b_err = 0.0
    names = ('d_value', 'd_offsets', 'd_attn')
    for name, gk, gp, ga in zip(names, grads_k, grads_p, grads_a):
        b_err = max(b_err, compare(f'MSDA backward {name} {tag}', gk, gp))
        compare(f'MSDA backward {name} {tag} vs autograd', gk, ga)
    before = (COUNTS['kernel.msda_forward'],
              COUNTS['kernel.msda_backward'])
    out_f = msda.ms_deform_attn(leaves[0], levels, ref, leaves[1], leaves[2])
    grads_f = torch.autograd.grad(out_f, leaves, grad)
    if (COUNTS['kernel.msda_forward'] - before[0],
            COUNTS['kernel.msda_backward'] - before[1]) != (1, 1):
        fail(f'the msda_forward op {tag} did not launch the pair once')
    compare(f'msda_forward op {tag}', out_f.detach(), out_p)
    for name, gf, gp in zip(names, grads_f, grads_p):
        compare(f'msda_forward op {name} {tag}', gf, gp)
    again = msda.msda_backward_cuda(value, levels, ref, offsets, attn, grad)
    same = [torch.equal(a, b) for a, b in zip(grads_k, again)]
    rerun = max((a - b).abs().max().item() for a, b in zip(grads_k, again))
    kept = msda_kept(levels, ref, offsets)
    print(f'MSDA {tag}: forward max abs err {f_err:.3g}, backward '
          f'{b_err:.3g} (max |d_offsets| '
          f'{grads_p[1].abs().max().item():.3g}); samples kept '
          f'{kept / attn.numel():.4f}; two backward runs bit-identical '
          f'{dict(zip(names, same))}, largest difference {rerun:.3g}')
    return f_err, b_err, rerun, kept


def phase_msda_kernels():
    """The MSDA kernel pair at one Box2Mask encoder layer's full shapes and
    at the ragged layer cases; times, plain times and bounds at the full
    shapes."""
    import torch
    from boxinstseg_tpu_torch.ops import msda
    gen = torch.Generator(device='cuda').manual_seed(1)
    value, ref, offsets, attn, grad = msda_layer_inputs(
        MSDA_B, MSDA_HEADS, MSDA_D, MSDA_P, MSDA_LEVELS, None, 0, gen)
    tag = (f'(B {MSDA_B}, heads {MSDA_HEADS}, D {MSDA_D}, P {MSDA_P}, '
           f'levels {MSDA_LEVELS}, L {ref.shape[1]})')
    f_err, b_err, rerun, kept = check_msda(tag, MSDA_LEVELS, value, ref,
                                           offsets, attn, grad)
    fwd_ms = cuda_ms(lambda: msda.msda_forward_cuda(value, MSDA_LEVELS, ref,
                                                    offsets, attn))
    bwd_ms = cuda_ms(lambda: msda.msda_backward_cuda(
        value, MSDA_LEVELS, ref, offsets, attn, grad))
    fwd_plain = cuda_ms(lambda: msda.ms_deform_attn_plain(
        value, MSDA_LEVELS, ref, offsets, attn), iters=5)
    leaves = [t.clone().requires_grad_(True) for t in (value, offsets, attn)]
    out_p = msda.ms_deform_attn_plain(leaves[0], MSDA_LEVELS, ref, leaves[1],
                                      leaves[2])
    bwd_plain = cuda_ms(lambda: torch.autograd.grad(
        out_p, leaves, grad, retain_graph=True), iters=5)
    # each input read once, each output written once; operations per kept
    # sample: four corners times a multiply-add per channel plus the corner
    # weights (the backward adds the row-dots and the location gradient)
    inputs = nbytes(value, ref, offsets, attn)
    fwd_bound = bound(inputs + nbytes(grad), kept * (8 * MSDA_D + 16))
    bwd_bound = bound(inputs + nbytes(grad) + nbytes(value, offsets, attn),
                      kept * (16 * MSDA_D + 30))
    # the corner rows the kernels gather through L1 / L2: four 4*D-byte
    # rows a kept sample
    gathered = kept * 4 * MSDA_D * 4
    for name, ms, plain, bnd in (('forward', fwd_ms, fwd_plain, fwd_bound),
                                 ('backward', bwd_ms, bwd_plain, bwd_bound)):
        print(f'MSDA {name} {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms,'
              f' bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_by"]}), '
              f'{bnd["bound_ms"] / ms:.3f} of it; corner rows gathered '
              f'{gathered / 1e9:.3f} GB, {gathered / ms / 1e9:.3f} TB/s')
    report = {
        'msda_forward': dict(max_abs_err=f_err, ms=fwd_ms,
                             plain_ms=fwd_plain, library_ms=None,
                             **fwd_bound),
        'msda_backward': dict(max_abs_err=b_err, ms=bwd_ms,
                              plain_ms=bwd_plain, library_ms=None,
                              rerun_max_diff=rerun, **bwd_bound)}
    for b, heads, d, p, levels, l, spread in MSDA_RAGGED:
        check_msda(f'ragged (B {b}, heads {heads}, D {d}, P {p}, levels '
                   f'{levels}, L {l or "S"}, spread {spread})', levels,
                   *msda_layer_inputs(b, heads, d, p, levels, l, spread,
                                      gen))
    return report


def lcm_inputs(shape, gen, dilations=(2,)):
    import torch
    from boxinstseg_tpu_torch.models.losses.levelset_loss import \
        LocalConsistencyModule
    b, c, h, w = shape
    module = LocalConsistencyModule(dilations=dilations, num_iter=LCM_ITERS)
    imgs = torch.rand((b, 3, h, w), generator=gen, device='cuda')
    aff = module.affinity(imgs).contiguous()
    phi = torch.rand(shape, generator=gen, device='cuda')
    g = torch.randn(shape, generator=gen, device='cuda')
    return module.offsets(), aff, phi, g


def check_lcm(shape, gen, dilations=(2,), rounds=LCM_ITERS):
    """LCM forward and adjoint kernels against the plain rounds, the
    adjoint identity, and the backward of the autograd.Function."""
    import torch
    from boxinstseg_tpu_torch.ops import lcm
    offs, aff, phi, g = lcm_inputs(shape, gen, dilations)
    f_err = compare(f'LCM forward {shape}',
                    lcm.lcm_forward_cuda(aff, phi, offs, rounds),
                    lcm.lcm_forward_plain(aff, phi, offs, rounds))
    a_err = compare(f'LCM adjoint {shape}',
                    lcm.lcm_adjoint_cuda(aff, g, offs, rounds),
                    lcm.lcm_adjoint_plain(aff, g, offs, rounds))
    # <A x, y> = <x, A^T y>, positive x and y so that the sums do not cancel
    x, y = phi, torch.rand(shape, generator=gen, device='cuda')
    lhs = (lcm.lcm_forward_cuda(aff, x, offs, rounds).double()
           * y.double()).sum().item()
    rhs = (x.double() * lcm.lcm_adjoint_cuda(aff, y, offs, rounds)
           .double()).sum().item()
    if not abs(lhs - rhs) <= ADJOINT_RTOL * abs(lhs):
        fail(f'LCM adjoint identity at {shape}: <Ax, y> {lhs} vs '
             f'<x, A^T y> {rhs}')
    p = phi.clone().requires_grad_(True)
    lcm.lcm_refine(aff, p, offs, rounds).backward(g)
    compare(f'LCM autograd backward {shape}', p.grad,
            lcm.lcm_adjoint_plain(aff, g, offs, rounds))
    plan = lcm.launch_plan(phi, offs, True)
    kind = (f'ring kernel, {plan["bands"]} bands of {plan["band_rows"]} '
            f'rows, {plan["G"]} channels a block' if plan else
            'generic kernel')
    print(f'LCM {shape}, dilations {dilations}, {rounds} rounds ({kind}): '
          f'forward max abs err {f_err:.3g}, adjoint {a_err:.3g}; '
          f'<Ax, y> {lhs:.10g} vs <x, A^T y> {rhs:.10g}')
    return offs, aff, phi, g, f_err, a_err


def in_turns(label, old, new, iters=20):
    """Times of ``old`` and ``new`` in the order old, new, new, old."""
    t = [cuda_ms(fn, iters) for fn in (old, new, new, old)]
    print(f'{label}: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / '
          f'{t[2]:.4f} ms (the baseline against the redesign, in turns)')
    return t


def load_baseline(name):
    """The baseline kernels of ``BASELINES[name]``, typed."""
    import ctypes
    from boxinstseg_tpu_torch.ops import _native
    lib = _native.load_library(BASELINES[name])
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == 'pairwise':
        for fn in (lib.baseline_pairwise_forward,
                   lib.baseline_pairwise_backward):
            fn.argtypes = [p] * 6 + [i] * 7 + [ctypes.c_float, p]
            fn.restype = i
        lib.baseline_pairwise_tiles.argtypes = [i, i]
        lib.baseline_pairwise_tiles.restype = i
    elif name == 'lcm':
        for fn in (lib.lcm_forward, lib.lcm_adjoint):
            fn.argtypes = [p] * 3 + [i] * 5 + [p, p, i, p]
            fn.restype = i
    else:
        lib.crf_mean_field.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.crf_mean_field.restype = i
    return lib


def pairwise_baseline(lib, x, sim, bm, valid, scale, thresh=0.3,
                      kernel_size=3, dilation=2):
    """Calls of the one-block-a-tile K1 (with the torch.sum of its
    partials, as its wrapper did) and K2 from ``load_baseline('pairwise')``
    on these inputs: (forward -> (2,) num and den, backward -> gradient x
    scale)."""
    import torch
    b, k, h, w = x.shape
    part = torch.empty((2, b, k, lib.baseline_pairwise_tiles(h, w)),
                       device=x.device)
    grad = torch.empty_like(x)
    cfg = (b, k, h, w, kernel_size ** 2 - 1, kernel_size // 2, dilation,
           thresh)
    ins = [t.data_ptr() for t in (x, sim, bm, valid)]

    def forward():
        err = lib.baseline_pairwise_forward(
            *ins, part[0].data_ptr(), part[1].data_ptr(), *cfg,
            torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f'baseline K1: CUDA error {err}')
        return part.sum(dim=(1, 2, 3))

    def backward():
        err = lib.baseline_pairwise_backward(
            *ins, scale.data_ptr(), grad.data_ptr(), *cfg,
            torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f'baseline K2: CUDA error {err}')
        return grad
    return forward, backward


def phase_lcm_kernels():
    import ctypes
    import torch
    from boxinstseg_tpu_torch.ops import lcm
    gen = torch.Generator(device='cuda').manual_seed(2)
    offs, aff, phi, g, f_err, a_err = check_lcm(LCM_MAIN, gen)
    for shape, dilations, rounds in LCM_RAGGED:
        check_lcm(shape, gen, dilations, rounds)
    big = torch.zeros(LCM_TOO_BIG, device='cuda')
    try:
        lcm.lcm_forward_cuda(torch.zeros((1, 8) + LCM_TOO_BIG[2:],
                                         device='cuda'), big, offs, LCM_ITERS)
    except ValueError as e:
        print(f'LCM {LCM_TOO_BIG} raises: {e}')
    else:
        fail(f'LCM at {LCM_TOO_BIG} did not raise')
    ops = LCM_ITERS * len(offs) * 2 * phi.numel()
    b = bound(nbytes(aff, phi, phi), ops)
    report = {
        'lcm_forward': dict(
            max_abs_err=f_err,
            ms=cuda_ms(lambda: lcm.lcm_forward_cuda(aff, phi, offs,
                                                    LCM_ITERS)),
            plain_ms=cuda_ms(lambda: lcm.lcm_forward_plain(
                aff, phi, offs, LCM_ITERS), iters=5),
            library_ms=None, **b),
        'lcm_adjoint': dict(
            max_abs_err=a_err,
            ms=cuda_ms(lambda: lcm.lcm_adjoint_cuda(aff, g, offs,
                                                    LCM_ITERS)),
            plain_ms=cuda_ms(lambda: lcm.lcm_adjoint_plain(
                aff, g, offs, LCM_ITERS), iters=5),
            library_ms=None, **b)}
    for name, r in report.items():
        print(f'{name} at {LCM_MAIN}: kernel {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, bound {r["bound_ms"]:.4f} ms '
              f'({r["bound_by"]})')
    old = load_baseline('lcm')
    dy = (ctypes.c_int * len(offs))(*[o[0] for o in offs])
    dx = (ctypes.c_int * len(offs))(*[o[1] for o in offs])
    for name, fn, x, new in (('lcm_forward', old.lcm_forward, phi,
                              lcm.lcm_forward_cuda),
                             ('lcm_adjoint', old.lcm_adjoint, g,
                              lcm.lcm_adjoint_cuda)):
        out = torch.empty_like(x)

        def run_old():
            err = fn(aff.data_ptr(), x.data_ptr(), out.data_ptr(),
                     *LCM_MAIN, len(offs), dy, dx, LCM_ITERS,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                fail(f'the one-block-a-plane {name}: CUDA error {err}')
        run_old()
        compare(f'{name}: one block a plane against the redesign', out,
                new(aff, x, offs, LCM_ITERS))
        in_turns(f'{name} at {LCM_MAIN}', run_old,
                 lambda: new(aff, x, offs, LCM_ITERS))
    return report


def swin_inputs(case, gen):
    """qkv (BW, N, 3C), bias (H, N, N), regions (nW, 1, N), g (BW, N, C) of
    one ``SWIN_MAIN`` / ``SWIN_RAGGED`` case, on the card."""
    import torch
    from boxinstseg_tpu_torch.ops.swin_attention import shift_regions
    hp, wp, ws, shift, images, heads, d, region_ids = case
    regions = torch.from_numpy(shift_regions(hp, wp, ws, shift)).cuda()
    if region_ids:
        regions = torch.randint(0, region_ids, regions.shape, generator=gen,
                                device='cuda', dtype=torch.int32)
    nw, _, n = regions.shape
    c = heads * d
    qkv = torch.randn((images * nw, n, 3 * c), generator=gen, device='cuda')
    bias = torch.randn((heads, n, n), generator=gen, device='cuda')
    g = torch.randn((images * nw, n, c), generator=gen, device='cuda')
    return qkv, bias, regions, g


def check_swin(tag, case, gen):
    """K5 and K6 against the plain versions: alone, through the registered
    op ``boxinstseg::window_attention`` and its autograd (what the backbone
    calls), and K6 against autograd through the plain forward. Returns the
    inputs and the forward / backward max abs errors."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    import torch
    from boxinstseg_tpu_torch.ops import swin_attention as swa
    qkv, bias, regions, g = swin_inputs(case, gen)
    scale = case[6] ** -0.5
    q, k, v = swa._split(qkv)
    out_p = swa.window_attention_plain(q, k, v, bias, regions, scale)
    f_err = compare(f'K5 {tag}', swa.window_attention_forward_cuda(
        q, k, v, bias, regions, scale), out_p)
    dqkv, dbias = swa.window_attention_backward_cuda(q, k, v, bias, regions,
                                                     scale, g)
    got = (*swa._split(dqkv), dbias)
    want = swa.window_attention_backward_plain(q, k, v, bias, regions, scale,
                                               g)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    auto = torch.autograd.grad(swa.window_attention_plain(
        *leaves[:3], leaves[3], regions, scale), leaves, g)
    b_err = 0.0
    for name, gk, gp, ga in zip(('dq', 'dk', 'dv', 'dbias'), got, want,
                                auto):
        b_err = max(b_err, compare(f'K6 {name} {tag}', gk, gp))
        compare(f'K6 {name} {tag} vs autograd', gk, ga)
    leaves = [t.clone().requires_grad_(True) for t in (qkv, bias)]
    before = (COUNTS['kernel.window_attention_forward'],
              COUNTS['kernel.window_attention_backward'])
    out_f = swa.window_attention_qkv(leaves[0], leaves[1], regions, scale)
    out_f.backward(g)
    if (COUNTS['kernel.window_attention_forward'] - before[0],
            COUNTS['kernel.window_attention_backward'] - before[1]) \
            != (1, 1):
        fail(f'the window_attention op {tag} did not launch K5 and K6 once')
    compare(f'window_attention op forward {tag}', out_f.detach(), out_p)
    compare(f'window_attention op d(qkv) {tag}', leaves[0].grad,
            torch.cat(want[:3], -1))
    compare(f'window_attention op d(bias) {tag}', leaves[1].grad, want[3])
    print(f'swin {tag} (BW {qkv.shape[0]}, N {qkv.shape[1]}, heads '
          f'{bias.shape[0]}, head dim {case[6]}, region ids '
          f'{int(regions.max().item()) + 1}): K5 max abs err {f_err:.3g}, '
          f'K6 {b_err:.3g} (max |dbias| {want[3].abs().max().item():.3g})')
    return (qkv, bias, regions, g, scale), f_err, b_err


def sdpa_backend(fn):
    """The kernels one call of ``fn`` ran, by the profiler, and the SDPA
    backend their names show."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type.name == 'CUDA'})
    joined = ' '.join(names).lower()
    for key, backend in (('flash', 'flash'), ('fmha', 'efficient'),
                         ('efficient', 'efficient'), ('cudnn', 'cudnn')):
        if key in joined:
            return backend, names
    return 'math', names


def phase_swin_kernels():
    """K5/K6 at the main path's shapes and ragged ones; times, bounds and
    the SDPA yardstick at Swin-L's stage-0 and stage-2 shapes."""
    import torch
    import torch.nn.functional as F
    from boxinstseg_tpu_torch.ops import swin_attention as swa
    gen = torch.Generator(device='cuda').manual_seed(3)
    report = {}
    for tag, case in SWIN_MAIN.items():
        (qkv, bias, regions, g, scale), f_err, b_err = check_swin(tag, case,
                                                                  gen)
        q, k, v = swa._split(qkv)
        bw, n = qkv.shape[:2]
        h, d = bias.shape[0], case[6]
        io = nbytes(qkv, bias, regions)
        # per (window, head): q k^T and P v (4 N^2 D), the logits' scale,
        # bias, mask, max, exponent and sum (6 N^2); the backward recomputes
        # the logits and softmax (2 N^2 D + 6 N^2), then dV, dP, dQ, dK
        # (8 N^2 D) and dS and the dbias sum (4 N^2)
        pairs = bw * h
        fwd_bytes = io + nbytes(g)
        bwd_bytes = io + nbytes(g) + nbytes(qkv, bias)
        fwd_bound = bound(fwd_bytes, pairs * (4 * n * n * d + 6 * n * n))
        bwd_bound = bound(bwd_bytes, pairs * (10 * n * n * d + 10 * n * n))
        fwd_bound['bound_3xtf32_ms'] = bound_3xtf32(
            fwd_bytes, pairs * 4 * n * n * d, pairs * 6 * n * n)
        bwd_bound['bound_3xtf32_ms'] = bound_3xtf32(
            bwd_bytes, pairs * 10 * n * n * d, pairs * 10 * n * n)
        fwd_ms = cuda_ms(lambda: swa.window_attention_forward_cuda(
            q, k, v, bias, regions, scale))
        bwd_ms = cuda_ms(lambda: swa.window_attention_backward_cuda(
            q, k, v, bias, regions, scale, g))
        fwd_plain = cuda_ms(lambda: swa.window_attention_plain(
            q, k, v, bias, regions, scale), iters=5)
        bwd_plain = cuda_ms(lambda: swa.window_attention_backward_plain(
            q, k, v, bias, regions, scale, g), iters=5)
        # the yardstick: one SDPA call on (BW, H, N, D) with the bias and
        # shift mask as a (BW, H, N, N) float mask built beforehand; its
        # backward with the mask requiring grad, the mask's gradient summed
        # over the windows being dbias
        heads = [swa._heads(t, h).contiguous() for t in (q, k, v)]
        r = regions[:, 0]
        mask = torch.where(r[:, :, None] != r[:, None, :], swa.NEG, 0.0)
        mask = (bias[None] + mask[torch.arange(bw, device='cuda')
                                  % r.shape[0]][:, None]).contiguous()
        gh = swa._heads(g, h).contiguous()
        lib_out = F.scaled_dot_product_attention(*heads, attn_mask=mask,
                                                 scale=scale)
        lib_err = (swa._merge_heads(lib_out) - swa.window_attention_plain(
            q, k, v, bias, regions, scale)).abs().max().item()
        leaves = [t.clone().requires_grad_(True) for t in heads + [mask]]

        def lib_fwd():
            return F.scaled_dot_product_attention(*heads, attn_mask=mask,
                                                  scale=scale)

        def lib_bwd():
            out = F.scaled_dot_product_attention(*leaves[:3],
                                                 attn_mask=leaves[3],
                                                 scale=scale)
            grads = torch.autograd.grad(out, leaves, gh)
            return grads[3].sum(0)

        backend_f, _ = sdpa_backend(lib_fwd)
        backend_b, names_b = sdpa_backend(lib_bwd)
        lib_fwd_ms = cuda_ms(lib_fwd)
        lib_bwd_ms = cuda_ms(lib_bwd)
        print(f'swin {tag}: K5 {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, '
              f'bound {fwd_bound["bound_ms"]:.4f} ms '
              f'({fwd_bound["bound_by"]}; 3xTF32 '
              f'{fwd_bound["bound_3xtf32_ms"]:.4f} ms), SDPA '
              f'{lib_fwd_ms:.4f} ms ({backend_f}; max abs diff to plain '
              f'{lib_err:.3g}); K6 {bwd_ms:.4f} ms, plain {bwd_plain:.4f} '
              f'ms, bound {bwd_bound["bound_ms"]:.4f} ms '
              f'({bwd_bound["bound_by"]}; 3xTF32 '
              f'{bwd_bound["bound_3xtf32_ms"]:.4f} ms), SDPA forward + '
              f'backward + window sum {lib_bwd_ms:.4f} ms ({backend_b}: '
              f'{", ".join(n[:60] for n in names_b[:4])})')
        rows = {'swin_attention_forward': dict(
                    max_abs_err=f_err, ms=fwd_ms, plain_ms=fwd_plain,
                    library_ms=lib_fwd_ms, **fwd_bound),
                'swin_attention_backward': dict(
                    max_abs_err=b_err, ms=bwd_ms, plain_ms=bwd_plain,
                    library_ms=lib_bwd_ms, **bwd_bound)}
        # the row's own numbers are stage 0's (comparable with earlier
        # runs); the other stages ride beside them under their tag
        for name, row in rows.items():
            if name in report:
                report[name][tag] = row
            else:
                report[name] = row
        del heads, mask, leaves, lib_out
    for tag, case in SWIN_RAGGED.items():
        check_swin(tag, case, gen)
    return report


def register_dataset():
    from boxinstseg_tpu_torch.registry import DATASETS
    for cls in (SyntheticBoxDataset, SyntheticEvalDataset):
        if cls.__name__ not in DATASETS:
            DATASETS.register_module(module=cls)


def train_tool(tool, config, work_dir, seed, opts, *args):
    """``tools/train_torch.py``'s ``main`` on the card, without evaluation
    (no dataset on the card), ``args`` appended."""
    return tool.main([config, '--work-dir', work_dir, '--seed', str(seed),
                      '--device', 'cuda', '--no-validate', *args,
                      '--cfg-options', *opts])


def check_history(result, steps, required=()):
    if result.step != steps:
        fail(f'ran {result.step} steps, expected {steps}')
    for i, logs in enumerate(result.history):
        bad = [k for k, v in logs.items() if not math.isfinite(v)]
        if bad:
            fail(f'step {i}: non-finite {bad}')
        for k in required:
            if i > 0 and not logs[k] > 0:
                fail(f'step {i}: {k} {logs[k]}')


def changed_tensors(tool, cfg, seed, result):
    """The names of the tensors that training changed, and the model (on
    the CPU) with the trained weights loaded."""
    import torch
    model = tool.build_model(cfg, seed)
    init = model.state_dict()
    final = torch.load(result.checkpoint, map_location='cpu')
    if final['_iter'] != result.step:
        fail(f'checkpoint _iter {final["_iter"]}')
    changed = [k for k, v in final['state_dict'].items()
               if v.is_floating_point() and not torch.equal(v, init[k])]
    model.load_state_dict(final['state_dict'])
    return changed, model


@contextlib.contextmanager
def timed_calls(owner, names):
    """Wrap the functions ``names`` of ``owner`` (a module or a class) to
    sum the host seconds spent in each."""
    seconds = dict.fromkeys(names, 0.0)
    saved = {name: getattr(owner, name) for name in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] += time.perf_counter() - t0
        return timed
    for name, fn in saved.items():
        setattr(owner, name, wrap(name, fn))
    try:
        yield seconds
    finally:
        for name, fn in saved.items():
            setattr(owner, name, fn)


@contextlib.contextmanager
def live_gt_counts():
    """Collect each training step's live GT count (the host batch's
    ``gt_valid``, read before it goes to the card: no device wait)."""
    from boxinstseg_tpu_torch.apis import train
    to_device = train.batch_to_device
    counts = []

    def counted(batch, device):
        counts.append(int(batch['gt_valid'].sum()))
        return to_device(batch, device)
    train.batch_to_device = counted
    try:
        yield counts
    finally:
        train.batch_to_device = to_device


def print_steps(result, peak, gts=None, teacher_after=None):
    """Each step's time (beside its live GT count where ``gts`` is given);
    the median, min and max of steps 2 on, or for DiscoBox
    (``teacher_after`` = start_iter) of the steps without and with the
    teacher's forward apart (PERF.md section 2). Returns the median of
    steps 2 on."""
    step_ms = [1e3 * (h['time'] - h['data_time']) for h in result.history]
    print(f'losses at step {result.step}: ' + ', '.join(
        f'{k} {v:.5f}' for k, v in result.history[-1].items()
        if k.startswith('loss')))
    print('step ms (compute + sync, data excluded)' + (
        ' with live GTs: ' + ', '.join(
            f'{t:.3f} ({n} GTs)' for t, n in zip(step_ms, gts))
        if gts is not None else ': ' + ', '.join(
            f'{t:.3f}' for t in step_ms)))

    def spread(first, last):
        ms = step_ms[first - 1:last]
        return (f'steps {first}-{last} median {statistics.median(ms):.3f}, '
                f'min {min(ms):.3f}, max {max(ms):.3f} ms')
    if teacher_after is None:
        medians = spread(2, result.step)
    else:
        k = teacher_after + 1
        medians = (f'{spread(2, k)} (no teacher), '
                   f'{spread(k + 1, result.step)} (teacher)')
    print(f'{medians}; peak memory {peak / 2**30:.3f} GiB')
    return statistics.median(step_ms[1:])


def phase_slice(tool, work_dir):
    """5 SGD steps of BoxInst R-50-FPN 1x through the train entry point,
    the checkpoint written under ``work_dir``. Returns the pairwise
    kernels' launches, the inputs (and config) of the last step's pairwise
    call, the checkpoint's path and the median step ms."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    import torch
    register_dataset()
    seed = 0
    opts = ['model.mask_head.pairwise_warmup=1',
            *TRAIN_OPTS,
            'data.samples_per_gpu=2', 'data.train.type=SyntheticBoxDataset']
    cfg = tool.load_config(CONFIG, opts, work_dir, seed)
    head = cfg.model.bbox_head
    gen_params = tool.build_model(cfg, seed).mask_head.num_gen_params
    print(f'model: {cfg.model.backbone.type}-{cfg.model.backbone.depth}'
          f', FPN {cfg.model.neck.out_channels}, '
          f'{head.stacked_convs}x GN towers, {gen_params} dynamic '
          f'params, {head.num_classes} classes, topk_per_img '
          f'{cfg.model.mask_head.topk_per_img}')
    torch.cuda.reset_peak_memory_stats()
    COUNTS['kernel.pairwise_forward'] = 0
    COUNTS['kernel.pairwise_backward'] = 0
    with live_gt_counts() as gts, capture_pairwise_inputs() as kept:
        result = train_tool(tool, CONFIG, work_dir, seed, opts)
    torch.cuda.synchronize()
    launches = {'pairwise_forward': COUNTS['kernel.pairwise_forward'],
                'pairwise_backward': COUNTS['kernel.pairwise_backward']}
    peak = torch.cuda.max_memory_allocated()
    check_history(result, STEPS, required=('loss_pairwise',))
    for name, n in launches.items():
        if n != STEPS:
            fail(f'{name} launched {n} times in {STEPS} steps')
    changed, _ = changed_tensors(tool, cfg, seed, result)
    if not changed:
        fail('no parameter changed in training')
    print(f'{len(changed)} tensors changed; launches {launches}')
    median_ms = print_steps(result, peak, gts)
    if tuple(kept['inputs'][0].shape) != MAIN_SHAPE:
        fail(f'the last pairwise call took {kept["inputs"][0].shape}, '
             f'not {MAIN_SHAPE}')
    return launches, kept, result.checkpoint, median_ms


def describe_backbone(bb):
    if bb.type == 'ResNet':
        return f'ResNet-{bb.depth}'
    if bb.type == 'ResNeXt':
        return f'ResNeXt-{bb.depth} {bb.groups}x{bb.base_width}d'
    return (f'{bb.type} embed {bb.embed_dims}, depths {list(bb.depths)}, '
            f'heads {list(bb.num_heads)}, window {bb.window_size}')


def phase_box2mask(tool, config, samples, parts, lsa_kept=None,
                   mst_kept=None):
    """5 AdamW steps of a Box2Mask config through the train entry point on
    1024x1024 synthetic images, ``samples`` a batch, with scipy's
    linear_sum_assignment refusing every call (the Hungarian match goes
    through the LSA kernel, once a step; the tree filter's trees through
    the MST kernel, once a step). Returns the launches of the kernels over
    the run, the config and the trained model (on the CPU). Fails unless a
    tensor of each of ``parts`` changed. ``lsa_kept`` and ``mst_kept``,
    dicts, receive the last LSA and MST calls' inputs."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    import torch
    register_dataset()
    work_dir = tempfile.mkdtemp(prefix='chip_smoke_b2m_')
    seed = 0
    opts = [*TRAIN_OPTS,
            f'data.samples_per_gpu={samples}',
            'data.train.type=SyntheticBoxDataset',
            'data.train.img_h=1024', 'data.train.img_w=1024']
    counters = {'msda_forward': 'kernel.msda_forward',
                'msda_backward': 'kernel.msda_backward',
                'lcm_forward': 'kernel.lcm_forward',
                'lcm_adjoint': 'kernel.lcm_adjoint',
                'lsa_solve': 'kernel.lsa',
                'grid_mst': 'kernel.grid_mst'}
    try:
        cfg = tool.load_config(config, opts, work_dir, seed)
        head = cfg.model.panoptic_head
        pd, td = head.pixel_decoder, head.transformer_decoder
        levels = head.num_transformer_feat_level
        bb = cfg.model.backbone
        print(f'model: {describe_backbone(bb)}, pixel decoder '
              f'{pd.num_encoder_layers} MSDeformAttn layers x {levels} '
              f'levels, {td.num_layers}-layer decoder, {head.num_queries} '
              f'queries, {head.feat_channels} channels, FFN '
              f'{td.transformerlayers.feedforward_channels}, '
              f'{head.num_things_classes} classes, canvas '
              f'{cfg.canvases[0]}, batch {samples}, optimizer '
              f'{cfg.optimizer.type}, grad clip '
              f'{cfg.optimizer_config.grad_clip.max_norm}')
        # one MSDA launch per encoder layer (all levels); one LCM
        # refinement; one LSA solve of every decoder output's match; one MST
        # launch for both trees of every image; one K5 and one K6 per Swin
        # block
        per_step = {'msda_forward': pd.num_encoder_layers,
                    'msda_backward': pd.num_encoder_layers,
                    'lcm_forward': 1, 'lcm_adjoint': 1, 'lsa_solve': 1,
                    'grid_mst': 1}
        if bb.type == 'SwinTransformer':
            counters['swin_attention_forward'] = \
                'kernel.window_attention_forward'
            counters['swin_attention_backward'] = \
                'kernel.window_attention_backward'
            per_step['swin_attention_forward'] = sum(bb.depths)
            per_step['swin_attention_backward'] = sum(bb.depths)
        torch.cuda.reset_peak_memory_stats()
        for key in counters.values():
            COUNTS[key] = 0
        kept = {} if lsa_kept is None else lsa_kept
        with live_gt_counts() as gts, no_scipy_lsa(), \
                capture_lsa_inputs(kept), \
                capture_mst_inputs({} if mst_kept is None else mst_kept):
            result = train_tool(tool, config, work_dir, seed, opts)
        torch.cuda.synchronize()
        launches = {name: COUNTS[key] for name, key in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        check_history(result, STEPS,
                      required=('loss_cls', 'loss_project',
                                'loss_levelset'))
        print(f'LSA kernel launches a step: {launches["lsa_solve"] / STEPS:g}'
              f' (scipy\'s linear_sum_assignment refused every call); the '
              f'last step\'s problems {tuple(kept["cost"].shape)}, live rows '
              f'{kept["n_rows"].tolist()}')
        for name, n in launches.items():
            if n != per_step[name] * STEPS:
                fail(f'{name} launched {n} times in {STEPS} steps, expected '
                     f'{per_step[name]} a step')
        changed, model = changed_tensors(tool, cfg, seed, result)
        for part in parts:
            if not any(part in k for k in changed):
                fail(f'no *{part}* tensor changed in training')
        print(f'{len(changed)} tensors changed; launches {launches} '
              f'(per step {per_step})')
        print_steps(result, peak, gts)
        return launches, cfg, model
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def phase_swin_predict(cfg, model):
    """``MaskFormer.predict`` of the trained Swin-L on one 1024x1024 image:
    K5 once per block a call, K6 never; the instance candidates' shapes;
    the median wall time of 3 calls after 1 warm-up; then
    ``format_detection`` and the RLE codec on its output."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    import torch
    from boxinstseg_tpu_torch.apis.test import format_detection
    from boxinstseg_tpu_torch.data.coco_api import rle_encode
    fwd, bwd = ('kernel.window_attention_forward',
                'kernel.window_attention_backward')
    blocks = sum(cfg.model.backbone.depths)
    k = cfg.model.test_cfg.max_per_image
    model = model.cuda().eval()
    gen = torch.Generator().manual_seed(0)
    batch = {'image': torch.randn((1, 3, 1024, 1024), generator=gen).cuda()}
    COUNTS[fwd] = COUNTS[bwd] = 0
    out = model.predict(batch)
    torch.cuda.synchronize()
    if (COUNTS[fwd], COUNTS[bwd]) != (blocks, 0):
        fail(f'predict launched K5 {COUNTS[fwd]} and K6 {COUNTS[bwd]} '
             f'times, expected {blocks} and 0')
    want = {'scores': (1, k), 'labels': (1, k), 'valid': (1, k),
            'masks_logit': (1, k, 256, 256)}
    for key, shape in want.items():
        if tuple(out[key].shape) != shape:
            fail(f'predict {key} {tuple(out[key].shape)}, expected {shape}')
    if not (torch.isfinite(out['scores']).all()
            and torch.isfinite(out['masks_logit']).all()):
        fail('predict gave non-finite scores or mask logits')
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.predict(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    if (COUNTS[fwd], COUNTS[bwd]) != (4 * blocks, 0):
        fail(f'4 predict calls launched K5 {COUNTS[fwd]} and K6 '
             f'{COUNTS[bwd]} times')
    print(f'predict: {k} candidates, scores {out["scores"][0, :3].tolist()}'
          f', labels {out["labels"][0, :3].tolist()}, masks_logit '
          f'{tuple(out["masks_logit"].shape)}; K5 {blocks} launches a call,'
          f' K6 none; wall ms {[round(t, 3) for t in times]}, median '
          f'{statistics.median(times):.3f} ms')
    # the MaskFormer family's host half: logits to the image's resolution,
    # binarised and rescored, then the RLE codec. After STEPS steps from
    # random weights no logit is positive, so every mask would be empty:
    # each query's logits are shifted so that its top tenth is positive,
    # and the formatting runs on real masks.
    raw = int((out['masks_logit'] > 0).flatten(2).any(2).sum())
    flat = out['masks_logit'].flatten(2)
    top = flat.kthvalue(int(0.9 * flat.shape[-1]), dim=2).values
    shifted = dict(out, masks_logit=out['masks_logit'] - top[..., None, None])
    test_cfg = dict(cfg.model.test_cfg)
    format_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        det = format_detection(shifted, 0, (1024, 1024), (1024, 1024),
                               test_cfg)
        rles = [rle_encode(m) for m in det['masks']]
        format_ms.append(1e3 * (time.perf_counter() - t0))
    n_valid = int(out['valid'].sum())
    if not len(rles) == len(det['bboxes']) == n_valid > 0 or not all(
            m.shape == (1024, 1024) for m in det['masks']):
        fail(f'format_detection gave {len(rles)} masks for '
             f'{len(det["bboxes"])} detections of {n_valid} valid queries')
    print(f'format + RLE: {raw} of {k} raw masks non-empty; with the top '
          f'tenth of each query made positive {len(rles)} masks, ms '
          f'{[round(t, 3) for t in format_ms]}, median '
          f'{statistics.median(format_ms):.3f}')
    check_format_on_cpu('Swin-L Box2Mask', shifted, (1024, 1024),
                        (1024, 1024), test_cfg, det)


def tiny_cfg():
    return dict(
        type='CondInst',
        backbone=dict(type='ResNet', depth=18, frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=1,
                  add_extra_convs='on_output', num_outs=5,
                  relu_before_extra_convs=True),
        bbox_head=dict(type='CondInstBoxHead', num_classes=4,
                       in_channels=32, feat_channels=32, stacked_convs=1,
                       norm_cfg=dict(type='GN', num_groups=4)),
        mask_branch=dict(type='CondInstMaskBranch', in_channels=32,
                         branch_convs=1, branch_channels=16,
                         branch_out_channels=8),
        mask_head=dict(type='CondInstMaskHead', in_channels=8,
                       topk_per_img=8, pairwise_warmup=100))


def compare_loss_dicts(cfg, batch, iteration=None, grads_of=None):
    """The model's loss dict on the card against the CPU, same weights;
    with ``grads_of``, also the gradients of the total loss for the
    parameters whose names start with it (relative L2 error per tensor,
    SWIN_REF_RTOL of the larger of its norm and a thousandth of the
    largest norm: a bias before a GroupNorm has a gradient of rounding
    noise)."""
    import torch
    from boxinstseg_tpu_torch.registry import build_detector
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_detector(cfg).train()
    losses, grads = {}, {}
    for dev in ('cpu', 'cuda'):
        model.to(dev)
        model.zero_grad(set_to_none=True)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state = {k: v.clone() for k, v in model.state_dict().items()}
        args = () if iteration is None else (iteration,)
        with torch.set_grad_enabled(grads_of is not None):
            out = model.loss(tb, *args)
        losses[dev] = {k: v.item() for k, v in out.items()}
        if grads_of is not None:
            sum(v for k, v in out.items() if 'loss' in k).backward()
            grads[dev] = {k: p.grad.detach().cpu().clone()
                          for k, p in model.named_parameters()
                          if k.startswith(grads_of)}
        model.load_state_dict(state)      # undo the BN running-stat update
    if grads_of is not None:
        largest = max(g.norm().item() for g in grads['cpu'].values())
        worst = 0.0
        for k, want in grads['cpu'].items():
            err = (grads['cuda'][k] - want).norm().item()
            scale = max(want.norm().item(), 1e-3 * largest)
            worst = max(worst, err / scale)
            if not err <= SWIN_REF_RTOL * scale:
                fail(f'gradient of {k} on the card vs CPU: relative L2 '
                     f'error {err / scale:.3g}')
        print(f'{len(grads["cpu"])} {grads_of}* gradients: worst relative '
              f'L2 error card vs CPU {worst:.3g} (largest norm '
              f'{largest:.3g})')
    for k, want in losses['cpu'].items():
        got = losses['cuda'][k]
        print(f'{k}: cuda {got:.7g} cpu {want:.7g}')
        if not math.isfinite(got) or abs(got - want) > REF_ATOL \
                + REF_RTOL * abs(want):
            fail(f'{k} on the card {got} vs CPU {want}')
    return losses['cuda']


def phase_reference():
    """Small CondInst: loss dict on the card vs the CPU plain path, in
    fp32."""
    print('fp32: the precision policy is off (no fp16 / bf16 key), so the '
          'card and the CPU compute the same function')
    compare_loss_dicts(tiny_cfg(), reference_batch(), 50)


def reference_batch():
    """The small CondInst's seeded numpy batch (NCHW, 128x160, up to 5
    boxes an image)."""
    import numpy as np
    rng = np.random.RandomState(0)
    b, h, w, g = 2, 128, 160, 5
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(rng.randint(1, g + 1)):
            x1, y1 = rng.randint(0, w - 40), rng.randint(0, h - 40)
            boxes[i, j] = (x1, y1, x1 + rng.randint(16, 40),
                           y1 + rng.randint(16, 40))
            valid[i, j] = True
    batch = dict(image=rng.rand(b, 3, h, w).astype(np.float32) * 4 - 2,
                 img_shape=np.array([[h, w]] * b, np.int32),
                 pixels_removed=np.array([5] * b, np.int32),
                 gt_bboxes=boxes, gt_labels=rng.randint(0, 4, (b, g)),
                 gt_valid=valid)
    return batch


def tiny_box2mask_cfg():
    """ResNet-18, 32 channels, 2 encoder and 3 decoder layers, 10 queries,
    a 24x24 tree filter with a binding depth cap."""
    return dict(
        type='Box2Mask',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=-1),
        panoptic_head=dict(
            type='Box2MaskHead', in_channels=[64, 128, 256, 512],
            strides=[4, 8, 16, 32], feat_channels=32, out_channels=32,
            num_things_classes=4, num_stuff_classes=0, num_queries=10,
            num_transformer_feat_level=3,
            pixel_decoder=dict(num_outs=3, num_encoder_layers=2),
            transformer_decoder=dict(
                num_layers=3, transformerlayers=dict(
                    attn_cfgs=dict(num_heads=4), feedforward_channels=64)),
            loss_cls=dict(type='CrossEntropyLoss', loss_weight=2.0),
            loss_box=dict(type='BoxProjectionLoss', loss_weight=5.0),
            loss_mask=dict(type='LevelsetLoss', loss_weight=1.0),
            max_matched=4, tf_size=(24, 24), tf_max_depth=64),
        train_cfg=dict(assigner=dict(cls_cost=dict(weight=2.0),
                                     dice_cost=dict(weight=5.0))))


def phase_box2mask_reference():
    """Small Box2Mask: loss dict on the card (kernels) vs the CPU (plain
    versions), in fp32."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    print('fp32: the precision policy is off (no fp16 / bf16 key), so the '
          'card and the CPU compute the same function')
    import numpy as np
    rng = np.random.RandomState(0)
    b, h, w, g = 2, 128, 128, 4
    masks = np.zeros((b, g, h // 4, w // 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(rng.randint(1, g + 1)):
            x1, y1 = rng.randint(0, w - 48), rng.randint(0, h - 48)
            x2, y2 = x1 + rng.randint(24, 48), y1 + rng.randint(24, 48)
            masks[i, j, y1 // 4:y2 // 4 + 1, x1 // 4:x2 // 4 + 1] = 1
            valid[i, j] = True
    batch = dict(image=rng.rand(b, 3, h, w).astype(np.float32) * 4 - 2,
                 gt_masks=masks, gt_labels=rng.randint(0, 4, (b, g)),
                 gt_valid=valid)
    before = COUNTS['kernel.msda_forward'], COUNTS['kernel.lcm_forward']
    compare_loss_dicts(tiny_box2mask_cfg(), batch)
    if (COUNTS['kernel.msda_forward'], COUNTS['kernel.lcm_forward']) \
            == before:
        fail('the small Box2Mask on the card launched no MSDA / LCM kernel')


def phase_swin_reference():
    """The small Box2Mask on a tiny Swin (window 4; 120x136 images give
    30x34, 15x17, 8x9 and 4x5 token maps, all padded, with shifted blocks in
    every stage): loss dict and backbone gradients on the card (K5, K6)
    against the CPU (plain versions), in fp32."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    print('fp32: the precision policy is off (no fp16 / bf16 key), so the '
          'card and the CPU compute the same function')
    import numpy as np
    rng = np.random.RandomState(1)
    b, h, w, g = 2, 120, 136, 4
    masks = np.zeros((b, g, h // 4, w // 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(rng.randint(1, g + 1)):
            x1, y1 = rng.randint(0, w - 48), rng.randint(0, h - 48)
            x2, y2 = x1 + rng.randint(24, 48), y1 + rng.randint(24, 48)
            masks[i, j, y1 // 4:y2 // 4 + 1, x1 // 4:x2 // 4 + 1] = 1
            valid[i, j] = True
    batch = dict(image=rng.rand(b, 3, h, w).astype(np.float32) * 4 - 2,
                 gt_masks=masks, gt_labels=rng.randint(0, 4, (b, g)),
                 gt_valid=valid)
    cfg = tiny_box2mask_cfg()
    cfg['backbone'] = dict(type='SwinTransformer', embed_dims=32,
                           depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
                           window_size=4)
    cfg['panoptic_head']['in_channels'] = [32, 64, 128, 256]
    fwd, bwd = ('kernel.window_attention_forward',
                'kernel.window_attention_backward')
    COUNTS[fwd] = COUNTS[bwd] = 0
    compare_loss_dicts(cfg, batch, grads_of='backbone.')
    if (COUNTS[fwd], COUNTS[bwd]) != (8, 8):
        fail(f'the small Swin Box2Mask on the card launched K5 '
             f'{COUNTS[fwd]} and K6 {COUNTS[bwd]} times, expected 8 each')


SWIN_RECIPE_STEPS = 4


def swin_recipe_opts(log_dir):
    """The Swin-L recipe's options: LayerDecay over the shipped custom keys,
    a cosine schedule with a linear warmup of 2 steps, the EMA, memory and
    profiler hooks (the trace of step 3), batch 1 on 1024x1024 synthetic
    images, SWIN_RECIPE_STEPS steps."""
    return ['runner.type=IterBasedRunner',
            f'runner.max_iters={SWIN_RECIPE_STEPS}', 'log_config.interval=1',
            'data.samples_per_gpu=1', 'data.train.type=SyntheticBoxDataset',
            'data.train.img_h=1024', 'data.train.img_w=1024',
            'optimizer.constructor=LayerDecayOptimizerConstructor',
            'optimizer.paramwise_cfg.num_layers=12',
            'optimizer.paramwise_cfg.layer_decay_rate=0.9',
            "lr_config={'policy': 'CosineAnnealing', 'min_lr_ratio': 0.01, "
            "'warmup': 'linear', 'warmup_iters': 2, 'warmup_ratio': 0.1, "
            "'by_epoch': False}",
            "custom_hooks=[{'type': 'EMAHook', 'momentum': 0.999}, "
            "{'type': 'MemoryProfilerHook', 'interval': 1}, "
            "{'type': 'ProfilerHook', 'start': 2, 'stop': 3, "
            f"'log_dir': {log_dir!r}}}]"]


@contextlib.contextmanager
def recorded_optimizer(train):
    """Wrap ``train.build_optimizer`` (the name ``apis.train`` calls) so
    that the run's parameter names, each group's params and each step's
    group LRs (a step pre-hook) are kept in the yielded dict."""
    build = train.build_optimizer
    seen = {'lrs': []}

    def recording(cfg, named_params):
        named = list(named_params)
        opt = build(cfg, named)
        seen['names'] = {id(p): n for n, p in named}
        seen['optimizer'] = opt
        opt.register_step_pre_hook(lambda o, args, kwargs: seen['lrs'].append(
            [g['lr'] for g in o.param_groups]))
        return opt
    train.build_optimizer = recording
    try:
        yield seen
    finally:
        train.build_optimizer = build


@contextlib.contextmanager
def recorded_ema(hooks, device):
    """Wrap ``EMAHook.after_step``: after each update, whether the average
    equals the parameters (exactly), and the update's ms (on a card with
    device syncs around it)."""
    import torch
    step = hooks.EMAHook.after_step
    seen = {'equal': [], 'ms': [], 'count': 0}
    sync = torch.cuda.synchronize if torch.device(device).type == 'cuda' \
        else (lambda: None)

    def recording(self, i, state, logs):
        sync()
        t0 = time.perf_counter()
        step(self, i, state, logs)
        sync()
        seen['ms'].append(1e3 * (time.perf_counter() - t0))
        params = dict(state.model.named_parameters())
        seen['equal'].append(all(torch.equal(v, params[k])
                                 for k, v in self.ema_params.items()))
        seen['count'] = sum(v.numel() for v in self.ema_params.values())
    hooks.EMAHook.after_step = recording
    try:
        yield seen
    finally:
        hooks.EMAHook.after_step = step


@contextlib.contextmanager
def logged_lines(pattern):
    """The package logger's messages holding ``pattern``, kept within."""
    import logging
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            if pattern in record.getMessage():
                lines.append(record.getMessage())
    handler = Keep()
    logger = logging.getLogger('boxinstseg_tpu_torch')
    logger.addHandler(handler)
    try:
        yield lines
    finally:
        logger.removeHandler(handler)


def check_group_lrs(seen, cfg, lr_fn, steps):
    """Each step's LR of each param group equals the schedule's times the
    group's ``lr_mult``, and each group's ``lr_mult`` is the LayerDecay
    rule's for every parameter in it; returns the groups' multipliers."""
    from boxinstseg_tpu_torch.engine.optimizers import paramwise_multipliers
    lr_mult, _ = paramwise_multipliers(cfg.optimizer)
    groups = seen['optimizer'].param_groups
    for g in groups:
        names = [seen['names'][id(p)] for p in g['params']]
        bad = [n for n in names if lr_mult(n) != g['lr_mult']]
        if bad:
            fail(f'group lr_mult {g["lr_mult"]} holds {bad[:3]}')
    if len(seen['lrs']) != steps:
        fail(f'{len(seen["lrs"])} optimizer steps recorded, not {steps}')
    for i, lrs in enumerate(seen['lrs']):
        for g, lr in zip(groups, lrs):
            want = lr_fn(i) * g['lr_mult']
            if abs(lr - want) > 1e-12 * abs(want):
                fail(f'step {i + 1}: group LR {lr}, schedule x lr_mult '
                     f'{want}')
    return sorted({g['lr_mult'] for g in groups})


def phase_swin_recipe(tool, device='cuda', narrow=None):
    """Box2Mask Swin-L LSJ at full width and depth, batch 1,
    SWIN_RECIPE_STEPS AdamW steps through the train entry point with the
    LayerDecay constructor, a cosine schedule and the EMA, memory and
    profiler hooks: each group's LR at each step, the EMA against the
    parameters after steps 1 and 4, the trace of step 3 naming K5 and K6,
    one memory line a step, K5 / K6 launches. ``device`` and ``narrow``
    rehearse it on the CPU (no kernel, no card: no memory line)."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    import torch
    from boxinstseg_tpu_torch.apis import train
    from boxinstseg_tpu_torch.engine import hooks
    register_dataset()
    work_dir = tempfile.mkdtemp(prefix='chip_smoke_recipe_')
    seed, steps = 0, SWIN_RECIPE_STEPS
    card = device == 'cuda'
    opts = [*swin_recipe_opts(os.path.join(work_dir, 'profile')),
            *(narrow or ())]
    try:
        cfg = tool.load_config(SWIN_CONFIG, opts, work_dir, seed)
        lr_fn, base_lr, _, _ = train.train_schedule(cfg, 1, 16)
        print(f'optimizer {cfg.optimizer.type}, constructor '
              f'{cfg.optimizer.constructor}, paramwise_cfg '
              f'{dict(cfg.optimizer.paramwise_cfg)}; lr_config '
              f'{dict(cfg.lr_config)}; custom_hooks '
              f'{[dict(h) for h in cfg.custom_hooks]}')
        fwd, bwd = ('kernel.window_attention_forward',
                    'kernel.window_attention_backward')
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        COUNTS[fwd] = COUNTS[bwd] = 0
        with recorded_optimizer(train) as seen, \
                recorded_ema(hooks, device) as ema, \
                logged_lines('GiB in use') as memory, live_gt_counts() as gts:
            result = tool.main([SWIN_CONFIG, '--work-dir', work_dir,
                                '--seed', str(seed), '--device', device,
                                '--no-validate', '--cfg-options', *opts])
        launches = (COUNTS[fwd], COUNTS[bwd])
        check_history(result, steps, required=('loss_cls', 'loss_project'))
        per_step = sum(cfg.model.backbone.depths)
        if card and launches != (per_step * steps,) * 2:
            fail(f'K5 / K6 launched {launches} times in {steps} steps')
        mults = check_group_lrs(seen, cfg, lr_fn, steps)
        if len(mults) < 13:
            fail(f'{len(mults)} distinct lr_mult values: {mults}')
        print(f'{len(seen["optimizer"].param_groups)} param groups, lr_mult '
              f'{min(mults):.6g} to {max(mults):.6g} ({len(mults)} values); '
              f'each group\'s LR = schedule x lr_mult at every step; the '
              f'schedule: ' + ', '.join(f'{lr_fn(i):.6g}'
                                        for i in range(steps)))
        if ema['equal'] != [True] + [False] * (steps - 1):
            fail(f'the EMA equals the parameters after steps '
                 f'{[i + 1 for i, e in enumerate(ema["equal"]) if e]}, '
                 f'expected after step 1 only')
        print(f'EMA of {ema["count"]} parameters: equal to them after step '
              f'1, apart after steps 2-{steps}; the update ms (device syncs '
              f'around it) ' + ', '.join(f'{t:.3f}' for t in ema['ms'][1:]))
        with open(os.path.join(work_dir, 'profile', 'trace.json')) as f:
            text = f.read()
        names = ('swin_attention_forward_kernel',
                 'swin_attention_backward_kernel') if card \
            else ('aten::linear',)
        missing = [n for n in names if n not in text]
        if missing:
            fail(f'the trace of step 3 lacks {missing}')
        print(f'trace of step 3: {len(text) / 2**20:.1f} MiB; ' + ', '.join(
            f'{n} {text.count(n)} times' for n in names))
        if len(memory) != (steps if card else 0):
            fail(f'{len(memory)} memory lines in {steps} steps: {memory}')
        print(f'memory log: {memory}')
        print(f'launches K5 / K6 {launches} ({per_step} a step each)')
        if card:
            print_steps(result, torch.cuda.max_memory_allocated(), gts)
            del result, seen
            release_cache()
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

def crf_inputs(shape, gen, rng, full=False):
    """K7's inputs as DiscoBox makes them on the card: the CRF kernel of a
    blocky image (flat 8x8 blocks at stride 4, the synthetic data's 32x32,
    plus noise), its threshold, box targets and random scores inside them;
    with more than one plane an image, the last plane of image 0 has no
    target; with ``full``, plane 0 of every image is a target everywhere
    (it touches every border)."""
    import torch
    from boxinstseg_tpu_torch.models.dense_heads.discobox_head import \
        MeanFieldCRF
    from boxinstseg_tpu_torch.ops import crf
    b, k, h, w = shape
    blocks = torch.rand((b, 3, h // 8 + 1, w // 8 + 1), generator=gen,
                        device='cuda')
    img = blocks.repeat_interleave(8, 2).repeat_interleave(8, 3)[
        :, :, :h, :w] + 0.05 * torch.rand((b, 3, h, w), generator=gen,
                                          device='cuda')
    kern = MeanFieldCRF().build_kernel(img).contiguous()
    targets = torch.zeros(shape, device='cuda')
    for i in range(b):
        for j in range(k):
            y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
            targets[i, j, y:y + rng.randint(2, h // 2 + 2),
                    x:x + rng.randint(2, w // 2 + 2)] = 1
    if full:
        targets[:, 0] = 1
    if k > 1:
        targets[0, -1] = 0
    scores = torch.rand(shape, generator=gen, device='cuda')
    bin0 = (scores * targets > 0.5).float()
    return kern, (0.5 * crf.kernel_sum(kern)).contiguous(), bin0, targets


def phase_crf_kernel():
    """K7 against the plain version, bit for bit, at the main path's shape
    and the others; its time beside the plain version's and its bound, and
    against the one-block-a-plane kernel in turns."""
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.ops import crf
    gen = torch.Generator(device='cuda').manual_seed(4)
    rng = np.random.RandomState(4)
    report = {}
    for shape, rounds, full in ((CRF_MAIN, CRF_ITERS, False),) + CRF_SHAPES:
        kern, thresh, bin0, targets = crf_inputs(shape, gen, rng, full)
        got = crf.crf_mean_field_cuda(kern, thresh, bin0, targets, rounds)
        want = crf.crf_mean_field_plain(kern, thresh, bin0, targets, rounds)
        torch.cuda.synchronize()
        differ = int((got != want).sum().item())
        moved = int((want != bin0).sum().item())
        inside = int((targets > 0).sum().item())
        plan = crf.launch_plan(bin0)
        print(f'K7 {shape}, {rounds} rounds ({plan["bands"]} bands of '
              f'{plan["band_rows"]} rows): {differ} of {got.numel()} pixels '
              f'differ from plain; the rounds moved {moved} labels; {inside} '
              f'target pixels')
        if differ or not torch.equal(got, want):
            fail(f'K7 differs from its plain version at {shape}')
        if rounds and not moved:
            fail(f'K7 at {shape}: the rounds moved no label; check is '
                 f'vacuous')
        if shape == CRF_MAIN:
            # each input read once and the output written once; the
            # stencil's multiply-add per offset and round at target pixels
            # (elsewhere the state is 0 whatever the sum is)
            report['crf_mean_field'] = dict(
                max_abs_err=(got - want).abs().max().item(),
                ms=cuda_ms(lambda: crf.crf_mean_field_cuda(
                    kern, thresh, bin0, targets, CRF_ITERS)),
                plain_ms=cuda_ms(lambda: crf.crf_mean_field_plain(
                    kern, thresh, bin0, targets, CRF_ITERS), iters=5),
                library_ms=None,
                **bound(nbytes(kern, thresh, bin0, targets, bin0),
                        CRF_ITERS * 9 * 2 * inside))
            main = kern, thresh, bin0, targets
    r = report['crf_mean_field']
    print(f'crf_mean_field at {CRF_MAIN}, {CRF_ITERS} rounds: kernel '
          f'{r["ms"]:.4f} ms, plain {r["plain_ms"]:.4f} ms, bound '
          f'{r["bound_ms"]:.4f} ms ({r["bound_by"]})')
    big = torch.zeros(CRF_TOO_BIG, device='cuda')
    try:
        crf.crf_mean_field_cuda(
            torch.zeros((1, 9) + CRF_TOO_BIG[2:], device='cuda'),
            torch.zeros((1,) + CRF_TOO_BIG[2:], device='cuda'), big, big,
            CRF_ITERS)
    except ValueError as e:
        print(f'K7 {CRF_TOO_BIG} raises: {e}')
    else:
        fail(f'K7 at {CRF_TOO_BIG} did not raise')
    del big
    old = load_baseline('crf')
    out = torch.empty_like(main[2])

    def run_old():
        err = old.crf_mean_field(*[t.data_ptr() for t in main],
                                 out.data_ptr(), *CRF_MAIN, CRF_ITERS,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f'the one-block-a-plane K7: CUDA error {err}')
    run_old()
    if not torch.equal(out, crf.crf_mean_field_cuda(*main, CRF_ITERS)):
        fail('K7: the one-block-a-plane kernel and the redesign differ')
    in_turns(f'crf_mean_field at {CRF_MAIN}', run_old,
             lambda: crf.crf_mean_field_cuda(*main, CRF_ITERS))
    return report


def record_ema_gaps(step_cls, gaps):
    """Wrap ``step_cls.__call__`` so that each step appends the largest
    absolute difference between a teacher and a student parameter after
    it to ``gaps`` (a device scalar: no host wait in the step); returns the
    original to put back."""
    import torch
    call = step_cls.__call__

    def recorded(self, batch, i):
        logs = call(self, batch, i)
        with torch.no_grad():
            gaps.append(torch.stack(torch._foreach_norm(torch._foreach_sub(
                list(self.teacher.parameters()),
                list(self.model.parameters())), float('inf'))).amax())
        return logs
    step_cls.__call__ = recorded
    return call


def phase_discobox(tool, config=DISCO_CONFIG, extra=(), parts=DISCO_PARTS):
    """5 SGD steps of DiscoBox (R-50 3x, or ``config`` with the options
    ``extra``) through the train entry point, the teacher switched on after
    step DISCO_START_ITER; fails unless a tensor of each of ``parts``
    changed. Returns the CRF kernel's launches, the config and the trained
    model (on the CPU)."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    import torch
    from boxinstseg_tpu_torch.engine.train_state import TSTrainStep
    register_dataset()
    work_dir = tempfile.mkdtemp(prefix='chip_smoke_disco_')
    seed = 0
    opts = [f'ts_cfg.start_iter={DISCO_START_ITER}',
            *TRAIN_OPTS, *extra,
            'data.samples_per_gpu=2', 'data.train.type=SyntheticBoxDataset']
    try:
        cfg = tool.load_config(config, opts, work_dir, seed)
        from boxinstseg_tpu_torch.apis.train import apply_precision_policy
        if not apply_precision_policy(cfg):
            fail(f'{os.path.basename(config)} no longer asks for mixed '
                 f'precision')
        print(f'precision: bf16 autocast, fp32 parameters and losses (the '
              f'config\'s fp16 = {dict(cfg.fp16)})')
        head, mf = cfg.model.bbox_head, cfg.model.mask_feat_head
        ob = head.loss_corr.obj_bank
        towers = (f'{head.type_dcn} ' if head.get('use_dcn_in_tower')
                  else '')
        print(f'model: {describe_backbone(cfg.model.backbone)}, FPN '
              f'{cfg.model.neck.out_channels} P2-P6, {head.stacked_convs}x '
              f'{head.seg_feat_channels}-channel {towers}GN towers, grids '
              f'{list(head.num_grids)}, {head.ins_out_channels}-channel '
              f'kernels, mask feature {mf.out_channels}->{mf.num_classes}, '
              f'{head.num_classes} classes, max_pos {head.max_pos}, CRF '
              f'{head.loss_ts.max_iter} rounds, object bank '
              f'{head.num_classes}x{ob.len_object_queues}, ts_cfg '
              f'{dict(cfg.ts_cfg)}')
        torch.cuda.reset_peak_memory_stats()
        gaps = []
        call = record_ema_gaps(TSTrainStep, gaps)
        COUNTS['kernel.crf_mean_field'] = 0
        try:
            with live_gt_counts() as gts:
                result = train_tool(tool, config, work_dir, seed, opts)
        finally:
            TSTrainStep.__call__ = call
        torch.cuda.synchronize()
        launches = {'crf_mean_field': COUNTS['kernel.crf_mean_field']}
        peak = torch.cuda.max_memory_allocated()
        gaps = [g.item() for g in gaps]
        check_history(result, STEPS, required=('loss_ins', 'loss_cate'))
        if launches['crf_mean_field'] != STEPS:
            fail(f'K7 launched {launches["crf_mean_field"]} times in {STEPS}'
                 f' steps')
        teacher = [h['teacher_forward'] for h in result.history]
        if teacher != [float(i > DISCO_START_ITER) for i in range(STEPS)]:
            fail(f'the teacher ran in steps {teacher}')
        if [g == 0 for g in gaps] != [i < DISCO_START_ITER
                                      for i in range(STEPS)]:
            fail(f'EMA replica gap to the student by step: {gaps}')
        ckpt = torch.load(result.checkpoint, map_location='cpu')
        if not {'teacher_state_dict', 'object_bank'} <= set(ckpt):
            fail(f'checkpoint keys {sorted(ckpt)}')
        changed, model = changed_tensors(tool, cfg, seed, result)
        for part in parts:
            if not any(k.startswith(part) for k in changed):
                fail(f'no {part}* tensor changed in training')
        print(f'{len(changed)} tensors changed; launches {launches} ('
              f'{launches["crf_mean_field"] / STEPS:g} a step); teacher '
              f'forward by step {teacher}; EMA gap by step '
              f'{[f"{g:.3g}" for g in gaps]}; avg_loss_ins by step '
              f'{[round(h["avg_loss_ins"], 5) for h in result.history]}')
        print_steps(result, peak, gts, teacher_after=DISCO_START_ITER)
        return launches, cfg, model
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def tiny_discobox_cfg():
    """ResNet-18, a 32-channel FPN, the correspondence loss with loose
    retrieval gates, a 16-slot bank and 8 queries."""
    return dict(
        type='DiscoBoxSOLOv2',
        backbone=dict(type='ResNet', depth=18, frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=0, num_outs=5),
        bbox_head=dict(
            type='DiscoBoxSOLOv2Head', num_classes=4, in_channels=32,
            seg_feat_channels=16, stacked_convs=1,
            scale_ranges=((1, 48), (24, 96), (48, 192), (96, 384),
                          (192, 2048)),
            num_grids=[12, 10, 8, 6, 4], ins_out_channels=16,
            loss_ts=dict(max_iter=3), max_pos=8, max_corr_queries=8,
            loss_corr=dict(corr_num_iter=2, dist_kernel=5, obj_bank=dict(
                len_object_queues=16, fg_iou_thresh=0.5, bg_iou_thresh=0.5,
                appear_thresh=0.5, ratio_range=[0.5, 2.0], mask_height=14,
                mask_width=14, min_size=2))),
        mask_feat_head=dict(type='DiscoBoxMaskFeatHead', in_channels=32,
                            out_channels=16, num_classes=16,
                            norm_cfg=dict(type='GN', num_groups=8)))


def phase_discobox_reference():
    """The small DiscoBox, two teacher-student steps with the gates forced
    open (avg_loss_ins set to 0.1 before each), start_iter 0, every GT of
    one class so that the first step's appends are retrieved in the second:
    logs, the bank and the parameters on the card (K7) against the CPU
    (plain version). The kernel branch's last conv is scaled by 30 so that
    the mask scores sit away from the CRF's 0.5 threshold; the LR is 1e-4
    (see tests/test_torch_discobox.py). In fp32: the step's bf16 switch is
    off."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    print('fp32: the precision policy is off (no fp16 / bf16 key), so the '
          'card and the CPU compute the same function')
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
    from boxinstseg_tpu_torch.engine.train_state import TSTrainStep
    from boxinstseg_tpu_torch.ops.correspondence import create_object_bank
    from boxinstseg_tpu_torch.registry import build_detector
    rng = np.random.RandomState(0)
    b, h, w, g = 2, 128, 128, 4
    boxes = np.zeros((b, g, 4), np.float32)
    masks = np.zeros((b, g, h // 4, w // 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(rng.randint(2, g + 1)):
            x1, y1 = rng.randint(0, w - 48), rng.randint(0, h - 48)
            x2, y2 = x1 + rng.randint(24, 48), y1 + rng.randint(24, 48)
            boxes[i, j] = (x1, y1, x2, y2)
            masks[i, j, y1 // 4:y2 // 4 + 1, x1 // 4:x2 // 4 + 1] = 1
            valid[i, j] = True
    batch = dict(image=rng.rand(b, 3, h, w).astype(np.float32) * 4 - 2,
                 gt_bboxes=boxes, gt_masks=masks, gt_valid=valid,
                 gt_labels=np.ones((b, g), np.int64))
    cfg = tiny_discobox_cfg()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init = build_detector(cfg).state_dict()
    init['bbox_head.solo_kernel.weight'] = \
        init['bbox_head.solo_kernel.weight'] * 30
    runs = {}
    for dev in ('cpu', 'cuda'):
        model = build_detector(cfg)
        model.load_state_dict(init)
        model.to(dev)
        opt = build_optimizer(dict(type='SGD', lr=1e-4, momentum=0.9,
                                   weight_decay=1e-4),
                              model.named_parameters())
        step = TSTrainStep(
            model, opt, lambda i: 1e-4, momentum=0.9, start_iter=0,
            bank=create_object_bank(4, 16, (7, 7), (14, 14), 32,
                                    device=dev))
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        before = COUNTS['kernel.crf_mean_field']
        logs = []
        for i in range(2):
            step.avg_loss_ins = torch.tensor(0.1, device=dev)
            logs.append({k: v.item() for k, v in step(tb, i).items()})
        if (COUNTS['kernel.crf_mean_field'] - before) != (
                2 if dev == 'cuda' else 0):
            fail(f'the small DiscoBox on {dev} launched K7 '
                 f'{COUNTS["kernel.crf_mean_field"] - before} times')
        runs[dev] = (logs, {k: v.cpu() for k, v in
                            step.bank._asdict().items()},
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()})
    (cpu_logs, cpu_bank, cpu_sd), (gpu_logs, gpu_bank, gpu_sd) = \
        runs['cpu'], runs['cuda']
    for i, (want, got) in enumerate(zip(cpu_logs, gpu_logs)):
        for k in want:
            if not math.isfinite(got[k]) or abs(got[k] - want[k]) > \
                    REF_ATOL + REF_RTOL * abs(want[k]):
                fail(f'step {i} {k} on the card {got[k]} vs CPU {want[k]}')
        print(f'step {i}: ' + ', '.join(f'{k} cuda {got[k]:.7g} cpu '
                                        f'{want[k]:.7g}' for k in want
                                        if k.startswith('loss')))
    if not cpu_logs[1]['loss_corr'] > 0:
        fail(f'no correspondence loss in the second step: {cpu_logs[1]}')
    for k in ('ptr', 'count'):
        if not torch.equal(gpu_bank[k], cpu_bank[k]):
            fail(f'bank {k} card {gpu_bank[k].tolist()} vs CPU '
                 f'{cpu_bank[k].tolist()}')
    for k in ('feat', 'mask', 'box'):
        err = (gpu_bank[k] - cpu_bank[k]).abs().max().item()
        if not err <= 1e-5:
            fail(f'bank {k} card vs CPU max abs err {err}')
    worst = 0.0
    for k, want in cpu_sd.items():
        if not want.is_floating_point():
            continue
        got = gpu_sd[k]
        if not torch.allclose(got, want, rtol=REF_RTOL, atol=REF_ATOL):
            fail(f'{k} after two steps: card vs CPU max abs err '
                 f'{(got - want).abs().max().item()}')
        worst = max(worst, (got - want).abs().max().item())
    print(f'bank count {cpu_bank["count"].tolist()}, ptr '
          f'{cpu_bank["ptr"].tolist()} on both; {len(cpu_sd)} tensors after '
          f'two steps within rtol {REF_RTOL} / atol {REF_ATOL} (max abs err '
          f'{worst:.3g})')


def eval_inputs(cfg, dataset, idx=0):
    """One test image of ``dataset`` batched as ``run_evaluation`` does:
    the device inputs and the image's (img_shape, ori_shape)."""
    import torch
    from boxinstseg_tpu_torch.apis.test import eval_batcher
    from boxinstseg_tpu_torch.apis.train import batch_to_device
    batch = eval_batcher(cfg)([dataset.prepare(idx)])
    inputs = batch_to_device({k: batch[k] for k in (
        'image', 'img_shape', 'scale_factor')}, torch.device('cuda'))
    return inputs, batch['img_shape'][0], batch['ori_shape'][0]


def time_predict(model, test_cfg, inputs, img_shape, ori_shape, bf16=False):
    """``predict`` on one image, then ``format_detection`` and the RLE
    codec on its output: 1 warm-up and 3 timed calls. Returns the last
    output, its formatted detections and the two lists of ms (predict:
    host clock around the call, ending in a device sync; format + RLE:
    host clock)."""
    import torch
    from boxinstseg_tpu_torch.apis.test import format_detection
    from boxinstseg_tpu_torch.data.coco_api import rle_encode
    from boxinstseg_tpu_torch.engine.train_state import autocast_bf16
    times = {'predict': [], 'format': [], 'RLE': []}
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode(), autocast_bf16('cuda', bf16):
            out = model.predict(inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        det = format_detection(out, 0, img_shape, ori_shape, test_cfg)
        t2 = time.perf_counter()
        rles = [rle_encode(m) for m in det['masks']]
        t3 = time.perf_counter()
        if i:
            for k, t in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
                times[k].append(1e3 * t)
    if len(rles) != len(det['bboxes']) or not len(rles):
        fail(f'{len(rles)} masks for {len(det["bboxes"])} detections')
    return out, det, times


def check_format_on_cpu(what, out, img_shape, ori_shape, test_cfg, det):
    """``format_detection`` of image 0 of the same ``out`` on the CPU
    against ``det``, the card's: the same labels and count; binary masks
    equal except at pixels whose CPU field lies within 1e-4 of the
    threshold (0.5, ``mask_thr`` or logit 0); boxes and scores within rtol
    1e-5 / atol 1e-4, the SOLO family's mask-extent boxes where no pixel
    flipped."""
    import numpy as np
    from boxinstseg_tpu_torch.apis.test import format_detection, \
        upsample_masks
    host = {k: v.cpu() for k, v in out.items()}
    want = format_detection(host, 0, img_shape, ori_shape, test_cfg)
    valid = host['valid'][0]
    if 'masks_logit' in host:
        src, thr, aligned = host['masks_logit'][0][valid], 0.0, False
    elif 'bboxes' in host:
        src, thr, aligned = host['masks'][0][valid], 0.5, True
    else:
        src, thr = host['masks'][0][valid], float(test_cfg['mask_thr'])
        aligned = False
    field = upsample_masks(src, img_shape, ori_shape, aligned=aligned)
    if 'masks_logit' in host:
        field = field[(field > 0).flatten(1).any(1)]
    if not (len(det['masks']) == len(want['masks']) == len(field) > 0
            and np.array_equal(det['labels'], want['labels'])):
        fail(f'{what}: format_detection kept {len(det["masks"])} masks on '
             f'the card and {len(want["masks"])} on the CPU, or other labels')
    got, ref = np.stack(det['masks']), np.stack(want['masks'])
    flips = got != ref
    far = flips & (np.abs(field.numpy() - thr) >= 1e-4)
    if far.any():
        fail(f'{what}: {int(far.sum())} mask pixels differ between the '
             f'card and the CPU away from the threshold {thr}')
    rows = np.ones(len(got), bool) if 'bboxes' in host \
        else ~flips.any(axis=(1, 2))
    err = float(np.abs(det['bboxes'][rows] - want['bboxes'][rows]).max(
        initial=0.0))
    if not np.allclose(det['bboxes'][rows], want['bboxes'][rows],
                       rtol=1e-5, atol=1e-4):
        fail(f'{what}: boxes or scores on the card vs the CPU: max abs '
             f'err {err}')
    print(f'{what}: format_detection on the card vs the CPU: {len(got)} '
          f'masks, {int(flips.sum())} of {flips.size} pixels differ (all '
          f'within 1e-4 of {thr}); boxes and scores max abs err {err}')


def print_predict_times(what, det, times, ori_shape):
    host = [f + r for f, r in zip(times['format'], times['RLE'])]
    print(f'{what}: {len(det["bboxes"])} detections at '
          f'{tuple(int(v) for v in ori_shape)}; ' + '; '.join(
              f'{k} ms {[round(t, 3) for t in v]}, median '
              f'{statistics.median(v):.3f}' for k, v in times.items())
          + f'; format + RLE median {statistics.median(host):.3f} ms')


def check_outputs(out, want):
    """Shapes as ``want`` says, every value finite."""
    import torch
    for key, shape in want.items():
        if tuple(out[key].shape) != shape:
            fail(f'predict {key} {tuple(out[key].shape)}, expected {shape}')
        if out[key].is_floating_point() and not torch.isfinite(
                out[key]).all():
            fail(f'predict gave non-finite {key}')
    if not out['valid'].any():
        fail('predict kept no detection')


def phase_boxinst_predict(tool, checkpoint):
    """The slice's checkpoint through ``init_detector``, then ``predict``
    on one 800x1333 image in its 800x1344 canvas, with ``score_thr`` 0 so
    that it keeps ``max_per_img`` detections, as a trained model's
    crowded images do: shapes, finite values, times."""
    from boxinstseg_tpu_torch.apis.inference import init_detector
    cfg = tool.load_config(CONFIG, EVAL_OPTS)
    model, cfg = init_detector(cfg, checkpoint, device='cuda')
    d = cfg.model.test_cfg.max_per_img
    inputs, img_shape, ori_shape = eval_inputs(
        cfg, SyntheticEvalDataset(cfg.data.test.pipeline, length=1))
    out, det, times = time_predict(
        model, dict(cfg.model.test_cfg), inputs, img_shape, ori_shape)
    check_outputs(out, {'bboxes': (1, d, 4), 'scores': (1, d),
                        'labels': (1, d), 'valid': (1, d),
                        'masks': (1, d, 200, 336)})
    print(f'test_cfg {dict(cfg.model.test_cfg)}')
    print_predict_times('BoxInst R-50-FPN predict, batch 1', det, times,
                        ori_shape)
    check_format_on_cpu('BoxInst', out, img_shape, ori_shape,
                        dict(cfg.model.test_cfg), det)


def phase_predict_reference():
    """A small CondInst's ``predict`` on the card against the CPU, same
    weights (random BN statistics; the box regression scaled so that the
    boxes are a stride or two wide), in fp32: validity and labels exactly;
    boxes and scores within rtol 1e-4 / atol 1e-5 and masks within atol
    1e-5 on valid slots, the tolerances of tests/test_torch_predict.py.
    Then the small DiscoBox under the bf16 policy
    (``discobox_bf16_reference``)."""
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.registry import build_detector
    cfg = tiny_cfg()
    cfg['test_cfg'] = dict(nms_pre=200, score_thr=0.003,
                           nms=dict(type='nms', iou_threshold=0.5),
                           max_per_img=20, pre_nms_limit=300)
    gen = torch.Generator().manual_seed(0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_detector(cfg).eval()
    with torch.no_grad():
        model.bbox_head.conv_reg.weight.mul_(30)
        model.bbox_head.conv_reg.bias.add_(1.5)
        for name, buf in model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith('running_var'):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    batch = dict(image=torch.randn((2, 3, 128, 160), generator=gen) * 2,
                 img_shape=torch.tensor([[120, 150], [100, 160]]),
                 scale_factor=torch.tensor([[2.0] * 4, [1.5] * 4]))
    outs = {}
    for dev in ('cpu', 'cuda'):
        model.to(dev)
        outs[dev] = {k: v.cpu().numpy() for k, v in model.predict(
            {k: v.to(dev) for k, v in batch.items()}).items()}
    got, want = outs['cuda'], outs['cpu']
    m = want['valid']
    if not (np.array_equal(got['valid'], m)
            and np.array_equal(got['labels'][m], want['labels'][m])):
        fail('predict on the card keeps other detections than on the CPU')
    if not m.sum(1).min() >= 10:
        fail(f'predict kept {m.sum(1)} detections, fewer than 10 an image')
    errs = {}
    for k, (atol, rtol) in {'bboxes': (1e-5, 1e-4), 'scores': (1e-5, 1e-4),
                            'masks': (1e-5, 0)}.items():
        errs[k] = float(np.abs(got[k][m] - want[k][m]).max())
        if not np.allclose(got[k][m], want[k][m], rtol=rtol, atol=atol):
            fail(f'predict {k} on the card vs CPU: max abs err {errs[k]}')
    print(f'CondInst: {m.sum(1).tolist()} detections an image on both; '
          f'max abs err card vs CPU {errs}')
    discobox_bf16_reference()


def discobox_bf16_reference():
    """The small DiscoBox's ``predict`` on the card under the bf16 policy
    against ``get_seg`` on the CPU in fp32 from the same head outputs (the
    ones the card's ``predict`` handed its ``get_seg``): the selection, the
    mask decode and the matrix NMS, whose mask products count pixels, must
    run in fp32 there. The tolerances of tests/test_torch_predict.py:
    validity and labels exactly, scores within rtol 1e-4 / atol 1e-5 and
    masks within atol 1e-5 on valid slots; the compared masks lie off
    ``mask_thr`` by more than that, and no two valid scores of an image lie
    closer than twice the scores' largest difference. The kernel branch's
    last conv is scaled by 30, as in ``phase_discobox_reference``, so that
    the mask scores sit away from ``mask_thr``."""
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.engine.train_state import autocast_bf16
    from boxinstseg_tpu_torch.registry import build_detector
    cfg = tiny_discobox_cfg()
    cfg['test_cfg'] = dict(nms_pre=50, score_thr=0.005, mask_thr=0.4,
                           filter_thr=0.002, kernel='gaussian', sigma=2.0,
                           max_per_img=20)
    gen = torch.Generator().manual_seed(0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_detector(cfg).eval()
    with torch.no_grad():
        model.bbox_head.solo_kernel.weight.mul_(30)
    image = torch.randn((2, 3, 128, 128), generator=gen)
    model.cuda()
    seen = {}
    get_seg = model.bbox_head.get_seg

    def spy(outs, mask_feat, test_cfg):
        seen.update(outs=outs, mask_feat=mask_feat,
                    autocast=torch.is_autocast_enabled('cuda'))
        return get_seg(outs, mask_feat, test_cfg)

    model.bbox_head.get_seg = spy
    with autocast_bf16('cuda', True):
        got = model.predict({'image': image.cuda()})
    del model.bbox_head.get_seg
    if seen['autocast'] or seen['mask_feat'].dtype != torch.float32:
        fail(f'get_seg ran with autocast {seen["autocast"]} on '
             f'{seen["mask_feat"].dtype} mask features')
    model.cpu()
    want = get_seg({k: v.cpu() for k, v in seen['outs'].items()},
                   seen['mask_feat'].cpu(), model.test_cfg)
    got, want = ({k: v.cpu().numpy() for k, v in d.items()}
                 for d in (got, want))
    m = want['valid']
    if not (np.array_equal(got['valid'], m)
            and np.array_equal(got['labels'][m], want['labels'][m])):
        fail('DiscoBox predict in bf16 on the card keeps other detections '
             'than get_seg in fp32 on the CPU')
    if not m.sum(1).min() >= 10:
        fail(f'DiscoBox predict kept {m.sum(1)} detections, fewer than 10 '
             f'an image')
    if (np.abs(want['masks'][m] - 0.4) < 1e-5).any():
        fail('a compared DiscoBox mask score lies within 1e-5 of mask_thr')
    gap = min(np.diff(np.sort(s[v])).min()
              for s, v in zip(want['scores'], m))
    if not gap > 2 * np.abs(got['scores'][m] - want['scores'][m]).max():
        fail(f'DiscoBox scores closer than twice their error: gap {gap}')
    errs = {}
    for k, (atol, rtol) in {'scores': (1e-5, 1e-4),
                            'masks': (1e-5, 0)}.items():
        errs[k] = float(np.abs(got[k][m] - want[k][m]).max())
        if not np.allclose(got[k][m], want[k][m], rtol=rtol, atol=atol):
            fail(f'DiscoBox predict {k} in bf16 on the card vs get_seg in '
                 f'fp32 on the CPU: max abs err {errs[k]}')
    print(f'DiscoBox under bf16 autocast: get_seg ran with autocast off; '
          f'{m.sum(1).tolist()} detections an image; max abs err card vs '
          f'CPU fp32 get_seg {errs}')


def phase_eval(checkpoint):
    """``tools/test_torch.py``'s ``main`` at full width on EVAL_IMAGES
    synthetic 800x1333 images with RLE ground truth (the slice's
    checkpoint, score_thr 0): the native RLE codec built, cv2 never
    imported, metrics finite; images/s over ``run_evaluation``. Then the
    ground truth itself as detections must read bbox and segm mAP 1.000."""
    from boxinstseg_tpu_torch import native
    from boxinstseg_tpu_torch.apis import test as eval_api
    register_dataset()
    if native.rle_lib() is None:
        fail(f'the native RLE codec did not build: {native.BUILD_ERROR}')
    with timed_calls(eval_api, ('run_evaluation', 'format_detection',
                                'rle_encode')) as seconds, \
            timed_calls(SyntheticEvalDataset, ('evaluate',)) as cocoeval:
        metrics = load_tool('test_torch').main([
            CONFIG, checkpoint, '--eval', 'bbox', 'segm',
            '--cfg-options', *EVAL_OPTS,
            f'data.test.length={EVAL_IMAGES}'])
    if not {'bbox_mAP', 'segm_mAP'} <= set(metrics) or not all(
            math.isfinite(v) for v in metrics.values()):
        fail(f'metrics {metrics}')
    if 'cv2' in sys.modules:
        fail('the evaluation imported cv2')
    total = seconds['run_evaluation']
    parts = dict(format=seconds['format_detection'],
                 RLE=seconds['rle_encode'], COCOeval=cocoeval['evaluate'])
    print(f'{EVAL_IMAGES} images in {total:.3f} s: '
          f'{EVAL_IMAGES / total:.3f} images/s (run_evaluation at batch 2);'
          f' of it ' + ', '.join(f'{k} {v:.3f} s' for k, v in parts.items())
          + f', loading and predict {total - sum(parts.values()):.3f} s; '
          f'bbox mAP {metrics["bbox_mAP"]}, segm mAP {metrics["segm_mAP"]}')
    data = SyntheticEvalDataset([], length=EVAL_IMAGES)
    oracle = data.evaluate(data.ground_truth_results())
    if not oracle['bbox_mAP'] == oracle['segm_mAP'] == 1.0:
        fail(f'the ground truth as detections reads {oracle}')
    print(f'the ground truth as detections ({len(data.coco.anns)} boxes): '
          f'bbox mAP {oracle["bbox_mAP"]:.3f}, segm mAP '
          f'{oracle["segm_mAP"]:.3f}')
    return metrics


def phase_discobox_predict(cfg, model, what='DiscoBox R-50'):
    """``predict`` of the trained DiscoBox on one 800x1333 image under its
    bf16 policy, with ``score_thr`` and ``filter_thr`` 0 so that it keeps
    ``max_per_img`` detections; the SOLO family's formatting."""
    from boxinstseg_tpu_torch.apis.train import apply_precision_policy
    bf16 = apply_precision_policy(cfg)
    if not bf16:
        fail(f'{what}: the config no longer asks for mixed precision')
    test_cfg = dict(cfg.model.test_cfg, score_thr=0.0, filter_thr=0.0)
    model.test_cfg = test_cfg
    model = model.cuda().eval()
    d = test_cfg['max_per_img']
    inputs, img_shape, ori_shape = eval_inputs(
        cfg, SyntheticEvalDataset(cfg.data.test.pipeline, length=1))
    out, det, times = time_predict(
        model, test_cfg, inputs, img_shape, ori_shape, bf16=True)
    check_outputs(out, {'scores': (1, d), 'labels': (1, d), 'valid': (1, d),
                        'masks': (1, d, 200, 336)})
    print(f'bf16 autocast; test_cfg {test_cfg}')
    print_predict_times(f'{what} predict, batch 1', det, times, ori_shape)
    check_format_on_cpu(what, out, img_shape, ori_shape, test_cfg, det)


def image_decoders():
    """Which of PIL, imageio and cv2 import on this machine (each tried in
    a child process, so that this one never imports cv2, and with its
    version) and where NVIDIA's libnvjpeg is (``ctypes.util.find_library``,
    else the CUDA toolkit's lib64): the candidates for reading JPEGs
    without cv2."""
    import ctypes.util
    import glob
    found = {}
    for name in ('PIL', 'imageio', 'cv2'):
        out = subprocess.run([sys.executable, '-c', f'import {name}; '
                              f'print({name}.__version__)'],
                             capture_output=True, text=True)
        why = (out.stderr.strip().splitlines() or ['?'])[-1]
        found[name] = (f'{name} {out.stdout.strip()}' if out.returncode == 0
                       else f'{name} absent ({why})')
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    nvjpeg = ctypes.util.find_library('nvjpeg') or next(iter(sorted(
        glob.glob(os.path.join(cuda_home, 'lib64', 'libnvjpeg.so*')))), None)
    found['libnvjpeg'] = f'libnvjpeg {nvjpeg or "absent"}'
    return found


def tiny_boxlevelset_cfg():
    """ResNet-18, a 32-channel FPN, a 16-channel head, grids 12/10/8/6/4,
    max_pos 8, the tree at 24x24 with a binding depth cap (the tiny config
    of tests/test_boxlevelset_model.py)."""
    return dict(
        type='BoxLevelSet',
        backbone=dict(type='ResNet', depth=18, frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=0, num_outs=5),
        bbox_head=dict(
            type='BoxSOLOv2Head', num_classes=4, in_channels=32,
            seg_feat_channels=16, stacked_convs=1,
            scale_ranges=((1, 48), (24, 96), (48, 192), (96, 384),
                          (192, 2048)),
            num_grids=[12, 10, 8, 6, 4], max_pos=8, tf_size=(24, 24),
            tf_max_depth=64),
        test_cfg=dict(nms_pre=50, score_thr=0.005, mask_thr=0.5,
                      filter_thr=0.002, kernel='gaussian', sigma=2.0,
                      max_per_img=20))


def phase_boxlevelset(tool, work_dir, mst_kept=None):
    """5 AdamW steps of BoxLevelset R-50 3x through the train entry point,
    a checkpoint every 2 steps, the newest 2 kept: the files left must be
    those of steps 4 and 5; then a resume from step 4 must run one step and
    leave _iter 5. The MST kernel must launch once a step in both runs;
    ``mst_kept``, a dict, receives the last MST call's inputs. Returns the
    config, the last checkpoint's path and the MST launches a step."""
    import torch
    register_dataset()
    seed = 0
    opts = [*TRAIN_OPTS, 'data.samples_per_gpu=2',
            'data.train.type=SyntheticBoxDataset',
            'checkpoint_config.interval=2', 'checkpoint_config.by_epoch=False',
            'checkpoint_config.max_keep_ckpts=2']
    cfg = tool.load_config(BOXLS_CONFIG, opts, work_dir, seed)
    head = cfg.model.bbox_head
    print(f'model: {describe_backbone(cfg.model.backbone)}, FPN '
          f'{cfg.model.neck.out_channels} P2-P6, {head.stacked_convs}x '
          f'{head.seg_feat_channels}-channel GN towers, grids '
          f'{list(head.num_grids)}, {head.num_classes} classes, max_pos '
          f'{head.max_pos}, tree at {tuple(head.tf_size)} (depth cap '
          f'{head.tf_max_depth or "none"}), optimizer {cfg.optimizer.type}, '
          f'grad clip {cfg.optimizer_config.grad_clip.max_norm}, canvas '
          f'{cfg.canvases[0]}; precision fp32 (no fp16 / bf16 key), TF32 '
          f'off')
    torch.cuda.reset_peak_memory_stats()
    with live_gt_counts() as gts, \
            launches_of({'grid_mst': 'kernel.grid_mst'}) as launches, \
            capture_mst_inputs({} if mst_kept is None else mst_kept):
        result = train_tool(tool, BOXLS_CONFIG, work_dir, seed, opts)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check_history(result, STEPS, required=('loss_cate', 'loss_boxpro',
                                           'loss_levelset'))
    if launches['grid_mst'] != STEPS:
        fail(f'the MST kernel launched {launches["grid_mst"]} times in '
             f'{STEPS} steps, expected once a step')
    if len(result.history) != STEPS:
        fail(f'{len(result.history)} logged steps at log interval 1')
    from boxinstseg_tpu_torch.engine.hooks import checkpoint_steps
    kept = checkpoint_steps(work_dir)
    if kept != [4, 5]:
        fail(f'checkpoints left {kept}, expected steps 4 and 5')
    changed, _ = changed_tensors(tool, cfg, seed, result)
    for part in ('backbone.layer2.', 'neck.', 'bbox_head.kernel_convs.',
                 'bbox_head.feature_convs.', 'bbox_head.levelset_bottom.'):
        if not any(k.startswith(part) for k in changed):
            fail(f'no {part}* tensor changed in training')
    print(f'{len(changed)} tensors changed; checkpoints left at steps '
          f'{kept}')
    print_steps(result, peak, gts)
    print(f'MST kernel launches a step: {launches["grid_mst"] / STEPS:g} '
          f'(the image\'s and the level-set feature\'s trees of both images '
          f'in one launch)')
    with launches_of({'grid_mst': 'kernel.grid_mst'}) as resumed_launches:
        resumed = train_tool(tool, BOXLS_CONFIG, work_dir, seed, opts,
                             '--resume-from',
                             os.path.join(work_dir, 'iter_4.pth'))
    torch.cuda.synchronize()
    if resumed_launches['grid_mst'] != 1:
        fail(f'the resumed step launched the MST kernel '
             f'{resumed_launches["grid_mst"]} times')
    ckpt = torch.load(resumed.checkpoint, map_location='cpu',
                      weights_only=False)
    if (resumed.step, len(resumed.history), ckpt['_iter']) != (5, 1, 5):
        fail(f'the resume from step 4 ran to step {resumed.step} with '
             f'{len(resumed.history)} logged steps, _iter {ckpt["_iter"]}')
    h = resumed.history[0]
    print(f'resumed from iter_4.pth: one step, _iter {ckpt["_iter"]}, '
          f'{1e3 * (h["time"] - h["data_time"]):.3f} ms (compute + sync), '
          f'loss {h["loss"]:.5f}')
    return cfg, resumed.checkpoint, launches['grid_mst'] / STEPS


def phase_boxlevelset_predict(cfg, checkpoint):
    """The BoxLevelset checkpoint through ``init_detector``, then
    ``predict`` on one 800x1333 image in its 800x1344 canvas with
    ``score_thr`` and ``filter_thr`` 0, then ``format_detection`` (boxes
    from the mask extents) and the RLE codec: shapes, finite values,
    times, and the card's formatting against the CPU's. After 5 steps from
    random weights the mask scores lie within a hair of 0.5, so no pixel
    may pass ``mask_thr`` (0.55) and no candidate is kept: then the
    threshold is 0.5, which is every mask logit shifted up by
    logit(0.55)."""
    from boxinstseg_tpu_torch.apis.inference import init_detector
    model, cfg = init_detector(cfg, checkpoint, device='cuda')
    test_cfg = dict(cfg.model.test_cfg, score_thr=0.0, filter_thr=0.0)
    model.test_cfg = test_cfg
    d = test_cfg['max_per_img']
    inputs, img_shape, ori_shape = eval_inputs(
        cfg, SyntheticEvalDataset(cfg.data.test.pipeline, length=1))
    import torch
    with torch.inference_mode():
        kept = int(model.predict(inputs)['valid'].sum())
    if not kept:
        print(f'no candidate has a mask at mask_thr {test_cfg["mask_thr"]} '
              f'after {STEPS} steps: mask_thr 0.5 (the logits shifted by '
              f'logit({test_cfg["mask_thr"]}))')
        test_cfg['mask_thr'] = 0.5
    out, det, times = time_predict(model, test_cfg, inputs, img_shape,
                                   ori_shape)
    check_outputs(out, {'scores': (1, d), 'labels': (1, d), 'valid': (1, d),
                        'masks': (1, d, 200, 336)})
    print(f'fp32; test_cfg {test_cfg}')
    print_predict_times('BoxLevelset R-50 predict, batch 1', det, times,
                        ori_shape)
    check_format_on_cpu('BoxLevelset', out, img_shape, ori_shape, test_cfg,
                        det)


def phase_boxlevelset_reference():
    """A small BoxLevelSet on the card against the CPU, same weights, in
    fp32: the loss dict (rtol REF_RTOL), then ``predict`` (the kernel
    branch's last conv scaled by 1000, so that the mask scores spread over
    0.3-0.7; the tolerances of tests/test_torch_boxlevelset.py): validity
    and labels exactly, scores within rtol 1e-4 / atol 1e-5 and masks
    within atol 1e-5 on valid slots, at least 10 detections an image."""
    print('fp32: the precision policy is off (no fp16 / bf16 key), so the '
          'card and the CPU compute the same function')
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.registry import build_detector
    cfg = tiny_boxlevelset_cfg()
    rng = np.random.RandomState(0)
    b, h, w, g = 2, 128, 128, 4
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    masks = np.zeros((b, g, h // 4, w // 4), np.uint8)
    for i in range(b):
        for j in range(rng.randint(1, g + 1)):
            x1, y1 = rng.randint(0, w - 48), rng.randint(0, h - 48)
            x2, y2 = x1 + rng.randint(24, 48), y1 + rng.randint(24, 48)
            boxes[i, j] = (x1, y1, x2, y2)
            valid[i, j] = True
            masks[i, j, y1 // 4:y2 // 4 + 1, x1 // 4:x2 // 4 + 1] = 1
    batch = dict(image=rng.rand(b, 3, h, w).astype(np.float32) * 4 - 2,
                 gt_bboxes=boxes, gt_labels=rng.randint(0, 4, (b, g)),
                 gt_valid=valid, gt_masks=masks)
    compare_loss_dicts(cfg, batch, 0)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_detector(cfg).eval()
    with torch.no_grad():
        model.bbox_head.solo_kernel.weight.mul_(1000)
    image = torch.from_numpy(batch['image'])
    outs = {}
    for dev in ('cpu', 'cuda'):
        model.to(dev)
        outs[dev] = {k: v.cpu().numpy() for k, v in model.predict(
            {'image': image.to(dev)}).items()}
    got, want = outs['cuda'], outs['cpu']
    m = want['valid']
    if not (np.array_equal(got['valid'], m)
            and np.array_equal(got['labels'][m], want['labels'][m])):
        fail('BoxLevelset predict on the card keeps other detections than '
             'on the CPU')
    if not m.sum(1).min() >= 10:
        fail(f'BoxLevelset predict kept {m.sum(1)} detections, fewer than '
             f'10 an image')
    errs = {}
    for k, (atol, rtol) in {'scores': (1e-5, 1e-4),
                            'masks': (1e-5, 0)}.items():
        errs[k] = float(np.abs(got[k][m] - want[k][m]).max())
        if not np.allclose(got[k][m], want[k][m], rtol=rtol, atol=atol):
            fail(f'BoxLevelset predict {k} on the card vs CPU: max abs err '
                 f'{errs[k]}')
    print(f'BoxLevelset get_seg: {m.sum(1).tolist()} detections an image on '
          f'both; max abs err card vs CPU {errs}')


def write_coco_files(root, shapes, boxes=None, seed=0):
    """JPEGs (``cv2.imwrite``) of ``synthetic_image`` scenes at ``shapes``
    (``boxes[i]`` boxes on image i, by default 1-8) and a COCO json whose
    ground truth is each painted box as a polygon, with the 80 COCO
    classes. Returns (ann_file, img_prefix)."""
    import cv2
    import numpy as np
    from boxinstseg_tpu_torch.data.coco import COCO_CLASSES
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'images')
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(shapes):
        img, painted = synthetic_image(rng, h, w,
                                       None if boxes is None else boxes[i])
        name = f'{i:03d}.jpg'
        if not cv2.imwrite(os.path.join(img_dir, name), img):
            fail(f'cv2.imwrite could not write {name}')
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
        for x1, y1, x2, y2 in painted.tolist():
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, iscrowd=0,
                category_id=int(rng.randint(1, len(COCO_CLASSES) + 1)),
                area=(x2 - x1) * (y2 - y1), bbox=[x1, y1, x2 - x1, y2 - y1],
                segmentation=[[x1, y1, x2, y1, x2, y2, x1, y2]]))
    ann_file = os.path.join(root, 'ann.json')
    with open(ann_file, 'w') as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=c + 1, name=n) for c, n in enumerate(COCO_CLASSES)]), f)
    return ann_file, img_dir + '/'


def file_opts(files, split):
    ann_file, prefix = files
    return [f'data.{split}.ann_file={ann_file}',
            f'data.{split}.img_prefix={prefix}']


def loader_rate(cfg):
    """Images/s of the run's ``TrainLoader`` alone (file reading, the
    train pipeline, batching) over LOADER_BATCHES batches, its threads
    started before the clock."""
    from boxinstseg_tpu_torch.apis.train import build_train_loader
    from boxinstseg_tpu_torch.registry import build_dataset
    loader = build_train_loader(cfg, build_dataset(cfg.data['train']))
    batches = iter(loader)
    try:
        next(batches)
        t0 = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            next(batches)
        seconds = time.perf_counter() - t0
    finally:
        batches.close()
    return LOADER_BATCHES * loader.batch_size / seconds


@contextlib.contextmanager
def launches_of(counters):
    """The launches of ``counters`` (name: the hand kernel's key in the
    port's launch counts, ``utils.profiling.COUNTS``) within: set to 0 on
    entry; the dict is filled on exit."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    counts = {}
    for key in counters.values():
        COUNTS[key] = 0
    yield counts
    counts.update({name: COUNTS[key] for name, key in counters.items()})


def pairwise_launches():
    """The pairwise kernels' launches within (``launches_of``)."""
    return launches_of({'pairwise_forward': 'kernel.pairwise_forward',
                        'pairwise_backward': 'kernel.pairwise_backward'})


def swin_launches():
    """The window-attention kernels' launches within (``launches_of``)."""
    return launches_of(
        {'swin_attention_forward': 'kernel.window_attention_forward',
         'swin_attention_backward': 'kernel.window_attention_backward'})


def print_data_times(result):
    print('step ms (compute + sync) beside data_time ms: ' + ', '.join(
        f'{1e3 * (h["time"] - h["data_time"]):.3f} / '
        f'{1e3 * h["data_time"]:.3f}' for h in result.history))


def phase_files(tool, work_dir, files, device='cuda', narrow=None):
    """BoxInst R-50 1x and BoxLevelset R-50 3x at full width, each from
    its shipped train pipeline unchanged, through CocoDataset on JPEGs with
    polygon ground truth: the loader's images/s alone, 2 steps each with
    data_time beside the step time; then BoxInst's checkpoint through
    tools/test_torch.py (bbox segm, batch 1) against the polygons. Returns
    the BoxInst checkpoint.
    ``device`` and ``narrow`` (extra options by config) let the phase be
    rehearsed on the CPU with a narrow model."""
    seed = 0
    narrow = narrow or {}
    common = ['runner.type=IterBasedRunner', f'runner.max_iters={FILES_STEPS}',
              'log_config.interval=1', 'data.samples_per_gpu=2',
              *file_opts(files, 'train')]
    checkpoint = None
    for name, config, extra in (
            ('boxinst', CONFIG, ['model.mask_head.pairwise_warmup=1']),
            ('boxlevelset', BOXLS_CONFIG, [])):
        opts = [*common, *extra, *narrow.get(config, ())]
        wd = os.path.join(work_dir, f'files_{name}')
        cfg = tool.load_config(config, opts, wd, seed)
        rate = loader_rate(cfg)
        print(f'{name}: TrainLoader alone {rate:.3f} images/s over '
              f'{LOADER_BATCHES} batches of {cfg.data.samples_per_gpu} '
              f'({cfg.data.workers_per_gpu * 4} threads; JPEG read, '
              f'{", ".join(t["type"] for t in cfg.data.train.pipeline)})')
        with pairwise_launches() as launches:
            result = tool.main([config, '--work-dir', wd, '--seed',
                                str(seed), '--device', device,
                                '--no-validate', '--cfg-options', *opts])
        check_history(result, FILES_STEPS)
        print_data_times(result)
        if name == 'boxinst':
            if device == 'cuda' and min(launches.values()) < FILES_STEPS:
                fail(f'pairwise launches {launches} in {FILES_STEPS} steps')
            print(f'losses at step {result.step}: ' + ', '.join(
                f'{k} {v:.5f}' for k, v in result.history[-1].items()
                if k.startswith('loss')) + f'; launches {launches}')
            checkpoint = result.checkpoint
    t0 = time.perf_counter()
    metrics = load_tool('test_torch').main([
        CONFIG, checkpoint, '--device', device, '--eval', 'bbox', 'segm',
        '--cfg-options', 'model.test_cfg.score_thr=0',
        'data.samples_per_gpu=1', *narrow.get(CONFIG, ()),
        *file_opts(files, 'test')])
    seconds = time.perf_counter() - t0
    if not {'bbox_mAP', 'segm_mAP'} <= set(metrics) or not all(
            math.isfinite(v) for v in metrics.values()):
        fail(f'metrics {metrics}')
    print(f'tools/test_torch.py on {len(FILE_SHAPES)} JPEGs (polygon ground '
          f'truth) in {seconds:.3f} s: bbox mAP {metrics["bbox_mAP"]}, segm '
          f'mAP {metrics["segm_mAP"]}')
    return checkpoint


# fully supervised CondInst from the BoxInst config: the mask loss against
# the GT masks (polygons of the JPEGs), the semantic head on P3, and the
# train pipeline loading the masks (LoadAnnotations is step 1 and Collect
# step 7 of the shipped pipeline)
CONDINST_OPTS = [
    'model.mask_head.boxinst_enabled=False',
    "model.segm_head={'type': 'CondInstSegmHead', 'num_classes': 80, "
    "'in_channels': 256, 'in_stride': 8}",
    'data.train.pipeline.1.with_mask=True',
    "data.train.pipeline.7.keys=['img', 'gt_bboxes', 'gt_labels', "
    "'gt_masks']"]


@contextlib.contextmanager
def timed_copies(device):
    """Wrap ``apis.train.batch_to_device``: each call's ms (with a device
    sync after it on a card, so the copy is done) and the MB of its GT
    masks and of its image."""
    import torch
    from boxinstseg_tpu_torch.apis import train
    to_device = train.batch_to_device
    copies = []

    def timed(batch, dev):
        t0 = time.perf_counter()
        out = to_device(batch, dev)
        if torch.device(device).type == 'cuda':
            torch.cuda.synchronize()
        copies.append((1e3 * (time.perf_counter() - t0),
                       batch['gt_masks'].nbytes / 2**20,
                       batch['image'].nbytes / 2**20))
        return out
    train.batch_to_device = timed
    try:
        yield copies
    finally:
        train.batch_to_device = to_device


def phase_condinst(tool, work_dir, files, device='cuda', narrow=None):
    """Fully supervised CondInst R-50-FPN 1x at full width (the BoxInst
    config with ``boxinst_enabled`` False, a CondInstSegmHead and the masks
    loaded), STEPS SGD steps at batch 2 through tools/train_torch.py on the
    JPEGs with polygon ground truth, stride-1 masks: no pairwise launch,
    the step times (median of steps 2-5 and their spread), data_time beside
    the masks' host-to-device copy, peak memory; then predict on one JPEG
    and the small supervised CondInst's loss dict on the card against the
    CPU. ``device`` and ``narrow`` rehearse it on the CPU."""
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.apis.inference import (inference_detector,
                                                     init_detector)
    from boxinstseg_tpu_torch.apis.train import mask_stride
    seed = 0
    narrow = (narrow or {}).get(CONFIG, [])
    opts = [*CONDINST_OPTS, *TRAIN_OPTS, 'data.samples_per_gpu=2',
            *file_opts(files, 'train'), *narrow]
    wd = os.path.join(work_dir, 'condinst')
    cfg = tool.load_config(CONFIG, opts, wd, seed)
    pipeline = cfg.data.train.pipeline
    if (pipeline[1]['type'], pipeline[7]['type']) != ('LoadAnnotations',
                                                      'Collect') \
            or not pipeline[1]['with_mask'] or mask_stride(cfg) != 1:
        fail(f'the supervised CondInst pipeline {pipeline}')
    print(f'model: CondInst, {cfg.model.backbone.type}-'
          f'{cfg.model.backbone.depth}, boxinst_enabled '
          f'{cfg.model.mask_head.boxinst_enabled}, segm_head '
          f'{dict(cfg.model.segm_head)}; masks at stride '
          f'{mask_stride(cfg)} from the polygons')
    if device == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    with pairwise_launches() as launches, timed_copies(device) as copies, \
            live_gt_counts() as gts:
        result = tool.main([CONFIG, '--work-dir', wd, '--seed', str(seed),
                            '--device', device, '--no-validate',
                            '--cfg-options', *opts])
    check_history(result, STEPS, required=('loss_mask', 'loss_segm'))
    if any(launches.values()):
        fail(f'the pairwise kernels launched {launches} with boxinst '
             f'off')
    step_ms = [1e3 * (h['time'] - h['data_time']) for h in result.history]
    later = step_ms[1:]
    print(f'losses at step {result.step}: ' + ', '.join(
        f'{k} {v:.5f}' for k, v in result.history[-1].items()
        if k.startswith('loss')) + f'; pairwise launches {launches}')
    print('step ms (compute + sync) with live GTs, data_time ms, the '
          'batch\'s copy to the device ms (masks MB, image MB): ' + '; '.join(
              f'{t:.3f} ({n}), {1e3 * h["data_time"]:.3f}, {c:.3f} '
              f'({m:.1f}, {im:.1f})' for t, n, h, (c, m, im) in zip(
                  step_ms, gts, result.history, copies)))
    peak = torch.cuda.max_memory_allocated() / 2**30 \
        if device == 'cuda' else float('nan')
    print(f'median of steps 2-{result.step} {statistics.median(later):.3f} '
          f'ms, spread {min(later):.3f}-{max(later):.3f}; peak memory '
          f'{peak:.3f} GiB')
    pcfg = tool.load_config(CONFIG, [*CONDINST_OPTS,
                                     'model.test_cfg.score_thr=0', *narrow])
    model, pcfg = init_detector(pcfg, result.checkpoint, device=device)
    img = os.path.join(files[1], '000.jpg')
    times = []
    for i in range(4):
        t0 = time.perf_counter()
        det = inference_detector(model, pcfg, img)
        if i:
            times.append(1e3 * (time.perf_counter() - t0))
    d = pcfg.model.test_cfg.max_per_img
    if len(det['bboxes']) != d or len(det['masks']) != d \
            or det['masks'][0].shape != FILE_SHAPES[0] \
            or not np.isfinite(det['bboxes']).all():
        fail(f'predict on {img}: {len(det["bboxes"])} boxes, masks '
             f'{det["masks"][0].shape if det["masks"] else None}')
    print(f'inference_detector on one JPEG {FILE_SHAPES[0]}: {d} '
          f'detections, masks at the image\'s size; ms (loading, predict, '
          f'format) {[round(t, 3) for t in times]}')
    if device == 'cuda':
        time_p3_heads(model)
        del model
        release_cache()
        phase_condinst_reference()


def time_p3_heads(model):
    """Forward + backward ms (CUDA events, 10 calls after 3) of the
    semantic head and of the mask branch alone at the step's shapes (batch
    2, 800x1344: P3 100x168, P4, P5), in train mode, fp32; then of their
    layers at P3 one by one: the semantic head's two ConvModules and 1x1
    conv, and the mask branch's ConvModules of the same shapes (its P3
    refine, 256 -> 128, and its first tower conv, 128 -> 128)."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(0)

    def feat(c, s=1):
        return torch.randn(2, c, 100 // s, 168 // s, device='cuda',
                           generator=gen, requires_grad=True)
    feats = [feat(256, s) for s in (1, 2, 4)]
    segm, branch = model.segm_head.train(), model.mask_branch.train()
    parts = {'semantic head': (segm, feats[0]),
             'mask branch': (branch, feats),
             'semantic segm_branch.0 (256->128)': (segm.segm_branch[0],
                                                    feats[0]),
             'semantic segm_branch.1 (128->128)': (segm.segm_branch[1],
                                                    feat(128)),
             'semantic segm_conv (1x1, 128->80)': (segm.segm_conv,
                                                   feat(128)),
             'mask branch refines.0 (256->128)': (branch.refines[0],
                                                  feats[0]),
             'mask branch mask_branch.0 (128->128)': (branch.mask_branch[0],
                                                      feat(128))}
    out = [f'{name} {cuda_ms(lambda: m(x).sum().backward(), 10):.3f}'
           for name, (m, x) in parts.items()]
    print('forward + backward ms at the step\'s shapes (P3 100x168, batch '
          '2): ' + ', '.join(out))


def card_memory(where):
    """Print the card's free memory, this process's reserved memory and
    each process's use by nvidia-smi."""
    import torch
    free, total = torch.cuda.mem_get_info()
    apps = subprocess.run(['nvidia-smi', '--query-compute-apps=pid,used_memory',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip().replace('\n', '; ')
    print(f'card memory {where}: {free / 2**30:.3f} of {total / 2**30:.3f} '
          f'GiB free, this process (pid {os.getpid()}) reserves '
          f'{torch.cuda.memory_reserved() / 2**30:.3f} GiB; nvidia-smi: '
          f'{apps}', flush=True)


def release_cache():
    """Return this process's cached, unused device memory to the card
    (the child processes of the data-parallel phases need it) and print
    what stays reserved."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    print(f'this process keeps {torch.cuda.memory_reserved() / 2**30:.3f} '
          f'GiB reserved')


def phase_condinst_reference():
    """A small fully supervised CondInst with a semantic head: its loss
    dict on the card against the CPU (fp32), on stride-1 masks."""
    import numpy as np
    rng = np.random.RandomState(2)
    b, h, w, g = 2, 128, 160, 5
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    masks = np.zeros((b, g, h, w), np.uint8)
    for i in range(b):
        for j in range(rng.randint(2, g + 1)):
            x1, y1 = rng.randint(0, w - 40), rng.randint(0, h - 40)
            x2, y2 = x1 + rng.randint(16, 40), y1 + rng.randint(16, 40)
            boxes[i, j] = (x1, y1, x2, y2)
            masks[i, j, y1 + 2:y2 - 1, x1 + 1:x2 - 3] = 1
            valid[i, j] = True
    batch = dict(image=rng.rand(b, 3, h, w).astype(np.float32) * 4 - 2,
                 img_shape=np.array([[h, w]] * b, np.int32),
                 pixels_removed=np.array([5] * b, np.int32),
                 gt_bboxes=boxes, gt_labels=rng.randint(0, 4, (b, g)),
                 gt_valid=valid, gt_masks=masks)
    cfg = tiny_cfg()
    cfg['mask_head'] = dict(cfg['mask_head'], boxinst_enabled=False)
    cfg['segm_head'] = dict(type='CondInstSegmHead', num_classes=4,
                            in_channels=32, in_stride=8, stacked_convs=1,
                            feat_channels=16)
    losses = compare_loss_dicts(cfg, batch, 50)
    if {'loss_mask', 'loss_segm'} - set(losses):
        fail(f'the small supervised CondInst gave {sorted(losses)}')


DISCO_X101_CONFIG = os.path.join(
    ROOT, 'configs/discobox/discobox_solov2_coco_r101_fpn_3x.py')
# DiscoBox on SOLOv2's X-101-DCN recipe: ResNeXt-101 64x4d, deformable
# (v1) tower convs; the backbone has no deformable stages (the JAX package
# has none)
X101_DCN_OPTS = ['model.backbone.type=ResNeXt', 'model.backbone.groups=64',
                 'model.backbone.base_width=4',
                 'model.bbox_head.use_dcn_in_tower=True',
                 'model.bbox_head.type_dcn=DCN']
X101_PARTS = ('backbone.layer3.', 'bbox_head.kernel_convs.0.conv.',
              'bbox_head.cate_convs.3.conv.conv_offset.')
BOXLS_DCN_OPTS = ['model.bbox_head.use_dcn_in_tower=True',
                  'model.bbox_head.type_dcn=DCNv2']
INVENTORY_STEPS = 2
INVENTORY_TRAIN_OPTS = ['runner.type=IterBasedRunner',
                        f'runner.max_iters={INVENTORY_STEPS}',
                        'log_config.interval=1']
PVT_CHANNELS = "model.neck.in_channels=[64, 128, 320, 512]"
# BoxInst R-50 1x with each new backbone and neck (options on its config)
BOXINST_VARIANTS = {
    'ResNetV1d-50': ['model.backbone.type=ResNetV1d'],
    # base_width 64 at groups 1: the JAX width int(planes * base_width / 64)
    # * groups is then planes, the published ResNeSt-50's (F9)
    'ResNeSt-50': ['model.backbone.type=ResNeSt',
                   'model.backbone.base_width=64'],
    'DetectoRS_ResNet-50': ['model.backbone.type=DetectoRS_ResNet'],
    'PVTv2-b2': ["model.backbone={'type': 'PyramidVisionTransformerV2', "
                 "'embed_dims': (64, 128, 320, 512), "
                 "'num_layers': (3, 4, 6, 3)}", PVT_CHANNELS],
    'PVT v1 (small)': ["model.backbone={'type': "
                       "'PyramidVisionTransformer'}", PVT_CHANNELS],
    'PAFPN': ['model.neck.type=PAFPN'],
    'FPN_CARAFE': ["model.neck={'type': 'FPN_CARAFE', 'in_channels': "
                   "[256, 512, 1024, 2048], 'out_channels': 256, "
                   "'start_level': 1, 'num_outs': 5}"],
    'FPN on_input': ['model.neck.add_extra_convs=on_input'],
}
DCN_LAYER_SHAPE = (2, 256, 200, 336)   # BoxLevelset's stride-4 feature conv
# tiny versions of every module of the slice, card against CPU
TINY_PVT = dict(embed_dims=(16, 32), num_stages=2, num_layers=(1, 2),
                num_heads=(1, 2), sr_ratios=(8, 4), mlp_ratios=(2, 2),
                out_indices=(0, 1))
TINY_BACKBONES = {
    'ResNeXt': dict(type='ResNeXt', depth=50, num_stages=2, groups=4,
                    out_indices=(0, 1)),
    'ResNetV1d': dict(type='ResNetV1d', depth=50, num_stages=2,
                      stem_channels=32, out_indices=(0, 1)),
    'ResNeSt': dict(type='ResNeSt', depth=50, num_stages=2, groups=2,
                    base_width=16, stem_channels=32, out_indices=(0, 1)),
    'DetectoRS_ResNet': dict(type='DetectoRS_ResNet', depth=50,
                             num_stages=2, out_indices=(0, 1)),
    'PyramidVisionTransformer': dict(type='PyramidVisionTransformer',
                                     **TINY_PVT),
    'PyramidVisionTransformerV2': dict(type='PyramidVisionTransformerV2',
                                       **TINY_PVT),
}
TINY_NECK_CHANNELS = (8, 16, 32, 64)
TINY_NECKS = {
    'FPN on_input': dict(type='FPN', in_channels=TINY_NECK_CHANNELS,
                         out_channels=16, start_level=1, num_outs=5,
                         add_extra_convs='on_input'),
    'FPN on_lateral': dict(type='FPN', in_channels=TINY_NECK_CHANNELS,
                           out_channels=16, start_level=1, num_outs=5,
                           add_extra_convs='on_lateral'),
    'PAFPN': dict(type='PAFPN', in_channels=TINY_NECK_CHANNELS,
                  out_channels=16, start_level=1, num_outs=5,
                  add_extra_convs='on_output', relu_before_extra_convs=True),
    'ChannelMapper': dict(type='ChannelMapper',
                          in_channels=TINY_NECK_CHANNELS, out_channels=16,
                          norm_cfg=dict(type='GN', num_groups=4),
                          act_cfg=dict(type='ReLU'), num_outs=5),
    'FPN_CARAFE': dict(type='FPN_CARAFE', in_channels=TINY_NECK_CHANNELS,
                       out_channels=16, num_outs=5),
}


def inventory_boxlevelset(tool):
    """BoxLevelset R-50 with DCNv2 towers and feature convs, fp32:
    INVENTORY_STEPS AdamW steps at batch 2, 800x1344, then predict on one
    image; the step ms and peak memory."""
    import torch
    from boxinstseg_tpu_torch.apis.inference import init_detector
    seed = 0
    work_dir = tempfile.mkdtemp(prefix='chip_smoke_boxls_dcn_')
    opts = [*INVENTORY_TRAIN_OPTS, *BOXLS_DCN_OPTS, 'data.samples_per_gpu=2',
            'data.train.type=SyntheticBoxDataset']
    try:
        torch.cuda.reset_peak_memory_stats()
        result = train_tool(tool, BOXLS_CONFIG, work_dir, seed, opts)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        check_history(result, INVENTORY_STEPS,
                      required=('loss_cate', 'loss_levelset'))
        cfg = tool.load_config(BOXLS_CONFIG, opts, work_dir, seed)
        model, cfg = init_detector(cfg, result.checkpoint, device='cuda')
        convs = [m for m in model.modules()
                 if type(m).__name__ == 'DeformConv2d']
        if len(convs) != 8 + 7 or not all(m.modulated for m in convs):
            fail(f'{len(convs)} DCNv2 layers in the BoxLevelset head')
        print(f'BoxLevelset R-50 DCNv2 ({len(convs)} layers: 8 tower, 7 '
              f'feature convs), batch 2, 800x1344, fp32:')
        print_steps(result, peak)
        test_cfg = dict(cfg.model.test_cfg, score_thr=0.0, filter_thr=0.0,
                        mask_thr=0.5)
        model.test_cfg = test_cfg
        inputs, img_shape, ori_shape = eval_inputs(
            cfg, SyntheticEvalDataset(cfg.data.test.pipeline, length=1))
        out, det, times = time_predict(model, test_cfg, inputs, img_shape,
                                       ori_shape)
        d = test_cfg['max_per_img']
        check_outputs(out, {'scores': (1, d), 'labels': (1, d),
                            'valid': (1, d), 'masks': (1, d, 200, 336)})
        print_predict_times('BoxLevelset R-50 DCNv2 predict, batch 1 '
                            '(mask_thr 0.5)', det, times, ori_shape)
        del model
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def time_dcn_layer():
    """One DCNv2 layer at the stride-4 feature conv's shape, forward +
    backward (CUDA events, 5 calls after 3), against the plain
    nn.Conv2d of the same shape, fp32; its offset branch set to non-zero
    weights, so that samples fall between pixels. The byte bound counts x,
    the output, their gradients and the weights once each; the operation
    bound the two convolutions' and the contraction's multiply-adds (2
    operations each, forward and the two backward products) at the fp32
    rate."""
    import torch
    from boxinstseg_tpu_torch.models.deform_conv import DeformConv2d
    gen = torch.Generator(device='cuda').manual_seed(0)
    b, c, h, w = DCN_LAYER_SHAPE
    x = torch.randn(DCN_LAYER_SHAPE, device='cuda', generator=gen,
                    requires_grad=True)
    dcn = DeformConv2d(c, c, 3, 1, 1, modulated=True).cuda()
    with torch.no_grad():
        dcn.conv_offset.weight.normal_(0, 0.01, generator=gen)
        dcn.conv_offset.bias.normal_(0, 1, generator=gen)
    conv = torch.nn.Conv2d(c, c, 3, 1, 1).cuda()
    dcn_ms = cuda_ms(lambda: dcn(x).sum().backward(), 5)
    conv_ms = cuda_ms(lambda: conv(x).sum().backward(), 5)
    weights = sum(p.numel() for p in dcn.parameters())
    nbytes = 4 * (4 * x.numel() + 2 * weights)
    macs = b * h * w * 9 * c * (c + 27)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 3 * 2 * macs / FP32_OPS_PER_S
    print(f'DCNv2 layer {DCN_LAYER_SHAPE} -> {c}, forward + backward, fp32: '
          f'{dcn_ms:.3f} ms; plain nn.Conv2d {conv_ms:.3f} ms '
          f'({dcn_ms / conv_ms:.2f}x); bound {max(bytes_ms, ops_ms):.3f} ms '
          f'(bytes {bytes_ms:.3f}, operations {ops_ms:.3f})')
    return dcn_ms, conv_ms


def inventory_boxinst(tool):
    """BoxInst R-50 1x with each of BOXINST_VARIANTS: INVENTORY_STEPS SGD
    steps at batch 2, 800x1344, fp32, K1/K2 on from step 1; each step's
    ms, peak memory, and K1/K2's launches (one each a step)."""
    import torch
    seed = 0
    for name, extra in BOXINST_VARIANTS.items():
        work_dir = tempfile.mkdtemp(prefix='chip_smoke_variant_')
        opts = ['model.mask_head.pairwise_warmup=1', *INVENTORY_TRAIN_OPTS,
                'data.samples_per_gpu=2',
                'data.train.type=SyntheticBoxDataset', *extra]
        try:
            torch.cuda.reset_peak_memory_stats()
            with pairwise_launches() as launches:
                result = train_tool(tool, CONFIG, work_dir, seed, opts)
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            check_history(result, INVENTORY_STEPS,
                          required=('loss_pairwise',))
            if set(launches.values()) != {INVENTORY_STEPS}:
                fail(f'BoxInst {name}: K1/K2 launched {launches} in '
                     f'{INVENTORY_STEPS} steps')
            cfg = tool.load_config(CONFIG, opts, work_dir, seed)
            print(f'BoxInst {name} ({cfg.model.backbone.type}, '
                  f'{cfg.model.neck.type}), batch 2, 800x1344, fp32; K1/K2 '
                  f'launches {launches}:')
            print_steps(result, peak)
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        release_cache()


def check_module_card_vs_cpu(name, module, inputs, gen_params=()):
    """``module`` (built on the CPU) on the CPU and on the card from the
    same weights and inputs, fp32: its outputs, the inputs' gradients and
    the gradients of ``gen_params`` (names) within REF_ATOL x max(1, max
    |cpu|) + REF_RTOL x |cpu|. Returns the largest relative error."""
    import torch
    runs = {}
    for dev in ('cpu', 'cuda'):
        m = module.to(dev)
        m.zero_grad(set_to_none=True)
        xs = [x.detach().to(dev).requires_grad_() for x in inputs]
        outs = m(xs) if len(xs) > 1 else m(xs[0])
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        sum((o * torch.cos(torch.arange(o.numel(), device=dev,
                                        dtype=o.dtype).view(o.shape) * 0.37)
             ).sum() for o in outs).backward()
        named = dict(m.named_parameters())
        runs[dev] = [t.detach().cpu() for t in (
            *outs, *[x.grad for x in xs if x.grad is not None],
            *[named[k].grad for k in gen_params])]
    worst = 0.0
    for i, (got, want) in enumerate(zip(runs['cuda'], runs['cpu'])):
        ref = max(want.abs().max().item(), 1.0)
        diff = (got - want).abs()
        tol = REF_ATOL * ref + REF_RTOL * want.abs()
        if got.shape != want.shape or not bool((diff <= tol).all()):
            fail(f'{name}: tensor {i} on the card vs CPU differs by '
                 f'{diff.max().item()} (max |cpu| {ref})')
        worst = max(worst, diff.max().item() / ref)
    return worst


def inventory_card_vs_cpu():
    """A tiny version of every module of the slice on the card against the
    CPU, fp32, TF32 off: the six backbones, the necks (FPN on_input and
    on_lateral, PAFPN, ChannelMapper, FPN_CARAFE), and DCN v1 / v2 layers
    at stride 2 / dilation 2 with offsets that leave the image, whose
    offset conv's weight gradients are compared too."""
    import torch
    from boxinstseg_tpu_torch.models.deform_conv import DeformConv2d
    from boxinstseg_tpu_torch.registry import BACKBONES, NECKS
    gen = torch.Generator().manual_seed(0)
    worst = {}
    for name, cfg in TINY_BACKBONES.items():
        torch.manual_seed(0)
        x = torch.randn(2, 3, 72, 88, generator=gen)
        backbone = BACKBONES.build(dict(cfg)).train()
        for m in backbone.modules():
            if type(m).__name__ == 'SACBottleneck':
                # the weight-standardised SAConv multiplies by about
                # sqrt(fan-in); its BN's variance absorbs that, as trained
                # statistics would, so the maps stay O(1)
                m.bn2.running_var.fill_(m.conv2.weight[0].numel())
        worst[name] = check_module_card_vs_cpu(name, backbone, [x])
    for name, cfg in TINY_NECKS.items():
        torch.manual_seed(0)
        xs = [torch.randn(2, c, h, w, generator=gen) for c, (h, w) in zip(
            TINY_NECK_CHANNELS, ((30, 26), (15, 13), (8, 7), (4, 4)))]
        worst[name] = check_module_card_vs_cpu(
            name, NECKS.build(dict(cfg)).train(), xs)
    for modulated in (False, True):
        torch.manual_seed(0)
        dcn = DeformConv2d(6, 8, 3, 2, 2, 2, modulated=modulated)
        with torch.no_grad():
            dcn.conv_offset.weight.normal_(0, 0.3, generator=gen)
            dcn.conv_offset.bias.normal_(0, 2, generator=gen)
        name = 'DCNv2' if modulated else 'DCN'
        worst[name] = check_module_card_vs_cpu(
            name, dcn, [torch.randn(2, 6, 17, 21, generator=gen)],
            ('conv_offset.weight', 'conv_offset.bias', 'weight'))
    print('card vs CPU (outputs, input gradients; DCN also its weights\' '
          'gradients), worst error / max(1, max |cpu|): ' + ', '.join(
              f'{k} {v:.3g}' for k, v in worst.items()))


def phase_inventory(tool):
    """The backbone and neck inventory at full width: DiscoBox X-101-DCN,
    BoxLevelset R-50 DCNv2 and one DCNv2 layer against its conv, BoxInst
    with each new backbone and neck, then every new module's tiny version
    on the card against the CPU."""
    t0 = time.perf_counter()
    register_dataset()
    _, cfg, model = phase_discobox(tool, DISCO_X101_CONFIG, X101_DCN_OPTS,
                                   X101_PARTS)
    phase_discobox_predict(cfg, model, 'DiscoBox X-101-DCN')
    del model
    release_cache()
    inventory_boxlevelset(tool)
    time_dcn_layer()
    release_cache()
    inventory_boxinst(tool)
    inventory_card_vs_cpu()
    print(f'inventory phase {time.perf_counter() - t0:.1f} s')


def _child_main(target, rank, world, port, mode, results, args):
    """A child process of ``run_children``: one rank that joins a gloo
    group itself (``mode`` 'gloo'), joins an nccl group on card ``rank``
    ('cards'; gloo on a host without cards), is given a launcher's
    environment ('env', card ``rank``), or runs alone (None)."""
    import traceback
    from datetime import timedelta
    try:
        sys.path.insert(0, ROOT)
        import torch
        from boxinstseg_tpu_torch.parallel import dist as pdist
        from boxinstseg_tpu_torch.utils.env import set_tf32
        set_tf32(False)
        os.environ['LOCAL_RANK'] = str(rank)
        if mode == 'env':
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                              MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
        elif mode in ('gloo', 'cards'):
            backend = 'nccl' if mode == 'cards' and \
                torch.cuda.is_available() else 'gloo'
            pdist.init_distributed(backend=backend,
                                   init_method=f'tcp://127.0.0.1:{port}',
                                   world_size=world, rank=rank,
                                   timeout=timedelta(seconds=300))
        results.put((rank, None, target(*args)))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
    finally:
        from boxinstseg_tpu_torch.parallel import dist as pdist
        pdist.destroy()


def run_children(target, args, world=1, mode='gloo', meanwhile=None):
    """``target(*args)`` in ``world`` spawned processes on this machine's
    card (ranks of a gloo group; with ``mode`` 'env' a torchrun-style
    environment that the target's entry point reads; with None one process
    alone), and ``meanwhile()`` here while they run; returns (their
    results in rank order, meanwhile's). A rank that fails, dies or
    outlasts DDP_LIMIT fails the run; no child outlives it."""
    import multiprocessing
    import queue
    import socket
    ctx = multiprocessing.get_context('spawn')
    results = ctx.Queue()
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    procs = [ctx.Process(target=_child_main, daemon=True, args=(
        target, r, world, port, mode, results, args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DDP_LIMIT
    out, errors, extra = {}, [], None
    try:
        extra = meanwhile() if meanwhile is not None else None
        while len(out) + len(errors) < world:
            if time.monotonic() > deadline:
                errors.append(f'no result within {DDP_LIMIT} s')
                break
            try:
                rank, err, res = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f'a rank exited with {dead}')
                    break
                continue
            if err is None:
                out[rank] = res
            else:
                errors.append(f'rank {rank}: {err}')
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 10.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        fail('; '.join(errors))
    return [out[r] for r in range(world)], extra


def ddp_train_tool(argv):
    """``tools/train_torch.py``'s ``main`` in a fresh process (with
    ``--launcher pytorch``, one rank it launches itself): its logs, each
    step's live GT count and the pairwise kernels' launches."""
    with pairwise_launches() as launches, live_gt_counts() as gts:
        result = load_tool('train_torch').main(argv)
    return dict(history=result.history, launches=launches, gts=gts,
                step=result.step, checkpoint=result.checkpoint)


def ddp_pair_run(opts, work_dir, device=None, config=CONFIG):
    """``train_detector`` of ``config`` (BoxInst by default) at full width
    on the JPEGs of ``opts``, from the seed's weights, on ``device`` (this
    rank's card when None): the logs (the mean over ranks), the BN running
    statistics and the launches of the pairwise kernels (Swin-L: of K5 and
    K6)."""
    from boxinstseg_tpu_torch.apis.train import train_detector
    from boxinstseg_tpu_torch.models.layers import SyncBatchNorm
    from boxinstseg_tpu_torch.parallel import dist as pdist
    from boxinstseg_tpu_torch.registry import build_dataset
    device = device or pdist.local_device()
    tool = load_tool('train_torch')
    cfg = tool.load_config(config, opts, work_dir, 0)
    model = tool.build_model(cfg, 0)
    counted = swin_launches if config == SWIN_CONFIG else pairwise_launches
    with counted() as launches:
        result = train_detector(model, build_dataset(cfg.data['train']),
                                cfg, device=device)
    bn = {f'{name}.{b}': getattr(m, b).cpu().numpy()
          for name, m in model.named_modules()
          if isinstance(m, SyncBatchNorm)
          for b in ('running_mean', 'running_var')}
    return dict(history=result.history, bn=bn, launches=launches)


def ddp_evaluate(opts, checkpoint, out, device=None):
    """``run_evaluation`` of BoxInst's checkpoint on this rank's share of
    the JPEGs, on ``device`` (this rank's card when None); rank 0 writes
    the gathered results to ``out``."""
    from boxinstseg_tpu_torch.apis.inference import init_detector
    from boxinstseg_tpu_torch.apis.test import run_evaluation
    from boxinstseg_tpu_torch.parallel import dist as pdist
    from boxinstseg_tpu_torch.registry import build_dataset
    device = device or pdist.local_device()
    side = (f'rank {pdist.rank()} of {pdist.world_size()}'
            if pdist.world_size() > 1 else 'one process')
    free = card_free_gib(device)
    if free is not None:
        import torch
        card = torch.device(device).index
        torch.cuda.set_per_process_memory_fraction(
            EVAL_MEMORY_FRACTION,
            torch.cuda.current_device() if card is None else card)
    cfg = load_tool('train_torch').load_config(CONFIG, opts)
    model, cfg = init_detector(cfg, checkpoint, device=device)
    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    result = run_evaluation(model, dataset, cfg, metrics=['bbox', 'segm'],
                            save_results=out if pdist.rank() == 0 else None)
    print(f'evaluation, {side} (pid {os.getpid()}): card memory free '
          f'{free} GiB before, {card_free_gib(device)} after; this '
          f'process\'s peak reserved {card_peak_reserved_gib(device)} GiB',
          flush=True)
    return result


def card_free_gib(device):
    """The card's free memory in GiB (None on the CPU)."""
    import torch
    if torch.device(device).type != 'cuda':
        return None
    return round(torch.cuda.mem_get_info(device)[0] / 2**30, 3)


def card_peak_reserved_gib(device):
    import torch
    if torch.device(device).type != 'cuda':
        return None
    return round(torch.cuda.max_memory_reserved(device) / 2**30, 3)


@contextlib.contextmanager
def cudnn_log(side):
    """With --cudnn-log: cuDNN's API log (level 3) of the child processes
    started within, a file a process named by ``side`` and its pid,
    gzipped on exit."""
    if CUDNN_LOG_DIR is None:
        yield
        return
    import glob
    import gzip
    os.makedirs(CUDNN_LOG_DIR, exist_ok=True)
    keys = ('CUDNN_LOGLEVEL_DBG', 'CUDNN_LOGINFO_DBG', 'CUDNN_LOGDEST_DBG')
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(CUDNN_LOGLEVEL_DBG='3', CUDNN_LOGINFO_DBG='1',
                      CUDNN_LOGDEST_DBG=os.path.join(
                          CUDNN_LOG_DIR, f'cudnn_{side}_%i.log'))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for path in glob.glob(os.path.join(CUDNN_LOG_DIR,
                                           f'cudnn_{side}_*.log')):
            size = os.path.getsize(path)
            with open(path, 'rb') as f, gzip.open(f'{path}.gz', 'wb') as g:
                g.write(f.read(CUDNN_LOG_BYTES))
            os.remove(path)
            print(f'cuDNN log {os.path.basename(path)}: {size / 2**20:.1f} '
                  f'MiB, the first {min(size, CUDNN_LOG_BYTES) / 2**20:.1f} '
                  f'MiB kept gzipped '
                  f'({os.path.getsize(path + ".gz") / 2**20:.1f} MiB)')


def time_launches(work_dir, files, opts, device, plan):
    """tools/train_torch.py's BoxInst runs at batch 2 a card, DDP_STEPS
    steps from the JPEGs, each in fresh processes, in the order of
    ``plan`` ((launcher, world) pairs; 'pytorch' gets a torchrun-style
    environment, card r for rank r). Prints each run's steps and returns
    the medians of steps 2-DDP_STEPS by (launcher, world) and the last
    run's checkpoint."""
    medians, checkpoint = {}, None
    for launcher, world in plan:
        wd = os.path.join(work_dir, f'time_{launcher}_{world}')
        runs, _ = run_children(ddp_train_tool, ([
            CONFIG, '--launcher', launcher, '--device', device, '--seed',
            '0', '--no-validate', '--work-dir', wd, '--cfg-options', *opts,
            f'runner.max_iters={DDP_STEPS}', 'data.samples_per_gpu=2',
            *file_opts(files, 'train')],), world,
            mode='env' if launcher == 'pytorch' else None)
        run = runs[0]
        if run['step'] != DDP_STEPS or len(run['history']) != DDP_STEPS:
            fail(f'--launcher {launcher} ran {run["step"]} steps')
        if device == 'cuda' and min(min(r['launches'].values())
                                    for r in runs) < DDP_STEPS:
            fail(f'pairwise launches {[r["launches"] for r in runs]} with '
                 f'--launcher {launcher} over {world}')
        step_ms = [1e3 * (h['time'] - h['data_time'])
                   for h in run['history']]
        median = statistics.median(step_ms[1:])
        medians.setdefault((launcher, world), []).append(median)
        print(f'--launcher {launcher}, world {world} (fresh processes, '
              f'batch 2 a card, JPEGs): rank 0 step ms with its live GTs '
              + ', '.join(f'{t:.3f} ({n})'
                          for t, n in zip(step_ms, run['gts']))
              + f'; median of steps 2-{DDP_STEPS} {median:.3f} ms, '
              f'{2 * world * 1e3 / median:.3f} images/s; launches a rank '
              f'{run["launches"]}')
        checkpoint = run['checkpoint']
    return medians, checkpoint


def script_launches(work_dir, files, opts, device, plan):
    """tools/dist_train_torch.sh (torchrun, ``--launcher pytorch``) over
    BoxInst at batch 2 a card, DDP_STEPS steps from the JPEGs, in the
    order of ``plan`` (worlds; fresh processes each run, card r for rank
    r). Each step's time comes from rank 0's log (``Iter`` lines: time and
    data_time in ms). Returns the medians of steps 2-DDP_STEPS by world and
    the last run's checkpoint."""
    import re
    import socket
    from boxinstseg_tpu_torch.engine.hooks import latest_checkpoint
    script = os.path.join(ROOT, 'tools', 'dist_train_torch.sh')
    medians, checkpoint = {}, None
    line = re.compile(r'Iter \[(\d+)/\d+\].* time: ([0-9.]+)s/iter .*'
                      r'data_time: ([0-9.]+),')
    for world in plan:
        wd = os.path.join(work_dir, f'script_{world}_{len(medians)}')
        with socket.socket() as sock:
            sock.bind(('127.0.0.1', 0))
            port = sock.getsockname()[1]
        try:
            out = subprocess.run(
                ['bash', script, CONFIG, str(world), '--device', device,
                 '--seed', '0', '--no-validate', '--work-dir', wd,
                 '--cfg-options', *opts, f'runner.max_iters={DDP_STEPS}',
                 'data.samples_per_gpu=2', *file_opts(files, 'train')],
                capture_output=True, text=True, timeout=DDP_LIMIT,
                env=dict(os.environ, PORT=str(port)))
        except subprocess.TimeoutExpired:
            fail(f'tools/dist_train_torch.sh over {world}: no end within '
                 f'{DDP_LIMIT} s')
        if out.returncode != 0:
            fail(f'tools/dist_train_torch.sh over {world} exited '
                 f'{out.returncode}: {out.stderr[-3000:]}')
        with open(os.path.join(wd, 'train.log')) as f:
            steps = [(int(m[1]), 1e3 * (float(m[2]) - float(m[3])))
                     for m in map(line.search, f) if m]
        if [i for i, _ in steps] != list(range(1, DDP_STEPS + 1)):
            fail(f'tools/dist_train_torch.sh over {world} logged steps '
                 f'{[i for i, _ in steps]}')
        step_ms = [t for _, t in steps]
        median = statistics.median(step_ms[1:])
        medians.setdefault(world, []).append(median)
        print(f'tools/dist_train_torch.sh over {world} (torchrun, fresh '
              f'processes, batch 2 a card, JPEGs): rank 0 step ms (its '
              f'log, ms resolution) ' + ', '.join(f'{t:.0f}' for t in step_ms)
              + f'; median of steps 2-{DDP_STEPS} {median:.0f} ms, '
              f'{2 * world * 1e3 / median:.3f} images/s')
        checkpoint = latest_checkpoint(wd)
    return medians, checkpoint


def check_ranks_against_one(ranks, one, what):
    """Each step's losses (DDP_LOSS_RTOL) and averaged gradient norm
    (DDP_GRAD_RTOL) of ``ranks`` (rank 0's logs, the mean over ranks)
    against ``one`` process's, and the BN running statistics
    (DDP_BN_RTOL / DDP_BN_ATOL) of every rank."""
    import numpy as np
    worst = dict(loss=0.0, grad_norm=0.0, bn=0.0)
    for i, (g, w) in enumerate(zip(ranks[0]['history'], one['history'])):
        for k, v in w.items():
            if k.startswith('loss') or k == 'grad_norm':
                rtol = DDP_GRAD_RTOL if k == 'grad_norm' else DDP_LOSS_RTOL
                key = 'grad_norm' if k == 'grad_norm' else 'loss'
                worst[key] = max(worst[key],
                                 abs(g[k] - v) / max(abs(v), 1e-12))
                if abs(g[k] - v) > rtol * abs(v) + 1e-7:
                    fail(f'{what}, step {i + 1} {k}: {g[k]} vs {v}')
    for rank in ranks:
        for k, v in one['bn'].items():
            # the share of its tolerance that the largest gap takes (<= 1)
            share = float(np.max(np.abs(rank['bn'][k] - v)
                                 / (DDP_BN_ATOL + DDP_BN_RTOL * np.abs(v))))
            worst['bn'] = max(worst['bn'], share)
            if share > 1:
                fail(f'{what}: BN statistics {k} differ')
    print(f'{what}: losses at step 1 ' + ', '.join(
        f'{k} {v:.5f}' for k, v in ranks[0]['history'][0].items()
        if k.startswith('loss'))
        + f'; largest relative gap: losses {worst["loss"]:.3e}, grad_norm '
        f'{worst["grad_norm"]:.3e}; BN statistics ({len(one["bn"])} '
        f'buffers) take {worst["bn"]:.3f} of their tolerance; launches a '
        f'rank {ranks[-1]["launches"]}')


def result_gaps(want, got):
    """Where two lists of per-image result dicts differ: (image, key,
    largest difference or 'length') for each differing entry."""
    import numpy as np
    gaps = [('images', len(want), len(got))] if len(want) != len(got) else []
    for i, (w, g) in enumerate(zip(want, got)):
        for k in sorted(set(w) | set(g)):
            if w.get(k) == g.get(k):
                continue
            try:
                d = float(np.abs(np.asarray(w[k], float)
                                 - np.asarray(g[k], float)).max())
            except (KeyError, TypeError, ValueError):
                d = 'length'
            gaps.append((i, k, d))
    return gaps[:12]


def check_eval_gather(work_dir, files, checkpoint, narrow, device, world,
                      mode):
    """run_evaluation of ``checkpoint`` at batch 1 (score_thr 0) over the
    JPEGs in ``world`` ranks and in one fresh process: rank 0's gathered
    per-image results and metrics must equal the one process's, the other
    ranks must return {}."""
    eval_opts = ['model.test_cfg.score_thr=0', 'data.samples_per_gpu=1',
                 *narrow, *file_opts(files, 'test')]
    outs = [os.path.join(work_dir, f'eval_{world}_{w}.json')
            for w in (1, world)]
    with cudnn_log('one'):
        (one,), _ = run_children(ddp_evaluate, (eval_opts, checkpoint,
                                                outs[0], device), mode=None)
    with cudnn_log(f'ranks{world}'):
        ranks, _ = run_children(ddp_evaluate, (eval_opts, checkpoint,
                                               outs[1], device), world,
                                mode=mode)
    if any(r != {} for r in ranks[1:]):
        fail(f'ranks 1-{world - 1} returned {ranks[1:]}')
    if ranks[0] != one:
        fail(f'{world}-rank evaluation {ranks[0]} differs from one process '
             f'{one}')
    with open(outs[0]) as f, open(outs[1]) as g:
        results = [json.load(f), json.load(g)]
    flips = mask_flips(*results, world)
    off, total = pixels_apart(flips, results[0])
    if flips:
        fail(f'the {world} ranks\' masks differ from one process\'s in {off} '
             f'of {total} pixels, in {sum(len(v) for v in flips.values())} '
             f'masks of images {sorted(flips)}')
    n_det = sum(len(r['bboxes']) for r in results[0])
    print(f'run_evaluation in {world} ranks ({mode}; {len(results[0])} JPEGs, '
          f'batch 1, rank 0 gathers) against one fresh process: the same '
          f'{n_det} detections image by image (boxes, scores, labels, masks '
          f'of {total} pixels), the same metrics (bbox mAP '
          f'{one["bbox_mAP"]}, segm mAP {one["segm_mAP"]}); the other ranks '
          f'{{}}')


def mask_flips(want, got, world):
    """One process's per-image results against the ranks' gathered ones:
    every field but the masks equal, as many masks; returns {image: [(the
    detection, its mask from one process, from the ranks)]} for the masks
    that differ."""
    if len(want) != len(got):
        fail(f'the {world} ranks gathered {len(got)} images, one process '
             f'{len(want)}')
    flips = {}
    for i, (w, g) in enumerate(zip(want, got)):
        rest = [k for k in set(w) | set(g) if k != 'masks'
                and w.get(k) != g.get(k)]
        if rest or len(w['masks']) != len(g['masks']):
            fail(f'the {world} ranks\' gathered per-image results differ '
                 f'from one process\'s: {result_gaps(want, got)}')
        apart = [(j, a, b) for j, (a, b) in enumerate(zip(w['masks'],
                                                          g['masks']))
                 if a != b]
        if apart:
            flips[i] = apart
    return flips


def pixels_apart(flips, results):
    """The pixels where the masks of ``mask_flips`` differ, and the pixels
    of every mask of ``results``."""
    import numpy as np
    from boxinstseg_tpu_torch.data.coco_api import rle_decode
    off = sum(int(np.count_nonzero(rle_decode(a) != rle_decode(b)))
              for apart in flips.values() for _, a, b in apart)
    total = sum(int(np.prod(m['size'])) for r in results for m in r['masks'])
    return off, total


def phase_ddp(work_dir, files, pair, slice_ms, checkpoint, device='cuda',
              narrow=None):
    """1. tools/train_torch.py --launcher pytorch in a child process with
    RANK=0 WORLD_SIZE=1 (nccl): BoxInst at full width, batch 2, DDP_STEPS
    steps from the JPEGs, in turns with the same run without a launcher,
    each in a fresh process (a process's history moves BoxInst's step
    time); the medians beside the slice phase's. 2. Two gloo ranks on the
    one card at batch 1 against one process at batch 2 on the same two
    JPEGs (1 and 6 boxes) from the same weights: each step's losses, the
    averaged gradient's norm and the BN running statistics. 3.
    run_evaluation of the files phase's checkpoint at batch 1 in two gloo
    ranks and in one fresh process: rank 0's gathered per-image results
    and metrics must equal the one process's, rank 1's must be {}."""
    narrow = (narrow or {}).get(CONFIG, [])
    opts = ['runner.type=IterBasedRunner', 'log_config.interval=1',
            'model.mask_head.pairwise_warmup=1', *narrow]
    if device == 'cuda':
        card_memory('before the ddp children')
        release_cache()      # the files phase's cache: the children need it
    medians, _ = time_launches(work_dir, files, opts, device, (
        ('none', 1), ('pytorch', 1), ('pytorch', 1), ('none', 1)))
    print('in turns (none, pytorch, pytorch, none): medians one process '
          + ', '.join(f'{v:.3f}' for v in medians[('none', 1)])
          + '; NCCL world of 1 '
          + ', '.join(f'{v:.3f}' for v in medians[('pytorch', 1)])
          + f' ms; the slice phase (this process, synthetic images) '
          f'{slice_ms:.3f} ms')

    pair_opts = [*opts, f'runner.max_iters={DDP_STEPS // 2}',
                 *file_opts(pair, 'train')]
    ranks, one = run_children(
        ddp_pair_run, ([*pair_opts, 'data.samples_per_gpu=1'],
                       os.path.join(work_dir, 'ddp_pair'), device), 2,
        meanwhile=lambda: ddp_pair_run(
            [*pair_opts, 'data.samples_per_gpu=2'],
            os.path.join(work_dir, 'ddp_one'), device))
    check_ranks_against_one(
        ranks, one, f'2 gloo ranks at batch 1 vs one process at batch 2 '
        f'({PAIR_BOXES} boxes, {DDP_STEPS // 2} steps)')
    check_eval_gather(work_dir, files, checkpoint, narrow, device, 2, 'gloo')


def phase_ddp_swin(work_dir, pair, device='cuda', narrow=None):
    """Box2Mask Swin-L LSJ at full width: two gloo ranks on the one card at
    batch 1 against one process at batch 2 on the two JPEGs (1 and 6
    boxes), DDP_STEPS // 2 steps from the same weights: each step's losses
    and the averaged gradient's norm, with the K5 / K6 launches of every
    rank. SGD in place of the recipe's AdamW, as in the CPU tests: AdamW
    moves an element whose gradient is at the float noise of the sums over
    ranks by up to the LR."""
    narrow = (narrow or {}).get(SWIN_CONFIG, [])
    steps = DDP_STEPS // 2
    opts = ['runner.type=IterBasedRunner', 'log_config.interval=1',
            f'runner.max_iters={steps}', 'optimizer.type=SGD',
            'optimizer.momentum=0.9', *narrow, *file_opts(pair, 'train')]
    if device == 'cuda':
        release_cache()
    ranks, one = run_children(
        ddp_pair_run, ([*opts, 'data.samples_per_gpu=1'],
                       os.path.join(work_dir, 'ddp_swin_pair'), device,
                       SWIN_CONFIG), 2,
        meanwhile=lambda: ddp_pair_run(
            [*opts, 'data.samples_per_gpu=2'],
            os.path.join(work_dir, 'ddp_swin_one'), device, SWIN_CONFIG))
    if device == 'cuda':
        for run in (*ranks, one):
            if min(run['launches'].values()) < steps:
                fail(f'K5 / K6 launches {run["launches"]} in {steps} steps')
    check_ranks_against_one(
        ranks, one, f'Swin-L: 2 gloo ranks at batch 1 vs one process at '
        f'batch 2 ({PAIR_BOXES} boxes, {steps} steps)')


def phase_cards(work_dir, files, cards, device='cuda', narrow=None):
    """Data parallelism over ``cards`` cards (nccl, one process a card):
    tools/dist_train_torch.sh (torchrun over tools/train_torch.py
    --launcher pytorch) over 1 and ``cards`` ranks in turns (1, n, n, 1),
    batch 2 a card; ``cards`` ranks at batch 1 against one process at batch
    ``cards`` on as many JPEGs with CARD_BOXES boxes (losses, gradient
    norm, BN statistics, each rank's K1/K2 launches); run_evaluation in
    ``cards`` ranks against one process."""
    narrow = (narrow or {}).get(CONFIG, [])
    opts = ['runner.type=IterBasedRunner', 'log_config.interval=1',
            'model.mask_head.pairwise_warmup=1', *narrow]
    medians, checkpoint = script_launches(work_dir, files, opts, device,
                                          (1, cards, cards, 1))
    one_ms = statistics.median(medians[1])
    many_ms = statistics.median(medians[cards])
    print(f'in turns (1, {cards}, {cards}, 1 cards): step ms at one card '
          + ', '.join(f'{v:.0f}' for v in medians[1])
          + f', at {cards} ' + ', '.join(f'{v:.0f}' for v in medians[cards])
          + f'; images/s {2e3 / one_ms:.3f} and {2e3 * cards / many_ms:.3f}'
          f' ({one_ms / many_ms:.3f} of linear)')

    shapes = FILE_SHAPES[:1] * cards
    boxes = CARD_BOXES[:cards]
    quad = write_coco_files(os.path.join(work_dir, 'quad'), shapes,
                            boxes=boxes, seed=2)
    quad_opts = [*opts, f'runner.max_iters={DDP_STEPS // 2}',
                 *file_opts(quad, 'train')]
    # each rank on its card (None); on the CPU, gloo ranks on the CPU
    rank_device = None if device == 'cuda' else device
    ranks, one = run_children(
        ddp_pair_run, ([*quad_opts, 'data.samples_per_gpu=1'],
                       os.path.join(work_dir, 'cards_ranks'), rank_device),
        cards, mode='cards', meanwhile=lambda: ddp_pair_run(
            [*quad_opts, f'data.samples_per_gpu={cards}'],
            os.path.join(work_dir, 'cards_one'), device))
    # the script's runs log no launches: these ranks, on the same path,
    # show K1 and K2 launched in every step on every card
    if device == 'cuda':
        for run in (*ranks, one):
            if min(run['launches'].values()) < DDP_STEPS // 2:
                fail(f'K1 / K2 launches {run["launches"]} in '
                     f'{DDP_STEPS // 2} steps over {cards} cards')
    check_ranks_against_one(
        ranks, one, f'{cards} ranks (nccl, one card each) at batch 1 vs one '
        f'process at batch {cards} ({boxes} boxes, {DDP_STEPS // 2} steps)')
    check_eval_gather(work_dir, files, checkpoint, narrow, rank_device,
                      cards, 'cards')


def load_script(rel):
    """The repo's script ``rel`` (a path under the root) as a module."""
    path = os.path.join(ROOT, rel)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cfg_options(*opts):
    """``--cfg-options`` and ``opts``, or nothing when there are none."""
    return ['--cfg-options', *opts] if opts else []


def write_video(path, images, frames):
    """An MJPG ``.avi`` of ``frames`` frames cycling through ``images``
    (one size), written with cv2."""
    import cv2
    first = cv2.imread(images[0])
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), 10,
                             (first.shape[1], first.shape[0]))
    if not writer.isOpened():
        fail(f'cv2 cannot write MJPG to {path}')
    for i in range(frames):
        writer.write(cv2.imread(images[i % len(images)]))
    writer.release()
    return path


def mask_scores(model, cfg, frame):
    """BoxInst's mask scores of one frame at batch 1, as the video demo
    predicts it, at the frame's resolution before the 0.5 threshold: (n,
    h, w) for the n valid detections in ``format_detection``'s order."""
    import torch
    from boxinstseg_tpu_torch.apis.test import (eval_batcher, predict_batch,
                                                upsample_masks)
    from boxinstseg_tpu_torch.data.pipelines import Compose
    sample = Compose(list(cfg.get('test_pipeline')
                          or cfg.data['test']['pipeline']))(
        {'img': frame, 'filename': None, 'bbox_fields': [],
         'mask_fields': []})
    batch = eval_batcher(cfg)([sample])
    out = predict_batch(model, batch, False)
    keep = torch.nonzero(out['valid'][0]).flatten()
    return upsample_masks(out['masks'][0][keep], batch['img_shape'][0],
                          batch['ori_shape'][0], aligned=True)


def ties(x, y):
    """Scores ``x`` and ``y`` equal within SCORE_RTOL of the larger."""
    import numpy as np
    return np.abs(x - y) <= SCORE_RTOL * np.maximum(np.abs(x), np.abs(y))


def pair_detections(a, b):
    """Pairs (i, j) of the detections ``a`` and ``b`` of one frame: the
    same label, boxes within BOX_ATOL px and tied scores (``ties``), each
    detection paired once, in ``a``'s order. Returns the pairs and the
    unpaired indices of ``a`` and of ``b``."""
    import numpy as np
    free = np.ones(len(b['labels']), bool)
    pairs, lone_a = [], []
    for i, (label, box) in enumerate(zip(a['labels'], a['bboxes'])):
        near = free & (b['labels'] == label) \
            & (np.abs(b['bboxes'][:, :4] - box[:4]).max(1) <= BOX_ATOL) \
            & ties(b['bboxes'][:, 4], box[4])
        if near.any():
            j = int(np.flatnonzero(near)[0])
            free[j] = False
            pairs.append((i, j))
        else:
            lone_a.append(i)
    return pairs, lone_a, [int(j) for j in np.flatnonzero(free)]


def check_demo_frames(plain, accel, model, cfg, video):
    """The two video demos' per-frame results. Batch 1 and batch 4 round
    the last bits apart, so two detections whose scores tie within
    SCORE_RTOL may trade places, and where NMS or the max_per_img cut chose
    between them, one may stand in for the other. Per frame: as many
    detections, their scores (each list in descending order) tied place by
    place; every detection paired (``pair_detections``: the same label,
    boxes within BOX_ATOL px, tied scores) but those that stand in for one
    another, which tie in score; paired masks equal except at pixels whose
    batch-1 score lies within MASK_NEAR of the 0.5 threshold. Returns the
    largest box and (relative) score differences of the pairs, the largest
    score difference place by place, the smallest gap between neighbouring
    batch-1 scores, the pairs out of place, the stand-ins, the mask pixels
    that differ and their largest distance to the threshold."""
    import cv2
    import numpy as np
    import torch
    if len(plain) != len(accel) or not plain:
        fail(f'video demos: {len(plain)} vs {len(accel)} frames')
    cap = cv2.VideoCapture(video)
    frames = [cap.read()[1] for _ in plain]
    cap.release()
    worst = dict(box=0.0, score=0.0, place=0.0, gap=math.inf, moved=0,
                 stand_in=0, off=0, near=0.0)
    for i, (a, b, frame) in enumerate(zip(plain, accel, frames)):
        if len(a['labels']) != len(b['labels']):
            fail(f'video demos, frame {i}: {len(a["labels"])} vs '
                 f'{len(b["labels"])} detections')
        sa, sb = a['bboxes'][:, 4], b['bboxes'][:, 4]
        if not ties(sa, sb).all():
            gap = np.abs(sa - sb).max()
            fail(f'video demos, frame {i}: scores differ by {gap} in place')
        if len(sa):
            worst['place'] = max(worst['place'], float(np.abs(sa - sb).max()))
        if len(sa) > 1:
            worst['gap'] = min(worst['gap'],
                              float(np.abs(np.diff(sa)).min()))
        pairs, lone_a, lone_b = pair_detections(a, b)
        for k in lone_a:
            tie = [j for j in lone_b if ties(sb[j], sa[k])]
            if not tie:
                fail(f'video demos, frame {i}: batch-1 detection {k} (label '
                     f'{a["labels"][k]}, score {sa[k]}, box '
                     f'{a["bboxes"][k, :4].tolist()}) has no counterpart')
            lone_b.remove(tie[0])
        if lone_b:
            fail(f'video demos, frame {i}: batch-{VIDEO_BATCH} detections '
                 f'{lone_b} have no counterpart')
        worst['stand_in'] += len(lone_a)
        worst['moved'] += sum(ia != ib for ia, ib in pairs)
        for ia, ib in pairs:
            worst['box'] = max(worst['box'], float(np.abs(
                a['bboxes'][ia, :4] - b['bboxes'][ib, :4]).max()))
            worst['score'] = max(worst['score'], float(
                abs(sa[ia] - sb[ib]) / max(abs(sa[ia]), abs(sb[ib]), 1e-30)))
        apart = [(ia, ib) for ia, ib in pairs
                 if not np.array_equal(a['masks'][ia], b['masks'][ib])]
        if not apart:
            continue
        scores = mask_scores(model, cfg, frame)
        for ia, ib in apart:
            where = torch.from_numpy(a['masks'][ia] != b['masks'][ib])
            dist = (scores[ia][where.to(scores.device)] - 0.5).abs().max()
            worst['off'] += int(where.sum())
            worst['near'] = max(worst['near'], dist.item())
            if not dist.item() <= MASK_NEAR:
                fail(f'video demos, frame {i}, detection {ia}: masks differ '
                     f'at a score {dist.item()} from the threshold')
    return worst


def check_close(what, got, want):
    """A loaded program's output against the eager model's: integer and
    boolean outputs exactly, floats within KERNEL_ATOL * max(1, max |want|)
    + KERNEL_RTOL * |want|. Returns the max abs difference."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f'{what}: {tuple(got.shape)} {got.dtype} vs '
             f'{tuple(want.shape)} {want.dtype}')
    if not want.is_floating_point():
        if not torch.equal(got, want):
            fail(f'{what}: differs from eager')
        return 0.0
    diff = (got - want).abs()
    tol = KERNEL_ATOL * max(want.abs().max().item(), 1.0) \
        + KERNEL_RTOL * want.abs()
    if not bool(torch.isfinite(got).all()) or not bool((diff <= tol).all()):
        fail(f'{what}: differs from eager by {diff.max().item()}')
    return diff.max().item()


def phase_public_surface(work_dir, files, files_checkpoint, checkpoint,
                         eval_metrics, device='cuda', narrow=None,
                         canvases=None):
    """The port's public surface on the card: the image demo on a JPEG of
    the files phase with its BoxInst checkpoint; the video demo (batch 1)
    and the accelerated one (batch VIDEO_BATCH) over an 8-frame MJPG video,
    compared frame by frame (``check_demo_frames``); BoxInst exported
    from the slice's checkpoint at 800x1344, batch 1, and evaluated
    through tools/deployment/test_torch.py on the eval phase's images with
    the eval phase's metrics; Box2Mask R-50 and Swin-L exported from seed 0
    at 1024x1024,
    their boxinstseg ops counted in the graph, the kernels' launches
    counted while the loaded programs run, their outputs against the eager
    models'; benchmark_torch (BoxInst and Box2Mask predict, BoxInst train)
    and get_flops_torch (the three) beside the card's name and power
    limit, the parameter counts those of the exported models. ``device``,
    ``narrow`` (extra options by config) and ``canvases`` (by config) let
    it be rehearsed on the CPU with narrow models."""
    import cv2
    import torch
    from boxinstseg_tpu_torch.apis.export import ExportedDetector
    from boxinstseg_tpu_torch.apis.inference import init_detector, load_config
    narrow = narrow or {}
    canvases = canvases or {}
    boxinst_canvas = canvases.get(CONFIG, BOXINST_CANVAS)
    score0 = ['--cfg-options', 'model.test_cfg.score_thr=0',
              *narrow.get(CONFIG, ())]
    ann_file, prefix = files
    with open(ann_file) as f:
        landscape = [os.path.join(prefix, im['file_name'])
                     for im in json.load(f)['images']
                     if im['width'] > im['height']]

    # 1. the image demo
    out = os.path.join(work_dir, 'demo_out.jpg')
    result = load_script('demo/image_demo_torch.py').main([
        landscape[0], CONFIG, files_checkpoint, '--out-file', out,
        '--score-thr', '0', '--device', device, *score0])
    drawn = cv2.imread(out)
    if drawn is None or drawn.shape != cv2.imread(landscape[0]).shape:
        fail(f'image demo: {out} not written at the image\'s size')
    print(f'image demo: {len(result["bboxes"])} detections; {out}: '
          f'{os.path.getsize(out)} bytes, shape {drawn.shape}')

    # 2. the video demos, frame by frame
    video = write_video(os.path.join(work_dir, 'frames.avi'), landscape,
                        VIDEO_FRAMES)
    plain, plain_rate = load_script('demo/video_demo_torch.py').main([
        video, CONFIG, files_checkpoint, '--out',
        os.path.join(work_dir, 'plain.avi'), '--score-thr', '0',
        '--device', device, *score0])
    accel, accel_rate = load_script('demo/video_accel_demo_torch.py').main([
        video, CONFIG, files_checkpoint, '--out',
        os.path.join(work_dir, 'accel.avi'), '--batch', str(VIDEO_BATCH),
        '--score-thr', '0', '--device', device, *score0])
    model, cfg = init_detector(load_config(CONFIG, score0[1:]),
                               files_checkpoint, device=device)
    worst = check_demo_frames(plain, accel, model, cfg, video)
    print(f'video demos over {VIDEO_FRAMES} frames of {drawn.shape[0]}x'
          f'{drawn.shape[1]} ({sum(len(r["labels"]) for r in plain)} '
          f'detections): batch 1 {plain_rate:.3f} frames/s, batch '
          f'{VIDEO_BATCH} {accel_rate:.3f} frames/s (decode, predict, '
          f'format, draw, encode); paired boxes within {worst["box"]:.3g} '
          f'px and scores within rtol {worst["score"]:.3g} (in place within '
          f'{worst["place"]:.3g}; neighbouring batch-1 scores at least '
          f'{worst["gap"]:.3g} apart), {worst["moved"]} '
          f'pairs out of place and {worst["stand_in"]} stand-ins among '
          f'tied scores, masks equal but {worst["off"]} pixels, each within '
          f'{worst["near"]:.3g} of the threshold')
    del plain, accel, model

    # 3. BoxInst from the slice's checkpoint, evaluated as the eval phase;
    # 4. Box2Mask R-50, Swin-L and DiscoBox R-50 from seed 0 (DiscoBox
    # under its fp16 key, exported in fp32: against eager fp32 predict)
    export = load_script('tools/deployment/export_model_torch.py')
    gen = torch.Generator(device=device).manual_seed(0)
    counters = {'msda_forward': 'kernel.msda_forward',
                'swin_attention_forward': 'kernel.window_attention_forward'}
    params = {}
    for name, config, ckpt, opts in (
            ('boxinst', CONFIG, [checkpoint], EVAL_OPTS),
            ('box2mask', B2M_CONFIG, [], ()), ('swin-l', SWIN_CONFIG, [], ()),
            ('discobox', DISCO_CONFIG, [], ())):
        h, w = canvases.get(config, BOXINST_CANVAS
                            if config in (CONFIG, DISCO_CONFIG)
                            else B2M_CANVAS)
        pt2 = os.path.join(work_dir, f'{name}.pt2')
        res = export.main([config, *ckpt, '--output-file', pt2, '--shape',
                           str(h), str(w), '--batch', '1', '--device', device,
                           *cfg_options(*opts, *narrow.get(config, ()))])
        model = res['model']
        params[name] = sum(p.numel() for p in model.parameters())
        want_ops = {}
        if getattr(model, 'panoptic_head', None) is not None:
            want_ops['msda_forward'] = len(
                model.panoptic_head.pixel_decoder.encoder.layers)
        if hasattr(model.backbone, 'stages'):
            want_ops['window_attention'] = sum(
                len(stage.blocks) for stage in model.backbone.stages)
        if res['ops'] != want_ops:
            fail(f'{name}: the graph holds {res["ops"]}, not {want_ops}')
        loaded = ExportedDetector(torch.export.load(pt2))
        batch = dict(image=torch.randn((1, 3, h, w), generator=gen,
                                       device=device),
                     img_shape=torch.tensor([[h, w]], dtype=torch.int32,
                                            device=device),
                     scale_factor=torch.ones((1, 4), device=device))
        with launches_of(counters) as launches, torch.inference_mode():
            got = loaded.predict(batch)
            if device == 'cuda':
                torch.cuda.synchronize()
        if device == 'cuda' and (
                launches['msda_forward'] != want_ops.get('msda_forward', 0)
                or launches['swin_attention_forward']
                != want_ops.get('window_attention', 0)):
            fail(f'{name}: the loaded program launched {launches}')
        with torch.inference_mode():
            want = model.predict(batch)
        if set(got) != set(want):
            fail(f'{name}: outputs {sorted(got)} vs {sorted(want)}')
        diffs = {k: check_close(f'{name} {k}', got[k], want[k])
                 for k in want}
        if name == 'discobox' and load_config(config).get('fp16') is None:
            fail('the DiscoBox config lost its fp16 key')
        print(f'{name} exported in {res["seconds"]:.3f} s at {h}x{w}, batch '
              f'1 ({res["bytes"] / 1e6:.3f} MB .pt2): boxinstseg ops '
              f'{res["ops"] or "none"}; launches while the loaded program '
              f'ran {launches}; against eager on a random image, max abs '
              f'diff ' + ', '.join(f'{k} {v:.3g}' for k, v in diffs.items()))
        del res, model, got, want
        if name == 'boxinst':
            register_dataset()
            metrics = load_script('tools/deployment/test_torch.py').main([
                CONFIG, pt2, '--shape', str(h), str(w), '--batch', '1',
                '--eval', 'bbox', 'segm', '--device', device,
                '--cfg-options', *EVAL_OPTS,
                f'data.test.length={EVAL_IMAGES}', *narrow.get(CONFIG, ())])
            if metrics != eval_metrics:
                fail(f'the exported BoxInst reads {metrics}, the eval phase '
                     f'{eval_metrics}')
            print(f'tools/deployment/test_torch.py on the eval phase\'s '
                  f'{EVAL_IMAGES} images: the eval phase\'s metrics (bbox '
                  f'mAP {metrics["bbox_mAP"]}, segm mAP '
                  f'{metrics["segm_mAP"]})')
        del loaded
        os.remove(pt2)

    # 5. the benchmark tool and 6. the FLOPs tool
    bench = load_script('tools/analysis_tools/benchmark_torch.py')
    timing = ['--iters', str(BENCH_ITERS), '--device', device]
    b2m_h, b2m_w = canvases.get(B2M_CONFIG, B2M_CANVAS)
    for config, extra in (
            (CONFIG, ['--height', str(boxinst_canvas[0]), '--width',
                      str(boxinst_canvas[1])]),
            (B2M_CONFIG, ['--height', str(b2m_h), '--width', str(b2m_w)]),
            (CONFIG, ['--train', '--batch-size', '2', '--height',
                      str(boxinst_canvas[0]), '--width',
                      str(boxinst_canvas[1])])):
        print(f'benchmark_torch {os.path.basename(config)}:', flush=True)
        bench.main([config, *extra, *timing,
                    *cfg_options(*narrow.get(config, ()))])
    flops = load_script('tools/analysis_tools/get_flops_torch.py')
    for name, config in (('boxinst', CONFIG), ('box2mask', B2M_CONFIG),
                         ('swin-l', SWIN_CONFIG)):
        h, w = canvases.get(config, BOXINST_CANVAS if config == CONFIG
                            else B2M_CANVAS)
        print(f'get_flops_torch {os.path.basename(config)}:', flush=True)
        out = flops.main([config, '--shape', str(h), str(w), '--device',
                          device, *cfg_options(*narrow.get(config, ()))])
        if out['params'] != params[name]:
            fail(f'{name}: get_flops_torch counts {out["params"]} '
                 f'parameters, the exported model has {params[name]}')
    release_cache()


# ---------------------------------------------------------------- LSA

@contextlib.contextmanager
def no_scipy_lsa():
    """scipy's linear_sum_assignment raises within: the Box2Mask phases
    must solve their Hungarian match on the card."""
    import scipy.optimize

    def refuse(*args, **kwargs):
        raise AssertionError('scipy.optimize.linear_sum_assignment called '
                             'on the Box2Mask path')
    saved = scipy.optimize.linear_sum_assignment
    scipy.optimize.linear_sum_assignment = refuse
    try:
        yield
    finally:
        scipy.optimize.linear_sum_assignment = saved


@contextlib.contextmanager
def capture_lsa_inputs(kept):
    """Keep the last Hungarian match's LSA inputs (cost, n_rows) in
    ``kept`` (references, no copies)."""
    from boxinstseg_tpu_torch.core.targets import hungarian
    inner = hungarian.solve_lsa

    def recorded(cost, n_rows=None):
        kept['cost'], kept['n_rows'] = cost, n_rows
        return inner(cost, n_rows)
    hungarian.solve_lsa = recorded
    try:
        yield
    finally:
        hungarian.solve_lsa = inner


def lsa_cases(b2m, gen):
    """The LSA kernel's input sets: the Box2Mask R-50 step's own costs
    with their live counts; a crowded full capacity (20, 100, 100), every
    row live; integer costs 0-3 (many exact ties), every row live."""
    import torch
    p = LSA_PROBLEMS
    crowded = torch.randn((p, 100, 100), generator=gen, device='cuda') * 3
    tied = torch.randint(0, 4, (p, 100, 100), generator=gen,
                         device='cuda').float()
    full = torch.full((p,), 100, dtype=torch.int32, device='cuda')
    return {'box2mask r-50 step': (b2m['cost'], b2m['n_rows']),
            'crowded 100x100': (crowded, full),
            'tied integers': (tied, full)}


def scipy_lsa(cost, n_rows):
    """The yardstick: the costs to the host, one scipy solve a problem on
    its live rows, the assignment back to the card."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment
    c = cost.cpu().numpy()
    rows = n_rows.cpu().numpy()
    out = np.zeros(c.shape[:2], np.int64)
    for i, k in enumerate(rows):
        if k:
            r, cols = linear_sum_assignment(c[i, :k])
            out[i, r] = cols
    return torch.from_numpy(out).to(cost.device)


def host_ms(fn, iters=20):
    """Host clock over ``iters`` calls after 3, ending in a device sync."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def phase_lsa_kernel(b2m, launches_a_step):
    """The LSA kernel against its plain version on each input set,
    assignments and step counts equal element for element; its time, the
    plain version's and the scipy path's in turns at the Box2Mask inputs,
    and the bound. Returns the report line's fields."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment
    from boxinstseg_tpu_torch.ops import lsa
    gen = torch.Generator(device='cuda').manual_seed(7)
    report = None
    for name, (cost, n_rows) in lsa_cases(b2m, gen).items():
        p, n, m = cost.shape
        steps = torch.zeros((p,), dtype=torch.int32, device='cuda')
        got = lsa.solve_lsa_cuda(cost, n_rows, steps)
        torch.cuda.synchronize()
        want, want_steps = lsa.solve_lsa_plain(cost.cpu(), n_rows.cpu(),
                                               return_steps=True)
        if not torch.equal(got.cpu(), want):
            bad = int((got.cpu() != want).sum())
            fail(f'lsa kernel, {name}: {bad} assignments differ from the '
                 f'plain version')
        if not torch.equal(steps.cpu().long(), want_steps):
            fail(f'lsa kernel, {name}: step counts differ from the plain '
                 f'version')
        rows = n_rows.cpu().numpy()
        ties = 0
        for i, k in enumerate(rows):
            c = cost[i, :k].cpu().numpy()
            r, cc = linear_sum_assignment(c)
            opt = c[r, cc].astype(np.float64).sum()
            tot = c[np.arange(k), want[i, :k].numpy()].astype(
                np.float64).sum()
            if abs(tot - opt) > 1e-6 * max(abs(opt), 1.0):
                fail(f'lsa kernel, {name}: problem {i} costs {tot}, '
                     f'scipy {opt}')
            ties += int((want[i, :k].numpy() != cc).any())
        ms = cuda_ms(lambda: lsa.solve_lsa_cuda(cost, n_rows))
        total = int(want_steps.sum())
        # bytes: the cost and the counts read once, col4row written once;
        # operations: the relaxation's two subtractions and the slack's
        # update, a column a step, over the steps these inputs took
        b = bound(nbytes(cost, n_rows) + p * n * 8, 3 * m * total)
        print(f'lsa kernel, {name}: ({p}, {n}, {m}), live rows '
              f'{int(rows.sum())} ({int(rows.min())}-{int(rows.max())}), '
              f'equal to the plain version (assignments and steps); '
              f'augmenting steps {total} in all, {int(want_steps.max())} in '
              f'the longest problem (serial); {ties} problems where scipy '
              f'picks another optimum; {ms:.4f} ms, bound {b["bound_ms"]:.6f}'
              f' ms ({b["bound_by"]})')
        if report is None:
            plain_ms = cuda_ms(lambda: lsa.solve_lsa_plain(cost, n_rows),
                               iters=3)
            turns = [host_ms(lambda: lsa.solve_lsa_cuda(cost, n_rows)),
                     host_ms(lambda: scipy_lsa(cost, n_rows)),
                     host_ms(lambda: scipy_lsa(cost, n_rows)),
                     host_ms(lambda: lsa.solve_lsa_cuda(cost, n_rows))]
            print(f'lsa kernel, {name}: in turns (host clock, 20 calls '
                  f'each, ending in a sync): kernel {turns[0]:.4f}, scipy '
                  f'path (copy, host solve, copy back) {turns[1]:.4f}, '
                  f'{turns[2]:.4f}, kernel {turns[3]:.4f} ms; the plain '
                  f'version on the card {plain_ms:.3f} ms')
            report = dict(
                name='lsa_solve', route='cuda',
                source='boxinstseg_tpu_torch/csrc/lsa.cu',
                replaces='boxinstseg_tpu/ops/lsa.py:24 solve_lsa (not a '
                         'pl.pallas_call)',
                launches_a_step=launches_a_step, max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, **b, scipy_ms=min(turns[1], turns[2]),
                kernel_host_ms=min(turns[0], turns[3]), steps=total,
                serial_steps=int(want_steps.max()))
    return report


# ---------------------------------------------------------------- MST

MST_TIES = (8, 96, 96)         # Swin-T's batch 4: 2 x 4 trees of tf_size
MST_RANDOM = (4, 96, 96)
MST_CAP = 64                   # a depth cap that binds on every tree


@contextlib.contextmanager
def capture_mst_inputs(kept):
    """Keep the last tree filter's grid MST inputs (w_right, w_down,
    max_depth) in ``kept`` (references, no copies)."""
    from boxinstseg_tpu_torch.ops import tree_filter
    inner = tree_filter.grid_mst

    def recorded(w_right, w_down, max_depth):
        kept['w_right'], kept['w_down'] = w_right, w_down
        kept['max_depth'] = max_depth
        return inner(w_right, w_down, max_depth)
    tree_filter.grid_mst = recorded
    try:
        yield
    finally:
        tree_filter.grid_mst = inner


def flat_block_weights(shape, gen):
    """Squared-difference edge weights of ``shape`` (B, H, W) trees over a
    guide of flat 3x3 colour blocks from 3 levels: most weights are 0 or
    repeat exactly, so the tree rests on the (weight, edge index) order."""
    import torch
    b, h, w = shape
    g = torch.randint(0, 3, (b, h // 3 + 1, w // 3 + 1, 3), generator=gen,
                      device='cuda').float() * 0.5
    g = g.repeat_interleave(3, 1).repeat_interleave(3, 2)[:, :h, :w]
    return (((g[:, :, 1:] - g[:, :, :-1]) ** 2).sum(-1),
            ((g[:, 1:] - g[:, :-1]) ** 2).sum(-1))


def mst_cases(b2m, boxls, gen):
    """The MST kernel's input sets: the Box2Mask R-50 and BoxLevelset R-50
    steps' own weights with their depth caps (none binds: H x W); flat-block
    ties at Swin-T's 8 trees; distinct random weights under a binding cap."""
    import torch
    b, h, w = MST_RANDOM
    return {'box2mask r-50 step': (b2m['w_right'], b2m['w_down'],
                                   b2m['max_depth']),
            'boxlevelset r-50 step': (boxls['w_right'], boxls['w_down'],
                                      boxls['max_depth']),
            f'flat-block ties {MST_TIES}': (
                *flat_block_weights(MST_TIES, gen),
                MST_TIES[1] * MST_TIES[2]),
            f'distinct random {MST_RANDOM}, cap {MST_CAP}': (
                torch.rand((b, h, w - 1), generator=gen, device='cuda'),
                torch.rand((b, h - 1, w), generator=gen, device='cuda'),
                MST_CAP)}


def phase_mst_kernel(b2m, boxls, launches_a_step):
    """The grid MST kernel against its plain version on the card and
    scipy's MST on the host (tests/mst_witness.py), parent and depth equal
    element for element on each input set; its time, the bound, the plain
    version's time and, in turns with the kernel, the host path's (copy,
    scipy, copy back) at the two steps' inputs. Returns the report line's
    fields."""
    import torch
    from boxinstseg_tpu_torch.ops import mst
    witness = load_script('tests/mst_witness.py')
    gen = torch.Generator(device='cuda').manual_seed(13)
    report = {}
    for name, (wr, wd, md) in mst_cases(b2m, boxls, gen).items():
        b, h, wm1 = wr.shape
        n = h * (wm1 + 1)
        stats = torch.zeros((b, 2), dtype=torch.int32, device='cuda')
        got = mst.grid_mst_cuda(wr, wd, md, stats)
        plain = mst.grid_mst_plain(wr, wd, md)
        host = witness.host_grid_mst(wr, wd, md)
        torch.cuda.synchronize()
        for what, want in (('the plain version on the card', plain),
                           ('scipy\'s MST', host)):
            for i, part in enumerate(('parent', 'depth')):
                if not torch.equal(got[i], want[i]):
                    bad = int((got[i] != want[i]).sum())
                    fail(f'mst kernel, {name}: {bad} of {got[i].numel()} '
                         f'{part} entries differ from {what}')
        rounds, levels = stats[:, 0].tolist(), stats[:, 1].tolist()
        if levels != plain[1].max(dim=1).values.tolist():
            fail(f'mst kernel, {name}: BFS levels {levels}, tree heights '
                 f'{plain[1].max(dim=1).values.tolist()}')
        detached = int(((plain[0] == torch.arange(n, device='cuda'))
                        .sum() - b))
        ms = cuda_ms(lambda: mst.grid_mst_cuda(wr, wd, md))
        e = wr[0].numel() + wd[0].numel()
        # bytes: the weights read once, parent and depth written once;
        # operations: a round compares the labels of every edge and hooks
        # and jumps every node; the BFS visits every node once
        b_ms = bound(nbytes(wr, wd) + 2 * b * n * 8,
                     sum(r * (e + 2 * n) + n for r in rounds))
        ties = (wr == 0).float().mean().item()
        print(f'mst kernel, {name}: {b} trees of {h}x{wm1 + 1}, depth cap '
              f'{md}, {100 * ties:.1f}% of right weights 0; parent and '
              f'depth equal to the plain version on the card and to '
              f'scipy\'s MST; Boruvka rounds {rounds}, BFS levels {levels}, '
              f'{detached} nodes past the cap; {ms:.4f} ms, bound '
              f'{b_ms["bound_ms"]:.6f} ms ({b_ms["bound_by"]})')
        if len(report) < 2:
            plain_ms = cuda_ms(lambda: mst.grid_mst_plain(wr, wd, md),
                               iters=3)
            turns = [cuda_ms(lambda: mst.grid_mst_cuda(wr, wd, md)),
                     cuda_ms(lambda: witness.host_grid_mst(wr, wd, md),
                             iters=10),
                     cuda_ms(lambda: witness.host_grid_mst(wr, wd, md),
                             iters=10),
                     cuda_ms(lambda: mst.grid_mst_cuda(wr, wd, md))]
            print(f'mst kernel, {name}: in turns (CUDA events): kernel '
                  f'{turns[0]:.4f}, host path (copy, scipy, copy back) '
                  f'{turns[1]:.4f}, {turns[2]:.4f}, kernel {turns[3]:.4f} '
                  f'ms; the plain version on the card {plain_ms:.3f} ms')
            key = name.split(' ')[0]
            report[key] = dict(ms=ms, plain_ms=plain_ms, **b_ms,
                               host_ms=min(turns[1], turns[2]),
                               kernel_turns_ms=min(turns[0], turns[3]),
                               rounds=rounds, levels=levels)
    main = report['box2mask']
    return dict(name='grid_mst', route='cuda',
                source='boxinstseg_tpu_torch/csrc/mst.cu',
                replaces='boxinstseg_tpu/ops/mst.py:501 grid_mst_device '
                         '(not a pl.pallas_call)',
                launches_a_step=launches_a_step, max_abs_err=0.0,
                ms=main['ms'], plain_ms=main['plain_ms'],
                bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                library_ms=None, host_ms=main['host_ms'], sets=report)


# ---------------------------------------------------------------- zoo

# RetinaNet R-50 at 800x1344: strides 8-128, 3 ratios x 3 octave scales
RETINA_SIZES = ((100, 168), (50, 84), (25, 42), (13, 21), (7, 11))
ZOO_GTS = 100                       # GT slots an image
ZOO_LIVE = 23                       # live GTs an image


class ZooCheck:
    """Runs a function on the card and on the CPU from the same inputs
    (CPU tensors moved), checks the outputs within atol x max(1,
    max |cpu|) + REF_RTOL x |cpu| (integer and boolean outputs equal), and
    prints the model, shape, card ms and worst error. atol is REF_ATOL,
    or KERNEL_ATOL for a full-width stack of long fp32 sums (a 3x3 conv
    over 256 channels sums 2,304 products, in another order on the card:
    the MaskFormer pixel decoders differ by up to ~4e-6 at max |cpu| ~2)."""

    def __init__(self):
        self.worst = {}

    def __call__(self, model, what, fn, *args, timed=True, atol=REF_ATOL,
                 **kwargs):
        import torch

        def move(a, dev):
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            if isinstance(a, (list, tuple)):
                return type(a)(move(x, dev) for x in a)
            return a
        cpu = fn(*args, **kwargs)
        cargs, ckw = move(args, 'cuda'), {k: move(v, 'cuda')
                                          for k, v in kwargs.items()}
        card = fn(*cargs, **ckw)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: fn(*cargs, **ckw), iters=3) if timed else None
        worst = 0.0
        for i, (g, w) in enumerate(zip(self.flat(card), self.flat(cpu))):
            g = g.detach().cpu()
            w = w.detach()
            if g.shape != w.shape:
                fail(f'zoo, {what}: output {i} {tuple(g.shape)} on the card, '
                     f'{tuple(w.shape)} on the CPU')
            if not w.is_floating_point():
                if not torch.equal(g, w):
                    fail(f'zoo, {what}: integer output {i} differs at '
                         f'{int((g != w).sum())} of {w.numel()} places')
                continue
            ref = max(w.abs().max().item() if w.numel() else 0.0, 1.0)
            diff = (g - w).abs()
            if not bool((diff <= atol * ref + REF_RTOL * w.abs()).all()):
                fail(f'zoo, {what}: output {i} differs by '
                     f'{diff.max().item()} (max |cpu| {ref}, atol {atol} x '
                     f'max(1, max |cpu|))')
            if w.numel():
                worst = max(worst, diff.max().item() / ref)
        self.worst[what] = worst
        print(f'zoo: {model}, {what}: ' + (f'{ms:.3f} ms, ' if timed else '')
              + f'worst error / max(1, max |cpu|) {worst:.3g}'
              + (f' (atol {atol:g})' if atol != REF_ATOL else ''),
              flush=True)
        return cpu

    @staticmethod
    def flat(x):
        import torch
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in ZooCheck.flat(x[k])]
        if isinstance(x, (list, tuple)):
            return [v for a in x for v in ZooCheck.flat(a)]
        return []


def zoo_boxes(gen, n, w=1344.0, h=800.0, max_wh=400.0):
    import torch
    xy = torch.rand((n, 2), generator=gen) * torch.tensor([w, h])
    wh = torch.rand((n, 2), generator=gen) * max_wh + 8
    return torch.cat([xy, xy + wh], 1)


def zoo_gts(gen, anchors, k=ZOO_GTS, live=ZOO_LIVE):
    """k GT slots, the first ``live`` valid: jittered anchors (so that
    some anchors overlap them well), labels in 0-79."""
    import torch
    idx = torch.randint(0, anchors.shape[0], (k,), generator=gen)
    g = anchors[idx] + torch.randn((k, 4), generator=gen) * 4
    valid = torch.arange(k) < live
    return g, valid, torch.randint(0, 80, (k,), generator=gen)


def zoo_anchors_and_assigners(check, gen):
    import torch
    from boxinstseg_tpu_torch.core.targets import assigner_zoo as Z
    from boxinstseg_tpu_torch.core.targets import assigners as A
    from boxinstseg_tpu_torch.registry import PRIOR_GENERATORS
    retina = PRIOR_GENERATORS.build(dict(
        type='AnchorGenerator', octave_base_scale=4, scales_per_octave=3,
        ratios=[0.5, 1.0, 2.0], strides=[8, 16, 32, 64, 128]))

    def grid(gen_, sizes, pad, device='cpu'):
        return (gen_.grid_priors(sizes, device=device),
                gen_.valid_flags(sizes, pad, device=device))
    priors = check('RetinaNet R-50', 'anchors at 800x1344 (5 levels x 9)',
                   lambda dev_probe: grid(retina, RETINA_SIZES, (800, 1333),
                                          dev_probe.device),
                   torch.zeros(1))
    anchors = torch.cat(priors[0])
    if anchors.shape[0] != 201600:
        fail(f'RetinaNet anchors: {anchors.shape[0]}, expected 201,600')
    ssd = PRIOR_GENERATORS.build(dict(
        type='SSDAnchorGenerator', scale_major=False, input_size=300,
        basesize_ratio_range=(0.15, 0.9), strides=[8, 16, 32, 64, 100, 300],
        ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]]))
    check('SSD300', 'anchors (6 levels, 8,732)',
          lambda probe: grid(ssd, ((38, 38), (19, 19), (10, 10), (5, 5),
                                   (3, 3), (1, 1)), (300, 300),
                             probe.device), torch.zeros(1))
    yolo = PRIOR_GENERATORS.build(dict(
        type='YOLOAnchorGenerator', strides=[32, 16, 8],
        base_sizes=[[(116, 90), (156, 198), (373, 326)],
                    [(30, 61), (62, 45), (59, 119)],
                    [(10, 13), (16, 30), (33, 23)]]))
    yolo_sizes = ((19, 19), (38, 38), (76, 76))
    yg = zoo_boxes(gen, 40, 608, 608, 200)
    check('YOLOv3-608', 'anchors and responsible flags (3 levels, 22,743)',
          lambda b: (grid(yolo, yolo_sizes, (608, 608), b.device),
                     yolo.responsible_flags(yolo_sizes, b)), yg)
    # max IoU at batch 2 against 100 GT slots (80.6 MB of overlaps an
    # image), then the RPN sampler's 256 from them
    for img in range(2):
        g, valid, labels = zoo_gts(gen, anchors)
        assigned, _, _ = check(
            'RetinaNet R-50', f'max_iou_assign image {img} (201,600 x 100)',
            A.max_iou_assign, anchors, g, valid, 0.5, 0.4, 0.0,
            gt_labels=labels)
    noise = torch.rand((2, anchors.shape[0]), generator=gen)
    check('RPN R-50', 'random_sample 256 of 201,600', A.random_sample,
          assigned, 256, 0.5, noise=tuple(noise))
    # ATSS / TOOD: one anchor a location, 22,400
    atss_gen = PRIOR_GENERATORS.build(dict(
        type='AnchorGenerator', ratios=[1.0], octave_base_scale=8,
        scales_per_octave=1, strides=[8, 16, 32, 64, 128]))
    a1 = torch.cat(atss_gen.grid_priors(RETINA_SIZES, device='cpu'))
    levels = [h * w for h, w in RETINA_SIZES]
    g, valid, labels = zoo_gts(gen, a1)
    check('ATSS R-50', 'atss_assign (22,400 x 100)', Z.atss_assign, a1,
          levels, g, valid, 9, gt_labels=labels)
    scores = torch.rand((a1.shape[0], 80), generator=gen)
    dec = a1 + torch.randn(a1.shape, generator=gen) * 8
    check('TOOD R-50', 'task_aligned_assign (22,400 x 100, 80 classes)',
          Z.task_aligned_assign, scores, dec, a1, g, valid, labels)
    # SimOTA at YOLOX-s 640x640: 8,400 points, 80 classes
    pts = []
    for s in (8, 16, 32):
        n = 640 // s
        yy, xx = torch.meshgrid(torch.arange(n), torch.arange(n),
                                indexing='ij')
        pts.append(torch.stack([xx.reshape(-1) * s, yy.reshape(-1) * s,
                                torch.full((n * n,), s),
                                torch.full((n * n,), s)], 1).float())
    pts = torch.cat(pts)
    g, valid, labels = zoo_gts(gen, torch.cat([pts[:, :2] - 20,
                                               pts[:, :2] + 40], 1))
    dec = torch.cat([pts[:, :2] - 16, pts[:, :2] + 16], 1) + torch.randn(
        (pts.shape[0], 4), generator=gen) * 4
    check('YOLOX-s', 'sim_ota_assign (8,400 x 100, 80 classes)',
          Z.sim_ota_assign, torch.rand((8400, 80), generator=gen), pts, dec,
          g, valid, labels)
    # DETR: 100 queries x 100 slots through the LSA kernel
    q = 100
    pred = torch.rand((q, 4), generator=gen) * 0.5 + 0.2
    g = zoo_boxes(gen, 100, 1333, 800, 300)
    valid = torch.arange(100) < 37
    check('DETR R-50', 'hungarian_bbox_assign (100 queries x 100 slots)',
          Z.hungarian_bbox_assign, pred, torch.randn((q, 80), generator=gen),
          g, valid, torch.randint(0, 80, (100,), generator=gen), (800, 1333))


def zoo_samplers(check, gen):
    """R-CNN's 512 of 2,000 proposals (and the GTs) a sampler."""
    import torch
    from boxinstseg_tpu_torch.core.targets import samplers as S
    n = 2000
    assigned = torch.where(torch.rand(n, generator=gen) < 0.1,
                           torch.randint(1, 24, (n,), generator=gen),
                           torch.randint(-1, 1, (n,), generator=gen))
    ov = torch.rand(n, generator=gen) * 0.5
    u = tuple(torch.rand((5, n), generator=gen))
    check('Libra R-CNN R-50', 'instance_balanced_pos_sample 128 of 2,000',
          S.instance_balanced_pos_sample, assigned, 128, max_gts=100,
          noise=u[:3])
    check('Libra R-CNN R-50', 'iou_balanced_neg_sample 384 of 2,000',
          S.iou_balanced_neg_sample, assigned, ov, 384, 0.0, 0.5,
          noise=u)
    check('Libra R-CNN R-50', 'combined_sample 512 of 2,000',
          S.combined_sample, assigned, ov, 512, 0.25,
          noise=(u[:3], u))
    check('Faster R-CNN OHEM', 'ohem_sample 512 of 2,000', S.ohem_sample,
          assigned, torch.rand(n, generator=gen), 512, 0.25)
    pred = zoo_boxes(gen, 200, max_wh=200).repeat(10, 1) + torch.randn(
        (n, 4), generator=gen) * 6
    check('PISA Faster R-CNN', 'score_hlr_neg_sample 512 of 2,000',
          S.score_hlr_neg_sample, assigned, torch.rand(n, generator=gen),
          pred, 512, ori_loss=torch.rand(n, generator=gen), noise=u[:2],
          timed=False)


def zoo_losses(check, gen):
    import torch
    from boxinstseg_tpu_torch.models import losses as L
    from boxinstseg_tpu_torch.registry import LOSSES
    n = 44800                        # 22,400 locations x batch 2
    logits = torch.randn((n, 80), generator=gen) * 2
    iou_t = torch.where(torch.rand((n, 80), generator=gen) > 0.99,
                        torch.rand((n, 80), generator=gen),
                        torch.zeros(n, 80))
    label = torch.randint(0, 81, (n,), generator=gen)
    score = torch.rand(n, generator=gen)
    heat = torch.rand((n, 80), generator=gen) ** 4
    lw = (torch.rand((n, 80), generator=gen) > 0.05).float()

    def loss_and_grad(fn):
        def run(x, *rest):
            x = x.detach().requires_grad_()
            v = fn(x, *rest)
            g, = torch.autograd.grad(v, x)
            return v.detach(), g
        return run
    for name, cfg, args in (
            ('VarifocalLoss', {}, (iou_t,)),
            ('QualityFocalLoss', {}, ((label, score),)),
            ('GHMC', {}, ((iou_t > 0).float(), lw)),
            ('KnowledgeDistillationKLDivLoss', dict(T=2),
             (torch.randn((n, 80), generator=gen),))):
        check('GFL / VFNet / GHM / LD R-50', f'{name} on ({n}, 80)',
              loss_and_grad(LOSSES.build(dict(type=name, **cfg))), logits,
              *args)
    check('CenterNet', f'GaussianFocalLoss on ({n}, 80)',
          loss_and_grad(LOSSES.build(dict(type='GaussianFocalLoss'))),
          torch.sigmoid(logits), heat)
    tgt = zoo_boxes(gen, n)
    pred = tgt + torch.randn((n, 4), generator=gen) * 10
    w4 = torch.rand((n, 4), generator=gen)
    for name in ('IoULoss', 'GIoULoss', 'DIoULoss', 'CIoULoss',
                 'BoundedIoULoss', 'L1Loss', 'SmoothL1Loss', 'MSELoss',
                 'BalancedL1Loss'):
        per_box = name in ('IoULoss', 'GIoULoss')
        check('FCOS / ATSS R-50', f'{name} on ({n}, 4)',
              loss_and_grad(lambda p, t, w, _l=LOSSES.build(dict(type=name)):
                            _l(p, t, w, avg_factor=1000.0)),
              pred, tgt, w4.mean(1) if per_box else w4)
    check('GHM RetinaNet', f'GHMR on ({n}, 4)',
          loss_and_grad(LOSSES.build(dict(type='GHMR'))),
          pred / 100, tgt / 100, (w4 > 0.1).float())
    check('GFL R-50', f'DistributionFocalLoss on ({4 * n}, 17)',
          loss_and_grad(LOSSES.build(dict(type='DistributionFocalLoss'))),
          torch.randn((4 * n, 17), generator=gen),
          torch.rand(4 * n, generator=gen) * 15.99)
    # Seesaw at LVIS v1: 1,024 samples, 1,203 classes (+2 objectness)
    seesaw = LOSSES.build(dict(type='SeesawLoss', num_classes=1203))
    labels = torch.randint(0, 1204, (1024,), generator=gen)

    def seesaw_run(s, lab):
        cum = seesaw.update_cum_samples(
            seesaw.init_cum_samples(device=s.device), lab)
        s = s.detach().requires_grad_()
        out = seesaw(s, lab, cum)
        g, = torch.autograd.grad(sum(out.values()), s)
        return cum, out, g
    check('Seesaw Mask R-CNN LVIS', 'SeesawLoss on (1,024, 1,205)',
          seesaw_run, torch.randn((1024, 1205), generator=gen), labels)
    # PISA at (1,024, 81); CE and accuracy on it
    cls = torch.randn((1024, 81), generator=gen)
    lab = torch.randint(0, 81, (1024,), generator=gen)
    deltas = torch.randn((1024, 4), generator=gen) * 0.1
    rois = zoo_boxes(gen, 1024)

    def isr(c, l, d, r, g):
        return L.isr_p(c, d, (l, torch.ones_like(d[:, 0]), d * 0.5,
                              torch.ones_like(d)), r, g,
                       lambda s, y, reduction_override=None:
                       torch.nn.functional.cross_entropy(s, y,
                                                         reduction='none'),
                       lambda r_, d_: r_ + d_, num_class=80)
    check('PISA Faster R-CNN', 'isr_p on (1,024, 81)', isr, cls, lab,
          deltas, rois, torch.randint(0, 20, (1024,), generator=gen))
    check('PISA Faster R-CNN', 'carl_loss on (1,024, 81)',
          loss_and_grad(lambda c, l, d, t: L.carl_loss(
              c, l, d, t, lambda a, b: (a - b).abs(),
              num_class=80)['loss_carl']),
          cls, lab, deltas, deltas * 0.5)
    check('Faster R-CNN', 'CrossEntropyLoss (softmax) on (1,024, 81)',
          loss_and_grad(LOSSES.build(dict(type='CrossEntropyLoss'))),
          cls, lab)
    check('Faster R-CNN', 'accuracy top-1, 5 on (1,024, 81)',
          lambda c, l: L.accuracy(c, l, (1, 5)), cls, lab)
    # CornerNet's associative embedding: 128 x 128 maps, 128 objects
    emb = torch.randn((2, 128, 128, 1), generator=gen)
    match = torch.randint(0, 128, (2, 128, 2, 2), generator=gen)
    mvalid = torch.arange(128)[None].expand(2, 128) < torch.tensor(
        [[37], [90]])
    check('CornerNet HG-104', 'AssociativeEmbeddingLoss (2, 128 objects)',
          lambda a, b, m, v: L.AssociativeEmbeddingLoss()(a, b, m, v),
          emb, torch.randn((2, 128, 128, 1), generator=gen), match, mvalid)


def zoo_modules(check, gen):
    import torch
    from boxinstseg_tpu_torch.models.plugins.dropblock import DropBlock
    from boxinstseg_tpu_torch.models.plugins.pixel_decoder import (
        PixelDecoder, TransformerEncoderPixelDecoder)
    from boxinstseg_tpu_torch.models.utils import bricks as B
    from boxinstseg_tpu_torch.models.utils import gaussian_target as G
    from boxinstseg_tpu_torch.models.utils import point_sample as P
    from boxinstseg_tpu_torch.ops import merge_augs as M

    def forward(module):
        def run(*xs):
            m = module.to(xs[0].device)
            with torch.no_grad():
                return m(list(xs)) if len(xs) > 1 else m(xs[0])
        return run
    # MaskFormer R-50 at 800x1333, batch 2: C2-C5
    feats = [torch.randn((2, c, h, w), generator=gen) for c, (h, w) in zip(
        (256, 512, 1024, 2048), ((200, 334), (100, 167), (50, 84),
                                 (25, 42)))]
    torch.manual_seed(0)
    check('MaskFormer R-50', 'TransformerEncoderPixelDecoder at 800x1333, '
          'batch 2 (6 layers)', forward(TransformerEncoderPixelDecoder(
              num_encoder_layers=6).eval()), *feats, atol=KERNEL_ATOL)
    check('MaskFormer R-50', 'PixelDecoder at 800x1333, batch 2',
          forward(PixelDecoder().eval()), *feats, atol=KERNEL_ATOL)
    # merge_aug_masks: a flip pair of 100 masks at 800x1333
    masks = [torch.randn((100, 1, 800, 1333), generator=gen)
             for _ in range(2)]
    metas = [dict(flip=False), dict(flip=True,
                                    flip_direction='horizontal')]
    check('Mask R-CNN R-50 TTA', 'merge_aug_masks, a flip pair of (100, 1, '
          '800, 1333)', lambda a, b: M.merge_aug_masks([a, b], metas),
          *masks)
    del masks
    props = [torch.cat([zoo_boxes(gen, 1000), torch.rand((1000, 1),
                                                          generator=gen)], 1)
             for _ in range(2)]
    pmetas = [dict(img_shape=(800, 1333), scale_factor=[1.0] * 4,
                   flip=False),
              dict(img_shape=(800, 1333), scale_factor=[1.0] * 4, flip=True)]
    check('RPN R-50 TTA', 'merge_aug_proposals, 2 x 1,000',
          lambda a, b: M.merge_aug_proposals(
              [a, b], pmetas, dict(nms=dict(iou_threshold=0.7),
                                   max_per_img=1000)), *props, timed=False)
    # Mask2Former: 12,544 points on 100 queries' stride-4 masks
    mp = torch.randn((100, 1, 200, 334), generator=gen)
    labels = torch.zeros(100, dtype=torch.long)
    noise = (torch.rand((100, 3 * 12544, 2), generator=gen),
             torch.rand((100, 12544 - int(0.75 * 12544), 2), generator=gen))
    check('Mask2Former R-50', 'get_uncertain_point_coords_with_randomness '
          '(100 queries, 12,544 points)',
          lambda m, l, n0, n1: P.get_uncertain_point_coords_with_randomness(
              m, l, 12544, 3.0, 0.75, noise=(n0, n1)), mp, labels, *noise)
    pts = torch.rand((100, 12544, 2), generator=gen)
    check('Mask2Former R-50', 'point_sample (100, 1, 200, 334) at 12,544',
          P.point_sample, mp, pts)
    # CenterNet R-18 at 512x512: (2, 80, 128, 128)
    centers = torch.rand((2, 20, 2), generator=gen) * 127
    whs = torch.rand((2, 20, 2), generator=gen) * 60 + 4
    cls_ids = torch.randint(0, 80, (2, 20), generator=gen)

    def centernet(c, wh, k):
        heat = torch.zeros((2, 80, 128, 128), device=c.device)
        for b in range(2):
            for i in range(20):
                r = torch.clamp(G.gaussian_radius(
                    (wh[b, i, 1], wh[b, i, 0]), 0.3).floor(), min=0)
                cx, cy = c[b, i].floor()
                heat[b, k[b, i]] = G.gen_gaussian_target(
                    heat[b, k[b, i]], (cx, cy), r)
        peaks = G.get_local_maximum(heat)
        top = G.get_topk_from_heatmap(peaks, 100)
        feat = G.transpose_and_gather_feat(heat[:, :8], top[1])
        return heat, top, feat
    check('CenterNet R-18', 'gaussian targets, local max, top 100 on (2, '
          '80, 128, 128)', centernet, centers, whs, cls_ids, timed=False)
    # DropBlock at ResNet-50 stage 3 of 800x1344: (2, 1024, 50, 84)
    drop = DropBlock(drop_prob=0.1, block_size=7, warmup_iters=0).train()
    x = torch.randn((2, 1024, 50, 84), generator=gen)
    seeds = (torch.rand((2, 1024, 44, 78), generator=gen)
             < float(drop.gamma(50, 84))).float()
    check('DropBlock R-50', 'DropBlock (2, 1024, 50, 84), block 7',
          lambda a, s: drop(a, seeds=s), x, seeds)
    torch.manual_seed(0)
    for model, what, module, shape, atol in (
            ('MobileNetV2 (SSDLite)', 'InvertedResidual 32 -> 32 at 80x80',
             B.InvertedResidual(32, 32, 192, se_ratio=4), (2, 32, 80, 80),
             REF_ATOL),
            ('DyHead ATSS', 'DyReLU 256 at 100x168', B.DyReLU(256),
             (2, 256, 100, 168), REF_ATOL),
            ('SCNet R-50', 'SimplifiedBasicBlock 256 at 14x14',
             B.SimplifiedBasicBlock(256, 256), (512, 256, 14, 14),
             REF_ATOL),
            ('Panoptic FPN R-50', 'ConvUpsample 256 -> 128, 3 layers',
             B.ConvUpsample(256, 128, 3, norm_cfg=dict(type='GN',
                                                       num_groups=32)),
             (2, 256, 25, 42), KERNEL_ATOL),
            ('Seesaw Mask R-CNN LVIS', 'NormedLinear 1,024 -> 1,204',
             B.NormedLinear(1024, 1204), (1024, 1024), REF_ATOL),
            ('RetinaNet (normed head)', 'NormedConv2d 256 -> 720 at 100x168',
             B.NormedConv2d(256, 720, 3), (2, 256, 100, 168), REF_ATOL)):
        check(model, what, forward(module.train()),
              torch.randn(shape, generator=gen), atol=atol)


def phase_zoo():
    """Every module of this slice on the card and on the CPU at the shapes
    of the mmdet model that uses it (ZooCheck)."""
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    check = ZooCheck()
    zoo_anchors_and_assigners(check, gen)
    zoo_samplers(check, gen)
    zoo_losses(check, gen)
    zoo_modules(check, gen)
    print(f'zoo: {len(check.worst)} checks, worst error / max(1, max |cpu|) '
          f'{max(check.worst.values()):.3g}; the phase '
          f'{time.perf_counter() - t0:.1f} s')


LSA_STEP = (20, 8, 100)            # a Box2Mask R-50 step's costs


def loss_op_cases(gen, shapes):
    """(op, arguments, plain version's output, check) for each of the loss
    path's registered ops at ``shapes`` (pairwise, lcm, crf, lsa, mst); the
    check holds the op's output against the plain one at the kernels'
    tolerances."""
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.ops import crf, lcm, lsa, mst
    from boxinstseg_tpu_torch.ops import pairwise as pw
    x, sim, bm, valid = kernel_inputs(shapes['pairwise'], gen)
    num, den = pw.pairwise_num_den_plain(x, sim, bm, valid)
    _, live = pw.pairwise_forward_op(x, sim, bm, valid, 0.3, 3, 2)
    scale = torch.full((1,), 1.0 / max(den.item(), 1.0), device='cuda')
    offs, aff, phi, g = lcm_inputs(shapes['lcm'], gen)
    flat = [v for o in offs for v in o]
    ck = crf_inputs(shapes['crf'], gen, np.random.RandomState(11))
    p, n, m = shapes['lsa']
    cost = torch.rand((p, n, m), generator=gen, device='cuda')
    n_rows = torch.randint(1, n + 1, (p,), generator=gen, device='cuda',
                           dtype=torch.int32)
    wr, wd = flat_block_weights(shapes['mst'], gen)
    md = shapes['mst'][1] * shapes['mst'][2]

    def sums(tag, got, want):
        if abs(got[0].item() - want[0].item()) > VALUE_RTOL * abs(
                want[0].item()) or abs(got[1].item() - want[1].item()) > \
                VALUE_RTOL * want[1].item():
            fail(f'{tag}: (num, den) {got.tolist()} vs plain '
                 f'{[t.item() for t in want]}')
        return abs(got[0].item() - want[0].item())

    def grad(tag, got, want):
        # the gradient at ``scale``: GRAD_ATOL scales with it, as in
        # check_pairwise
        if not torch.allclose(got, want, atol=GRAD_ATOL * scale.item(),
                              rtol=GRAD_RTOL):
            fail(f'{tag}: gradient differs from plain')
        return (got - want).abs().max().item()

    def equal(tag, got, want):
        if not torch.equal(got, want):
            fail(f'{tag}: differs from its plain version')
        return 0.0

    return {
        'pairwise_forward': (
            pw.pairwise_forward_op, (x, sim, bm, valid, 0.3, 3, 2),
            (num, den), lambda tag, out, want: sums(tag, out[0], want)),
        'pairwise_backward': (
            pw.pairwise_backward_op, (x, sim, bm, valid, scale, live, 0.3,
                                      3, 2),
            pw.pairwise_grad_plain(x, sim, bm, valid) * scale, grad),
        'lcm_forward': (lcm.lcm_forward_op, (aff, phi, flat, LCM_ITERS),
                        lcm.lcm_forward_plain(aff, phi, offs, LCM_ITERS),
                        compare),
        'lcm_adjoint': (lcm.lcm_adjoint_op, (aff, g, flat, LCM_ITERS),
                        lcm.lcm_adjoint_plain(aff, g, offs, LCM_ITERS),
                        compare),
        'crf_mean_field': (crf.crf_mean_field_op, (*ck, CRF_ITERS, 3),
                           crf.crf_mean_field_plain(*ck, CRF_ITERS), equal),
        'solve_lsa': (lsa.solve_lsa_op, (cost, n_rows),
                      lsa.solve_lsa_plain(cost, n_rows), equal),
        'grid_mst': (mst.grid_mst_op, (wr, wd, md),
                     mst.grid_mst_plain(wr, wd, md),
                     lambda tag, out, want: max(
                         equal(tag, o, w) for o, w in zip(out, want))),
    }


def phase_ops():
    """The loss path's kernels as registered torch ops on the card:
    ``torch.library.opcheck`` of each op at small shapes; each op against
    its plain version at the main path's shapes (the kernels'
    tolerances), its time through the op beside its wrapper's in turns;
    the small CondInst's forward and loss
    exported on the card (``apis.export.export_loss``), run and
    differentiated, with one K1 and one K2 launch."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    import torch
    from boxinstseg_tpu_torch.apis import export as tex
    from boxinstseg_tpu_torch.ops import crf, lcm, lsa, mst
    from boxinstseg_tpu_torch.ops import pairwise as pw
    from boxinstseg_tpu_torch.registry import build_detector
    gen = torch.Generator(device='cuda').manual_seed(11)
    small = dict(pairwise=(1, 3, 37, 53), lcm=(1, 3, 37, 53),
                 crf=(1, 5, 37, 53), lsa=(3, 4, 6), mst=(2, 9, 11))
    for name, (op, args, _, _) in loss_op_cases(gen, small).items():
        result = torch.library.opcheck(op, args)
        if set(result.values()) != {'SUCCESS'}:
            fail(f'opcheck of boxinstseg::{name} on the card: {result}')
    print('opcheck on the card (schema, autograd registration, fake '
          'against real, AOT dispatch): pairwise_forward, '
          'pairwise_backward, lcm_forward, lcm_adjoint, crf_mean_field, '
          'solve_lsa, grid_mst: every test SUCCESS')

    wrappers = {
        'pairwise_forward': lambda x, s, b, v, *cfg: pw.pairwise_forward_cuda(
            x, s, b, v, *cfg, keep_live=True),
        'pairwise_backward': lambda x, s, b, v, sc, live, *cfg:
            pw.pairwise_grad_cuda(x, s, b, v, sc, *cfg, live=live),
        'lcm_forward': lambda a, p, flat, n: lcm.lcm_forward_cuda(
            a, p, lcm._pairs(flat), n),
        'lcm_adjoint': lambda a, g, flat, n: lcm.lcm_adjoint_cuda(
            a, g, lcm._pairs(flat), n),
        'crf_mean_field': crf.crf_mean_field_cuda,
        'solve_lsa': lsa.solve_lsa_cuda,
        'grid_mst': mst.grid_mst_cuda}
    main = dict(pairwise=MAIN_SHAPE, lcm=LCM_MAIN, crf=CRF_MAIN,
                lsa=LSA_STEP, mst=MST_RANDOM)
    for name, (op, args, want, check) in loss_op_cases(gen, main).items():
        out = op(*args)
        torch.cuda.synchronize()
        key = {'solve_lsa': 'lsa', 'grid_mst': 'mst'}.get(
            name, name.split('_')[0])
        err = check(f'boxinstseg::{name} at {main[key]}', out, want)
        t = [cuda_ms(fn) for fn in (
            lambda: wrappers[name](*args), lambda: op(*args),
            lambda: op(*args), lambda: wrappers[name](*args))]
        print(f'boxinstseg::{name}: equal to its plain version (max abs '
              f'err {err:.3g}); {t[1]:.4f} / {t[2]:.4f} ms through the op, '
              f'{t[0]:.4f} / {t[3]:.4f} ms through its wrapper in turns')

    batch = {k: torch.from_numpy(v).cuda()
             for k, v in reference_batch().items()}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_detector(tiny_cfg()).cuda()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    program = tex.export_loss(model, batch, 50)
    export_s = time.perf_counter() - t0
    ops = tex.count_ops(program)
    if ops != {'pairwise_forward': 1}:
        fail(f'the exported BoxInst loss holds {ops}')
    model.load_state_dict(state)
    before = (COUNTS['kernel.pairwise_forward'],
              COUNTS['kernel.pairwise_backward'])
    got = program.module()(batch)
    sum(v for k, v in got.items() if 'loss' in k).backward()
    torch.cuda.synchronize()
    moved = (COUNTS['kernel.pairwise_forward'] - before[0],
             COUNTS['kernel.pairwise_backward'] - before[1])
    model.load_state_dict(state)
    eager = model.loss(batch, 50)
    for k, v in eager.items():
        if not math.isfinite(got[k].item()) or abs(
                got[k].item() - v.item()) > REF_RTOL * abs(v.item()):
            fail(f'exported {k} {got[k].item()} vs eager {v.item()}')
    if moved != (1, 1):
        fail(f'the exported loss and its backward launched K1 / K2 '
             f'{moved} times')
    print(f'small CondInst forward and loss exported on the card in '
          f'{export_s:.2f} s: ops {ops}; the program and its backward '
          f'launched K1 / K2 {moved[0]} / {moved[1]} times; its losses '
          f'equal eager within rtol {REF_RTOL}: ' + ', '.join(
              f'{k} {got[k].item():.6g}' for k in eager))


# ------------------------------------------------------------- configs

# every shipped config that ran on the card only under options (or not at
# all) before, in this order; each trains CONFIGS_STEPS steps as shipped
# (the runner, the log interval and the synthetic dataset apart) and
# predicts once. Their hand kernels a step follow from the model
# (``config_kernels``).
SHIPPED_UNRUN = (
    'boxinst/boxinst_r101_fpn_1x_coco.py',
    'boxinst/boxinst_r101_fpn_3x_coco.py',
    'boxinst/boxinst_r50_fpn_3x_coco.py',
    'boxinst/boxinst_r50_fpn_3x_voc.py',
    'boxinst/boxinst_r50_fpn_1x_voc.py',
    'boxinst/boxinst_r101_fpn_3x_voc.py',
    'boxlevelset/box_levelset_coco_r101_fpn_3x.py',
    'boxlevelset/box_levelset_voc_r50_fpn_3x.py',
    'boxlevelset/box_levelset_voc_r101_fpn_3x.py',
    'boxlevelset/box_levelset_voc_r50_fpn_1x_640.py',
    'discobox/discobox_solov2_coco_r101_fpn_3x.py',
    'discobox/discobox_solov2_voc_r50_fpn_3x.py',
    'discobox/discobox_solov2_voc_r101_fpn_3x.py',
    'box2mask/box2mask_r101_lsj_8x2_50e_coco.py',
    'box2mask/box2mask_r50_lsj_8x2_50e_voc.py',
    'box2mask/box2mask_r101_lsj_8x2_50e_voc.py',
    'box2mask/box2mask_swin-t-p4-w7-224_lsj_8x2_50e_coco.py')
CONFIGS_STEPS = 2
# the VOC configs that also run end to end through the CLIs, on the files
# phase's JPEGs relabelled into PascalVOCDataset's classes
VOC_CLI = ('boxinst/boxinst_r50_fpn_1x_voc.py',
           'box2mask/box2mask_r50_lsj_8x2_50e_voc.py')


def kernel_counters():
    """Every hand kernel's key in ``utils.profiling.COUNTS`` by the name
    of its launch count."""
    return {'pairwise_forward': 'kernel.pairwise_forward',
            'pairwise_backward': 'kernel.pairwise_backward',
            'msda_forward': 'kernel.msda_forward',
            'msda_backward': 'kernel.msda_backward',
            'lcm_forward': 'kernel.lcm_forward',
            'lcm_adjoint': 'kernel.lcm_adjoint',
            'swin_attention_forward': 'kernel.window_attention_forward',
            'swin_attention_backward': 'kernel.window_attention_backward',
            'crf_mean_field': 'kernel.crf_mean_field',
            'lsa_solve': 'kernel.lsa',
            'grid_mst': 'kernel.grid_mst'}


def config_kernels(cfg):
    """The hand kernels' launches a training step of ``cfg``'s model (the
    rest launch 0 times): BoxInst's pairwise pair; DiscoBox's CRF;
    Box2Mask's MSDA pair (one launch an encoder layer each way), the LCM
    pair, the LSA solve, the grid MST (both trees of every image in one
    launch) and, on a Swin, K5 and K6 once a block; BoxLevelset the grid
    MST."""
    m = cfg.model
    if m.type == 'CondInst':
        return {'pairwise_forward': 1, 'pairwise_backward': 1}
    if m.type in ('DiscoBoxSOLOv2', 'SingleStageWSInsTSDetector'):
        return {'crf_mean_field': 1}
    if 'panoptic_head' in m:
        layers = m.panoptic_head.pixel_decoder.num_encoder_layers
        out = {'msda_forward': layers, 'msda_backward': layers,
               'lcm_forward': 1, 'lcm_adjoint': 1, 'lsa_solve': 1,
               'grid_mst': 1}
        if m.backbone.type == 'SwinTransformer':
            blocks = sum(m.backbone.depths)
            out.update(swin_attention_forward=blocks,
                       swin_attention_backward=blocks)
        return out
    if m.type == 'BoxLevelSet':
        return {'grid_mst': 1}
    return {}


def model_classes(cfg):
    head = cfg.model.get('panoptic_head') or cfg.model.bbox_head
    return head.get('num_things_classes') or head.num_classes


def synthetic_size(cfg):
    """(h, w) of the synthetic train images: the largest image the train
    pipeline's Resize gives (its longest side and largest short side), or
    Box2Mask's LSJ crop (1024x1024)."""
    for t in cfg.data.train.pipeline:
        if t['type'] == 'RandomCrop':
            return tuple(t['crop_size'])
    for t in cfg.data.train.pipeline:
        if t['type'] == 'Resize':
            scales = t['img_scale']
            scales = [scales] if isinstance(scales[0], int) else scales
            return (max(min(s) for s in scales), max(max(s) for s in scales))
    fail('no Resize in the train pipeline')


@contextlib.contextmanager
def per_step(counters):
    """Each training step's hand-kernel launches, peak memory and live GT
    count: a snapshot at every step's batch copy (the step before it has
    synced in its log) and one on exit; the counts start at 0."""
    from boxinstseg_tpu_torch.utils.profiling import COUNTS
    import torch
    from boxinstseg_tpu_torch.apis import train
    to_device = train.batch_to_device
    marks, gts, peaks = [], [], []

    def snapshot():
        marks.append({name: COUNTS[key] for name, key in counters.items()})

    def counted(batch, device):
        if marks:
            peaks.append(torch.cuda.max_memory_allocated())
        snapshot()
        torch.cuda.reset_peak_memory_stats()
        gts.append(int(batch['gt_valid'].sum()))
        return to_device(batch, device)
    for key in counters.values():
        COUNTS[key] = 0
    train.batch_to_device = counted
    steps = []
    try:
        yield steps
    finally:
        train.batch_to_device = to_device
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated())
    snapshot()
    for i, gt in enumerate(gts):
        steps.append(dict(gts=gt, peak=peaks[i], launches={
            k: marks[i + 1][k] - marks[i][k] for k in counters}))


def predict_once(cfg, model):
    """``predict_batch`` (the config's precision) on one synthetic image
    at batch 1 on the test canvas, a host batch as ``eval_batcher`` gives
    it: the outputs' shapes, all finite, and the call's ms (host clock,
    the copy to the card included, ending in a device sync); the kernels'
    launches within."""
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.apis.test import predict_batch
    from boxinstseg_tpu_torch.apis.train import apply_precision_policy
    h, w = cfg.canvases[0]
    rng = np.random.RandomState(1)
    img, _ = synthetic_image(rng, h, w)
    mean = np.array(cfg.img_norm_cfg['mean'], np.float32)
    std = np.array(cfg.img_norm_cfg['std'], np.float32)
    x = (img[..., ::-1].astype(np.float32) - mean) / std
    batch = dict(image=x[None], img_shape=np.array([[h, w]], np.int32),
                 scale_factor=np.ones((1, 4), np.float32))
    model.eval()
    with launches_of(kernel_counters()) as launches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = predict_batch(model, batch, apply_precision_policy(cfg))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    for k, v in out.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            fail(f'predict: non-finite {k}')
    return ms, {k: tuple(v.shape) for k, v in out.items()}, {
        k: n for k, n in launches.items() if n}


def phase_configs(tool, work_dir):
    """Each config of SHIPPED_UNRUN at full width and depth from random
    init (seed 0), in its own precision, as shipped but for the runner
    (CONFIGS_STEPS iterations), log_config.interval=1 and the seeded
    synthetic dataset at the train pipeline's size and the config's own
    samples_per_gpu: each step's ms, peak GiB, live GT count and
    hand-kernel launches (which must be ``config_kernels``'), the loss
    dict finite; then one predict at batch 1. Returns the launches summed
    over the phase and each config's step ms."""
    import torch
    from boxinstseg_tpu_torch.apis.train import default_canvases
    register_dataset()
    counters = kernel_counters()
    total = dict.fromkeys(counters, 0)
    summary = {}
    built = []
    build_model = tool.build_model

    def keep(cfg, seed):
        built.append(build_model(cfg, seed))
        return built[-1]
    tool.build_model = keep
    try:
        with no_scipy_lsa():
            for rel in SHIPPED_UNRUN:
                config = os.path.join(ROOT, 'configs', rel)
                name = os.path.basename(rel)[:-3]
                base = tool.load_config(config)
                h, w = synthetic_size(base)
                opts = ['runner.type=IterBasedRunner',
                        f'runner.max_iters={CONFIGS_STEPS}',
                        'log_config.interval=1',
                        'data.train.type=SyntheticBoxDataset',
                        f'data.train.img_h={h}', f'data.train.img_w={w}',
                        f'data.train.num_classes={model_classes(base)}']
                wd = os.path.join(work_dir, f'configs_{name}')
                cfg = tool.load_config(config, opts, wd, 0)
                want = config_kernels(cfg)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with per_step(counters) as steps:
                    result = train_tool(tool, config, wd, 0, opts)
                seconds = time.perf_counter() - t0
                check_history(result, CONFIGS_STEPS)
                model = built[-1]
                del built[:]
                step_ms = [1e3 * (hh['time'] - hh['data_time'])
                           for hh in result.history]
                print(f'{name}: {describe_backbone(cfg.model.backbone)}, '
                      f'{cfg.model.type}, {model_classes(cfg)} classes, '
                      f'batch {cfg.data.samples_per_gpu} '
                      f'at {h}x{w} (canvases '
                      f'{cfg.get("canvases", default_canvases(cfg))}), '
                      f'{cfg.optimizer.type} lr {cfg.optimizer.lr}, '
                      f'precision '
                      f'{"bf16" if cfg.get("fp16") or cfg.get("bf16") else "fp32"}'
                      f'; {seconds:.1f} s with the build')
                for i, (st, ms) in enumerate(zip(steps, step_ms)):
                    got = {k: n for k, n in st['launches'].items() if n}
                    if got != want:
                        fail(f'{name} step {i + 1}: launches {got}, '
                             f'expected {want}')
                    print(f'  step {i + 1}: {ms:.3f} ms, peak '
                          f'{st["peak"] / 2**30:.3f} GiB, {st["gts"]} GTs, '
                          f'launches {got or "none"}')
                    for k, n in st['launches'].items():
                        total[k] += n
                print('  losses at step 2: ' + ', '.join(
                    f'{k} {v:.5f}' for k, v in result.history[-1].items()
                    if k.startswith('loss')))
                ms, shapes, launches = predict_once(cfg, model)
                print(f'  predict at batch 1: {ms:.3f} ms, outputs {shapes}'
                      f', launches {launches or "none"}')
                summary[name] = step_ms
                del model, result
                shutil.rmtree(wd, ignore_errors=True)
                release_cache()
    finally:
        tool.build_model = build_model
    return total, summary


def voc_files(files, root):
    """The files phase's JPEGs with their annotations relabelled into
    PascalVOCDataset's 20 classes, in a cocostyle json under ``root``:
    (ann_file, img_prefix)."""
    from boxinstseg_tpu_torch.data.coco import PascalVOCDataset
    classes = PascalVOCDataset.CLASSES
    with open(files[0]) as f:
        coco = json.load(f)
    for a in coco['annotations']:
        a['category_id'] = (a['category_id'] - 1) % len(classes) + 1
    coco['categories'] = [dict(id=i + 1, name=n)
                          for i, n in enumerate(classes)]
    os.makedirs(root, exist_ok=True)
    ann_file = os.path.join(root, 'voc_cocostyle.json')
    with open(ann_file, 'w') as f:
        json.dump(coco, f)
    return ann_file, files[1]


def phase_voc_cli(tool, work_dir, files):
    """The VOC_CLI configs end to end through the CLIs on the JPEGs as
    PascalVOCDataset: tools/train_torch.py for CONFIGS_STEPS steps (the
    hand kernels of ``config_kernels`` each step), then
    tools/test_torch.py --eval segm at batch 1 on the same images: finite
    metrics."""
    voc = voc_files(files, os.path.join(work_dir, 'voc'))
    for rel in VOC_CLI:
        config = os.path.join(ROOT, 'configs', rel)
        name = os.path.basename(rel)[:-3]
        wd = os.path.join(work_dir, f'voc_{name}')
        opts = ['runner.type=IterBasedRunner',
                f'runner.max_iters={CONFIGS_STEPS}', 'log_config.interval=1',
                *file_opts(voc, 'train')]
        with launches_of(kernel_counters()) as launches:
            result = train_tool(tool, config, wd, 0, opts)
        check_history(result, CONFIGS_STEPS)
        want = {k: n * CONFIGS_STEPS for k, n in config_kernels(
            tool.load_config(config)).items()}
        if {k: n for k, n in launches.items() if n} != want:
            fail(f'{name}: launches {launches}, expected {want}')
        print(f'{name} through tools/train_torch.py on {len(FILE_SHAPES)} '
              f'JPEGs as PascalVOCDataset: step ms ' + ', '.join(
                  f'{1e3 * (h["time"] - h["data_time"]):.3f}'
                  for h in result.history) + '; losses at step 2: ' +
              ', '.join(f'{k} {v:.5f}' for k, v in
                        result.history[-1].items() if k.startswith('loss'))
              + f'; launches {dict((k, n) for k, n in launches.items() if n)}')
        t0 = time.perf_counter()
        metrics = load_tool('test_torch').main([
            config, result.checkpoint, '--device', 'cuda', '--eval', 'segm',
            '--cfg-options', 'data.samples_per_gpu=1',
            *file_opts(voc, 'test')])
        if not metrics or not all(math.isfinite(v)
                                  for v in metrics.values()):
            fail(f'{name}: metrics {metrics}')
        print(f'{name} through tools/test_torch.py --eval segm in '
              f'{time.perf_counter() - t0:.3f} s: segm mAP '
              f'{metrics.get("segm_mAP")}')
        shutil.rmtree(wd, ignore_errors=True)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--cards', type=int, default=1,
                        help='more than 1: only the data-parallel check '
                             'across this many cards (nccl), after the '
                             'build; 1 (the default): every phase')
    parser.add_argument('--cudnn-log', metavar='DIR',
                        help='cuDNN\'s API log (level 3) of each evaluation '
                             'process of the ddp phase, gzipped into DIR')
    args = parser.parse_args(argv)
    global CUDNN_LOG_DIR
    CUDNN_LOG_DIR = args.cudnn_log and os.path.abspath(args.cudnn_log)
    if not os.path.isdir(os.path.join(ROOT, 'boxinstseg_tpu_torch')):
        fail(f'the boxinstseg_tpu_torch package is not beside {__file__}')
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke needs a GPU')
    if torch.cuda.device_count() < args.cards:
        fail(f'--cards {args.cards}: {torch.cuda.device_count()} cards')
    t_start = time.perf_counter()

    phase('device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    from boxinstseg_tpu_torch.utils.env import set_tf32
    set_tf32(False)
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}, device '
          f'{torch.cuda.get_device_name(0)}; TF32 matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, cudnn '
          f'{torch.backends.cudnn.allow_tf32}; cuDNN '
          f'{torch.backends.cudnn.version()}, benchmark mode '
          f'{torch.backends.cudnn.benchmark}')
    print('image decoders on this machine (reading JPEGs without cv2): ' +
          ', '.join(image_decoders().values()))

    phase('build')
    from boxinstseg_tpu_torch.ops import _native
    t0 = time.perf_counter()
    _native.build_all(['pairwise', 'msda', 'lcm', 'swin_attention', 'crf',
                       'lsa', 'mst', *BASELINES.values()])
    print(f'pairwise.cu, msda.cu, lcm.cu, swin_attention.cu, crf.cu, lsa.cu, '
          f'mst.cu and the baselines of pairwise.cu, lcm.cu and crf.cu: '
          f'{time.perf_counter() - t0:.2f} s (nvcc ' + ', '.join(
              f'{os.path.basename(k)} {v:.2f} s'
              for k, v in _native.BUILD_SECONDS.items()) + ')')

    work_dir = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        if args.cards > 1:
            phase('cards')
            files = write_coco_files(os.path.join(work_dir, 'files'),
                                     FILE_SHAPES)
            phase_cards(work_dir, files, args.cards)
            print(f'smoke wall time {time.perf_counter() - t_start:.1f} s')
            print('\n'.join(smi))
            print(json.dumps({'ok': True, 'device': {
                'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                'count': torch.cuda.device_count()}}))
            return
        phase('kernels')
        report = phase_kernels()
        report.update(phase_msda_kernels())
        report.update(phase_lcm_kernels())
        run_phases(load_tool('train_torch'), work_dir, report, smi, t_start)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def run_phases(tool, work_dir, report, smi, t_start):
    """Every phase from the slice on, then the result lines."""
    import torch
    phase('slice')
    launches, kept, checkpoint, slice_ms = phase_slice(tool, work_dir)

    phase('pairwise main path')
    phase_pairwise_main_path(kept, report)
    del kept

    phase('reference')
    phase_reference()

    phase('box2mask')
    lsa_kept, b2m_mst = {}, {}
    b2m_launches, _, _ = phase_box2mask(
        tool, B2M_CONFIG, 2, ('backbone.', 'panoptic_head.pixel_decoder.'
                              'encoder.', 'panoptic_head.transformer_decoder.'),
        lsa_kept, b2m_mst)
    launches.update(b2m_launches)

    phase('box2mask reference')
    phase_box2mask_reference()

    phase('swin kernels')
    report.update(phase_swin_kernels())

    phase('swin-l')
    swin_launches, cfg, model = phase_box2mask(
        tool, SWIN_CONFIG, 1, ('backbone.stages.0.', 'backbone.stages.2.',
                               'backbone.stages.3.',
                               'relative_position_bias_table'))
    bb = cfg.model.backbone
    if (bb.embed_dims, list(bb.depths), list(bb.num_heads),
            bb.window_size) != (192, [2, 2, 18, 2], [6, 12, 24, 48], 12):
        fail(f'not Swin-L: {describe_backbone(bb)}')
    launches['swin_attention_forward'] = \
        swin_launches['swin_attention_forward']
    launches['swin_attention_backward'] = \
        swin_launches['swin_attention_backward']
    phase_swin_predict(cfg, model)
    del model

    phase('swin reference')
    phase_swin_reference()

    phase('swin-l recipe')
    phase_swin_recipe(tool)

    phase('crf kernel')
    report.update(phase_crf_kernel())

    phase('lsa kernel')
    lsa_report = phase_lsa_kernel(lsa_kept, b2m_launches['lsa_solve'] / STEPS)
    del lsa_kept

    phase('discobox')
    disco_launches, disco_cfg, disco_model = phase_discobox(tool)
    launches.update(disco_launches)

    phase('discobox reference')
    phase_discobox_reference()

    phase('boxinst predict')
    phase_boxinst_predict(tool, checkpoint)
    phase('predict reference')
    phase_predict_reference()

    phase('eval')
    eval_metrics = phase_eval(checkpoint)

    phase('discobox predict')
    phase_discobox_predict(disco_cfg, disco_model)
    del disco_model

    phase('boxlevelset')
    boxls_dir = os.path.join(work_dir, 'boxlevelset')
    boxls_mst = {}
    boxls_cfg, boxls_ckpt, boxls_mst_a_step = phase_boxlevelset(
        tool, boxls_dir, boxls_mst)
    phase_boxlevelset_predict(boxls_cfg, boxls_ckpt)
    shutil.rmtree(boxls_dir, ignore_errors=True)

    phase('boxlevelset reference')
    phase_boxlevelset_reference()

    phase('mst kernel')
    mst_report = phase_mst_kernel(b2m_mst, boxls_mst, {
        'box2mask r-50': b2m_launches['grid_mst'] / STEPS,
        'boxlevelset r-50': boxls_mst_a_step})
    del b2m_mst, boxls_mst

    phase('files')
    files = write_coco_files(os.path.join(work_dir, 'files'), FILE_SHAPES)
    pair = write_coco_files(os.path.join(work_dir, 'pair'),
                            FILE_SHAPES[:1] * 2, boxes=PAIR_BOXES, seed=1)
    files_checkpoint = phase_files(tool, work_dir, files)

    phase('ddp')
    phase_ddp(work_dir, files, pair, slice_ms, files_checkpoint)

    phase('ddp swin-l')
    phase_ddp_swin(work_dir, pair)

    phase('public surface')
    phase_public_surface(work_dir, files, files_checkpoint, checkpoint,
                         eval_metrics)

    phase('condinst')
    phase_condinst(tool, work_dir, files)

    phase('inventory')
    phase_inventory(tool)

    phase('zoo')
    phase_zoo()

    phase('ops')
    phase_ops()

    phase('configs')
    config_launches, config_ms = phase_configs(tool, work_dir)
    phase('voc cli')
    phase_voc_cli(tool, work_dir, files)

    mst_steps = CONFIGS_STEPS * sum(
        1 for rel in SHIPPED_UNRUN if rel.split('/')[0] in ('boxlevelset',
                                                            'box2mask'))
    mst_report['launches_a_step']['configs'] = \
        config_launches['grid_mst'] / mst_steps
    if config_launches['grid_mst'] != mst_steps:
        fail(f'the MST kernel launched {config_launches["grid_mst"]} times '
             f'in the configs phase\'s {mst_steps} BoxLevelset and Box2Mask '
             f'steps')
    kernels = [dict(name=name, route='cuda', source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    **report[name]) for name in REPLACES]
    for row, n in ((lsa_report, b2m_launches['lsa_solve']),
                   (mst_report, b2m_launches['grid_mst']
                    + round(boxls_mst_a_step * STEPS))):
        kernels.append(dict(launches=n, library_ms=None, **{
            k: row[k] for k in ('name', 'route', 'source', 'replaces',
                                'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                                'bound_by')}))
    print(f'smoke wall time {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'lsa': lsa_report}))
    print(json.dumps({'mst': mst_report}))
    print(json.dumps({'configs': {'step_ms': config_ms,
                                  'launches': config_launches}}))
    print(json.dumps({'kernels': kernels}))
    print(smi[0])
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
