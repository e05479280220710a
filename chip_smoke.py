#!/usr/bin/env python3
"""Smoke run of the PyTorch port (yolodl_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero with no
result line:

1. build  — compile every CUDA kernel of yolodl_torch/csrc with nvcc, and
   the host libraries this machine can build with g++ (one process per
   source, all started together), into build/yolodl_torch/.
2. kernel — B1's kernels against their plain PyTorch versions on the card.
   nms_conflict_bits must give the plain version's bits exactly
   (torch.equal) for f32 and bf16 boxes, greedy and diou (β 0.6), one group
   and 80, K in 1, 8, 300, 512, 1000, 1500 (a ragged last word; shared
   memory above 48 KB; rows read from device memory), on boxes that include
   zero-area ones and exact duplicates; nms_keep_from_bits the plain keep
   mask on those bits and on a 512-box chain in which each box overlaps
   only its neighbour; two launches of each the same bits.  pairwise_iou f32
   must equal its plain version at [8,512,4], [1,300,4], [2,8,4] and
   [3,510,4] (scalar stores) with a diagonal of 1.  The library's powf is
   held against torch.pow (the DIoU penalty's power).  Then, at [8,512]
   with diou β 0.6 on bf16 boxes (the serving case), each kernel's median
   time over 200 launches (CUDA events, queued behind a sleep so that host
   launch overhead is not timed) beside its bound and the plain version's.
3. serve  — YoloModel on cfg/darknet/yolov4-csp.cfg at 608x608 with seeded
   random weights, DetectionService(batch 8, bf16, NMS kind from the cfg)
   answering 32 requests from 8 threads and the HTTP endpoints.  The
   launch counters are zeroed right before and read right after: the
   conflict and the resolution kernel must each have launched once per
   served batch.  One batch is post-processed again on the plain route (no
   kernel may launch) and on the dense route (the pairwise_iou kernel's
   [B,K,K] matrix, eager DIoU, a Jacobi fixed point read on the host): keep masks, classes and
   instances must be identical.  The breakdown line gives both routes' ms,
   kernels and host syncs (the profiler's aten::equal count, which must be
   0 on the kernel route), and the two kernels' times on the served
   batch's own candidates.  The f32 forward on the card is held against
   the same model on the CPU at 64x64.
4. cli    — the port's detect, eval and serve CLIs on yolov4-csp at 608²
   (full depth, 80 classes) from a .weights file.  The seed-0 model is
   written out by the port's darknet saver and read back through
   zoo.load_darknet_model, and saved and loaded as a .ckpt with an EMA:
   both state_dicts must be bit-identical.  A CSV dataset of 24 JPEGs at
   480x640, 720x1280, 608x608 and 375x500 (1-5 boxes each over COCO's 80
   names, seed 0) and a detect.json5 with comments and trailing commas go
   to build/chip_smoke_cli/.  detect_main.main (bf16, --save-json) and
   eval_main.main (bf16, NMS by class at confidence 0.005) run in this
   process with B1's launch counters zeroed right before and read right
   after each: each kernel must launch once per batch, 3 times per call.
   24 images and a parseable JSON must come out, and detect's first batch
   must equal model -> non_max_suppression -> yolo_inference ->
   to_host_detections on the same decoded batch.  Then `python -m
   yolodl_torch.cli.serve_main --port 0 --batch-size 8` as a subprocess:
   16 of the images POSTed from 4 threads, every box in its image's
   original pixels, /stats with 0 errors, exit code 0 on SIGINT.  The
   line gives each CLI's img/s and ms per batch (from its first decode to
   its return) with the host's ms per batch by span (decode, the forward's
   and the NMS's issue, device wait + unpack, drawing, AP, the rest),
   serve's p50/p95 and the seconds to load the .weights file.
5. train_main — the port's training CLI on the repo's own configs.  The
   f32 forward of cfg/train.json5's 64x64 NEWSLAB model (it holds a
   DeconvBn2D) on the card is held against the CPU at 64x64 first.  A CSV
   set of 192 training and 24 held-out JPEGs (seed 0, 1-4 boxes of one
   class) and a train.json5 made from cfg/train.json5 with the port's JSON5
   reader go to build/chip_smoke_train/ (removed at the end); only the
   dataset (Csv at the file's 256), logging.dir, cache_dir,
   load_checkpoint (Disabled) and an evaluation block (every 3 steps, batch
   8, the held-out set) change, and so does the memory: at 256², batch
   96, f32 the model's saved activations outgrow the card's 80 GB, so
   training.remat is set (no value changes) and the batch runs as 4 accumulated micro-batches
   of 24; the line gives the saved bytes of a batch both ways, counted by
   saved_tensors_hooks over one image, and the host ms of the port's
   CRC-32C over one TFRecord cache payload.  Batch 96, the augmentations, the Hausdorff/Rect4 loss, AdamW and
   the logging flags stay.  The CLIs run with PyTorch's
   TF32 defaults, as in a user's process.  train_main.main
   runs 6 steps in this process with B1's counters zeroed right before and
   read right after: each kernel launches once for the in-training
   inference (step 1) and once per evaluation batch (2 x 3).  Then a
   subprocess run (ordered records, a checkpoint every step) gets SIGINT
   after its first checkpoint and must exit 0 with a checkpoint holding
   opt/; a FromRecent run must print "data stream resumed at record
   step x 96" and train first on the batch an uninterrupted run trains on
   at that step (torch.equal).  Last, detect_main runs cfg/detect.json5's
   model (109.5 M parameters, 256², minibatch 4) from a seed-0 .ckpt over
   the held-out images, one launch of each kernel per batch.  The line
   gives steps/s, records/s and the data-wait share of the steady steps
   (2 to 5; step 6 runs under torch.profiler: device ms, kernels, and the
   card's idle share of a steady step),
   ms per step by span (data wait, the batch's H2D copy on the card, the
   synchronized step, the rest of the loop), evaluation ms, peak memory
   and detect img/s, with the card's name and power limit.
6. native_loader — the port's host libraries (data/native_loader.py,
   ROADMAP A11b): csrc/host_augment.cpp (the pipeline's affine warp and HSV
   jitter) and, where g++ finds jpeglib.h and png.h, csrc/host_decode.cpp
   (JPEG/PNG decode + letterbox), built by g++ -O3 -march=native with the
   CUDA kernels in phase build.  The line gives each library's path and
   compile seconds, g++'s version, what -march=native resolves to and the
   decode route with the probe's reason (PIL on a machine without those
   headers; where it is native, tests/test_data.py's decode gates against
   PIL apply).  Gates over the 16 records of one batch of phase augment's
   recipe at 608², each with its own jitter and affine draws, the native
   route against the plain numpy/scipy version (selected by the port's
   switch, native_loader._aug_lib_cache = False): every warp value within
   1e-5 except at border ties (a source coordinate within 1e-9 of an edge,
   where the two may round to opposite sides), whose differing values are
   counted and may be at most 1e-4 of the values; every jitter value within
   3e-5.  Then ms a record of each route's warp and jitter (median of the
   16), and the recipe's host records/s through TrainingStream: native at
   1 and 4 workers, plain at 1, beside the host's CPU model and
   os.cpu_count() and the card's name and power limit.
7. augment — the device augmentation (data/device_augment.py, ROADMAP
   A13).  First the program at the flagship's width: 64 seeded records at
   608² (smooth colour fields with noise on the u8/255 grid, 1-7 boxes),
   scripts/bench_device_augment.py's recipe (mosaic 0.5 with margin 0.25,
   jitter, the affine with rotation up to 10°, translation, scale 0.8-1.2,
   flip), one u8 pack of batch 16 with k_max 4 (rotation-free for the
   separable warp).  Each warp (separable, two-pass with the recipe's
   bands, general) runs jitter + warp + mosaic on the card and on the CPU:
   mean |Δ| ≤ 1e-5 and at most 0.2 % of pixels with |Δ| > 1e-3 (a border
   or hue-sextant flip is one ulp away); the mix-only program must be
   identical.  Per route: ms by CUDA events (median of 20), the
   synchronized wall ms, device ms, kernels and host syncs (profiler), and
   the peak memory above the pack; the pack's H2D copy, u8 against f32.
   Then the host side it frees: the same recipe through the port's host
   pipeline (every pixel on the host, jitter and warp on the native route
   of phase native_loader; the line names the route) and through the
   deferred host prep (draws, labels, the u8 pack), one worker each,
   records/s.  Last,
   train_main on cfg/train.json5 as phase train_main changes it, plus
   preprocessor.pipeline.device "cuda", logging.enable_images false (true
   keeps the CPU pipeline, as in the reference) and ordered records: 5
   steps in this process with B1's counters zeroed right before and read
   right after (1 launch of each kernel for the step-1 inference + 3 for
   the evaluation at step 3); every loss finite, no fallback warning, the
   CPU pipeline never entered, the two-pass warp chosen.  Its first
   batch's images against the CPU program on the same pack (the bounds
   above) and its boxes, classes and mask equal (torch.equal) to the CPU
   pipeline's run with the same seed; the images against that run within
   the two-pass pipeline bound of tests/test_device_augment.py.  The line
   gives steps/s, records/s, the data-wait share, ms per step by span
   (data wait, the u8 pack's H2D copy, the synchronized step, the rest),
   the program's ms, device ms and kernels a batch, peak memory, beside
   phase train_main's numbers, and the card's name and power limit.
8. wgrad  — conv2d_lowch and conv2d_db (yolodl_torch.kernels), forward and
   backward at each stride-1 low-channel conv shape of yolov4-csp at 608²,
   batch 8, bf16, with both launch counters zeroed right before and read
   right after: each kernel must have launched once per backward.  dW is
   held against the plain version, max|Δ| ≤ 1e-4 · max|ref| (f32 sums over
   up to 3 M terms in another order), and against conv2d_weight in f32,
   ≤ 1e-3 · max|ref| (cuDNN may choose an algorithm that rounds more); y
   and dX must be identical to autograd of the same library conv calls.
   Two launches of a kernel must give identical bits.  Then per shape the
   kernels' median time beside their bound, the plain version's and
   conv2d_weight's (bf16, channels-last), the plan of each launch (how often
   xp and g are read from device memory, 1 = once; shared bytes; chunks),
   the chunk reduction's share of a launch's device time (profiler), and
   at 304², 32→64, k3 the same on f32 inputs.  Last, ragged shapes the
   flagship lacks (odd widths, 3, 40 and 130 input channels, 20, 24 and 72
   output channels, k 1, 3 and 5), bf16 and f32, against the plain version
   within the same 1e-4, again with identical bits from two launches.
9. train  — first one f32 SGD step of yolov4-csp at 64², batch 2, on the
   card and on the CPU from the same weights and batch: losses within
   rel 1e-4, every updated parameter within 25 % of its tensor's largest
   update plus 4 f32 ulps of its largest entry (see train_card_vs_cpu).
   Then yolov4-csp at 608² on the card (seed 0), train_init with the
   default TrainConfig() (Adam β1 0.937, lr 1e-3), bench.py's synthetic
   batch (batch 16, bf16 images, 32 boxes per image, seed 0): 2 warm-up
   steps, 10 timed steps through make_train_step, one make_multi_step(k=2)
   call.  Every loss finite, num_matched > 0, every parameter changed, no
   wgrad launch.  Prints step ms (CUDA events), img/s, peak memory, a
   profile of one step (device ms, kernels, the costliest, the card's idle
   share) and of its parts (forward, loss, backward, optimizer).
10. darknet_loss — the darknet-exact loss (yolodl_torch/loss/darknet_loss.py),
   TF32 off for its f32 comparisons.  First the card against the CPU:
   yolov4-csp's three head params at 608² and Gaussian_yolov3_BDD's at
   512², seeded f32 NCHW raws (batch 2) and 64 truth rows an image (40
   real, then zeros); every discrete decision (head_decisions: the ignore
   and truth_thresh masks, each truth's best anchor and the cells it
   writes) and num_matched identical, each head's delta within 1e-4 ·
   max|ref|, the cost within rel 1e-5.  Then yolov4-csp at 608², b16,
   bf16 images, TrainConfig(darknet_loss=...) on bench.py's synthetic
   batch: 2 warm-up and 10 timed steps through make_train_step and one
   make_multi_step(k=2) call; every loss finite, num_matched > 0, every
   parameter changed.  The line gives step ms (CUDA events) and img/s
   beside phase train's production-loss step, peak memory, the loss alone
   (forward + backward on that batch's head outputs: ms by events, device
   ms, kernels, host syncs = aten::item/_local_scalar_dense calls, which
   must be 0) and its share of the step, and a profile of one step.  Last,
   train_main.main with training.loss.impl Darknet on
   cfg/darknet/Gaussian_yolov3_BDD.cfg: cfg/train.json5 with only the
   model, loss.impl, the dataset (192 + 24 seeded JPEGs over BDD's 10
   classes), logging.dir, cache_dir, load_checkpoint, an evaluation block
   (every 3 steps, batch 8) and training.multi_scale (the sizes darknet's
   random=1 gives at 512², interval 2) changed, and the batch cut only if
   its saved activations at the largest visited size outgrow 56 GB (the
   line prints the cut and its reason).  6 steps visit 3 sizes, each of
   which must train with head params of that size; B1's counters zeroed
   right before and read right after: 1 launch of each kernel for the
   step-1 inference + 1 per evaluation batch (2 x 3).  The line gives
   steps/s, ms per step by span (data wait, the synchronized step, the
   loss inside it, the rest), the loss's share of the step, peak memory,
   and the card's name and power limit.
11. deploy — yolov4-csp at 608² deployed as a user would (ROADMAP A11c),
   and ROADMAP A4's node kinds on the card.  The seed-0 model with seeded
   BN statistics goes to a .weights file; tool_main fold-weights (in this
   process) writes the BN-free pair, whose cfg must hold no
   batch_normalize.  Both pairs load through zoo.load_darknet_model
   (seconds timed: the .weights load plus build); their f32 forwards at
   b2 must agree within 1e-4 · max|unfolded|.  tool_main export --serving
   --dtype bfloat16 --batch 8 --size 608 --device cuda writes an artifact of each
   pair, and DetectionService.from_artifact loads it (seconds timed).  On
   one batch of 8 frames each artifact's outputs must equal its live
   model's bf16 forward bit for bit (or, should the exported graph change
   an op, lie within 1e-3 · max|live|; the line says which), and the
   valid masks, classes and instances after NMS must be identical.  Each
   of the four services (live, folded, artifact, folded artifact) then
   answers 32 requests from 8 threads, B1's counters zeroed right before
   and read right after: each kernel once per served batch.  Then
   detect_main --artifact in this process on phase cli's kind of dataset
   (one launch of each kernel per batch) and serve_main --artifact as a
   subprocess (16 POSTs from 4 threads, exit 0 on SIGINT).  Last, the f32
   forwards of yolov2.cfg (Reorg2D, [region]) and cspx-p7-mish.cfg
   (DarknetSam) at 128² on the card against the CPU (1e-4 · max|ref|),
   and detect_main on yolov2.cfg at its own 416² from a seed-0 .weights
   file, one launch of each kernel per batch.  The line gives, for each
   service, img/s, p50/p95, the forward's ms (CUDA events) and its device
   ms and kernels (profiler), and the load seconds, and each exported
   program's aten calls; the workspace,
   build/chip_smoke_deploy/, is removed at the end.
12. classify — the dense and recurrent node kinds and classify_main
   (ROADMAP A11d + A12).  First the f32 eval forwards of vgg-16 (256²,
   fc1 32768 -> 4096, 2 images), alexnet (227²), rnn and gru (one time
   step), lstm.train and crnn.train (one sequence of 576 one-hot bytes)
   and yolov3-tiny_occlusion_track (416², a sequence of 20 frames), each at
   its cfg's own size, on the card against the CPU from the same seed-0
   weights with seeded BN statistics: the output and a classifier's
   pre-softmax logits within 1e-4 · max|cpu| + 1e-6.  Then classify_main
   on vgg-16.cfg as a user runs it: a CSV set of 384 synthetic JPEGs
   (seed 0, 10 colour-coded classes, four sizes letterboxed to 256²) and a
   JSON5 config (batch 128, the cfg's own; f32; the reference's default
   Adam) under build/chip_smoke_classify/ (removed at the end), the batch
   cut only if its saved activations outgrow 56 GB (the line prints the
   cut and its reason); 6 steps in this process with cuDNN TF32 on, as in
   a user's process (every loss finite, a checkpoint holding opt/), then
   --eval --topk 5 (top-5 >= top-1, and the top-1 count equal to the
   checkpoint's model -> argmax on the same decoded, padded batches).  The
   line gives steps/s, the decode's ms per step and the synchronized
   step's (timed from outside the CLI), peak memory, and one step at
   library level: ms by events, device ms, kernels, the card's idle share.
   Then lstm.train.cfg at full width through make_classifier_train_step:
   16 sequences (its batch 128 / subdivisions 8) × 576 time steps of the
   repo's README.md + SURVEY.md as one-hot bytes, each label the next
   byte, Adam: 1 step profiled (device activity only, counted on the raw
   kineto events), then 1 timed (CUDA events; 13-23 s a step, so two keep
   the smoke inside its time limit); every loss
   finite, every parameter changed; step ms, kernels, device ms, idle
   share, peak memory.  Last, detect_main on
   yolov3-tiny_occlusion_track.cfg at 416², batch 20 (its time_steps),
   from a seed-0 .weights file written by the port's saver and read back
   through zoo.load_darknet_model bit-identical, over 40 frames of one
   synthetic sequence: B1's counters zeroed right before and read right
   after, one launch of each kernel per batch; img/s.
13. dp    — data-parallel training and multi-device inference (ROADMAP
   A14a, yolodl_torch/parallel/).  First make_dp_train_step at world
   size 1 over NCCL (one rank with a card of its own): the flagship at
   608², b16, bf16, default TrainConfig(), phase train's batch, 2 steps
   against the plain make_train_step, bit for bit (losses, parameters, BN
   statistics), with cuDNN's deterministic algorithms and the plain step
   run twice as a control; then 3 more steps of each, their median ms,
   and the all-reduce's ms of the flat 211.7 MB gradient buffer (CUDA
   events).  Then 2 ranks on cuda:0
   over gloo (NCCL refuses two ranks on one device), started by
   parallel/mesh.py launch_ranks: the flagship b16 as 8 rows a rank, one
   warm-up and 2 timed steps (CUDA events), the all-reduce's ms, the
   two ranks' parameters bit-identical (sha256); yolov4-tiny at 64² with
   seeded BN, one f32 SGD step of 8 rows a rank, on the card and on the
   CPU in the same ranks: loss within rel 1e-5, num_matched equal, every
   tensor within 1e-4 · max|cpu| (tests/test_torch_dp.py's limits).  Then
   train_main with MultiDevice [cuda:0, cuda:0] on a toy NEWSLAB
   workspace under build/chip_smoke_dp/ (removed at the end), 3 steps in
   a subprocess: exit 0, the "backend gloo (ranks share cuda:0)" line, a
   checkpoint a step from rank 0 and none from rank 1.  Last,
   DetectionService on the flagship (b8, bf16) with two replicas on
   cuda:0, beside one replica at b4 and one at b8, 16 frames from 16
   threads: B1's counters zeroed right before and read right after, each
   kernel launched once per replica per served batch; the two replicas'
   detections equal to the b4 replica's (the same forward shape), and
   the share equal to the b8 replica's is printed.
14. tp    — ZeRO-1 and tensor parallelism (ROADMAP A14b,
   yolodl_torch/parallel/zero.py and tp.py).  First make_zero_train_step
   at world size 1 over NCCL: the flagship at 608², b16, bf16, default
   TrainConfig(), phase train's batch, 2 steps against the plain step
   (cuDNN deterministic): losses within rel 1e-5, parameters within 1e-6
   and BN statistics within 1e-6 (tests/test_train.py:405-411), max|Δ|
   printed.  Then 2 ranks on cuda:0 over gloo (launch_ranks): ZeRO-1 on
   the flagship b16 as 8 rows a rank, the reduce-scatter route the backend
   rule chose, one warm-up and 2 timed steps (CUDA events), the ms of the
   reduce-scatter and of the all-gather, the optimizer-state bytes per
   rank beside the data-parallel step's, the two ranks' parameters
   bit-identical (sha256) and their 3 losses equal to the data-parallel
   step's on the same rows (rel 1e-5).  In the same ranks, tensor
   parallelism 1×2: rank 0 first takes one f32 SGD step (momentum 0.937)
   of the flagship at 608² on a global batch of 2 alone; the 1×2 step on
   the same batch must give its loss within rel 1e-4, and every
   parameter, BN statistic and gradient (the momentum buffer after one
   step) within 1e-4 · max|ref| or within 10 times the largest difference
   that the same single-process step shows on images 1 ulp up (rounding
   alone: one f32 step at 608² amplifies it in some gradients, up to
   0.3 % of max); the sharded-leaf count, and parameter + moment bytes
   per rank beside the single process's; one warm-up and 2 timed bf16
   steps (default TrainConfig()) with the host-staged collectives' count
   and ms per step; make_tp_infer in f32 against the unsharded forward of
   the gathered model (1e-4 · max|ref|), then NMS on rank 0 with B1's
   counters zeroed before and read after (one launch of each).  Last,
   train_main on a toy NEWSLAB workspace under build/chip_smoke_tp/
   (removed at the end) with MultiDevice [cuda:0, cuda:0] and
   tensor_parallel 2, then zero_optimizer: its ranks started by
   launch_ranks, as train_main's own parent starts them, so that each
   rank reports B1's counters; 3 steps with an evaluation at step 3: the
   mesh (or reduce-scatter) line, a checkpoint a step from rank 0 and none
   from rank 1, the last loading into a single-device port model whose
   forward is finite, and each B1 kernel launched once per evaluated
   batch on rank 0.
15. pp    — GPipe pipeline parallelism (ROADMAP A14c,
   yolodl_torch/parallel/pipeline.py).  2 ranks on cuda:0 over gloo
   (launch_ranks, pp_rank): rank 0 first takes one f32 SGD step (lr 1e-2)
   of the flagship at 608², b16 as 2 micro-batches, through the
   single-process make_train_step(accum=2) alone (TF32 off, cuDNN
   deterministic), the same step on images 1 ulp up (the control), and
   the bf16 accumulation step (default TrainConfig(), one warm-up and 2
   timed, its peak memory); then both ranks take the same steps as a
   2-stage pipeline (76 and 101 nodes, each rank holding its stage only):
   the f32 loss within rel 1e-5 and every parameter and BN statistic
   after the step within 1e-4 · max|ref| (PP_F32_TOL, with no control
   factor: the stages run the single process's arithmetic; the control's
   difference and the count of bit-identical tensors are printed beside
   it), the bf16 step's ms (one
   warm-up, 2 timed by CUDA events) with the host ms spent inside the
   host-staged transfer calls, and each rank's peak memory beside the
   single process's.  Then train_main with MultiDevice [cuda:0, cuda:0],
   pipeline_parallel 2 and 2 micro-batches on the toy workspace under
   build/chip_smoke_pp/ (removed at the end), its ranks started as
   phase tp's: 3 steps with an evaluation at step 3, the "pipeline: 2
   stages" line, a checkpoint a step from rank 0 and none from rank 1, the
   last loading into a single-device port model, and each B1 kernel
   launched once per evaluated batch on rank 0 (none on rank 1); last,
   detect_main in this process on that checkpoint over the workspace's 8
   images, one launch of each B1 kernel per batch of 4.
16. recurrent_parallel — recurrent nodes under tensor and pipeline
   parallelism over several data ranks (parallel/tp.py SequenceShard,
   mesh.py gather_rows_summed): yolov3-tiny_occlusion_track.cfg (two
   [crnn] with BN) at its own 416² and time_steps 20, seed-0 weights, a
   global micro-batch of 40 rows (2 sequences), one class; four ranks on
   cuda:0 over gloo (launch_ranks, rp_rank), TF32 off and cuDNN
   deterministic.  Rank 0 first takes alone one f32 SGD step (lr 1e-2) of
   one process, the same on images 1 ulp up (the control), and bf16 steps
   (TrainConfig(compute_dtype="bfloat16"), one warm-up and 2 timed), on
   the 40 rows and, with 2 micro-batches, on 80.  Then all four: TP 2×2
   (make_tp_train_step; every recurrent sub-layer cut) and the pipeline
   of 2 stages × dp 2 with 2 micro-batches, each one f32 SGD step: the
   loss within rel 1e-5 of one process's; as phase tp holds them, every
   tensor after the step and every gradient (the momentum buffer) within
   max(1e-4, 10 × the control's worst) · max of one process's, the worst
   over its own control printed beside; the BN running statistics equal
   on the data ranks of a model index (TP) or a stage (pipeline), by
   sha256;
   make_tp_infer within 1e-4 · max of one process's forward, and its NMS
   with B1's counters zeroed right before and read right after, one
   launch of each kernel.  Then each mode's bf16 step: ms by CUDA events
   (one warm-up, 2 timed), the host ms inside the recurrent nodes' row
   gathers (forward and backward), and each rank's peak memory beside one
   process's.  Every failed gate is printed in the phase line, then the
   phase raises.
17. spatial — spatial parallelism (ROADMAP A14d,
   yolodl_torch/parallel/spatial.py and spatial_model.py): the image
   height cut over 2 ranks on cuda:0 over gloo (launch_ranks,
   spatial_rank), TF32 off and cuDNN deterministic for f32.  yolov4-csp
   built at 608² and at 1216² (the planner reads the graph's static
   heights; seed-0 weights, seeded BN) through make_spatial_infer on a
   space mesh of 2: at 608², b8, 85 of 177 nodes run height-sharded and
   the prefix stops at /16 (19 rows do not halve); at 1216², b2, 173.
   Every output of the f32 MergedDetection within 1e-4 · max|ref| of the
   unsharded forward in one process (rank 0), the two ranks' outputs
   bit-identical (sha256), and non_max_suppression on the spatial and the
   unsharded outputs giving identical keep masks (`valid`), with B1's
   counters zeroed right before and read right after the NMS of the
   spatial output: one launch of each kernel per batch.  The entries in
   another order (near-tied scores) and the kept (instance, class) pairs
   not shared are printed beside the same counts for one process on
   images 1 ulp up.  Then the bf16 forward (bf16 activations, as the
   service runs them): ms by CUDA events (one warm-up, 3 timed) with the
   host ms inside the halo and gather transfers, and each rank's peak
   memory, beside one process's.  Then one f32 SGD step (lr 1e-2) at
   608², b8, on a 1 × 2 mesh against rank 0's single-process
   make_train_step on the same batch: the loss within rel 1e-5 and the
   forward's outputs within 1e-4 · max|ref|; ‖Δ − Δ_one‖₂ / ‖Δ_one‖₂ of
   every parameter and BN statistic (Δ the change the step made) is
   printed beside the same quantity for one process on images 1 ulp up.
   The same step in float64 is held to ‖Δ − Δ_one‖₂ ≤ 1e-3 · ‖Δ_one‖₂ for
   every tensor (a prefix gradient off by the space axis's factor reads
   0.5; in f32, rounding alone moves a BN scale's change by 3e-2).  Last,
   three timed bf16 steps (SGD, one warm-up) of each: step ms and the host
   ms inside the transfers.
18. layout — the reference's layout rewrites (ROADMAP A15,
   yolodl_torch/ops/spd_stem.py, fold_region.py, wgrad.py).  yolov4-csp at
   608², seed-0 weights with seeded BN, built five times from one state
   dict: every knob off, spd_stem "auto", "deep", fold_region "on", and
   "auto" with the fold.  Against off, in f32 (TF32 off): the raw head
   outputs of an eval forward at b8 within 1e-4 · max|off|; non_max_
   suppression (argmax, DIoU β 0.6) on each model's output with B1's
   counters zeroed right before and read right after, one launch of each
   kernel per batch; the kept (instance, class) pairs not shared with off,
   each with its score under both and each side's top-k cut (printed
   beside off's own count on images 1 ulp up; near-ties do not fail the
   run); one train-mode forward and backward at b8 on bench.py's kind of
   batch: the loss within rel 1e-5, the rewritten nodes' new BN running
   statistics within 1e-4 · max, their gradients within 1e-4 · max or 10×
   off's own move on images 1 ulp up.  Then per model, bf16: the serve
   forward at b8 (median ms by CUDA events over 10, device ms, kernels,
   and the aten::copy_ and aten::clone (layout copy) calls it adds to
   off's) and the train step at b16 with TrainConfig() (median ms over 3
   after 2 warm-up, peak memory, and the device ms and kernels of one step
   profiled with the device activity only).  The line gives each part's
   wall seconds.  Last,
   conv2d_packed_wgrad at phase wgrad's eight stride-1 shapes and the
   stride-2 layer1 and layer5, b8, bf16: the forward equal to F.conv2d,
   dW f32 within 1e-3 · max of f32 conv2d_weight, the product's route
   (mm with an f32 output on the card), and the dW's ms and peak bytes
   beside wgrad_lowch's and wgrad_db's (stride 1), conv2d_weight's on
   the same NCHW operands, and its bound.
19. card  — `nvidia-smi --query-gpu=name,power.limit` as it prints it.

After the last phase a line gives each phase's wall seconds (`timing`).
The line before the last lists the kernels; the last line is
{"ok": true, "device": {...}}.  TF32 is switched off for every f32
comparison on the card (cuDNN would otherwise run f32 convs in TF32).
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "cfg", "darknet", "yolov4-csp.cfg")
IMAGE_SIZE = 608
BATCH = 8
MAX_DETS = 512          # non_max_suppression's default
NMS_IOU = 0.45          # DetectionService's threshold
NMS_BETA = 0.6          # yolov4-csp.cfg beta_nms
NMS_KS = (1, 8, 300, MAX_DETS, 1000, 1500)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM f32, outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense

# the stride-1 low-channel convs of yolov4-csp at 608² (H, Ci, Co, k);
# B2/B3's reference shape is the third
WGRAD_SHAPES = [(608, 3, 32, 3), (304, 64, 32, 1), (304, 32, 64, 3), (152, 128, 64, 1),
                (152, 64, 64, 1), (152, 64, 64, 3), (152, 128, 128, 1), (76, 256, 128, 1)]
WGRAD_REF_SHAPE = (304, 32, 64, 3)
# ragged cases (B, H, W, Ci, Co, k): widths that are no multiple of the MMA
# depth, channel counts that are no multiple of 8, a last chunk shorter than
# the others, and the 25 taps of k = 5
WGRAD_RAGGED = [(2, 37, 53, 3, 24, 3), (3, 19, 19, 40, 72, 1), (2, 8, 40, 130, 20, 1),
                (2, 20, 20, 64, 64, 5), (1, 5, 5, 3, 3, 1)]
WGRAD_TOL = 1e-4       # dW against the plain version: f32 sums in another order
WGRAD_LIB_TOL = 1e-3   # against conv2d_weight, whose algorithm may round more (6e-5 seen)
CLI_IMAGES = 24
CLI_SIZES = [(480, 640), (720, 1280), (608, 608), (375, 500)]  # original h x w, in turn
CLI_CONF = 0.25         # detect.json5's nms_conf_thresh (the service's default)
CLI_POSTS, CLI_CLIENTS = 16, 4
CLI_SERVE_TIMEOUT = 300  # seconds for the serve subprocess to come up, answer and stop
CLI_DEVICE_ARGS: list = []  # the CLIs' --device: none, so their default, the card
TRAIN_MAIN_ROOT = os.path.join(REPO, "build", "chip_smoke_train")  # removed at the end
TRAIN_MAIN_CONFIG = os.path.join(REPO, "cfg", "train.json5")
DETECT_MAIN_CONFIG = os.path.join(REPO, "cfg", "detect.json5")
TRAIN_MAIN_IMAGES = 192       # the synthetic training set (two batches of 96)
TRAIN_MAIN_EVAL_IMAGES = 24   # held out, for the in-training evaluation
TRAIN_MAIN_SIZES = [(360, 480), (256, 256), (300, 400), (480, 360)]  # original h x w
TRAIN_MAIN_STEPS = 6          # the timed in-process run
TRAIN_MAIN_EVAL_INTERVAL = 3  # evaluations at steps 3 and 6
TRAIN_MAIN_EVAL_BATCH = 8     # 3 batches per evaluation
TRAIN_MAIN_TIMEOUT = 600      # seconds for the interrupted subprocess
TRAIN_MAIN_ACCUMULATION = 4   # micro-batches of 24: batch 96 at 256² fits 80 GB no other way
AUGMENT_ROOT = os.path.join(REPO, "build", "chip_smoke_augment")  # removed at the end
AUGMENT_SIZE = 608            # the flagship's width (scripts/bench_device_augment.py's)
AUGMENT_BATCH = 16            # bench.py:20, and the bench script's
AUGMENT_RECORDS = 64          # the bench script's synthetic set
AUGMENT_ROTATE = 10.0         # the bench script's recipe: rotation up to 10°, scale 0.8-1.2
AUGMENT_TIMED = 20            # program calls timed by CUDA events, after 10 warm-up calls
AUGMENT_HOST_BATCHES = 1      # host batches timed per route, after one warm-up batch
AUGMENT_STEPS = 5             # train_main steps: an evaluation at step 3
NATIVE_WARP_TOL = 1e-5        # native warp vs scipy (tests/test_data.py:925), off border ties
NATIVE_TIE_SHARE = 1e-4       # border-tie values beyond the tolerance: at most this share
NATIVE_JITTER_TOL = 3e-5      # native jitter vs numpy (tests/test_data.py:940)
NATIVE_WORKERS = 4            # the native route's host rate at 1 and this many workers
NATIVE_HOST_BATCHES = 3       # native batches timed per rate, after one warm-up batch
AUGMENT_MEAN_TOL = 1e-5       # card vs CPU program: mean |Δ| ...
AUGMENT_FLIP_TOL = 0.002      # ... and the share of pixels with |Δ| > 1e-3 (border, hue sextant)
BF16_BOX_TOL = 0.05      # bf16 vs f32 forward at 608²: max|Δ| / max|f32| of cycxhw
BF16_LOGIT_TOL = 0.1     # ... and of the objectness and class logits
DK_ROOT = os.path.join(REPO, "build", "chip_smoke_darknet")  # removed at the end
DK_MODELS = (("yolov4-csp", CFG, 608),
             ("Gaussian_yolov3_BDD", os.path.join(REPO, "cfg", "darknet", "Gaussian_yolov3_BDD.cfg"),
              512))
BDD_CLASSES = ("bike", "bus", "car", "motor", "person", "rider", "traffic light",
               "traffic sign", "train", "truck")  # BDD100K's 10 detection classes
DK_TRUTHS, DK_REAL = 64, 40   # truth rows an image in the card-vs-CPU check, real ones first
DK_STEPS = 6                  # train_main steps on Gaussian_yolov3_BDD
DK_MULTI_SCALE_INTERVAL = 2   # so that 6 steps visit 3 sizes
DK_IMAGES, DK_EVAL_IMAGES = 192, 24
DK_EVAL_INTERVAL, DK_EVAL_BATCH = 3, 8
DK_SAVED_BUDGET = 56e9        # saved activations a batch may hold on the card's 80 GB
TRAIN_BATCH = 16        # bench.py:20; fits the card's 80 GB (PERF.md)
TRAIN_MAX_GT = 32       # bench.py:117
DEVICE = "cuda"         # the cli, wgrad and train phases' device
DEPLOY_ROOT = os.path.join(REPO, "build", "chip_smoke_deploy")  # removed at the end
DEPLOY_FOLD_BATCH = 2        # folded vs unfolded f32 forward at 608²
DEPLOY_FOLD_TOL = 1e-4       # ... max|Δ| / max|unfolded|
DEPLOY_ARTIFACT_TOL = 1e-3   # artifact vs live bf16, should the program not be bit-identical
DEPLOY_REQUESTS, DEPLOY_CLIENTS = 32, 8
DP_ROOT = os.path.join(REPO, "build", "chip_smoke_dp")  # removed at the end
DP_STEPS = 2                  # world size 1: steps held bit for bit against the plain step
DP_TIMED = 3                  # ... then steps timed by CUDA events, their median reported
DP_RANK_TIMED = 2             # 2 ranks: timed steps after one warm-up step
DP_TINY_CFG = os.path.join(REPO, "cfg", "darknet", "yolov4-tiny.cfg")
DP_TINY_SIZE, DP_TINY_BATCH = 64, 16  # card vs CPU, 8 rows a rank (tests/test_torch_dp.py)
DP_TINY_TOL = 1e-4            # card vs CPU after one SGD step: tests/test_torch_dp.py's limit
DP_TRAIN_MAIN_STEPS = 3
DP_SERVE_FRAMES = 16          # two batches of 8, 4 rows a replica
DP_TIMEOUT = 600              # seconds for the ranks and the train_main run
A4_MODELS = (("yolov2", 128), ("cspx-p7-mish", 128))  # card vs CPU; p7's stride is 128
YOLOV2_CFG = os.path.join(REPO, "cfg", "darknet", "yolov2.cfg")
YOLOV2_SIZE = 416            # yolov2.cfg's own input size
TP_ROOT = os.path.join(REPO, "build", "chip_smoke_tp")  # removed at the end
TP_ZERO_STEPS = 2             # world size 1: ZeRO-1 steps held against the plain step
TP_RANK_TIMED = 2             # 2 ranks: ZeRO-1 (and DP) steps timed after one warm-up step
TP_BATCH = 2                  # TP 1x2: the global batch of the f32 check and the bf16 steps
TP_TIMED = 2                  # TP 1x2: bf16 steps timed after one warm-up step
TP_F32_TOL = 1e-4             # TP 1x2 vs one process, f32: max|d| / max|ref| per tensor
TP_CONTROL_FACTOR = 10        # ... or 10x one process's own difference on images 1 ulp up
TP_TRAIN_MAIN_STEPS = 3       # train_main: 3 steps, an evaluation at step 3
TP_EVAL_BATCH = 4             # ... of dp_workspace's 8 images: 2 evaluation batches
TP_TIMEOUT = 900              # seconds for the ranks of each run
PP_ROOT = os.path.join(REPO, "build", "chip_smoke_pp")  # removed at the end
PP_ACCUM = 2                  # micro-batches a step (b16 -> 2 of 8 rows)
PP_F32_TOL = 1e-4             # pipeline vs one process, f32: max|d| / max|ref| per tensor
PP_TIMED = 2                  # bf16 steps timed after one warm-up step
PP_TIMEOUT = 900              # seconds for the ranks of each run
# phase recurrent_parallel: occlusion_track (two [crnn] with BN) at its own
# 416² and time_steps 20, over 4 ranks sharing the card
RP_ROOT = os.path.join(REPO, "build", "chip_smoke_recurrent")  # removed at the end
RP_ROWS = 40                  # a global micro-batch: 2 sequences of 20 frames
RP_ACCUM = 2                  # the pipeline's micro-batches a step (80 rows)
RP_LOSS_TOL = 1e-5            # the f32 loss against one process's, relative
RP_F32_TOL = 1e-4             # f32 step, every tensor and gradient: max|d| / max|one|
RP_CONTROL_FACTOR = 10        # ... or 10x one process's worst on images 1 ulp up
RP_TIMED = 2                  # bf16 steps timed after one warm-up step
RP_TIMEOUT = 600              # seconds for the ranks
SPATIAL_ROOT = os.path.join(REPO, "build", "chip_smoke_spatial")  # removed at the end
SPATIAL_INFER = [[608, 8], [1216, 2]]  # (size, batch) of the spatial inference checks
SPATIAL_TRAIN = [608, 8]      # the 1 x 2 train step's size and global batch
SPATIAL_F32_TOL = 1e-4        # spatial vs one process, f32 outputs: max|d| / max|ref|
SPATIAL_DELTA_TOL = 1e-3      # each tensor's change by the float64 step: |Δ - Δ_one|₂ / |Δ_one|₂
SPATIAL_TIMEOUT = 600         # seconds for the ranks
# phase layout: yolov4-csp-608 with each knob of the reference, against off
LAYOUT_KNOBS = (("off", {}), ("auto", dict(spd_stem="auto")), ("deep", dict(spd_stem="deep")),
                ("fold", dict(fold_region="on")),
                ("auto+fold", dict(spd_stem="auto", fold_region="on")))
LAYOUT_F32_TOL = 1e-4         # f32 heads and new BN statistics against off, of max
LAYOUT_LOSS_TOL = 1e-5        # the f32 loss against off's, relative
LAYOUT_CONTROL_FACTOR = 10    # gradients: 1e-4 of max, or 10x off's own move on images 1 ulp up
LAYOUT_TIMED = 10             # bf16 serve forwards timed, after 3 warm-up
LAYOUT_STEPS = 3              # bf16 train steps timed, after 2 warm-up
# the flagship's stride-2 convs layer1 and layer5 (H, Ci, Co, k, stride)
LAYOUT_WGRAD_STRIDE2 = [(608, 32, 64, 3, 2), (304, 64, 128, 3, 2)]
CLASSIFY_ROOT = os.path.join(REPO, "build", "chip_smoke_classify")  # removed at the end
VGG_CFG = os.path.join(REPO, "cfg", "darknet", "vgg-16.cfg")
LSTM_CFG = os.path.join(REPO, "cfg", "darknet", "lstm.train.cfg")
OCCLUSION_CFG = os.path.join(REPO, "cfg", "darknet", "yolov3-tiny_occlusion_track.cfg")
# card vs CPU, f32, each at its cfg's own size and time steps: (cfg, images
# or sequences); a sequence is time_steps rows (576 for the .train cfgs),
# occlusion_track's is 20 frames
CLASSIFY_CARD_VS_CPU = (("vgg-16", 2), ("alexnet", 1), ("rnn", 1), ("gru", 1),
                        ("lstm.train", 1), ("crnn.train", 1),
                        ("yolov3-tiny_occlusion_track", 1))
CLASSIFY_TOL = 1e-4           # card vs CPU: max|d| <= 1e-4 * max|cpu| + 1e-6
CLASSIFY_CLASSES = 10         # colour-coded classes of the synthetic set
CLASSIFY_IMAGES = 384         # 3 batches of vgg-16.cfg's batch 128
CLASSIFY_BATCH = 128
CLASSIFY_SIZES = [(300, 400), (256, 256), (480, 360), (200, 320)]  # original h x w
CLASSIFY_STEPS = 6
LSTM_SEQUENCES = 16           # lstm.train.cfg's batch 128 / subdivisions 8
LSTM_WARMUP, LSTM_TIMED = 1, 1   # 13-23 s a step: the smoke's time limit
OCCLUSION_FRAMES = 40         # two batches of the cfg's time_steps 20
OCCLUSION_SIZE = 416


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, n: int = 200) -> float:
    """Median device time of one call over ``n`` calls, each between two
    CUDA events, all queued behind a sleep kernel."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(100_000_000)  # keeps the card busy while the host queues
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def random_tlbr(gen, b, k):
    tl = torch.rand((b, k, 2), generator=gen)
    hw = torch.rand((b, k, 2), generator=gen) * 0.3 + 0.001
    return torch.cat([tl, tl + hw], dim=-1)


def iou_bound(b, k):
    """(bound_ms, bound_by) of pairwise_iou: each input byte read once,
    each output byte written once; 13 f32 operations per pair and 6 per
    box."""
    t_bytes = (b * k * 4 * 4 + b * k * k * 4) / HBM_BYTES_PER_S
    t_ops = (13 * b * k * k + 6 * b * k) / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def conflict_bound(iou, tlbr, group, thr, kind):
    """(bound_ms, bound_by) of nms_conflict_bits on these inputs: boxes and
    int64 groups read once, the [B, K, ceil(K/32)] words written once,
    against the f32 operations of the formula, each counted once, that this
    data needs over the pairs j < i of one group: the intersection (4
    min/max, 2 differences, 2 clamps, a product: 9) of every pair; the rest
    of the IoU and the comparison (3 for the union, the division, the
    comparison: 5) where the boxes intersect; and for diou the penalty (2
    differences, 2 squares and a sum for the distance; 4 min/max, 2
    differences, 2 squares and 2 sums for the diagonal; the division, the
    power counted as 1, the subtraction: 18) where the IoU passes the
    threshold.  Per box: the area (3) and for diou the centres (4)."""
    b, k, _ = tlbr.shape
    score = iou.pairwise_iou_reference(tlbr)
    pairs = (group[:, :, None] == group[:, None, :]) & torch.ones(
        (k, k), dtype=torch.bool, device=tlbr.device).triu(1)
    ops = 9 * int(pairs.sum()) + 5 * int((pairs & (score > 0)).sum()) + 3 * b * k
    if kind == "diou":
        ops += 18 * int((pairs & (score > thr)).sum()) + 4 * b * k
    words = (k + 31) // 32
    t_bytes = (b * k * (4 * tlbr.element_size() + 8) + b * k * words * 4) / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def keep_bound(b, k):
    """(bound_ms, "bytes") of nms_keep_from_bits: the words and the valid
    flags read once, the keep flags written once.  Its serial chain of K
    dependent decisions per image is in no roofline."""
    return (b * k * ((k + 31) // 32) * 4 + 2 * b * k) / HBM_BYTES_PER_S * 1e3, "bytes"


def nms_inputs(gen, b, k, dtype, groups):
    """Boxes (with zero-area boxes and exact duplicates), groups and a valid
    mask for B1's kernels, on the card."""
    tlbr = random_tlbr(gen, b, k)
    tlbr[:, : min(3, k), 2:] = tlbr[:, : min(3, k), :2]  # zero area
    if k >= 8:
        tlbr[:, 5] = tlbr[:, 4]  # exact duplicates, of a box and of a zero-area one
        tlbr[:, 7] = tlbr[:, 1]
    group = torch.randint(0, groups, (b, k), generator=gen)
    valid = torch.rand((b, k), generator=gen) < 0.9
    return tlbr.to(dtype).cuda(), group.cuda(), valid.cuda()


def chain_tlbr(k):
    """K boxes along x, each overlapping only its neighbours (IoU 1/3):
    greedy NMS at 0.3 keeps every other box."""
    t = torch.arange(k, dtype=torch.float32) * 0.5
    z = torch.zeros(k)
    return torch.stack([z, t, z + 1.0, t + 1.0], -1)[None]


def phase_kernel(iou):
    """B1's kernels against their plain versions, then their times at
    [8,512]; see the module docstring.  Returns the kernels-line entries."""
    gen = torch.Generator().manual_seed(0)
    cases = conflicts = kept = 0
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("greedy", "diou"):
            for groups in (1, 80):
                for k in NMS_KS:
                    b = BATCH if k == MAX_DETS else 2
                    tlbr, group, valid = nms_inputs(gen, b, k, dtype, groups)
                    case = f"[{b},{k}] {str(dtype)[6:]} {kind} groups={groups}"
                    bits = iou.nms_conflict_bits(tlbr, group, NMS_IOU, kind, NMS_BETA)
                    ref = iou.nms_conflict_bits_reference(tlbr, group, NMS_IOU, kind, NMS_BETA)
                    if not torch.equal(bits, ref):
                        diff = int((iou.unpack_bits(bits, k) != iou.unpack_bits(ref, k)).sum())
                        raise AssertionError(f"nms_conflict_bits {case}: {diff} bits differ")
                    keep = iou.nms_keep_from_bits(bits, valid)
                    if not torch.equal(keep, iou.nms_keep_from_bits_reference(bits, valid)):
                        raise AssertionError(f"nms_keep_from_bits {case}: keep masks differ")
                    if not (torch.equal(bits, iou.nms_conflict_bits(tlbr, group, NMS_IOU, kind,
                                                                    NMS_BETA))
                            and torch.equal(keep, iou.nms_keep_from_bits(bits, valid))):
                        raise AssertionError(f"{case}: two launches differ")
                    cases += 1
                    conflicts += int(iou.unpack_bits(bits, k).sum())
                    kept += int(keep.sum())
    chain = chain_tlbr(MAX_DETS).cuda()
    ones = torch.ones((1, MAX_DETS), dtype=torch.bool, device="cuda")
    zeros = torch.zeros((1, MAX_DETS), dtype=torch.long, device="cuda")
    chain_bits = iou.nms_conflict_bits(chain, zeros, 0.3)
    chain_keep = iou.nms_keep_from_bits(chain_bits, ones)
    expect = (torch.arange(MAX_DETS, device="cuda") % 2 == 0)[None]
    if not (torch.equal(chain_bits, iou.nms_conflict_bits_reference(chain, zeros, 0.3))
            and torch.equal(chain_keep, iou.nms_keep_from_bits_reference(chain_bits, ones))
            and torch.equal(chain_keep, expect)):
        raise AssertionError("the 512-box chain: keep is not every other box")

    max_err = 0.0
    for b, k in [(BATCH, MAX_DETS), (1, 300), (2, 8), (3, 510)]:
        tlbr = random_tlbr(gen, b, k)
        tlbr[:, : min(3, k), 2:] = tlbr[:, : min(3, k), :2]  # zero-area boxes
        tlbr = tlbr.cuda()
        out = iou.pairwise_iou(tlbr)
        ref = iou.pairwise_iou_reference(tlbr)
        if not torch.equal(out, ref):
            raise AssertionError(f"pairwise_iou [{b},{k}]: max|d|={float((out - ref).abs().max())}")
        diag = torch.diagonal(out, dim1=1, dim2=2)[:, min(3, k):]
        if not torch.allclose(diag, torch.ones_like(diag), atol=1e-6):
            raise AssertionError(f"pairwise_iou [{b},{k}]: diagonal is not 1")
        max_err = max(max_err, float((out - ref).abs().max()))

    # the library's powf against torch.pow, at the exponent of each dtype
    x = torch.rand(1 << 20, generator=gen).cuda()
    powf = {}
    for dtype in (torch.float32, torch.bfloat16):
        e = float(torch.tensor(NMS_BETA, dtype=dtype))
        y = torch.empty_like(x)
        if iou.entry("yolodl_powf_probe")(x.data_ptr(), y.data_ptr(), x.numel(), e,
                                           torch.cuda.current_stream().cuda_stream):
            raise AssertionError("powf probe launch failed")
        ref = torch.pow(x, x.new_full((), e))
        powf[str(e)] = {"identical": torch.equal(y, ref), "max_abs_diff": float((y - ref).abs().max())}

    # times at the serving shape: bf16 boxes, one group, diou
    tlbr, group, valid = nms_inputs(gen, BATCH, MAX_DETS, torch.bfloat16, 1)
    group.zero_()
    bits = iou.nms_conflict_bits(tlbr, group, NMS_IOU, "diou", NMS_BETA)
    tlbr32 = tlbr.float()
    entries = {}
    for name, fn, plain, bound, err in (
            ("nms_conflict_bits",
             lambda: iou.nms_conflict_bits(tlbr, group, NMS_IOU, "diou", NMS_BETA),
             lambda: iou.nms_conflict_bits_reference(tlbr, group, NMS_IOU, "diou", NMS_BETA),
             conflict_bound(iou, tlbr, group, NMS_IOU, "diou"), 0.0),
            ("nms_keep_from_bits", lambda: iou.nms_keep_from_bits(bits, valid),
             lambda: iou.nms_keep_from_bits_reference(bits, valid),
             keep_bound(BATCH, MAX_DETS), 0.0),
            ("pairwise_iou", lambda: iou.pairwise_iou(tlbr32),
             lambda: iou.pairwise_iou_reference(tlbr32), iou_bound(BATCH, MAX_DETS),
             max_err)):
        entries[name] = {"ms": median_ms(fn), "plain_ms": median_ms(plain),
                         "bound_ms": bound[0], "bound_by": bound[1], "max_abs_err": err}
    emit({"phase": "kernel", "nms_cases": cases, "nms_conflicting_pairs": conflicts,
          "nms_kept": kept, "chain_kept": int(chain_keep.sum()), "powf": powf,
          "timed_shape": [BATCH, MAX_DETS, 4], "timed_dtype": "bfloat16", "timed_kind": "diou",
          "timed_kept": int(iou.nms_keep_from_bits(bits, valid).sum()), **{
              f"{name}_{key}": v for name, e in entries.items() for key, v in e.items()}})
    return entries


def wgrad_bound(b, h, ci, co, k, itemsize):
    """(bound_ms, bound_by) of one dW: xp and g read once, dW written once,
    at 3.35 TB/s, against 2·B·H·W·k²·Ci·Co operations at the peak of the
    inputs' type (tensor cores for bf16)."""
    hp = h + k - 1
    t_bytes = (b * hp * hp * ci * itemsize + b * h * h * co * itemsize
               + 4 * k * k * ci * co) / HBM_BYTES_PER_S
    t_ops = 2 * b * h * h * k * k * ci * co / (BF16_FLOPS if itemsize == 2 else F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_err(out, ref) -> float:
    return float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def phase_wgrad():
    """conv2d_lowch / conv2d_db forward and backward at the flagship's
    shapes; see the module docstring."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight

    from yolodl_torch.kernels import conv2d_db, conv2d_lowch, wgrad_db, wgrad_lowch
    from yolodl_torch.kernels import wgrad_lowch_reference as wgrad_reference
    from yolodl_torch.kernels._util import wgrad_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan_keys = ("reads_xp", "reads_g", "smem_bytes", "chunks", "blocks", "stages")
    kinds = {"wgrad_lowch": "lowch", "wgrad_db": "db"}

    def reduction_share(fn, xp, g, k):
        """Device time of the chunk reduction over that of both kernels of a
        launch (torch.profiler over 5 launches); None if it sees no kernel."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn(xp, g, k, device=DEVICE)
            torch.cuda.synchronize()
        times = {e.key: getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if is_device_work(e) and "kernel" in e.key}
        total = sum(times.values())
        reduce_us = sum(v for key, v in times.items() if "reduce_slices" in key)
        return reduce_us / total if total else None

    def same_bits(fn, xp, g, k, first):
        """A second launch on the same operands gives the first one's bits."""
        if not torch.equal(first, fn(xp, g, k, device=DEVICE)):
            raise AssertionError(f"{fn.__name__} {tuple(g.shape)} k={k}: two launches differ")

    kernels = {"wgrad_lowch": (wgrad_lowch, conv2d_lowch),
               "wgrad_db": (wgrad_db, conv2d_db)}
    gen = torch.Generator().manual_seed(0)
    b = BATCH
    cases = []
    for h, ci, co, k in WGRAD_SHAPES:
        x = torch.randn((b, h, h, ci), generator=gen).to(torch.bfloat16).to(DEVICE)
        w = (torch.randn((k, k, ci, co), generator=gen) / (k * k * ci) ** 0.5).to(DEVICE)
        gy = torch.randn((b, h, h, co), generator=gen).to(torch.bfloat16).to(DEVICE)
        cases.append(((h, ci, co, k), x, w, gy))

    # the path: counters zeroed right before, read right after
    for fn, _ in kernels.values():
        fn.launches = 0
    results, backward_calls = {}, 0
    for (h, ci, co, k), x, w, gy in cases:
        for name, (_, conv) in kernels.items():
            xr = x.detach().requires_grad_()
            wr = w.detach().requires_grad_()
            y = conv(xr, wr, k)
            y.backward(gy)
            backward_calls += 1
            results[(name, h, ci, co, k)] = (y.detach(), xr.grad, wr.grad)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
    for name, n in launches.items():
        if n != backward_calls // len(kernels):
            raise AssertionError(f"{name}: {n} launches for "
                                 f"{backward_calls // len(kernels)} backwards")

    ref_entry = {}
    for (h, ci, co, k), x, w, gy in cases:
        pad = (k - 1) // 2
        # the library calls of the Function's forward and dX, through autograd
        xl = x.detach().requires_grad_()
        xp_l = F.pad(xl, (0, 0, pad, pad, pad, pad)) if pad else xl
        y_lib = F.conv2d(xp_l.permute(0, 3, 1, 2), w.to(torch.bfloat16).permute(3, 2, 0, 1))
        y_lib = y_lib.permute(0, 2, 3, 1)
        y_lib.backward(gy)
        xp = (F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x).contiguous()
        g = gy.contiguous()
        plain = wgrad_reference(xp, g, k)
        lib32 = conv2d_weight(xp.permute(0, 3, 1, 2).float(), (co, ci, k, k),
                              g.permute(0, 3, 1, 2).float()).permute(2, 3, 1, 0)
        row = {"shape": [b, h, ci, co, k], "dtype": "bfloat16"}
        for name, (fn, _) in kernels.items():
            y, dx, dw = results[(name, h, ci, co, k)]
            if not torch.equal(y, y_lib) or not torch.equal(dx, xl.grad):
                raise AssertionError(f"{name} {row['shape']}: y or dX differ from the library's")
            err_plain, err_lib = rel_err(dw, plain), rel_err(dw, lib32)
            if not (err_plain <= WGRAD_TOL and err_lib <= WGRAD_LIB_TOL):
                raise AssertionError(f"{name} {row['shape']}: dW rel err {err_plain} (plain), "
                                     f"{err_lib} (conv2d_weight)")
            same_bits(fn, xp, g, k, dw)
            plan = wgrad_plan(kinds[name], b, h, h, ci, co, k, torch.bfloat16, sms)
            row[f"{name}_plan"] = {key: plan[key] for key in plan_keys}
            row[f"{name}_rel_err"] = err_plain
            row[f"{name}_lib_rel_err"] = err_lib
            row[f"{name}_ms"] = median_ms(lambda fn=fn: fn(xp, g, k, device=DEVICE), n=50)
            row[f"{name}_reduction_share"] = reduction_share(fn, xp, g, k)
            if (h, ci, co, k) == WGRAD_REF_SHAPE:
                ref_entry[name] = {"max_abs_err": float((dw - plain).abs().max())}
        row["plain_ms"] = median_ms(lambda: wgrad_reference(xp, g, k), n=10)
        xp_cl = xp.permute(0, 3, 1, 2)  # channels-last NCHW views
        g_cl = g.permute(0, 3, 1, 2)
        row["library_ms"] = median_ms(lambda: conv2d_weight(xp_cl, (co, ci, k, k), g_cl), n=50)
        row["bound_ms"], row["bound_by"] = wgrad_bound(b, h, ci, co, k, 2)
        emit({"phase": "wgrad", **row})
        if (h, ci, co, k) == WGRAD_REF_SHAPE:
            for name in kernels:
                ref_entry[name].update(ms=row[f"{name}_ms"], plain_ms=row["plain_ms"],
                                       library_ms=row["library_ms"], bound_ms=row["bound_ms"],
                                       bound_by=row["bound_by"])
            # the same shape on f32 inputs
            x32, g32 = xp.float(), g.float()
            plain32 = wgrad_reference(x32, g32, k)
            row32 = {"shape": [b, h, ci, co, k], "dtype": "float32"}
            for name, (fn, _) in kernels.items():
                dw32 = fn(x32, g32, k, device=DEVICE)
                err = rel_err(dw32, plain32)
                if not err <= WGRAD_TOL:
                    raise AssertionError(f"{name} f32: dW rel err {err} > {WGRAD_TOL}")
                same_bits(fn, x32, g32, k, dw32)
                row32[f"{name}_rel_err"] = err
                row32[f"{name}_ms"] = median_ms(lambda fn=fn: fn(x32, g32, k, device=DEVICE), n=50)
            row32["plain_ms"] = median_ms(lambda: wgrad_reference(x32, g32, k), n=10)
            row32["library_ms"] = median_ms(
                lambda: conv2d_weight(x32.permute(0, 3, 1, 2), (co, ci, k, k),
                                      g32.permute(0, 3, 1, 2)), n=50)
            row32["bound_ms"], row32["bound_by"] = wgrad_bound(b, h, ci, co, k, 4)
            emit({"phase": "wgrad", **row32})
    del cases, results

    # ragged shapes, after the path's launches were counted
    for rb, rh, rw, ci, co, k in WGRAD_RAGGED:
        for dtype in (torch.bfloat16, torch.float32):
            xp = torch.randn((rb, rh + k - 1, rw + k - 1, ci), generator=gen).to(dtype).to(DEVICE)
            g = torch.randn((rb, rh, rw, co), generator=gen).to(dtype).to(DEVICE)
            plain = wgrad_reference(xp, g, k)
            row = {"ragged": [rb, rh, rw, ci, co, k], "dtype": str(dtype).split(".")[1]}
            for name, (fn, _) in kernels.items():
                dw = fn(xp, g, k, device=DEVICE)
                err = rel_err(dw, plain)
                if not err <= WGRAD_TOL:
                    raise AssertionError(f"{name} {row}: dW rel err {err} > {WGRAD_TOL}")
                same_bits(fn, xp, g, k, dw)
                row[f"{name}_rel_err"] = err
            emit({"phase": "wgrad", **row})
    torch.cuda.empty_cache()
    return launches, ref_entry


def synthetic_batch(batch, size, seed=0):
    """bench.py:118-127: normal images, 32 boxes per image with centres in
    [0.2, 0.8] and sizes in [0.05, 0.3], random classes, all valid."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, 3, size, size)).astype(np.float32)
    boxes = rng.uniform(0.2, 0.8, (batch, TRAIN_MAX_GT, 4)).astype(np.float32)
    boxes[..., 2:] = rng.uniform(0.05, 0.3, (batch, TRAIN_MAX_GT, 2))
    classes = rng.integers(0, 80, (batch, TRAIN_MAX_GT)).astype(np.int32)
    mask = np.ones((batch, TRAIN_MAX_GT), bool)
    return images, boxes, classes, mask


def train_card_vs_cpu(darknet):
    """One f32 SGD step of yolov4-csp at 64², batch 2, on the card and on
    the CPU from the same weights and batch."""
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.models import YoloModel
    from yolodl_torch.train import TrainConfig, make_train_step, train_init
    from yolodl_torch.train.lr_schedule import LrScheduleConfig

    config = TrainConfig(optimizer="sgd", lr=LrScheduleConfig(kind="constant", lr=1e-2))
    batch = [torch.from_numpy(a) for a in synthetic_batch(2, 64, seed=1)]
    runs = {}
    for device in ("cpu", DEVICE):
        model = YoloModel(graph_from_darknet(darknet), device=device,
                          generator=torch.Generator().manual_seed(0))
        p0 = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
        ts, opt = train_init(model, config)
        ts, metrics = make_train_step(model, opt, config)(ts, *(a.to(device) for a in batch))
        runs[device] = (float(metrics["total_loss"]),
                        {k: v.detach().cpu() for k, v in model.named_parameters()})
    (l_cpu, p_cpu), (l_card, p_card) = runs["cpu"], runs[DEVICE]
    if not abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu):
        raise AssertionError(f"f32 train step loss: card {l_card} vs cpu {l_cpu}")
    # each tensor within 25 % of its largest update, plus 4 ulps of its
    # largest entry (p - lr*g rounds once more in f32 on either device).
    # cuDNN's f32 conv algorithms round otherwise than the CPU's, and at 64²
    # the deepest level is 2x2: training-mode BN normalizes over 8 values
    # there, and its backward amplifies those differences in the gradients
    # of the layers around it.  A wrong gradient moves the update by 100 %.
    worst, worst_key = 0.0, None
    eps = torch.finfo(torch.float32).eps
    for k, v in p_cpu.items():
        tol = 0.25 * float((v - p0[k]).abs().max()) + 4 * eps * float(v.abs().max())
        diff = float((p_card[k] - v).abs().max())
        ratio = diff / tol if tol > 0 else (0.0 if diff == 0 else float("inf"))
        if ratio > worst:
            worst, worst_key = ratio, k
    if not worst <= 1.0:
        raise AssertionError(f"f32 train step: {worst_key} differs by {worst} of its tolerance")
    return {"loss_card": l_card, "loss_cpu": l_cpu,
            "param_err_of_tolerance": worst, "worst_param": worst_key}


def is_device_work(event) -> bool:
    """A profiler event that is work on the card (a kernel, a copy, a
    memset), not a user annotation such as ``Optimizer.step#Adam.step``,
    which the profiler also files under the device."""
    return (getattr(event, "device_type", None) is not None
            and event.device_type.name == "CUDA"
            and not getattr(event, "is_user_annotation", False))


def profile_step(step, ts, batch) -> dict:
    """torch.profiler over one train step: device time, kernel count and
    the costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(ts, *batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if is_device_work(e)]

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    kernels.sort(key=dev_us, reverse=True)
    return {"step_kernels": sum(e.count for e in kernels),
            "step_device_ms": sum(dev_us(e) for e in kernels) / 1e3,
            "step_top": [[e.key[:60], e.count, dev_us(e) / 1e3] for e in kernels[:8]]}


def breakdown_step(model, optimizer, config, batch) -> dict:
    """The parts of one step in the step's own order — forward(train=True),
    yolo_loss, backward, optimizer + BN clamp — each synchronized and
    profiled on its own: device ms (profiler sum of its kernels), kernel
    count, and ms between CUDA events around it."""
    from torch.profiler import ProfilerActivity, profile

    from yolodl_torch.loss import yolo_loss

    images, boxes, classes, mask = batch
    state = {}

    def forward():
        state["pred"] = model(images, train=True)

    def loss():
        state["out"], _ = yolo_loss(state["pred"], boxes, classes, mask, config.loss)

    def backward():
        state["out"].total_loss.backward()

    def update():
        optimizer.step()
        model.clamp_running_vars()

    optimizer.zero_grad(set_to_none=False)
    out = {}
    for name, fn in (("forward", forward), ("loss", loss), ("backward", backward),
                     ("optimizer", update)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if is_device_work(e)]
        out[f"{name}_ms"] = start.elapsed_time(end)
        out[f"{name}_device_ms"] = sum(e.device_time_total for e in kernels) / 1e3
        out[f"{name}_kernels"] = len(kernels)
    return out


def phase_train():
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.kernels import wgrad_db, wgrad_lowch
    from yolodl_torch.models import YoloModel
    from yolodl_torch.train import TrainConfig, make_multi_step, make_train_step, train_init

    darknet = dk.Darknet.load(CFG)
    parity = train_card_vs_cpu(darknet)

    model = YoloModel(graph_from_darknet(darknet), device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
    config = TrainConfig()
    ts, opt = train_init(model, config)
    images, boxes, classes, mask = synthetic_batch(TRAIN_BATCH, IMAGE_SIZE)
    batch = (torch.from_numpy(images).to(torch.bfloat16).to(DEVICE),
             *(torch.from_numpy(a).to(DEVICE) for a in (boxes, classes, mask)))
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_train_step(model, opt, config)

    torch.cuda.reset_peak_memory_stats()
    wgrad_lowch.launches = wgrad_db.launches = 0
    losses, matched = [], []
    for _ in range(2):  # warm-up
        ts, m = step(ts, *batch)
        losses.append(m["total_loss"])
        matched.append(m["num_matched"])
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(10):
        ts, m = step(ts, *batch)
        events[i + 1].record()
        losses.append(m["total_loss"])
        matched.append(m["num_matched"])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 10
    step_ms = sorted(events[i].elapsed_time(events[i + 1]) for i in range(10))

    multi = make_multi_step(model, opt, config, 2)
    stacked = tuple(x.unsqueeze(0).expand(2, *x.shape) for x in batch)
    t0 = time.perf_counter()
    ts, m = multi(ts, *stacked)
    torch.cuda.synchronize()
    multi_ms = (time.perf_counter() - t0) * 1e3 / 2
    losses.extend(m["total_loss"].unbind(0))
    matched.extend(m["num_matched"].unbind(0))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    loss_values = [float(v) for v in losses]
    if not all(np.isfinite(loss_values)) or len(loss_values) != 14:
        raise AssertionError(f"train losses {loss_values}")
    if not all(int(v) > 0 for v in matched):
        raise AssertionError("a step matched no target")
    changed = sum(int(not torch.equal(v, p0[k])) for k, v in model.named_parameters())
    if changed != len(p0):
        raise AssertionError(f"{len(p0) - changed} of {len(p0)} parameters did not change")
    if wgrad_lowch.launches or wgrad_db.launches:
        raise AssertionError("the train step launched a wgrad kernel")
    if ts.step != 14:
        raise AssertionError(f"step count {ts.step} != 14")

    try:  # auxiliary: a profiler that sees no device time is not a failure
        profiled = {**profile_step(step, ts, batch), **breakdown_step(model, opt, config, batch)}
    except Exception as e:
        profiled = {"profile": f"not measured: {type(e).__name__}: {e}"}
    median = step_ms[len(step_ms) // 2]
    if "step_device_ms" in profiled:  # the card's idle share of a median step
        profiled["device_idle_share"] = 1.0 - profiled["step_device_ms"] / median
    emit({"phase": "train", "model": "yolov4-csp", "image_size": IMAGE_SIZE,
          "batch": TRAIN_BATCH, "dtype": "bfloat16", "optimizer": "adam",
          "steps": ts.step, "step_ms_median": median, "step_ms_min": step_ms[0],
          "step_ms_max": step_ms[-1], "host_ms_per_step": wall_ms,
          "multi_step_ms_per_step": multi_ms, "img_per_s": TRAIN_BATCH * 1e3 / median,
          "peak_memory_gb": peak_gb, "first_loss": loss_values[0],
          "last_loss": loss_values[-1], "num_matched": int(matched[-1]),
          "card_vs_cpu": parity, **profiled})
    del model, opt, ts, batch, stacked
    torch.cuda.empty_cache()
    return {"step_ms_median": median, "img_per_s": TRAIN_BATCH * 1e3 / median}


def profile_postprocess(svc, pred) -> dict:
    """torch.profiler over one postprocess: work on the card (kernels,
    copies, memsets) and host syncs of a fixed-point loop (aten::equal)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc.postprocess(pred)
        torch.cuda.synchronize()
    events = prof.events()
    return {"kernels": sum(1 for e in events if is_device_work(e)),
            "convergence_checks": sum(1 for e in events if e.name == "aten::equal")}


def profile_forward(svc, stacked) -> dict:
    """torch.profiler over one forward: kernels, device ms, the costliest."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc.forward(stacked)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and e.device_type.name == "CUDA"]

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    kernels.sort(key=dev_us, reverse=True)
    return {"forward_kernels": sum(e.count for e in kernels),
            "forward_device_ms": sum(dev_us(e) for e in kernels) / 1e3,
            "forward_top": [[e.key[:60], e.count, dev_us(e) / 1e3] for e in kernels[:6]]}


class swapped:
    """Replaces attributes of a module for the duration of a with-block."""

    def __init__(self, module, **attrs):
        self.module, self.attrs = module, attrs

    def __enter__(self):
        self.saved = {k: getattr(self.module, k) for k in self.attrs}
        for k, v in self.attrs.items():
            setattr(self.module, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)


def bf16_vs_f32(model) -> None:
    """The card's bf16 forward of the seeded model at IMAGE_SIZE² against
    its f32 forward on the same two images: max|Δ| / max|f32| of the boxes
    within BF16_BOX_TOL and of the logits within BF16_LOGIT_TOL.  The line
    is printed before the check."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 3, IMAGE_SIZE, IMAGE_SIZE))
                         .astype(np.float32)).to(DEVICE)
    with torch.inference_mode():
        f32, bf16 = model(x), model(x.to(torch.bfloat16))
    line = {"phase": "precision", "model": "yolov4-csp", "image_size": IMAGE_SIZE,
            "tolerance": {"cycxhw": BF16_BOX_TOL, "obj_logit": BF16_LOGIT_TOL,
                          "class_logit": BF16_LOGIT_TOL}}
    for f in ("cycxhw", "obj_logit", "class_logit"):
        r, o = getattr(f32, f).float(), getattr(bf16, f).float()
        scale = float(r.abs().max())
        line[f] = {"max_abs_err_of_max": float((o - r).abs().max()) / scale,
                   "mean_abs_err_of_max": float((o - r).abs().mean()) / scale,
                   "max_abs_f32": scale}
    emit(line)
    for f in ("cycxhw", "obj_logit", "class_logit"):
        if not line[f]["max_abs_err_of_max"] <= line["tolerance"][f]:
            raise AssertionError(f"bf16 forward {f}: {line[f]} beyond {line['tolerance'][f]}")


def phase_serve(iou):
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.loss import nms as nms_mod
    from yolodl_torch.loss import to_host_detections
    from yolodl_torch.models import YoloModel
    from yolodl_torch.serve import DetectionService, make_http_server

    darknet = dk.Darknet.load(CFG)
    nms_kind, nms_beta = nms_mod.nms_options_from_darknet(darknet)
    t0 = time.perf_counter()
    model = YoloModel(graph_from_darknet(darknet), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    build_s = time.perf_counter() - t0

    # f32 forward on the card vs the same seeded model on the CPU, 64x64
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 3, 64, 64))
                         .astype(np.float32))
    cpu_model = YoloModel(graph_from_darknet(darknet), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        ref = cpu_model(x)
        out = model(x.cuda())
    for f in ("cycxhw", "obj_logit", "class_logit"):
        r, o = getattr(ref, f), getattr(out, f).cpu()
        scale = float(r.abs().max())
        err = float((o - r).abs().max())
        if not err <= 1e-4 * scale + 1e-6:
            raise AssertionError(f"f32 forward {f}: card vs cpu max|d|={err} (max {scale})")
    del cpu_model
    bf16_vs_f32(model)

    svc = DetectionService(model, image_size=IMAGE_SIZE, batch_size=BATCH,
                           window_ms=10.0, nms_kind=nms_kind, nms_beta=nms_beta)
    warm_s = svc.warmup()

    # device time of one batch, forward and postprocess apart
    frames = [np.random.default_rng(i).integers(0, 256, (IMAGE_SIZE, IMAGE_SIZE, 3),
                                                dtype=np.uint8) for i in range(BATCH)]
    stacked = torch.from_numpy(np.stack(frames)).cuda()
    with torch.inference_mode():
        pred = svc.forward(stacked)
        fwd_ms = median_ms(lambda: svc.forward(stacked), n=20)
        post_ms = median_ms(lambda: svc.postprocess(pred), n=20)
        finite = all(bool(torch.isfinite(getattr(pred, f)).all())
                     for f in ("cycxhw", "obj_logit", "class_logit"))
        if not finite or pred.cycxhw.shape != (BATCH, 22743, 4):
            raise AssertionError(f"bad forward output {tuple(pred.cycxhw.shape)}")
        # one batch post-processed on three routes: the two kernels; their
        # plain versions; the dense route (IoU matrix from the pairwise_iou
        # kernel, eager DIoU, Jacobi fixed point read on the host)
        plain = swapped(nms_mod,
                        nms_conflict_bits=lambda *a, device: iou.nms_conflict_bits_reference(*a),
                        nms_keep_from_bits=lambda *a, device: iou.nms_keep_from_bits_reference(*a))
        dense = swapped(nms_mod, _suppress=lambda tlbr, group, valid, thr, kind, beta:
                         iou.keep_from_conflict(iou.conflict_matrix(
                             tlbr, group, thr, kind, beta, iou=iou.pairwise_iou(tlbr)), valid))
        kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)
        with_kernel = svc.postprocess(pred)
        before = [fn.launches for fn in kernels]
        with plain:
            with_plain = svc.postprocess(pred)
        if [fn.launches for fn in kernels] != before:
            raise AssertionError("the plain postprocess launched a kernel")
        iou.pairwise_iou.launches = 0
        with dense:
            with_dense = svc.postprocess(pred)
        dense_iou_launches = iou.pairwise_iou.launches
        if [fn.launches for fn in kernels] != before or dense_iou_launches != 1:
            raise AssertionError("the dense postprocess: wrong launches")
        for f in ("valid", "classes", "instances"):
            for route, other in (("plain", with_plain), ("dense", with_dense)):
                if not torch.equal(getattr(with_kernel, f), getattr(other, f)):
                    raise AssertionError(f"postprocess {f}: kernel and {route} route disagree")
        kept = int(with_kernel.valid.sum())
        post = profile_postprocess(svc, pred)
        with dense:
            dense_ms = median_ms(lambda: svc.postprocess(pred), n=20)
            dense_post = profile_postprocess(svc, pred)
        if post["convergence_checks"] != 0:
            raise AssertionError(f"the postprocess synced {post['convergence_checks']} times")
        # the two kernels on the served batch's own candidates
        captured = []
        real_suppress = nms_mod._suppress

        def capture(*args):
            captured.append(args)
            return real_suppress(*args)

        with swapped(nms_mod, _suppress=capture):
            svc.postprocess(pred)
        tlbr, group, valid, thr, kind, beta = captured[0]
        bits = iou.nms_conflict_bits(tlbr, group, thr, kind, beta)
        served = {"served_conflict_ms": median_ms(
                      lambda: iou.nms_conflict_bits(tlbr, group, thr, kind, beta)),
                  "served_keep_ms": median_ms(lambda: iou.nms_keep_from_bits(bits, valid)),
                  "served_candidates": int(valid.sum()),
                  "served_kept": int(iou.nms_keep_from_bits(bits, valid).sum())}
        # host side of one batch: unpack + map to original pixels, as the
        # completer thread does it
        t0 = time.perf_counter()
        dets = to_host_detections(with_kernel)
        for d in dets:
            svc._to_original_pixels(d, (IMAGE_SIZE, IMAGE_SIZE))
        host_unpack_ms = (time.perf_counter() - t0) * 1e3
        try:  # auxiliary: a profiler that sees no device time is not a failure
            profiled = profile_forward(svc, stacked)
        except Exception as e:
            profiled = {"profile": f"not measured: {type(e).__name__}: {e}"}
    emit({"phase": "breakdown", "forward_ms": fwd_ms, "postprocess_ms": post_ms,
          "postprocess_kernels": post["kernels"],
          "postprocess_convergence_checks": post["convergence_checks"],
          "dense_postprocess_ms": dense_ms, "dense_postprocess_kernels": dense_post["kernels"],
          "dense_postprocess_convergence_checks": dense_post["convergence_checks"],
          **served, "batch": BATCH, "kept_detections": kept, "host_unpack_ms": host_unpack_ms,
          "model_build_s": build_s, "warmup_s": warm_s, **profiled})

    # the serving run: counters zeroed right before, read right after
    for fn in kernels:
        fn.launches = 0
    svc.start()
    server = make_http_server(svc, port=0)
    http = threading.Thread(target=server.serve_forever, daemon=True)
    http.start()
    results, errors = [None] * 32, []

    def client(i):
        try:
            for j in range(4):
                results[4 * i + j] = svc.submit_u8(frames[(i + j) % BATCH])
        except Exception as e:  # reported below
            errors.append(repr(e))

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        snap_run = svc.stats.snapshot(BATCH)

        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            if json.load(r) != {"ok": True}:
                raise AssertionError("/healthz")
        from PIL import Image

        posted = 0
        for arr, fmt in [(frames[0], "PNG"),
                         (np.asarray(Image.fromarray(frames[1]).resize((640, 480))), "JPEG")]:
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format=fmt)
            req = urllib.request.Request(base + "/detect", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                body = json.load(r)
            if not isinstance(body.get("detections"), list):
                raise AssertionError(f"/detect: {body}")
            posted += 1
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.load(r)
    finally:
        server.shutdown()
        server.server_close()
        svc.shutdown()
    launches = {fn.__name__: fn.launches for fn in kernels}

    if errors or any(r is None for r in results):
        raise AssertionError(f"requests failed: {errors[:3]}")
    for dets in results:
        for d in dets:
            x0, y0, w, h = d["bbox"]
            if not (0 <= d["class"] < 80 and 0.25 <= d["score"] <= 1.0
                    and 0 <= x0 <= IMAGE_SIZE and 0 <= y0 <= IMAGE_SIZE
                    and w >= 0 and h >= 0 and np.isfinite([x0, y0, w, h]).all()):
                raise AssertionError(f"malformed detection {d}")
    if stats["errors"] != 0:
        raise AssertionError(f"service errors: {stats}")
    if set(launches.values()) != {stats["batches"]} or stats["batches"] == 0:
        raise AssertionError(f"launches {launches} != served batches {stats['batches']}")
    lat = snap_run.get("latency_ms", {})
    emit({"phase": "serve", "model": "yolov4-csp", "image_size": IMAGE_SIZE,
          "batch": BATCH, "dtype": "bfloat16", "nms_kind": nms_kind, "nms_beta": nms_beta,
          "requests": len(results), "http_posts": posted,
          "img_per_s": snap_run["images_done"] / wall,
          "latency_p50_ms": lat.get("p50"), "latency_p95_ms": lat.get("p95"),
          "mean_batch_fill": snap_run["mean_batch_fill"],
          "batches": stats["batches"], **{f"{n}_launches": v for n, v in launches.items()},
          "detections": sum(len(r) for r in results), "errors": stats["errors"],
          "pil": True})
    return {**launches, "pairwise_iou": dense_iou_launches}


def cli_workspace(root, seed=0):
    """CLI_IMAGES JPEGs under root/images at CLI_SIZES in turn (smooth
    colour fields with noise), 1-5 boxes each over COCO's 80 names, as a
    CSV dataset, and root/detect.json5 (comments, trailing commas).
    Returns (config path, number of boxes)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    with open(os.path.join(REPO, "cfg", "class", "coco.class")) as f:
        names = [line.strip() for line in f if line.strip()]
    os.makedirs(os.path.join(root, "images"))
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    lines, boxes = ["image_file,class_name,cy,cx,h,w"], 0
    for i in range(CLI_IMAGES):
        h, w = CLI_SIZES[i % len(CLI_SIZES)]
        low = rng.integers(0, 256, (h // 40 + 2, w // 40 + 2, 3), dtype=np.uint8)
        pixels = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR), np.int16)
        pixels = np.clip(pixels + rng.integers(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(pixels).save(os.path.join(root, "images", f"{i:03d}.jpg"), quality=90)
        for _ in range(int(rng.integers(1, 6))):
            bh, bw = rng.uniform(0.05, 0.6) * h, rng.uniform(0.05, 0.6) * w
            cy, cx = rng.uniform(bh / 2, h - bh / 2), rng.uniform(bw / 2, w - bw / 2)
            lines.append(f"{i:03d}.jpg,{names[rng.integers(80)]},{cy:.2f},{cx:.2f},"
                         f"{bh:.2f},{bw:.2f}")
            boxes += 1
    with open(os.path.join(root, "label.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    config = os.path.join(root, "detect.json5")
    with open(config, "w") as f:
        f.write(f"""// yolov4-csp at {IMAGE_SIZE}x{IMAGE_SIZE} on a synthetic CSV dataset
{{
  version: "0.1.0",
  model: {{
    kind: "Darknet",
    cfg_file: "{CFG}",  // absolute: the workspace lies outside cfg/
    minibatch_size: {BATCH},
    devices: ["cuda:0",],
  }},
  input: {{
    kind: {{
      type: "Csv", image_size: {IMAGE_SIZE}, image_dir: "images",
      label_file: "label.csv", classes_file: "classes.txt",
    }},
  }},
  /* boxes were written to 0.01 px */
  preprocess: {{out_of_bound_tolerance: 1.0,}},
  output: {{
    output_dir: "{os.path.join(root, 'out')}",
    nms_iou_thresh: {NMS_IOU}, nms_conf_thresh: {CLI_CONF},
  }},
}}
""")
    return config, boxes


def serve_subprocess(config, model_args, images) -> dict:
    """serve_main as a user starts it, the model from ``model_args``
    (``--weights`` or ``--artifact``): POST CLI_POSTS images from
    CLI_CLIENTS threads, check every answer, read /stats, stop it with
    SIGINT.  Returns the numbers of the run."""
    import queue
    import signal

    log = os.path.join(os.path.dirname(config), "serve.log")
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "yolodl_torch.cli.serve_main", "--config-file", config,
             *model_args, "--port", "0", "--batch-size", str(BATCH), *CLI_DEVICE_ARGS],
            stdout=subprocess.PIPE, stderr=err, text=True, cwd=REPO,
            env={**os.environ, "PYTHONPATH": REPO})
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout], daemon=True).start()
    t_start = time.perf_counter()
    deadline = t_start + CLI_SERVE_TIMEOUT
    try:
        line = ""
        while "serving on http://" not in line:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None or time.perf_counter() > deadline:
                    with open(log) as f:
                        raise AssertionError(f"serve_main did not come up (exit code "
                                             f"{proc.poll()}): {f.read()[-2000:]}") from None
        up_s = time.perf_counter() - t_start
        base = line.split("serving on ")[1].split()[0]
        results, errors = [None] * CLI_POSTS, []

        def client(c):
            try:
                for j in range(c, CLI_POSTS, CLI_CLIENTS):
                    path, h, w = images[j % len(images)]
                    with open(path, "rb") as f:
                        req = urllib.request.Request(base + "/detect", data=f.read(), method="POST")
                    with urllib.request.urlopen(req, timeout=120) as r:
                        results[j] = (json.load(r), h, w)
            except Exception as e:  # reported below
                errors.append(repr(e))

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(CLI_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=max(1.0, deadline - time.perf_counter()))
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.load(r)
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    with open(log) as f:
        log_tail = f.read()[-2000:]
    if rc != 0:
        raise AssertionError(f"serve_main exited {rc} on SIGINT: {log_tail}")
    if errors or any(r is None for r in results):
        raise AssertionError(f"serve_main: requests failed: {errors[:3]}")
    detections = 0
    for body, h, w in results:
        if not isinstance(body.get("latency_ms"), (int, float)):
            raise AssertionError(f"serve_main: no latency_ms in {body}")
        for d in body["detections"]:
            x0, y0, bw, bh = d["bbox"]
            if not (0 <= d["class"] < 80 and d.get("class_name") and CLI_CONF <= d["score"] <= 1
                    and 0 <= x0 and 0 <= y0 and bw >= 0 and bh >= 0
                    and x0 + bw <= w + 0.01 and y0 + bh <= h + 0.01):
                raise AssertionError(f"serve_main: detection {d} outside its {w}x{h} image")
        detections += len(body["detections"])
    if stats["errors"] != 0 or stats["images_done"] != CLI_POSTS:
        raise AssertionError(f"serve_main stats: {stats}")
    lat = stats.get("latency_ms", {})
    return {"serve_img_per_s": CLI_POSTS / wall, "serve_p50_ms": lat.get("p50"),
            "serve_p95_ms": lat.get("p95"), "serve_batches": stats["batches"],
            "serve_mean_batch_fill": stats["mean_batch_fill"], "serve_detections": detections,
            "serve_start_s": up_s, "serve_exit_code": rc}


def phase_cli(iou):
    """The detect, eval and serve CLIs on yolov4-csp-608 from a .weights
    file; see the module docstring.  Returns B1's launches per CLI call."""
    import contextlib
    import shutil

    from yolodl_torch.bridge import params_from_jax, params_to_jax
    from yolodl_torch.cli import detect_main, eval_main
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.config.app_config import DetectAppConfig
    from yolodl_torch.data import cache as cache_mod
    from yolodl_torch import loss as loss_pkg
    from yolodl_torch.data.datasets import SanitizedDataset
    from yolodl_torch.loss import inference as inference_mod
    from yolodl_torch.loss import non_max_suppression, yolo_inference
    from yolodl_torch.loss.nms import nms_options_from_darknet
    from yolodl_torch.models import GraphModel, zoo
    from yolodl_torch.models.weights import save_darknet_weights
    from yolodl_torch.train import checkpoint
    from yolodl_torch.train import evaluation as evaluation_mod
    from yolodl_torch.train import logging as logging_mod
    from yolodl_torch.train.ema import ema_init, ema_update

    root = os.path.join(REPO, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        darknet = dk.Darknet.load(CFG)
        model = zoo.load_darknet_model(CFG, seed=0, device=DEVICE)
        reference = model.state_dict()
        n_params = sum(p.numel() for p in model.parameters())

        def identical(other, what):
            got = other.state_dict()
            differ = [k for k in reference if not torch.equal(got[k], reference[k])]
            if set(got) != set(reference) or differ:
                raise AssertionError(f"{what}: {len(differ)} tensors differ: {differ[:4]}")

        # .weights round trip through the port's saver and zoo.load_darknet_model
        weights = os.path.join(root, "yolov4-csp.weights")
        save_darknet_weights(darknet, *params_to_jax(reference), weights)
        t0 = time.perf_counter()
        identical(zoo.load_darknet_model(CFG, weights, seed=1, device=DEVICE), ".weights round trip")
        weights_load_s = time.perf_counter() - t0

        # .ckpt round trip with an EMA that differs from the parameters
        params = dict(model.named_parameters())
        ema = ema_init(params)
        with torch.no_grad():
            ema_update(ema, {k: v * 0.5 for k, v in params.items()}, step=1000, decay=0.9)
        path = checkpoint.save_checkpoint(os.path.join(root, "checkpoints"), 1, 0.5,
                                          *params_to_jax(reference),
                                          ema_params=params_to_jax(ema)[0])
        fresh = zoo.load_darknet_model(CFG, seed=2, device=DEVICE)
        p, s, _, meta = checkpoint.load_checkpoint(path, *params_to_jax(fresh.state_dict()))
        params_from_jax(p, s, model=fresh)
        identical(fresh, ".ckpt round trip")
        ema_back = params_from_jax(meta["ema"], {})
        if set(ema_back) != set(ema) or not all(torch.equal(ema_back[k], ema[k].cpu()) for k in ema):
            raise AssertionError(".ckpt round trip: the EMA parameters differ")
        del fresh, p, s, meta, ema_back

        config, n_boxes = cli_workspace(root)
        kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)
        batches = -(-CLI_IMAGES // BATCH)
        spans = {}  # seconds by span of the CLI call under way
        first_decode = []
        real_make_loader = cache_mod.make_decode_loader

        def timed(key, fn):
            """``fn``, adding the seconds of each call to spans[key]."""
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
            return wrapper

        def timed_loader(hw):
            """The CLI's loader, noting when its first image is decoded and
            timing each decode + letterbox."""
            loader = real_make_loader(hw)
            real_load = timed("decode", loader.load)

            def load(record):
                if not first_decode:
                    first_decode.append(time.perf_counter())
                return real_load(record)

            loader.load = load
            return loader

        captured = []
        real_unpack = inference_mod.to_host_detections

        def unpack(out):
            captured.append(real_unpack(out))
            return captured[-1]

        def run_cli(main, argv, **timed_spans):
            """(return value, stdout lines, seconds from the first decode to
            the return, ms per batch by span, launches), the counters zeroed
            right before.  ``timed_spans``: span → (module or class, name of
            the function timed during the call).  The forward and the NMS
            are timed as the host issues them; the device's work on them is
            waited for in the span that first reads a result."""
            first_decode.clear()
            spans.clear()
            out = io.StringIO()
            for fn in kernels:
                fn.launches = 0
            with contextlib.ExitStack() as stack:
                stack.enter_context(swapped(cache_mod, make_decode_loader=timed_loader))
                stack.enter_context(swapped(inference_mod, to_host_detections=unpack))
                for key, (owner, name) in timed_spans.items():
                    stack.enter_context(swapped(owner, **{name: timed(key, getattr(owner, name))}))
                stack.enter_context(contextlib.redirect_stdout(out))
                result = main(argv)
            torch.cuda.synchronize()
            total = time.perf_counter() - first_decode[0]
            launches = {fn.__name__: fn.launches for fn in kernels}
            if set(launches.values()) != {batches}:
                raise AssertionError(f"{main.__module__}: launches {launches}, {batches} batches")
            by_span = {k: v / batches * 1e3 for k, v in spans.items()}
            by_span["other"] = total / batches * 1e3 - sum(by_span.values())
            return result, out.getvalue().splitlines(), total, by_span, launches

        coco_json = os.path.join(root, "detections.json")
        _, detect_lines, detect_s, detect_spans, detect_launches = run_cli(detect_main.main, [
            "--config-file", config, "--weights", weights, "--precision", "bfloat16",
            "--save-json", coco_json, *CLI_DEVICE_ARGS],
            forward=(GraphModel, "forward"), nms=(loss_pkg, "non_max_suppression"),
            device_wait_and_unpack=(inference_mod, "to_host_detections"),
            draw=(logging_mod, "draw_boxes_on_image"))
        drawn = sorted(os.listdir(os.path.join(root, "out")))
        if len(drawn) != CLI_IMAGES or len(captured) != batches:
            raise AssertionError(f"detect_main: {len(drawn)} images, {len(captured)} batches")
        with open(coco_json) as f:
            coco = json.load(f)
        if not all(set(d) == {"image_id", "file_name", "category_id", "bbox", "score"}
                   and 0 <= d["image_id"] < CLI_IMAGES and d["score"] >= CLI_CONF
                   for d in coco):
            raise AssertionError("detect_main: malformed COCO JSON entries")

        # detect's first batch against the direct path on the same decoded batch
        cfg = DetectAppConfig.load(config)
        records = SanitizedDataset(cfg.dataset.open(root), out_of_bound_tolerance=1.0).records()
        loader = real_make_loader((IMAGE_SIZE, IMAGE_SIZE))
        images = np.stack([loader.load(r).image for r in records[:BATCH]])
        kind, beta = nms_options_from_darknet(darknet)
        with torch.inference_mode():
            pred = model(torch.from_numpy(images).to(DEVICE).to(torch.bfloat16))
            direct = real_unpack(yolo_inference(non_max_suppression(
                pred, iou_threshold=cfg.nms_iou_thresh, confidence_threshold=cfg.nms_conf_thresh,
                suppress_by_class=False, class_mode="argmax", kind=kind, beta=beta),
                pred.num_flats))
        if direct != captured[0]:
            same = sum(a == b for a, b in zip(direct, captured[0]))
            raise AssertionError(f"detect_main's first batch differs from the direct path "
                                 f"({same} of {BATCH} images agree)")

        report, eval_lines, eval_s, eval_spans, eval_launches = run_cli(eval_main.main, [
            "--config-file", config, "--weights", weights, "--precision", "bfloat16",
            *CLI_DEVICE_ARGS],
            forward=(GraphModel, "forward"), nms=(evaluation_mod, "non_max_suppression"),
            ap=(evaluation_mod, "ap_at_thresholds"))
        if not (report["images"] == CLI_IMAGES and report["ground_truths"] == n_boxes
                and all(0.0 <= report[k] <= 1.0 for k in ("mAP@0.5", "mAP@0.5:0.95"))
                and json.loads(eval_lines[-1]) == report):
            raise AssertionError(f"eval_main: {report}")

        src = [(os.path.join(root, "images", f"{i:03d}.jpg"), *CLI_SIZES[i % len(CLI_SIZES)])
               for i in range(CLI_IMAGES)]
        served = serve_subprocess(config, ["--weights", weights], src)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        emit({"phase": "cli", "model": "yolov4-csp", "image_size": IMAGE_SIZE,
              "parameters": n_params, "batch": BATCH, "images": CLI_IMAGES,
              "original_sizes": CLI_SIZES, "boxes": n_boxes, "dtype": "bfloat16",
              "nms_kind": kind, "nms_beta": beta, "weights_load_s": weights_load_s,
              "weights_mb": os.path.getsize(weights) / 1e6,
              "detect_img_per_s": CLI_IMAGES / detect_s,
              "detect_ms_per_batch": detect_s / batches * 1e3,
              "detect_ms_per_batch_by_span": detect_spans,
              "detect_detections": len(coco), "detect_stdout": detect_lines,
              "eval_img_per_s": CLI_IMAGES / eval_s, "eval_ms_per_batch": eval_s / batches * 1e3,
              "eval_ms_per_batch_by_span": eval_spans,
              "eval": report, **served,
              **{f"detect_{k}_launches": v for k, v in detect_launches.items()},
              **{f"eval_{k}_launches": v for k, v in eval_launches.items()},
              "card": card.splitlines()[0]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"cli_detect": detect_launches, "cli_eval": eval_launches}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def train_main_workspace(root, size, seed=0, names=None, images=None, eval_images=None):
    """JPEGs at TRAIN_MAIN_SIZES in turn (smooth colour fields with noise,
    seed 0), 1-4 boxes each of a random one of ``names`` (default:
    cfg/class/iii.class's first class, the one class of cfg/train.json5's
    64x64 model), as a training CSV set of ``images`` (TRAIN_MAIN_IMAGES)
    and a held-out one of ``eval_images`` (TRAIN_MAIN_EVAL_IMAGES).
    Returns {name: dataset.kind} for "train" and "eval"."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    if names is None:
        with open(os.path.join(REPO, "cfg", "class", "iii.class")) as f:
            names = [f.readline().strip()]
    images = TRAIN_MAIN_IMAGES if images is None else images
    eval_images = TRAIN_MAIN_EVAL_IMAGES if eval_images is None else eval_images
    os.makedirs(os.path.join(root, "images"))
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    lines = {"train": ["image_file,class_name,cy,cx,h,w"], "eval": ["image_file,class_name,cy,cx,h,w"]}
    for i in range(images + eval_images):
        h, w = TRAIN_MAIN_SIZES[i % len(TRAIN_MAIN_SIZES)]
        low = rng.integers(0, 256, (h // 40 + 2, w // 40 + 2, 3), dtype=np.uint8)
        pixels = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR), np.int16)
        pixels = np.clip(pixels + rng.integers(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(pixels).save(os.path.join(root, "images", f"{i:04d}.jpg"), quality=90)
        split = "train" if i < images else "eval"
        for _ in range(int(rng.integers(1, 5))):
            bh, bw = rng.uniform(0.1, 0.5) * h, rng.uniform(0.1, 0.5) * w
            cy, cx = rng.uniform(bh / 2, h - bh / 2), rng.uniform(bw / 2, w - bw / 2)
            name = names[int(rng.integers(len(names)))] if len(names) > 1 else names[0]
            lines[split].append(f"{i:04d}.jpg,{name},{cy:.2f},{cx:.2f},{bh:.2f},{bw:.2f}")
    kinds = {}
    for split, rows in lines.items():
        with open(os.path.join(root, f"{split}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
        kinds[split] = {"type": "Csv", "image_size": size, "input_channels": 3,
                        "image_dir": os.path.join(root, "images"),
                        "label_file": os.path.join(root, f"{split}.csv"),
                        "classes_file": os.path.join(root, "classes.txt")}
    return kinds


def write_json(path, raw) -> str:
    with open(path, "w") as f:
        json.dump(raw, f, indent=1)
    return path


def newslab_card_vs_cpu(path) -> dict:
    """The f32 forward of a NEWSLAB model on the card and on the CPU, same
    seeded weights, 64x64: within 1e-4 · max|ref| + 1e-6, as the darknet
    model in phase serve."""
    from yolodl_torch.models import zoo

    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 3, 64, 64))
                         .astype(np.float32))
    out = {}
    with torch.inference_mode():
        ref = zoo.load_newslab_model(path, seed=0, device="cpu")(x)
        got = zoo.load_newslab_model(path, seed=0, device=DEVICE)(x.to(DEVICE))
    for f in ("cycxhw", "obj_logit", "class_logit"):
        r, o = getattr(ref, f), getattr(got, f).cpu()
        scale, err = float(r.abs().max()), float((o - r).abs().max())
        out[f"{f}_max_abs_err"] = err
        if not err <= 1e-4 * scale + 1e-6:
            raise AssertionError(f"NEWSLAB f32 forward {f}: card vs cpu max|d|={err} "
                                 f"(max {scale})")
    return out


def saved_bytes(model, size, **forward) -> int:
    """Bytes autograd saves for the backward of one image's training
    forward at size², on the card: unique storages seen by
    torch.autograd.graph.saved_tensors_hooks, the parameters not counted."""
    seen = {p.untyped_storage().data_ptr() for p in model.parameters()}
    total = [0]

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in seen:
            seen.add(ptr)
            total[0] += t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(torch.rand((1, 3, size, size), device=DEVICE), train=True, **forward)
    return total[0]


def saved_activation_bytes(model_path, size) -> dict:
    """saved_bytes of a NEWSLAB model at size², without and with remat
    "blocks"."""
    from yolodl_torch.graph import Graph
    from yolodl_torch.models import YoloModel

    out = {}
    for remat in ("off", "blocks"):
        model = YoloModel(Graph.load_newslab_v1_json(model_path), device=DEVICE, remat=remat)
        out[remat] = saved_bytes(model, size)
        del model
    torch.cuda.empty_cache()
    return out


def crc32c_ms(size) -> float:
    """Median host ms of the port's CRC-32C over one TFRecord cache payload
    (a 3 x size x size u8 image), 20 calls."""
    from yolodl_torch.data.tfrecord_cache import crc32c

    payload = np.random.default_rng(0).integers(0, 256, 3 * size * size, np.uint8).tobytes()
    crc32c(payload)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        crc32c(payload)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def train_main_config(root, kinds) -> dict:
    """cfg/train.json5 read by the port's JSON5 reader, with what phase
    train_main changes: the dataset (``kinds``: train_main_workspace's),
    logging.dir, cache_dir, load_checkpoint, an evaluation block, and the
    memory (remat, accumulation_steps); the model path only becomes
    absolute."""
    from yolodl_torch.config import json5_reader

    with open(TRAIN_MAIN_CONFIG) as f:
        raw = json5_reader.load(f)
    raw["model"]["cfg_file"] = os.path.join(REPO, raw["model"]["cfg_file"])
    raw["dataset"]["kind"] = kinds["train"]
    raw["logging"]["dir"] = os.path.join(root, "logs")
    raw["preprocessor"]["cache"]["cache_dir"] = os.path.join(root, "cache")
    raw["training"]["load_checkpoint"] = {"type": "Disabled"}
    # at 256², batch 96, f32 the model's saved activations outgrow the
    # card's 80 GB (its head is at full resolution, 65,536 flats an
    # image; the line's saved_activations_gb_per_batch).  remat "blocks"
    # changes no value (tests/test_torch_newslab_ops.py) and cuts them,
    # but a block's recompute at batch 96 still outgrew the card; so the
    # batch of 96 also runs as 4 accumulated micro-batches of 24
    # (darknet's subdivisions; BN normalizes over each micro-batch)
    raw["training"]["remat"] = True
    raw["training"]["accumulation_steps"] = TRAIN_MAIN_ACCUMULATION
    raw["evaluation"] = {"interval": TRAIN_MAIN_EVAL_INTERVAL,
                         "batch_size": TRAIN_MAIN_EVAL_BATCH,
                         "dataset": {"kind": kinds["eval"]}}
    return raw


def run_train_main(*argv) -> None:
    """train_main.main in this process, with PyTorch's TF32 defaults, as in
    a user's process (cuDNN convs in TF32); its SIGINT/SIGTERM handlers and
    the smoke's TF32 settings are put back afterwards."""
    import signal

    from yolodl_torch.cli import train_main

    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    with swapped(torch.backends.cudnn, allow_tf32=True):
        try:
            train_main.main([*argv, *CLI_DEVICE_ARGS])
        finally:
            for s, handler in saved.items():
                signal.signal(s, handler)


def phase_train_main(iou):
    """yolodl_torch.cli.train_main on cfg/train.json5's model and recipe at
    batch 96, interrupted and resumed, then detect_main on cfg/detect.json5's
    model; see the module docstring.  Returns B1's launches per path and
    the line's step numbers (for phase augment)."""
    import contextlib
    import glob
    import shutil
    import signal

    from yolodl_torch import train as train_pkg
    from yolodl_torch.bridge import params_to_jax
    from yolodl_torch.cli import detect_main
    from yolodl_torch.config import json5_reader
    from yolodl_torch.data import pipeline as pipeline_mod
    from yolodl_torch.models import zoo
    from yolodl_torch.train import checkpoint
    from yolodl_torch.train import evaluation as evaluation_mod

    root = TRAIN_MAIN_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)

    try:
        with open(TRAIN_MAIN_CONFIG) as f:
            size = int(json5_reader.load(f)["dataset"]["kind"]["image_size"])  # the Iii set's
        kinds = train_main_workspace(root, size)
        raw = train_main_config(root, kinds)
        model_path = raw["model"]["cfg_file"]
        parity = newslab_card_vs_cpu(model_path)
        saved = saved_activation_bytes(model_path, size)
        batch = int(raw["training"]["batch_size"])
        config = write_json(os.path.join(root, "train.json5"), raw)

        # the timed run, in this process: B1's counters zeroed right before
        spans = {"data_wait": [], "step": [], "evaluation": []}
        losses, records, profiled = [], [], {}
        real_prefetch, real_make_step = pipeline_mod.device_prefetch, train_pkg.make_train_step
        real_eval = evaluation_mod.DatasetEvaluator.__call__

        def timed_prefetch(iterator, device="cuda", depth=2):
            it = real_prefetch(iterator, device, depth)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                spans["data_wait"].append(time.perf_counter() - t0)
                records.append(item[0])
                yield item

        def timed_make_step(*args, **kwargs):
            step = real_make_step(*args, **kwargs)

            def run(ts, *batch_args):
                t0 = time.perf_counter()
                if len(spans["step"]) < TRAIN_MAIN_STEPS - 1:
                    ts, metrics = step(ts, *batch_args)
                    torch.cuda.synchronize()
                else:  # the last step under the profiler: device time, kernels
                    from torch.profiler import ProfilerActivity, profile

                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        ts, metrics = step(ts, *batch_args)
                        torch.cuda.synchronize()
                    device = [e for e in prof.key_averages() if is_device_work(e)]
                    device.sort(key=lambda e: e.self_device_time_total, reverse=True)
                    profiled.update({
                        "profiled_step_kernels": sum(e.count for e in device),
                        "profiled_step_device_ms": sum(
                            e.self_device_time_total for e in device) / 1e3,
                        "profiled_step_top": [[e.key[:160], e.count,
                                               e.self_device_time_total / 1e3]
                                              for e in device[:8]]})
                spans["step"].append(time.perf_counter() - t0)
                losses.append(float(metrics["total_loss"]))
                return ts, metrics
            return run

        def timed_eval(self):
            t0 = time.perf_counter()
            try:
                return real_eval(self)
            finally:
                spans["evaluation"].append(time.perf_counter() - t0)

        for fn in kernels:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        with contextlib.ExitStack() as stack:
            stack.enter_context(swapped(pipeline_mod, device_prefetch=timed_prefetch))
            stack.enter_context(swapped(train_pkg, make_train_step=timed_make_step))
            stack.enter_context(swapped(evaluation_mod.DatasetEvaluator, __call__=timed_eval))
            stack.enter_context(contextlib.redirect_stdout(out))
            t0 = time.perf_counter()
            run_train_main("--config-file", config, "--max-steps", str(TRAIN_MAIN_STEPS))
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = {fn.__name__: fn.launches for fn in kernels}
        lines = out.getvalue().splitlines()
        evaluations = TRAIN_MAIN_STEPS // TRAIN_MAIN_EVAL_INTERVAL
        per_eval = -(-TRAIN_MAIN_EVAL_IMAGES // TRAIN_MAIN_EVAL_BATCH)
        # one inference (step 1) and one launch per evaluation batch
        if set(launches.values()) != {1 + evaluations * per_eval}:
            raise AssertionError(f"train_main: B1 launches {launches}, expected "
                                 f"1 + {evaluations} x {per_eval}")
        if len(losses) != TRAIN_MAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"train_main losses {losses}")
        if sum("val mAP@0.5" in line for line in lines) != evaluations:
            raise AssertionError(f"train_main printed no evaluation lines: {lines}")
        (run_dir,) = [os.path.join(root, "logs", d) for d in os.listdir(os.path.join(root, "logs"))]
        ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
        if not (ckpts and os.path.exists(os.path.join(run_dir, "best.json"))
                and any(n.startswith("events.out.tfevents") for n in os.listdir(run_dir))):
            raise AssertionError(f"train_main run dir: {os.listdir(run_dir)}")
        h2d = [a.elapsed_time(b) for a, b in (r.upload_events for r in records
                                              if r.upload_events is not None)]
        # steady steps: not the first (it also waits for the first decode and
        # cuDNN's first calls) and not the last (profiled)
        steady = slice(1, TRAIN_MAIN_STEPS - 1)
        n_steady = TRAIN_MAIN_STEPS - 2
        wait_ms = [v * 1e3 for v in spans["data_wait"][:TRAIN_MAIN_STEPS]]
        step_ms = [v * 1e3 for v in spans["step"]]
        eval_ms = [v * 1e3 for v in spans["evaluation"]]
        loop_ms = (total_s * 1e3 - sum(wait_ms) - sum(step_ms) - sum(eval_ms)) / TRAIN_MAIN_STEPS
        steady_ms = (sum(wait_ms[steady]) + sum(step_ms[steady])) / n_steady
        if "profiled_step_device_ms" in profiled:
            # the profiler's own cost stretches the profiled step's wall, so
            # the card's idle share is read against the steady steps' mean
            profiled["profiled_step_wall_ms"] = step_ms[-1]
            profiled["idle_share_of_steady_step"] = (
                1.0 - profiled["profiled_step_device_ms"] / steady_ms)

        # SIGINT after a step: a subprocess, ordered records so that the
        # resumed batch can be compared (the file's unordered_records lets
        # records arrive as workers finish them)
        raw["preprocessor"].setdefault("pipeline", {})["unordered_records"] = False
        raw["training"]["save_checkpoint_steps"] = 1
        raw["logging"]["dir"] = os.path.join(root, "logs_interrupted")
        interrupted = write_json(os.path.join(root, "interrupted.json5"), raw)
        proc = subprocess.Popen(
            [sys.executable, "-m", "yolodl_torch.cli.train_main", "--config-file", interrupted,
             *CLI_DEVICE_ARGS],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
            env={**os.environ, "PYTHONPATH": REPO})
        t0 = time.perf_counter()
        try:
            pattern = os.path.join(raw["logging"]["dir"], "*", "checkpoints", "*.ckpt")
            while not glob.glob(pattern):
                if proc.poll() is not None or time.perf_counter() - t0 > TRAIN_MAIN_TIMEOUT:
                    raise AssertionError(f"interrupted run: no checkpoint "
                                         f"(exit {proc.poll()}): {proc.communicate()[1][-2000:]}")
                time.sleep(0.1)
            proc.send_signal(signal.SIGINT)
            proc_out, proc_err = proc.communicate(timeout=TRAIN_MAIN_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        said = [x for x in proc_out.splitlines() if x.startswith("received signal")]
        if proc.returncode != 0 or not said:
            raise AssertionError(f"interrupted run: exit {proc.returncode}: {proc_err[-2000:]}")
        stopped_at = int(said[0].split("at step ")[1].split(",")[0])
        newest = sorted(glob.glob(pattern))[-1]
        with np.load(newest) as f:
            meta = json.loads(bytes(f["__meta__"].tobytes()).decode())
            opt_entries = sum(k.startswith("opt/") for k in f.files)
        if not (meta["has_opt"] and meta["step"] == stopped_at and opt_entries):
            raise AssertionError(f"interrupted run's checkpoint: {meta}, {opt_entries} opt/")

        def first_batches(cfg, steps):
            """train_main in this process → the batches its step was given."""
            seen = []

            def recording(*args, **kwargs):
                step = real_make_step(*args, **kwargs)

                def run(ts, *batch_args):
                    seen.append(tuple(a.clone() for a in batch_args))
                    return step(ts, *batch_args)
                return run

            said = io.StringIO()
            with swapped(train_pkg, make_train_step=recording), contextlib.redirect_stdout(said):
                run_train_main("--config-file", cfg, "--max-steps", str(steps))
            return seen, said.getvalue()

        raw["training"]["load_checkpoint"] = {"type": "FromRecent"}
        resumed, said = first_batches(write_json(os.path.join(root, "resumed.json5"), raw),
                                      stopped_at + 1)
        if (f"data stream resumed at record {stopped_at * batch}" not in said
                or f"restored checkpoint at step {stopped_at}" not in said or len(resumed) != 1):
            raise AssertionError(f"resumed run: {said[-2000:]}")
        raw["training"]["load_checkpoint"] = {"type": "Disabled"}
        raw["logging"]["dir"] = os.path.join(root, "logs_uninterrupted")
        whole, _ = first_batches(write_json(os.path.join(root, "whole.json5"), raw),
                                 stopped_at + 1)
        if not all(torch.equal(a, b) for a, b in zip(resumed[0], whole[stopped_at])):
            raise AssertionError("the resumed run's first batch differs from the "
                                 f"uninterrupted run's batch {stopped_at}")
        del resumed, whole

        # detect_main on cfg/detect.json5's model from a seed-0 .ckpt
        with open(DETECT_MAIN_CONFIG) as f:
            det = json5_reader.load(f)
        det_model_path = os.path.join(REPO, det["model"]["cfg_file"])
        model = zoo.load_newslab_model(det_model_path, seed=0, device=DEVICE)
        n_params = sum(p.numel() for p in model.parameters())
        ckpt = checkpoint.save_checkpoint(os.path.join(root, "detect_ckpt"), 0, 0.0,
                                          *params_to_jax(model.state_dict()))
        del model
        det["model"]["cfg_file"] = det_model_path
        det["input"]["kind"] = {**kinds["eval"], "image_size": det["input"]["kind"]["image_size"]}
        det["output"]["output_dir"] = os.path.join(root, "detect_out")
        det_config = write_json(os.path.join(root, "detect.json5"), det)
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                swapped(torch.backends.cudnn, allow_tf32=True):
            detect_main.main(["--config-file", det_config, "--checkpoint", ckpt,
                              *CLI_DEVICE_ARGS])
        torch.cuda.synchronize()
        detect_s = time.perf_counter() - t0
        detect_launches = {fn.__name__: fn.launches for fn in kernels}
        det_batches = -(-TRAIN_MAIN_EVAL_IMAGES // int(det["model"]["minibatch_size"]))
        drawn = len(os.listdir(det["output"]["output_dir"]))
        if set(detect_launches.values()) != {det_batches} or drawn != TRAIN_MAIN_EVAL_IMAGES:
            raise AssertionError(f"detect_main: {drawn} images, launches {detect_launches}")

        summary = {"steady_ms_per_step": steady_ms, "steps_per_s": 1e3 / steady_ms,
                   "data_wait_share": sum(wait_ms[steady]) / (steady_ms * n_steady),
                   "data_wait_ms": wait_ms, "step_ms": step_ms,
                   "logging_and_rest_mean_ms": loop_ms,
                   "profiled_step_device_ms": profiled.get("profiled_step_device_ms")}
        emit({"phase": "train_main", "config": "cfg/train.json5",
              "model": raw["model"]["cfg_file"].replace(REPO + os.sep, ""),
              "image_size": size, "batch": batch, "steps": TRAIN_MAIN_STEPS,
              "images": TRAIN_MAIN_IMAGES, "eval_images": TRAIN_MAIN_EVAL_IMAGES,
              "accumulation_steps": TRAIN_MAIN_ACCUMULATION, "remat": "blocks",
              "steady_steps": n_steady, "steady_ms_per_step": steady_ms,
              "steps_per_s": 1e3 / steady_ms, "records_per_s": batch * 1e3 / steady_ms,
              "data_wait_share": sum(wait_ms[steady]) / (steady_ms * n_steady),
              "step_ms_by_span": {
                  "data_wait": wait_ms, "h2d_device": h2d[:TRAIN_MAIN_STEPS],
                  "step": step_ms, "logging_and_rest_mean": loop_ms},
              "evaluation_ms": eval_ms, "first_loss": losses[0], "last_loss": losses[-1],
              **profiled,
              "peak_memory_gb": peak_gb, "run_s": total_s, "stdout": lines[-4:],
              "saved_activations_gb_per_batch": {k: v * batch / 1e9 for k, v in saved.items()},
              "crc32c_host_ms_per_record": crc32c_ms(size),
              **{f"{k}_launches": v for k, v in launches.items()},
              "interrupted_at_step": stopped_at, "resumed_batch_equal": True,
              "newslab_card_vs_cpu_64": parity,
              "detect_model": det["model"]["cfg_file"].replace(REPO + os.sep, ""),
              "detect_parameters": n_params, "detect_image_size": det["input"]["kind"]["image_size"],
              "detect_batch": int(det["model"]["minibatch_size"]),
              "detect_img_per_s": TRAIN_MAIN_EVAL_IMAGES / detect_s,
              **{f"detect_{k}_launches": v for k, v in detect_launches.items()},
              "card": card_line()})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"train_main": launches, "detect_main_newslab": detect_launches}, summary


# ---------------------------------------------------------------------------
# phase native_loader: the host libraries (data/native_loader.py)


def host_cpu() -> dict:
    """The host's CPU model (/proc/cpuinfo, else lscpu) and os.cpu_count(),
    for every host rate."""
    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        pass
    try:
        lines += subprocess.run(["lscpu"], capture_output=True, text=True,
                                timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    model = next((line.split(":", 1)[1].strip() for line in lines
                  if line.lower().startswith(("model name", "model name:"))), "unknown")
    return {"cpu": model, "cpu_count": os.cpu_count()}


@contextlib.contextmanager
def plain_host_route():
    """The jitter and the warp on their plain numpy/scipy versions, through
    the port's switch (data/native_loader.py); the native route again on
    exit."""
    from yolodl_torch.data import native_loader

    saved = native_loader._aug_lib()
    native_loader._aug_lib_cache = False
    try:
        yield
    finally:
        native_loader._aug_lib_cache = saved


def border_ties(m_rc: np.ndarray, b_rc: np.ndarray, h: int, w: int,
                eps: float = 1e-9) -> np.ndarray:
    """[h, w] bool: the output pixels whose source coordinate
    ``m_rc @ (row, col) + b_rc``, recomputed in float64, lies within ``eps``
    of an edge (0 or size-1) of either axis.  There the C++ warp and scipy
    may sum the coordinate to opposite sides of the edge, so that one gives
    cval and the other the edge pixel: a difference of up to a whole pixel
    value that is rounding, not a fault."""
    rows, cols = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                             indexing="ij")
    m = np.asarray(m_rc, np.float64)
    b = np.asarray(b_rc, np.float64)
    src_r = m[0, 0] * rows + m[0, 1] * cols + b[0]
    src_c = m[1, 0] * rows + m[1, 1] * cols + b[1]
    return ((np.abs(src_r) < eps) | (np.abs(src_r - (h - 1)) < eps)
            | (np.abs(src_c) < eps) | (np.abs(src_c - (w - 1)) < eps))


def native_gates(loader) -> dict:
    """The 16 records of one augment_recipe batch at AUGMENT_SIZE², each with
    its own draws of the recipe's jitter and affine: the native warp and
    jitter against their plain versions, and each one's ms a record."""
    from yolodl_torch.data import native_loader
    from yolodl_torch.data.affine import pixel_affine, warp_image

    recipe = augment_recipe(False)
    jitter = recipe.color_jitter
    times = collections.defaultdict(list)
    warp = {"max_abs_err_off_ties": 0.0, "tie_pixels": 0, "tie_values": 0,
            "tie_values_over_tol": 0, "max_abs_err_at_ties": 0.0, "values": 0,
            "values_over_tol_off_ties": 0, "identity_draws": 0}
    jitter_err = 0.0

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        times[key].append((time.perf_counter() - t0) * 1e3)
        return out

    for i in range(AUGMENT_BATCH):
        image = loader.items[i][0]
        rng = np.random.default_rng(i)
        shifts = jitter.sample(rng)
        transform = recipe.random_affine.sample_transform(rng)
        warp["identity_draws"] += int(np.allclose(transform, np.eye(3)))
        m_rc, b_rc = pixel_affine(transform, AUGMENT_SIZE, AUGMENT_SIZE)
        nat_warp = timed("warp_native", native_loader.affine_warp_native, image, m_rc, b_rc)
        nat_jit = timed("jitter_native", native_loader.color_jitter_native, image, *shifts)
        with plain_host_route():
            plain_warp = timed("warp_plain", warp_image, image, m_rc, b_rc)
            plain_jit = timed("jitter_plain", jitter.apply, image, *shifts)
        ties = np.broadcast_to(border_ties(m_rc, b_rc, AUGMENT_SIZE, AUGMENT_SIZE), image.shape)
        diff = np.abs(nat_warp - plain_warp)
        over = diff > NATIVE_WARP_TOL
        warp["values"] += diff.size
        warp["tie_pixels"] += int(ties[0].sum())
        warp["tie_values"] += int(ties.sum())
        warp["tie_values_over_tol"] += int((over & ties).sum())
        warp["values_over_tol_off_ties"] += int((over & ~ties).sum())
        warp["max_abs_err_off_ties"] = max(warp["max_abs_err_off_ties"],
                                           float(diff[~ties].max(initial=0.0)))
        warp["max_abs_err_at_ties"] = max(warp["max_abs_err_at_ties"],
                                          float(diff[ties].max(initial=0.0)))
        jitter_err = max(jitter_err, float(np.abs(nat_jit - plain_jit).max()))
    # a tie pixel counts against the gate only where the two routes differ
    warp["tie_share"] = warp["tie_values_over_tol"] / warp["values"]
    ms = {k: statistics.median(v) for k, v in times.items()}
    line = {"records": AUGMENT_BATCH, "warp": warp, "jitter_max_abs_err": jitter_err,
            "ms_a_record": ms,
            "native_speedup": {"warp": ms["warp_plain"] / ms["warp_native"],
                               "jitter": ms["jitter_plain"] / ms["jitter_native"]}}
    failed = []
    if warp["values_over_tol_off_ties"] or warp["max_abs_err_off_ties"] > NATIVE_WARP_TOL:
        failed.append(f"warp off border ties beyond {NATIVE_WARP_TOL}")
    if warp["tie_share"] > NATIVE_TIE_SHARE:
        failed.append(f"border ties {warp['tie_share']} of the values > {NATIVE_TIE_SHARE}")
    if not jitter_err <= NATIVE_JITTER_TOL:
        failed.append(f"jitter {jitter_err} > {NATIVE_JITTER_TOL}")
    return line, failed


def native_host_rates(loader) -> dict:
    """The recipe through the port's host pipeline, records/s: the native
    route at 1 and NATIVE_WORKERS workers, the plain route at 1."""
    import dataclasses

    from yolodl_torch.data.pipeline import TrainingStream

    def rate(workers, batches):
        config = dataclasses.replace(augment_recipe(False), workers=workers)
        stream = iter(TrainingStream(list(range(AUGMENT_RECORDS)), loader, config))
        try:
            next(stream)
            t0 = time.perf_counter()
            for _ in range(batches):
                next(stream)
            return batches * AUGMENT_BATCH / (time.perf_counter() - t0)
        finally:
            stream.close()

    rates = {"native_1_worker": rate(1, NATIVE_HOST_BATCHES),
             f"native_{NATIVE_WORKERS}_workers": rate(NATIVE_WORKERS, NATIVE_HOST_BATCHES)}
    with plain_host_route():
        rates["plain_1_worker"] = rate(1, 1)
    return rates


def native_decode_gates(root) -> dict:
    """Where the decode route is native: tests/test_data.py's decode gates
    (:568-569, :583) on the port's NativeLoader against PIL."""
    from PIL import Image

    from yolodl_torch.data.cache import OnDemandLoader
    from yolodl_torch.data.native_loader import NativeLoader
    from yolodl_torch.data.records import FileRecord

    grad = np.zeros((40, 60, 3), np.uint8)
    grad[..., 0] = np.linspace(0, 255, 60, dtype=np.uint8)[None, :]
    grad[..., 1] = np.linspace(0, 255, 40, dtype=np.uint8)[:, None]
    Image.fromarray(grad).save(os.path.join(root, "grad.png"))
    boxes = np.asarray([[12.0, 20.0, 10.0, 16.0]])
    rec = FileRecord(os.path.join(root, "grad.png"), 40, 60, boxes, np.zeros(1, np.int32))
    a, b = NativeLoader((32, 32)).load(rec), OnDemandLoader((32, 32)).load(rec)
    noise = np.random.default_rng(0).uniform(0, 255, (40, 60, 3)).astype(np.uint8)
    Image.fromarray(noise).save(os.path.join(root, "x.jpg"), quality=95)
    jrec = FileRecord(os.path.join(root, "x.jpg"), 40, 60, np.zeros((0, 4)),
                      np.zeros((0,), np.int32))
    line = {"png_mean_abs": float(np.abs(a.image - b.image).mean()),
            "png_boxes_max_abs": float(np.abs(a.boxes - b.boxes).max()),
            "jpeg_mean_abs": float(np.abs(NativeLoader((48, 48)).load(jrec).image
                                          - OnDemandLoader((48, 48)).load(jrec).image).mean())}
    if not (line["png_mean_abs"] < 0.02 and line["png_boxes_max_abs"] <= 1e-5
            and line["jpeg_mean_abs"] < 0.03):
        raise AssertionError(f"native_loader: decode gates failed: {line}")
    return line


def phase_native_loader() -> None:
    """The port's host libraries (ROADMAP A11b): see the module docstring."""
    import shutil

    from yolodl_torch.data import native_loader
    from yolodl_torch.data.cache import make_decode_loader
    from yolodl_torch.kernels import _build

    t0 = time.perf_counter()
    root = os.path.join(REPO, "build", "chip_smoke_native")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        native_loader._aug_lib()  # built by build_all, or raises
        _, reason = _build.decode_probe()
        decode = make_decode_loader((AUGMENT_SIZE, AUGMENT_SIZE))  # says its route on stderr
        route = "native" if isinstance(decode, native_loader.NativeLoader) else "PIL"
        line = {"phase": "native_loader",
                "libraries": {n: {"path": str(_build.library_path(n).relative_to(REPO)),
                                  "build_seconds": _build.BUILD_SECONDS.get(n)}
                              for n in _build.host_libraries()},
                "gxx": _build.gxx_identity().decode().splitlines()[0],
                "march": _build.resolved_march(),
                "decode": {"route": route, "probe": reason,
                           "no_native_decode": bool(os.environ.get("YDL_NO_NATIVE_DECODE"))},
                "image_size": AUGMENT_SIZE, "batch": AUGMENT_BATCH, **host_cpu()}
        if route == "native":
            line["decode"]["gates"] = native_decode_gates(root)
        loader = AugmentLoader(AUGMENT_SIZE, AUGMENT_RECORDS)
        line["gates"], failed = native_gates(loader)
        line["host_records_per_s"] = native_host_rates(loader)
        line["seconds"] = time.perf_counter() - t0
        line["card"] = card_line()
        line["failed"] = failed
        emit(line)
        if failed:
            raise AssertionError(f"native_loader: {failed}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase augment: the device augmentation (data/device_augment.py)


class AugmentLoader:
    """Index → a seeded record at size²: a smooth colour field with noise on
    the u8/255 grid, as a decoded JPEG gives, and 1-7 boxes of 3 classes
    (scripts/bench_device_augment.py's boxes).  The images are made once;
    each load returns fresh copies."""

    def __init__(self, size, records):
        from yolodl_torch.data.records import DataRecord

        self.record = DataRecord
        self.items = []
        for i in range(records):
            rng = np.random.default_rng(3000 + i)
            low = rng.uniform(0, 255, (1, 3, size // 32 + 2, size // 32 + 2)).astype(np.float32)
            field = torch.nn.functional.interpolate(torch.from_numpy(low), size=(size, size),
                                                    mode="bilinear")[0].numpy()
            pixels = np.clip(np.rint(field + rng.integers(-12, 13, field.shape)), 0, 255)
            n = int(rng.integers(1, 8))
            cy, cx = rng.uniform(0.2, 0.8, (2, n))
            bh, bw = rng.uniform(0.05, 0.3, (2, n))
            self.items.append(((pixels / 255.0).astype(np.float32),
                               np.stack([cy, cx, bh, bw], -1).astype(np.float32),
                               rng.integers(0, 3, n).astype(np.int32)))

    def load(self, index):
        image, boxes, classes = self.items[int(index)]
        return self.record(image.copy(), boxes.copy(), classes.copy())


def augment_recipe(defer, rotate=True):
    """scripts/bench_device_augment.py's recipe at AUGMENT_BATCH: mosaic 0.5
    (margin 0.25), colour jitter (0.1, 0.2, 0.2), the random affine
    (rotation 0.5 up to 10°, or none; translation 0.5 by 0.1; scale 0.5 in
    0.8-1.2; flip 0.5); one worker, seed 0, u8 packs."""
    from yolodl_torch.data.affine import RandomAffine
    from yolodl_torch.data.color import ColorJitter
    from yolodl_torch.data.mosaic import MosaicMixer
    from yolodl_torch.data.pipeline import TrainingStreamConfig

    return TrainingStreamConfig(
        batch_size=AUGMENT_BATCH, max_gt=64, seed=0, workers=1, defer_images=defer,
        mosaic_prob=0.5, mosaic=MosaicMixer(mosaic_margin=0.25),
        color_jitter=ColorJitter(hue_shift=0.1, saturation_shift=0.2, value_shift=0.2),
        random_affine=RandomAffine(
            rotate_prob=0.5 if rotate else 0.0, rotate_degrees=AUGMENT_ROTATE if rotate else None,
            translation_prob=0.5, translation=0.1, scale_prob=0.5, scale=(0.8, 1.2),
            horizontal_flip_prob=0.5))


def first_batch(loader, config):
    from yolodl_torch.data.pipeline import TrainingStream

    stream = iter(TrainingStream(list(range(AUGMENT_RECORDS)), loader, config))
    try:
        return next(stream)
    finally:
        stream.close()


def card_vs_cpu_images(card, cpu) -> dict:
    diff = (card.cpu() - cpu).abs()
    return {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
            "share_above_1e-3": float((diff > 1e-3).double().mean())}


def augment_program(loader) -> dict:
    """The augment program at 608², b16, k_max 4 on one u8 pack a route (a
    rotating one, a rotation-free one for the separable warp): the card
    against the CPU for each warp (mean |Δ| ≤ 1e-5, ≤ 0.2 % of pixels above
    1e-3) and for the mix-only program (identical); then per route ms by
    CUDA events (median of 20), the synchronized wall ms, device ms,
    kernels and host syncs (profiler), peak memory over the pack; and the
    pack's H2D copy from pinned memory, u8 against f32."""
    from yolodl_torch.data import device_augment as da

    size = AUGMENT_SIZE
    packs = {rotate: first_batch(loader, augment_recipe(True, rotate)).deferred
             for rotate in (True, False)}
    flags = dict(has_jitter=True, has_affine=True, has_mosaic=True, has_mixup=False,
                 has_cutmix=False)
    routes = {"separable": (False, dict(separable=True)),
              "twopass": (True, dict(separable=False,
                                     bands=da.twopass_bands(AUGMENT_ROTATE, 0.8))),
              "general": (True, dict(separable=False)),
              "mix_only": (True, dict(separable=False, has_jitter=False, has_affine=False,
                                      has_mixup=True, has_cutmix=True))}
    out = {"bands": da.twopass_bands(AUGMENT_ROTATE, 0.8),
           "mix_kinds": np.bincount(packs[True]["kind"], minlength=4).tolist()}
    for name, (rotate, kw) in routes.items():
        pack = packs[rotate]
        fn = da.make_augment_fn(size, size, **{**flags, **kw})
        cpu = fn({k: torch.from_numpy(v) for k, v in pack.items()})
        dev_pack = {k: torch.from_numpy(v).to(DEVICE) for k, v in pack.items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        card = fn(dev_pack)
        torch.cuda.synchronize()
        line = {**card_vs_cpu_images(card, cpu),
                "peak_memory_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
        if name == "mix_only":
            if not torch.equal(card.cpu(), cpu):
                raise AssertionError(f"augment mix-only program: card != cpu: {line}")
        elif not (line["mean_abs_err"] <= AUGMENT_MEAN_TOL
                  and line["share_above_1e-3"] <= AUGMENT_FLIP_TOL):
            raise AssertionError(f"augment {name} program: card vs cpu {line}")
        del card, cpu
        wall = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(dev_pack)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        line.update({"ms": median_ms(lambda: fn(dev_pack), AUGMENT_TIMED),
                     "wall_ms": statistics.median(wall), **profile_calls(lambda: fn(dev_pack))})
        out[name] = line
        del dev_pack
    pack = packs[True]
    f32 = {**pack, "images": pack["images"].astype(np.float32)}
    for name, arrays in (("u8", pack), ("f32", f32)):
        pinned = [torch.from_numpy(a).pin_memory() for a in arrays.values()]
        out[f"h2d_{name}_pack"] = {
            "mb": sum(a.nbytes for a in arrays.values()) / 1e6,
            "ms": median_ms(lambda: [t.to(DEVICE, non_blocking=True) for t in pinned], 10)}
    torch.cuda.empty_cache()
    return out


def augment_host_rates(loader) -> dict:
    """The same recipe on the host, one worker: the port's host pipeline
    (every pixel augmented there) against the deferred host prep (draws,
    labels and the u8 pack), records/s."""
    from yolodl_torch.data.pipeline import TrainingStream

    rates = {}
    for route, defer in (("host_pipeline", False), ("deferred_prep", True)):
        stream = iter(TrainingStream(list(range(AUGMENT_RECORDS)), loader, augment_recipe(defer)))
        try:
            next(stream)
            t0 = time.perf_counter()
            for _ in range(AUGMENT_HOST_BATCHES):
                next(stream)
            rates[route] = AUGMENT_HOST_BATCHES * AUGMENT_BATCH / (time.perf_counter() - t0)
        finally:
            stream.close()
    from yolodl_torch.data import native_loader

    return {"records_per_s": rates, "deferred_over_host": rates["deferred_prep"] /
            rates["host_pipeline"], "workers": 1,
            "host_pipeline_route": "native" if native_loader._aug_lib_cache else "plain",
            **host_cpu()}


def augment_train_main(iou) -> dict:
    """train_main on cfg/train.json5 as phase train_main changes it, plus
    pipeline.device "cuda", logging.enable_images false (which would keep
    the CPU pipeline) and ordered records; AUGMENT_STEPS steps in this
    process with B1's counters zeroed right before and read right after.
    Its first batch against the CPU program on the same pack and against
    the CPU pipeline's run (same seed, one step)."""
    import contextlib

    from yolodl_torch import train as train_pkg
    from yolodl_torch.config import json5_reader
    from yolodl_torch.data import device_augment as da
    from yolodl_torch.data import pipeline as pipeline_mod

    root = AUGMENT_ROOT
    kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)
    with open(TRAIN_MAIN_CONFIG) as f:
        size = int(json5_reader.load(f)["dataset"]["kind"]["image_size"])
    kinds = train_main_workspace(root, size)
    raw = train_main_config(root, kinds)
    raw["preprocessor"]["pipeline"].update({"device": "cuda", "unordered_records": False})
    raw["logging"]["enable_images"] = False
    batch = int(raw["training"]["batch_size"])
    config = write_json(os.path.join(root, "augment.json5"), raw)

    spans = {"data_wait": [], "step": []}
    records, first, captured, losses = [], [], {}, []
    real_apply, real_fn_for = da.apply_device_augmentation, da.augment_fn_for
    real_make_fn, real_make_step = da.make_augment_fn, train_pkg.make_train_step

    def timed_apply(iterator, stream_cfg, device="cuda", depth=2):
        it = real_apply(iterator, stream_cfg, device, depth)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            spans["data_wait"].append(time.perf_counter() - t0)
            records.append(item[0])
            yield item

    def recording_make_fn(h, w, **kw):
        captured["warp"] = ("separable" if kw["separable"] else
                            "twopass" if kw["bands"] else "general", kw["bands"])
        return real_make_fn(h, w, **kw)

    def capturing_fn_for(stream_cfg, h, w):
        fn = real_fn_for(stream_cfg, h, w)

        def run(pack):  # on the augmentation's side stream
            if "pack" not in captured:
                captured.update(fn=fn, pack={k: v.clone() for k, v in pack.items()})
            return fn(pack)
        return run

    def timed_make_step(*args, **kwargs):
        step = real_make_step(*args, **kwargs)

        def run(ts, *batch_args):
            if not first:
                first.append(tuple(a.clone() for a in batch_args))
            t0 = time.perf_counter()
            ts, metrics = step(ts, *batch_args)
            torch.cuda.synchronize()
            spans["step"].append(time.perf_counter() - t0)
            losses.append(float(metrics["total_loss"]))
            return ts, metrics
        return run

    def no_cpu_pipeline(*args, **kwargs):
        raise AssertionError("train_main took the CPU pipeline (device_prefetch)")

    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(swapped(da, apply_device_augmentation=timed_apply,
                                    augment_fn_for=capturing_fn_for,
                                    make_augment_fn=recording_make_fn))
        stack.enter_context(swapped(pipeline_mod, device_prefetch=no_cpu_pipeline))
        stack.enter_context(swapped(train_pkg, make_train_step=timed_make_step))
        stack.enter_context(contextlib.redirect_stdout(out))
        stack.enter_context(contextlib.redirect_stderr(err))
        t0 = time.perf_counter()
        run_train_main("--config-file", config, "--max-steps", str(AUGMENT_STEPS))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {fn.__name__: fn.launches for fn in kernels}
    per_eval = -(-TRAIN_MAIN_EVAL_IMAGES // TRAIN_MAIN_EVAL_BATCH)
    expected = 1 + AUGMENT_STEPS // TRAIN_MAIN_EVAL_INTERVAL * per_eval
    if set(launches.values()) != {expected}:
        raise AssertionError(f"augment train_main: B1 launches {launches}, expected {expected}")
    if len(losses) != AUGMENT_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"augment train_main losses {losses}")
    if ("CPU pipeline" in err.getvalue() or len(records) < AUGMENT_STEPS
            or captured["warp"][0] != "twopass"):
        raise AssertionError(f"augment train_main: {len(records)} batches, warp "
                             f"{captured['warp']}; {err.getvalue()[-2000:]}")

    # the program on the card's first pack, on the CPU
    cpu_images = captured["fn"]({k: v.cpu() for k, v in captured["pack"].items()})
    vs_cpu_program = card_vs_cpu_images(first[0][0], cpu_images)
    if not (vs_cpu_program["mean_abs_err"] <= AUGMENT_MEAN_TOL
            and vs_cpu_program["share_above_1e-3"] <= AUGMENT_FLIP_TOL):
        raise AssertionError(f"augment train_main: first batch vs cpu program {vs_cpu_program}")
    program = {"ms": median_ms(lambda: captured["fn"](captured["pack"]), 10),
               **profile_calls(lambda: captured["fn"](captured["pack"]))}

    # the CPU pipeline's run with the same seed: its first batch
    raw["preprocessor"]["pipeline"]["device"] = "cpu"
    raw["logging"]["dir"] = os.path.join(root, "logs_cpu_pipeline")
    cpu_first = []

    def recording(*args, **kwargs):
        step = real_make_step(*args, **kwargs)

        def run(ts, *batch_args):
            cpu_first.append(tuple(a.cpu() for a in batch_args))
            return step(ts, *batch_args)
        return run

    with swapped(train_pkg, make_train_step=recording), \
            contextlib.redirect_stdout(io.StringIO()):
        run_train_main("--config-file", write_json(os.path.join(root, "cpu.json5"), raw),
                       "--max-steps", "1")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(first[0][1:], cpu_first[0][1:])):
        raise AssertionError("augment train_main: the first batch's labels differ from "
                             "the CPU pipeline's")
    vs_cpu_pipeline = card_vs_cpu_images(first[0][0], cpu_first[0][0])
    # the two-pass warp's interpolation is not scipy's bilinear
    # (tests/test_device_augment.py test_rotation_twopass_pipeline's bound)
    diff = (first[0][0].cpu() - cpu_first[0][0]).abs()
    if not (float(diff.mean()) < 0.02 and float((diff > 0.25).double().mean()) < 0.02):
        raise AssertionError(f"augment train_main: vs the CPU pipeline {vs_cpu_pipeline}")

    h2d = [a.elapsed_time(b) for a, b in (r.upload_events for r in records
                                          if r.upload_events is not None)]
    steady = slice(1, AUGMENT_STEPS)
    wait_ms = [v * 1e3 for v in spans["data_wait"][:AUGMENT_STEPS]]
    step_ms = [v * 1e3 for v in spans["step"]]
    steady_ms = (sum(wait_ms[steady]) + sum(step_ms[steady])) / (AUGMENT_STEPS - 1)
    return {"config": "cfg/train.json5", "image_size": size, "batch": batch,
            "steps": AUGMENT_STEPS, "warp": captured["warp"],
            "steady_ms_per_step": steady_ms, "steps_per_s": 1e3 / steady_ms,
            "records_per_s": batch * 1e3 / steady_ms,
            "data_wait_share": sum(wait_ms[steady]) / (steady_ms * (AUGMENT_STEPS - 1)),
            "step_ms_by_span": {"data_wait": wait_ms, "h2d_device_u8_pack": h2d[:AUGMENT_STEPS],
                                "step": step_ms,
                                "logging_and_rest_mean": (total_s * 1e3 - sum(wait_ms)
                                                          - sum(step_ms)) / AUGMENT_STEPS},
            "program_per_batch": program, "losses": losses, "peak_memory_gb": peak_gb,
            "first_batch_vs_cpu_program": vs_cpu_program,
            "first_batch_vs_cpu_pipeline": vs_cpu_pipeline, "labels_equal": True,
            **{f"{k}_launches": v for k, v in launches.items()}}, launches


def phase_augment(iou, train_main_summary) -> dict:
    """The device augmentation (ROADMAP A13) on the card; see the module
    docstring.  Returns B1's launches on its train_main path."""
    import shutil

    shutil.rmtree(AUGMENT_ROOT, ignore_errors=True)
    os.makedirs(AUGMENT_ROOT)
    try:
        loader = AugmentLoader(AUGMENT_SIZE, AUGMENT_RECORDS)
        line = {"phase": "augment", "image_size": AUGMENT_SIZE, "batch": AUGMENT_BATCH,
                "k_max": 4, "program": augment_program(loader),
                "host": augment_host_rates(loader)}
        del loader
        line["train_main"], launches = augment_train_main(iou)
        line["train_main_cpu_pipeline"] = train_main_summary
        line["card"] = card_line()
        emit(line)
    finally:
        shutil.rmtree(AUGMENT_ROOT, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"augment_train_main": launches}


# ---------------------------------------------------------------------------
# phase darknet_loss: the darknet-exact loss (loss/darknet_loss.py)


def darknet_heads(path, size):
    """(model graph, head-conv node keys, head params at size², each head's
    (H, W) at size²) of a darknet cfg."""
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.loss.darknet_loss import head_params_from_darknet

    darknet = dk.Darknet.load(path)
    graph = graph_from_darknet(darknet)
    keys = graph.detect_head_input_keys()
    params = tuple(head_params_from_darknet(l, size, size) for l in darknet.layers
                   if isinstance(l, dk.Yolo))
    cfg_w = int(darknet.net.width)
    shapes = []
    for k in keys:
        _, _, h, w = (d.size for d in graph.nodes[k].output_shape.tensor_shape())
        shapes.append((size * h // cfg_w, size * w // cfg_w))
    return graph, keys, params, shapes


def darknet_truth(rng, batch, classes, rows=DK_TRUTHS, real=DK_REAL):
    """Darknet truth rows (x, y, w, h, class): ``real`` random boxes, then
    zero rows (the `!truth.x` break)."""
    truth = np.zeros((batch, rows, 5), np.float32)
    truth[:, :real, 0:2] = rng.uniform(0.02, 0.98, (batch, real, 2))
    truth[:, :real, 2:4] = rng.uniform(0.01, 0.5, (batch, real, 2))
    truth[:, :real, 4] = rng.integers(0, classes, (batch, real))
    return truth


def darknet_card_vs_cpu() -> dict:
    """yolov4-csp's three head params at 608² and Gaussian_yolov3_BDD's at
    512², seeded f32 NCHW raws (batch 2) and DK_TRUTHS truth rows an image
    (DK_REAL real): the loss on the card against the CPU.  Every discrete
    decision (head_decisions: the ignore and truth_thresh masks, each
    truth's best anchor and the cells it writes) and num_matched must be
    identical; each head's delta within 1e-4 · max|ref|, the cost within
    rel 1e-5."""
    from yolodl_torch.loss import darknet_loss as dl

    out = {}
    for name, path, size in DK_MODELS:
        _, _, params, shapes = darknet_heads(path, size)
        rng = np.random.default_rng(0)
        raws = [rng.normal(0, 1, (2, p.num_anchors * p.entries, h, w)).astype(np.float32)
                for p, (h, w) in zip(params, shapes)]
        truth = darknet_truth(rng, 2, params[0].classes)
        runs = {}
        for device in ("cpu", DEVICE):
            rs = [torch.from_numpy(r).to(device) for r in raws]
            tr = torch.from_numpy(truth).to(device)
            heads = []
            for r, p in zip(rs, params):
                braw = dl.reshape_head_raw(r, p)
                decisions = dl.head_decisions(braw, tr, p)
                delta = dl._head_deltas(braw, tr, p)[0]
                heads.append(({k: v.cpu() for k, v in decisions.items()}, delta.cpu()))
            loss, metrics = dl.darknet_detection_loss_with_metrics(rs, tr, params)
            runs[device] = (heads, float(loss), int(metrics["num_matched"]))
        (cpu_heads, cpu_loss, cpu_n), (card_heads, card_loss, card_n) = runs["cpu"], runs[DEVICE]
        if card_n != cpu_n:
            raise AssertionError(f"{name}: num_matched card {card_n} vs cpu {cpu_n}")
        worst = 0.0
        for k, ((d_cpu, x_cpu), (d_card, x_card)) in enumerate(zip(cpu_heads, card_heads)):
            for key, v in d_cpu.items():
                if not torch.equal(v, d_card[key]):
                    raise AssertionError(f"{name} head {k}: decision {key!r} differs "
                                         f"card vs cpu ({int((v != d_card[key]).sum())} entries)")
            err = float((x_card - x_cpu).abs().max()) / float(x_cpu.abs().max())
            if not err <= 1e-4:
                raise AssertionError(f"{name} head {k}: delta card vs cpu {err} of max|ref|")
            worst = max(worst, err)
        if not abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss):
            raise AssertionError(f"{name}: loss card {card_loss} vs cpu {cpu_loss}")
        out[name] = {"image_size": size, "heads": [list(s) for s in shapes],
                     "num_matched": card_n, "ignored_cells": [int(d["ignored"].sum())
                                                              for d, _ in card_heads],
                     "delta_max_err_of_max": worst, "loss_card": card_loss,
                     "loss_cpu": cpu_loss}
    return out


def profile_calls(fn) -> dict:
    """torch.profiler over fn(): device ms and kernels (is_device_work); the
    aten::copy_ calls (every copy, dtype casts too) and the aten::clone
    calls among them (a reshape of a permuted map); the host syncs as aten::item / aten::_local_scalar_dense calls (these count
    a CPU tensor's too, such as the optimizer's step counters); and the
    CUDA runtime's stream/device/event synchronizations that an operator
    issued (the profiler's own and the closing torch.cuda.synchronize have
    no operator above them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if is_device_work(e)]
    return {"device_ms": sum(e.device_time_total for e in kernels) / 1e3,
            "kernels": len(kernels),
            "copies": sum(e.name == "aten::copy_" for e in events),
            "layout_copies": sum(e.name == "aten::clone" for e in events),
            "host_syncs": sum(e.name in ("aten::item", "aten::_local_scalar_dense")
                              for e in events),
            "cuda_syncs": sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                         "cudaEventSynchronize")
                              and e.cpu_parent is not None for e in events)}


def darknet_train_step(train_ms) -> dict:
    """yolov4-csp at 608², b16, bf16 images, TrainConfig(darknet_loss=...)
    (Adam, as phase train) on bench.py's synthetic batch: 2 warm-up steps,
    10 timed, one make_multi_step(k=2); every loss finite, num_matched > 0,
    every parameter changed.  Then the loss alone (forward + backward, on
    this batch's f32 head outputs): its ms by CUDA events, and a profile of
    it and of one step: device ms, kernels, host syncs (0 in the loss)."""
    from yolodl_torch.loss import darknet_loss as dl
    from yolodl_torch.models import YoloModel
    from yolodl_torch.train import TrainConfig, make_multi_step, make_train_step, train_init

    graph, keys, params, _ = darknet_heads(CFG, IMAGE_SIZE)
    model = YoloModel(graph, device=DEVICE, generator=torch.Generator().manual_seed(0))
    config = TrainConfig(darknet_loss=(keys, params))
    ts, opt = train_init(model, config)
    images, boxes, classes, mask = synthetic_batch(TRAIN_BATCH, IMAGE_SIZE)
    batch = (torch.from_numpy(images).to(torch.bfloat16).to(DEVICE),
             *(torch.from_numpy(a).to(DEVICE) for a in (boxes, classes, mask)))
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_train_step(model, opt, config)

    torch.cuda.reset_peak_memory_stats()
    metrics = []
    for _ in range(2):  # warm-up
        ts, m = step(ts, *batch)
        metrics.append(m)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
    events[0].record()
    for i in range(10):
        ts, m = step(ts, *batch)
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = sorted(events[i].elapsed_time(events[i + 1]) for i in range(10))
    stacked = tuple(x.unsqueeze(0).expand(2, *x.shape) for x in batch)
    ts, m = make_multi_step(model, opt, config, 2)(ts, *stacked)
    metrics.extend({k: v[i] for k, v in m.items()} for i in range(2))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [float(m["total_loss"]) for m in metrics]
    if len(losses) != 14 or not all(np.isfinite(losses)):
        raise AssertionError(f"darknet-loss train losses {losses}")
    if not all(int(m["num_matched"]) > 0 for m in metrics):
        raise AssertionError("a darknet-loss step matched no truth")
    changed = sum(int(not torch.equal(v, p0[k])) for k, v in model.named_parameters())
    if changed != len(p0):
        raise AssertionError(f"{len(p0) - changed} of {len(p0)} parameters did not change")

    # the loss alone, on this batch's head outputs, forward and backward
    with torch.no_grad():
        outs = model(batch[0], train=False, output_keys=keys)
    raws = [outs[k].to(torch.float32).requires_grad_() for k in keys]
    truth = dl.truth_rows(*batch[1:])

    def loss_call():
        loss, _ = dl.darknet_detection_loss_with_metrics(raws, truth, params)
        loss.backward()

    loss_call()
    loss_ms = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        loss_call()
        end.record()
        torch.cuda.synchronize()
        loss_ms.append(start.elapsed_time(end))
    loss_prof = profile_calls(loss_call)
    if loss_prof["host_syncs"] or loss_prof["cuda_syncs"] > 0:
        raise AssertionError(f"the loss synced with the host: {loss_prof}")
    if not loss_prof["kernels"]:
        raise AssertionError("the loss's profile holds no device work")
    step_prof = profile_calls(lambda: step(ts, *batch))
    median = step_ms[len(step_ms) // 2]
    loss_median = sorted(loss_ms)[len(loss_ms) // 2]
    del model, opt, ts, batch, stacked, raws, outs
    torch.cuda.empty_cache()
    return {"model": "yolov4-csp", "image_size": IMAGE_SIZE, "batch": TRAIN_BATCH,
            "dtype": "bfloat16", "truths_per_image": TRAIN_MAX_GT,
            "step_ms_median": median, "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
            "img_per_s": TRAIN_BATCH * 1e3 / median,
            "production_loss_step_ms_median": train_ms["step_ms_median"],
            "production_loss_img_per_s": train_ms["img_per_s"],
            "peak_memory_gb": peak_gb, "first_loss": losses[0], "last_loss": losses[-1],
            "num_matched": int(metrics[-1]["num_matched"]),
            "loss_ms_median": loss_median, "loss_ms_all": loss_ms,
            "loss_share_of_step": loss_median / median,
            "loss_device_ms": loss_prof["device_ms"], "loss_kernels": loss_prof["kernels"],
            "loss_host_syncs": loss_prof["host_syncs"], "loss_cuda_syncs": loss_prof["cuda_syncs"],
            "step_device_ms": step_prof["device_ms"], "step_kernels": step_prof["kernels"],
            "step_item_calls": step_prof["host_syncs"], "step_cuda_syncs": step_prof["cuda_syncs"],
            "device_idle_share": 1.0 - step_prof["device_ms"] / median}


def darknet_train_main(iou) -> dict:
    """train_main.main with training.loss.impl Darknet on
    cfg/darknet/Gaussian_yolov3_BDD.cfg (Gaussian heads, 10 classes, 512²,
    random=1): cfg/train.json5 read by the port's JSON5 reader with only
    the model, loss.impl, the dataset (a seeded CSV set of DK_IMAGES +
    DK_EVAL_IMAGES JPEGs over BDD's 10 classes), logging.dir, cache_dir,
    load_checkpoint, an evaluation block and training.multi_scale changed:
    the sizes darknet's random=1 gives at 512² (adopt_darknet_data_recipe),
    at an interval of DK_MULTI_SCALE_INTERVAL so that DK_STEPS steps visit
    several.  The batch is cut only if the saved activations of a batch at
    the largest visited size outgrow DK_SAVED_BUDGET.  B1's counters are
    zeroed right before and read right after: one launch for the step-1
    inference and one per evaluation batch.  Every visited size must train
    with head params of that size."""
    import contextlib
    import dataclasses
    import shutil
    import signal

    from yolodl_torch import train as train_pkg
    from yolodl_torch.cli import train_main
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.config import json5_reader
    from yolodl_torch.config.app_config import TrainAppConfig, adopt_darknet_data_recipe
    from yolodl_torch.data import pipeline as pipeline_mod
    from yolodl_torch.loss import darknet_loss as dl
    from yolodl_torch.models import YoloModel

    root = DK_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)
    path, size = DK_MODELS[1][1], DK_MODELS[1][2]
    try:
        with open(TRAIN_MAIN_CONFIG) as f:
            raw = json5_reader.load(f)
        kinds = train_main_workspace(root, size, names=list(BDD_CLASSES), images=DK_IMAGES,
                                     eval_images=DK_EVAL_IMAGES)
        raw["model"] = {"kind": "Darknet", "cfg_file": path}
        raw["training"]["loss"]["impl"] = "Darknet"
        raw["dataset"]["kind"] = kinds["train"]
        raw["logging"]["dir"] = os.path.join(root, "logs")
        raw["preprocessor"]["cache"]["cache_dir"] = os.path.join(root, "cache")
        raw["training"]["load_checkpoint"] = {"type": "Disabled"}
        raw["evaluation"] = {"interval": DK_EVAL_INTERVAL, "batch_size": DK_EVAL_BATCH,
                             "dataset": {"kind": kinds["eval"]}}
        config = write_json(os.path.join(root, "train.json5"), raw)
        recipe = adopt_darknet_data_recipe(TrainAppConfig.load(config), dk.Darknet.load(path))
        sizes = [int(v) for v in recipe.multi_scale_sizes]
        raw["training"]["multi_scale"] = {"sizes": sizes, "interval": DK_MULTI_SCALE_INTERVAL}
        visited = sorted({sizes[(s // DK_MULTI_SCALE_INTERVAL) % len(sizes)]
                          for s in range(DK_STEPS)})
        graph, keys, _, _ = darknet_heads(path, size)
        saved = saved_bytes(YoloModel(graph, device=DEVICE), max(visited), output_keys=keys)
        torch.cuda.empty_cache()
        batch = int(raw["training"]["batch_size"])
        cut = None
        if batch * saved > DK_SAVED_BUDGET:
            fits = max(8, int(DK_SAVED_BUDGET // saved) // 8 * 8)
            cut = {"from": batch, "to": fits,
                   "reason": f"at {max(visited)}², f32, one image saves {saved / 1e9:.3f} GB "
                             f"of activations: {batch * saved / 1e9:.1f} GB for {batch}, over "
                             f"the {DK_SAVED_BUDGET / 1e9:.0f} GB this smoke allows on the "
                             f"card's 80 GB"}
            batch = raw["training"]["batch_size"] = fits
        config = write_json(os.path.join(root, "train.json5"), raw)

        spans = {"data_wait": [], "step": [], "loss": [], "evaluation": []}
        trained, losses = [], []
        real_prefetch, real_make_step = pipeline_mod.device_prefetch, train_pkg.make_train_step
        real_loss = dl.darknet_detection_loss_with_metrics

        def timed_prefetch(iterator, device="cuda", depth=2):
            it = real_prefetch(iterator, device, depth)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                spans["data_wait"].append(time.perf_counter() - t0)
                yield item

        def timed_loss(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_loss(*args, **kwargs)
            torch.cuda.synchronize()
            spans["loss"].append(time.perf_counter() - t0)
            return out

        def recording_make_step(model, optimizer, cfg, *args, **kwargs):
            step = real_make_step(model, optimizer, cfg, *args, **kwargs)
            nets = {(p.net_w, p.net_h) for p in cfg.darknet_loss[1]}

            def run(ts, images, *rest):
                t0 = time.perf_counter()
                ts, metrics = step(ts, images, *rest)
                torch.cuda.synchronize()
                spans["step"].append(time.perf_counter() - t0)
                trained.append((int(images.shape[-1]), nets))
                losses.append(float(metrics["total_loss"]))
                return ts, metrics
            return run

        for fn in kernels:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        saved_handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
        with contextlib.ExitStack() as stack:
            stack.enter_context(swapped(pipeline_mod, device_prefetch=timed_prefetch))
            stack.enter_context(swapped(train_pkg, make_train_step=recording_make_step))
            stack.enter_context(swapped(dl, darknet_detection_loss_with_metrics=timed_loss))
            stack.enter_context(swapped(torch.backends.cudnn, allow_tf32=True))
            stack.enter_context(contextlib.redirect_stdout(out))
            t0 = time.perf_counter()
            try:
                train_main.main(["--config-file", config, "--max-steps", str(DK_STEPS),
                                 *CLI_DEVICE_ARGS])
            finally:
                for s, handler in saved_handlers.items():
                    signal.signal(s, handler)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = {fn.__name__: fn.launches for fn in kernels}
        lines = out.getvalue().splitlines()
        evaluations = DK_STEPS // DK_EVAL_INTERVAL
        per_eval = -(-DK_EVAL_IMAGES // DK_EVAL_BATCH)
        if set(launches.values()) != {1 + evaluations * per_eval}:
            raise AssertionError(f"darknet train_main: B1 launches {launches}, expected "
                                 f"1 + {evaluations} x {per_eval}")
        if len(losses) != DK_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"darknet train_main losses {losses}")
        if not any(line.startswith("loss impl: darknet-exact (3 heads;") for line in lines):
            raise AssertionError(f"darknet train_main printed no loss impl line: {lines[:20]}")
        if (sorted({s for s, _ in trained}) != visited
                or not all(nets == {(s, s)} for s, nets in trained)):
            raise AssertionError(f"darknet train_main: sizes and head params {trained}")
        step_ms = [v * 1e3 for v in spans["step"]]
        loss_ms = [v * 1e3 for v in spans["loss"]]
        wait_ms = [v * 1e3 for v in spans["data_wait"][:DK_STEPS]]
        steady = slice(1, DK_STEPS)
        n_steady = DK_STEPS - 1
        steady_ms = (sum(wait_ms[steady]) + sum(step_ms[steady])) / n_steady
        rest_ms = (total_s * 1e3 - sum(wait_ms) - sum(step_ms)) / DK_STEPS
        return {"config": "cfg/train.json5", "model": path.replace(REPO + os.sep, ""),
                "image_size": size, "multi_scale_sizes": sizes,
                "multi_scale_interval": DK_MULTI_SCALE_INTERVAL, "visited_sizes": visited,
                "head_net_sizes_by_step": [s for s, _ in trained], "batch": batch,
                "batch_cut": cut, "saved_activations_gb_per_image": saved / 1e9,
                "steps": DK_STEPS, "images": DK_IMAGES, "eval_images": DK_EVAL_IMAGES,
                "steady_ms_per_step": steady_ms, "steps_per_s": 1e3 / steady_ms,
                "records_per_s": batch * 1e3 / steady_ms,
                "step_ms_by_span": {"data_wait": wait_ms, "step": step_ms,
                                    "loss_in_step": loss_ms,
                                    "evaluation_logging_and_rest_mean": rest_ms},
                "loss_share_of_step": sum(loss_ms[steady]) / sum(step_ms[steady]),
                "first_loss": losses[0], "last_loss": losses[-1], "peak_memory_gb": peak_gb,
                "run_s": total_s, **{f"{k}_launches": v for k, v in launches.items()},
                "card": card_line()}, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_darknet_loss(iou, train_ms) -> dict:
    """The darknet-exact loss on the card: card against CPU, the train step
    at the flagship's size beside phase train's, and train_main on
    Gaussian_yolov3_BDD.  Returns B1's launches on the train_main run."""
    parity = darknet_card_vs_cpu()
    step = darknet_train_step(train_ms)
    cli, launches = darknet_train_main(iou)
    emit({"phase": "darknet_loss", "card_vs_cpu": parity, "train_step": step,
          "train_main": cli, "card": card_line()})
    return {"darknet_train_main": launches}


def randomize_bn(model, seed) -> None:
    """Seeded BN affine and running statistics away from init, so that a
    fold changes every kernel and bias: scale in [0.8, 1.2], bias N(0,
    0.2), mean N(0, 0.05), var in [0.25, 0.45], about the third of its
    input's variance that a uniform-init conv passes on, which keeps the
    flagship's logits near unit scale at 608² (var in [0.1, 0.3] lets
    them grow by orders of magnitude, and f32 rounding with them).  A
    dense layer's BN has no bias; its draw is made all the same."""
    from yolodl_torch.models.builder import DarkBatchNorm

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DarkBatchNorm):
                c = m.mean.numel()
                for t, v in ((m.scale, rng.uniform(0.8, 1.2, c)),
                             (getattr(m, "bias", None), rng.normal(0, 0.2, c)),
                             (m.mean, rng.normal(0, 0.05, c)), (m.var, rng.uniform(0.25, 0.45, c))):
                    if t is not None:
                        t.copy_(torch.from_numpy(v.astype(np.float32)))


def quiet(main, argv) -> list:
    """``main(argv)`` with its stdout captured; returns its lines."""
    import contextlib

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def serve_requests(svc, frames, kernels) -> dict:
    """``svc`` answers DEPLOY_REQUESTS requests from DEPLOY_CLIENTS threads
    over ``frames``, B1's counters zeroed right before and read right after:
    each kernel must launch once per served batch."""
    per = DEPLOY_REQUESTS // DEPLOY_CLIENTS
    results, errors = [None] * DEPLOY_REQUESTS, []

    def client(i):
        try:
            for j in range(per):
                results[per * i + j] = svc.submit_u8(frames[(i + j) % len(frames)])
        except Exception as e:  # reported below
            errors.append(repr(e))

    for fn in kernels:
        fn.launches = 0
    svc.start()
    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(DEPLOY_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        snap = svc.stats.snapshot(svc.batch_size)
    finally:
        svc.shutdown()
    launches = {fn.__name__: fn.launches for fn in kernels}
    if errors or any(r is None for r in results) or snap["errors"]:
        raise AssertionError(f"serving failed: {errors[:3]} {snap}")
    if set(launches.values()) != {snap["batches"]} or snap["batches"] == 0:
        raise AssertionError(f"launches {launches} != served batches {snap['batches']}")
    lat = snap.get("latency_ms", {})
    return {"img_per_s": DEPLOY_REQUESTS / wall, "p50_ms": lat.get("p50"),
            "p95_ms": lat.get("p95"), "batches": snap["batches"],
            "mean_batch_fill": snap["mean_batch_fill"],
            "detections": sum(len(r) for r in results), "launches": launches}


def a4_card_vs_cpu(name, size) -> dict:
    """The f32 forward of cfg/darknet/<name>.cfg cut to size² on the card
    and on the CPU, the same seed-0 weights, one image: within 1e-4 ·
    max|ref| + 1e-6, as the flagship in phase serve."""
    import re

    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.models import GraphModel

    with open(os.path.join(REPO, "cfg", "darknet", f"{name}.cfg")) as f:
        text = f.read()
    text = re.sub(r"(?m)^height *= *\d+", f"height={size}", text)
    text = re.sub(r"(?m)^width *= *\d+", f"width={size}", text)
    graph = graph_from_darknet(dk.Darknet.from_str(text))
    kinds = sorted({n.config.kind for n in graph.nodes.values()})
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (1, 3, size, size))
                         .astype(np.float32))
    out = {"size": size, "node_kinds": kinds}
    with torch.inference_mode():
        cpu_model = GraphModel(graph, device="cpu")
        ref = cpu_model(x)
        card_model = GraphModel(graph, device=DEVICE)
        card_model.load_state_dict(cpu_model.state_dict())
        got = card_model(x.to(DEVICE))
    for f in ("cycxhw", "obj_logit", "class_logit"):
        r, o = getattr(ref, f), getattr(got, f).cpu()
        scale, err = float(r.abs().max()), float((o - r).abs().max())
        out[f"{f}_max_abs_err"], out[f"{f}_max_abs"] = err, scale
        if not (err <= 1e-4 * scale + 1e-6 and torch.isfinite(o).all()):
            raise AssertionError(f"{name} f32 forward {f}: card vs cpu max|d|={err} "
                                 f"(max {scale})")
    return out


def phase_deploy(iou) -> dict:
    """Deployment of yolov4-csp-608 from a folded .weights pair and an
    exported artifact, and ROADMAP A4's node kinds on the card; see the
    module docstring.  Returns B1's launches per path."""
    import shutil

    from yolodl_torch.bridge import params_to_jax
    from yolodl_torch.cli import detect_main, tool_main
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.loss import nms as nms_mod
    from yolodl_torch.models import zoo
    from yolodl_torch.models.builder import DarkBatchNorm
    from yolodl_torch.models.weights import save_darknet_weights
    from yolodl_torch.serve import DetectionService

    root = DEPLOY_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)
    fields = ("cycxhw", "obj_logit", "class_logit")
    line = {"phase": "deploy", "model": "yolov4-csp", "image_size": IMAGE_SIZE, "batch": BATCH}
    try:
        # the seed-0 flagship with seeded BN statistics, as a .weights file
        darknet = dk.Darknet.load(CFG)
        kind, beta = nms_mod.nms_options_from_darknet(darknet)
        model = zoo.load_darknet_model(CFG, seed=0, device=DEVICE)
        randomize_bn(model, 0)
        weights = os.path.join(root, "yolov4-csp.weights")
        save_darknet_weights(darknet, *params_to_jax(model.state_dict()), weights)
        del model

        # fold: tool_main fold-weights in this process
        folded_cfg = os.path.join(root, "yolov4-csp-folded.cfg")
        folded_weights = os.path.join(root, "yolov4-csp-folded.weights")
        t0 = time.perf_counter()
        fold_lines = quiet(tool_main.main, ["fold-weights", CFG, weights, "--out-cfg", folded_cfg,
                                            "--out-weights", folded_weights])
        line["fold_s"] = time.perf_counter() - t0
        line["fold_stdout"] = fold_lines
        with open(folded_cfg) as f:
            if "batch_normalize" in f.read():
                raise AssertionError("the folded cfg still has batch_normalize")

        # both pairs through zoo.load_darknet_model: the .weights load plus build
        load_s, models = {}, {}
        for name, (c, w) in (("live", (CFG, weights)), ("folded", (folded_cfg, folded_weights))):
            t0 = time.perf_counter()
            models[name] = zoo.load_darknet_model(c, w, device=DEVICE)
            torch.cuda.synchronize()
            load_s[name] = time.perf_counter() - t0
        n_bn = {name: sum(isinstance(m, DarkBatchNorm) for m in m_.modules())
                for name, m_ in models.items()}
        if n_bn["folded"] != 0 or n_bn["live"] == 0:
            raise AssertionError(f"BN layers live/folded: {n_bn}")
        line["bn_layers"] = n_bn
        line["weights_mb"] = {"live": os.path.getsize(weights) / 1e6,
                              "folded": os.path.getsize(folded_weights) / 1e6}

        # folded vs unfolded, f32 at DEPLOY_FOLD_BATCH x 608²
        x = torch.from_numpy(np.random.default_rng(5).uniform(
            0, 1, (DEPLOY_FOLD_BATCH, 3, IMAGE_SIZE, IMAGE_SIZE)).astype(np.float32)).to(DEVICE)
        with torch.inference_mode():
            ref, got = models["live"](x), models["folded"](x)
        fold_err = {}
        for f in fields:
            r, o = getattr(ref, f), getattr(got, f)
            fold_err[f] = float((o - r).abs().max()) / float(r.abs().max())
        line["fold_f32_max_abs_err_of_max"] = fold_err
        if not all(e <= DEPLOY_FOLD_TOL for e in fold_err.values()):
            raise AssertionError(f"folded vs unfolded f32 forward: {fold_err}")
        del x, ref, got

        # export: tool_main export --serving --dtype bfloat16 on each pair
        arts, export_s = {}, {}
        for name, (c, w) in (("artifact", (CFG, weights)),
                             ("folded_artifact", (folded_cfg, folded_weights))):
            arts[name] = os.path.join(root, name)
            t0 = time.perf_counter()
            quiet(tool_main.main, ["export", c, arts[name], "--weights", w, "--serving",
                                   "--dtype", "bfloat16", "--batch", str(BATCH),
                                   "--size", str(IMAGE_SIZE), "--device", DEVICE])
            export_s[name] = time.perf_counter() - t0
        line["export_s"] = export_s
        # what the exported programs run: their aten calls (the .to casts
        # come with a _assert_tensor_metadata node each, which launches nothing)
        line["artifact_graph"] = {}
        for name, path in arts.items():
            calls = collections.Counter(
                str(n.target) for n in torch.export.load(os.path.join(path, "model.pt2"))
                .graph.nodes if n.op == "call_function")
            line["artifact_graph"][name] = {"aten_calls": sum(calls.values()),
                                            "top": calls.most_common(6)}
        line["artifact_mb"] = {n: os.path.getsize(os.path.join(a, "model.pt2")) / 1e6
                               for n, a in arts.items()}

        # the four services: live, folded, and each artifact (from_artifact
        # loads the program: its load seconds)
        nms = dict(window_ms=10.0, nms_kind=kind, nms_beta=beta, device=DEVICE)
        svcs = {name: DetectionService(models[name], image_size=IMAGE_SIZE, batch_size=BATCH,
                                       **nms) for name in ("live", "folded")}
        for name, path in arts.items():
            t0 = time.perf_counter()
            svcs[name] = DetectionService.from_artifact(path, **nms)
            torch.cuda.synchronize()
            load_s[name] = time.perf_counter() - t0
            if (svcs[name].batch_size, svcs[name].image_size) != (BATCH, IMAGE_SIZE):
                raise AssertionError(f"{name}: batch/size {svcs[name].batch_size}, "
                                     f"{svcs[name].image_size}")
        line["load_s"] = load_s
        line["warmup_s"] = {name: svc.warmup() for name, svc in svcs.items()}

        # one batch of frames through each: artifact = live (bf16), the same
        # instances after NMS; then each forward's time and profile
        frames = [np.random.default_rng(i).integers(0, 256, (IMAGE_SIZE, IMAGE_SIZE, 3),
                                                    dtype=np.uint8) for i in range(BATCH)]
        stacked = torch.from_numpy(np.stack(frames)).to(DEVICE)
        forward_ms, profiled, equal, posts = {}, {}, {}, {}
        with torch.inference_mode():
            preds = {name: svc.forward(stacked) for name, svc in svcs.items()}
            for art, live in (("artifact", "live"), ("folded_artifact", "folded")):
                same = all(torch.equal(getattr(preds[art], f), getattr(preds[live], f))
                           for f in fields)
                errs = {f: float((getattr(preds[art], f).float() - getattr(preds[live], f).float())
                                 .abs().max()) / float(getattr(preds[live], f).float().abs().max())
                        for f in fields}
                equal[art] = {"bit_identical": same, "max_abs_err_of_max": errs}
                if not same and not all(e <= DEPLOY_ARTIFACT_TOL for e in errs.values()):
                    raise AssertionError(f"{art} vs {live}: {errs}")
            for name, svc in svcs.items():
                posts[name] = svc.postprocess(preds[name])
            for art, live in (("artifact", "live"), ("folded_artifact", "folded")):
                for f in ("valid", "classes", "instances"):
                    if not torch.equal(getattr(posts[art], f), getattr(posts[live], f)):
                        raise AssertionError(f"{art} and {live}: {f} differ after NMS")
            kept = {name: int(p.valid.sum()) for name, p in posts.items()}
            for name, svc in svcs.items():
                forward_ms[name] = median_ms(lambda: svc.forward(stacked), n=20)
                try:  # auxiliary: a profiler that sees no device time is not a failure
                    profiled[name] = profile_forward(svc, stacked)
                except Exception as e:
                    profiled[name] = {"profile": f"not measured: {type(e).__name__}: {e}"}
        line.update(artifact_vs_live=equal, kept_detections=kept, forward_ms=forward_ms,
                    forward_profile=profiled)

        # serving: 32 requests from 8 threads through each service
        line["serve"] = {name: serve_requests(svc, frames, kernels)
                         for name, svc in svcs.items()}
        del svcs, preds, posts, models
        torch.cuda.empty_cache()

        # the artifact CLIs on phase cli's kind of dataset
        config, _ = cli_workspace(root)
        batches = -(-CLI_IMAGES // BATCH)
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        detect_lines = quiet(detect_main.main, ["--config-file", config, "--artifact",
                                                arts["artifact"], *CLI_DEVICE_ARGS])
        torch.cuda.synchronize()
        detect_s = time.perf_counter() - t0
        detect_launches = {fn.__name__: fn.launches for fn in kernels}
        drawn = len(os.listdir(os.path.join(root, "out")))
        if set(detect_launches.values()) != {batches} or drawn != CLI_IMAGES:
            raise AssertionError(f"detect_main --artifact: launches {detect_launches}, "
                                 f"{drawn} images, {batches} batches")
        src = [(os.path.join(root, "images", f"{i:03d}.jpg"), *CLI_SIZES[i % len(CLI_SIZES)])
               for i in range(CLI_IMAGES)]
        line["detect_artifact"] = {"img_per_s": CLI_IMAGES / detect_s, "stdout": detect_lines,
                                   "launches": detect_launches}
        line["serve_main_artifact"] = serve_subprocess(config, ["--artifact", arts["artifact"]],
                                                       src)

        # A4 on the card: Reorg2D and [region] (yolov2), DarknetSam (cspx-p7-mish)
        line["a4_card_vs_cpu"] = {name: a4_card_vs_cpu(name, size)
                                  for name, size in A4_MODELS}
        # detect_main on yolov2.cfg at its own 416² from a seed-0 .weights file
        y2_weights = os.path.join(root, "yolov2.weights")
        y2 = zoo.load_darknet_model(YOLOV2_CFG, seed=0, device=DEVICE)
        save_darknet_weights(dk.Darknet.load(YOLOV2_CFG), *params_to_jax(y2.state_dict()),
                             y2_weights)
        del y2
        with open(config) as f:
            text = f.read()
        y2_config = os.path.join(root, "detect_yolov2.json5")
        with open(y2_config, "w") as f:
            f.write(text.replace(CFG, YOLOV2_CFG)
                    .replace(f"image_size: {IMAGE_SIZE}", f"image_size: {YOLOV2_SIZE}")
                    .replace(os.path.join(root, "out"), os.path.join(root, "out_yolov2")))
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        y2_lines = quiet(detect_main.main, ["--config-file", y2_config, "--weights", y2_weights,
                                            *CLI_DEVICE_ARGS])
        torch.cuda.synchronize()
        y2_s = time.perf_counter() - t0
        y2_launches = {fn.__name__: fn.launches for fn in kernels}
        drawn = len(os.listdir(os.path.join(root, "out_yolov2")))
        if set(y2_launches.values()) != {batches} or drawn != CLI_IMAGES:
            raise AssertionError(f"yolov2 detect_main: launches {y2_launches}, {drawn} images")
        line["yolov2_detect"] = {"image_size": YOLOV2_SIZE, "img_per_s": CLI_IMAGES / y2_s,
                                 "stdout": y2_lines, "launches": y2_launches}
        line["card"] = card_line()
        emit(line)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {**{f"deploy_serve_{name}": s["launches"] for name, s in line["serve"].items()},
            "deploy_detect_artifact": detect_launches, "deploy_yolov2_detect": y2_launches}


def dense_card_vs_cpu(name, count) -> dict:
    """The f32 eval forward of cfg/darknet/<name>.cfg at its own size and
    time steps on the card and on the CPU, the same seed-0 weights with
    seeded BN statistics: ``count`` images (uniform in [0, 1]) or
    sequences (time-major one-hot bytes of ``time_steps`` rows each; a
    detector's sequence is ``time_steps`` frames).  The output, and a
    classifier's pre-softmax logits, within CLASSIFY_TOL · max|cpu| + 1e-6."""
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.models import GraphModel
    from yolodl_torch.train.classifier import _pre_softmax_key

    darknet = dk.Darknet.load(os.path.join(REPO, "cfg", "darknet", f"{name}.cfg"))
    graph = graph_from_darknet(darknet)
    h, w, c = darknet.net.input_shape_hwc
    t = max(darknet.net.time_steps, 1)
    rng = np.random.default_rng(6)
    if darknet.net.inputs and not darknet.net.height:
        rows = np.zeros((t * count, c, 1, 1), np.float32)
        rows[np.arange(t * count), rng.integers(0, c, t * count)] = 1.0
        x = torch.from_numpy(rows)
    else:
        x = torch.from_numpy(rng.uniform(0, 1, (t * count, c, h, w)).astype(np.float32))
    cpu_model = GraphModel(graph, device="cpu")
    randomize_bn(cpu_model, 6)
    card_model = GraphModel(graph, device=DEVICE)
    card_model.load_state_dict(cpu_model.state_dict())
    logits = _pre_softmax_key(cpu_model)
    keys = tuple(k for k in (logits, cpu_model.output_key) if k is not None)
    out = {"input": list(x.shape), "parameters": sum(p.numel() for p in cpu_model.parameters()),
           "kinds": sorted({n.config.kind for n in graph.nodes.values()
                            if n.config.kind in ("Linear", "DarknetRnn", "DarknetGru",
                                                 "DarknetLstm", "DarknetCrnn")})}
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu_model(x, output_keys=keys)
        out["cpu_s"] = time.perf_counter() - t0
        got = card_model(x.to(DEVICE), output_keys=keys)
        torch.cuda.synchronize()
    fields = {}
    for k in keys:
        r, o = ref[k], got[k]
        if isinstance(r, torch.Tensor):
            fields["logits" if k == logits and k != cpu_model.output_key else "output"] = (r, o)
        else:
            fields.update({f: (getattr(r, f), getattr(o, f))
                           for f in ("cycxhw", "obj_logit", "class_logit")})
    for f, (r, o) in fields.items():
        o = o.cpu()
        scale, err = float(r.abs().max()), float((o - r).abs().max())
        out[f"{f}_max_abs_err"], out[f"{f}_max_abs"] = err, scale
        if not (err <= CLASSIFY_TOL * scale + 1e-6 and torch.isfinite(o).all()):
            raise AssertionError(f"{name} f32 forward {f}: card vs cpu max|d|={err} "
                                 f"(max {scale})")
    del cpu_model, card_model, got
    torch.cuda.empty_cache()
    return out


def classify_workspace(root, batch) -> str:
    """CLASSIFY_IMAGES JPEGs at CLASSIFY_SIZES in turn, each a noisy field
    of one of CLASSIFY_CLASSES colours (seed 0), as a CSV-labelled folder,
    and root/classify.json5 for vgg-16.cfg at ``batch``, f32, the
    reference's default optimizer (Adam, β1 0.937, lr 1e-3).  Returns the
    config's path."""
    from PIL import Image

    rng = np.random.default_rng(0)
    palette = rng.integers(0, 256, (CLASSIFY_CLASSES, 3))
    names = [f"colour{i}" for i in range(CLASSIFY_CLASSES)]
    os.makedirs(os.path.join(root, "images"))
    rows = ["image_file,class_name"]
    for i in range(CLASSIFY_IMAGES):
        h, w = CLASSIFY_SIZES[i % len(CLASSIFY_SIZES)]
        label = int(rng.integers(CLASSIFY_CLASSES))
        pixels = palette[label] + rng.integers(-40, 41, (h, w, 3))
        Image.fromarray(np.clip(pixels, 0, 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"{i:04d}.jpg"), quality=90)
        rows.append(f"{i:04d}.jpg,{names[label]}")
    with open(os.path.join(root, "labels.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    config = os.path.join(root, "classify.json5")
    with open(config, "w") as f:
        f.write(f"""// vgg-16 at its own 256x256 on a synthetic colour-coded set
{{
  version: "0.1.0",
  model: {{kind: "Darknet", cfg_file: "{VGG_CFG}",}},
  dataset: {{image_dir: "images", label_file: "labels.csv", classes_file: "classes.txt",}},
  logging: {{dir: "logs",}},
  training: {{batch_size: {batch}, precision: "float32",}},  // Adam, the defaults
}}
""")
    return config


def device_profile(fn) -> tuple:
    """(kernels, device ms) of one ``fn()`` under torch.profiler with the
    device activity only, counted on the raw kineto events (a step of
    10^4-10^6 kernels takes seconds to minutes as FunctionEvents)."""
    from torch.profiler import ProfilerActivity, profile

    # (DEVICE "cpu", a rehearsal: the CPU's operators stand in for kernels)
    activity, kind = ((ProfilerActivity.CUDA, "CUDA") if DEVICE == "cuda"
                      else (ProfilerActivity.CPU, "CPU"))
    torch.cuda.synchronize()
    with profile(activities=[activity]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, ns = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == kind and not e.is_user_annotation():
            kernels += 1
            ns += e.duration_ns()
    return kernels, ns / 1e6


def step_profile(step, n_timed) -> dict:
    """One call of ``step()`` under :func:`device_profile`, then
    ``n_timed`` calls between CUDA events (ms each, sorted), and the card's
    idle share of the median one (1 - device ms / step ms)."""
    kernels, device_ms = device_profile(step)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_timed + 1)]
    events[0].record()
    for i in range(n_timed):
        step()
        events[i + 1].record()
    torch.cuda.synchronize()
    ms = sorted(events[i].elapsed_time(events[i + 1]) for i in range(n_timed))
    median = ms[len(ms) // 2]
    return {"step_ms": ms, "step_ms_median": median, "device_ms": device_ms,
            "kernels": kernels, "device_idle_share": 1.0 - device_ms / median}


def vgg_classify_main(root) -> dict:
    """classify_main on vgg-16.cfg as a user runs it; see the module
    docstring."""
    import glob

    from yolodl_torch.bridge import params_from_jax, params_to_jax
    from yolodl_torch.cli import classify_main
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.data import cache as cache_mod
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.models import GraphModel, zoo
    from yolodl_torch.train import TrainConfig, train_init
    from yolodl_torch.train import classifier as classifier_mod
    from yolodl_torch.train.checkpoint import load_recent_checkpoint_in_runs

    size = dk.Darknet.load(VGG_CFG).net.height
    probe = GraphModel(graph_from_darknet(dk.Darknet.load(VGG_CFG)), device=DEVICE)
    saved = saved_bytes(probe, size)
    del probe
    torch.cuda.empty_cache()
    batch, cut = CLASSIFY_BATCH, None
    if saved * batch > DK_SAVED_BUDGET:
        batch = int(DK_SAVED_BUDGET // saved)
        cut = (f"batch {CLASSIFY_BATCH} -> {batch}: {saved * CLASSIFY_BATCH / 1e9:.1f} GB of "
               f"saved activations > {DK_SAVED_BUDGET / 1e9:.0f} GB")
    config = classify_workspace(root, batch)
    line = {"model": "vgg-16", "image_size": size, "batch": batch, "batch_cut": cut,
            "dtype": "float32", "saved_gb_per_image": saved / 1e9,
            "saved_gb_per_batch": saved * batch / 1e9}

    # train: decode and step timed from outside the CLI
    decode_s, steps = [0.0], []
    real_loader, real_make_step = cache_mod.make_decode_loader, classifier_mod.make_classifier_train_step

    def timed_loader(hw):
        loader = real_loader(hw)
        load = loader.load

        def timed_load(record):
            t0 = time.perf_counter()
            try:
                return load(record)
            finally:
                decode_s[0] += time.perf_counter() - t0
        loader.load = timed_load
        return loader

    def timed_make_step(*args, **kwargs):
        step = real_make_step(*args, **kwargs)

        def timed(ts, images, labels):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, metrics = step(ts, images, labels)
            loss = float(metrics["loss"])
            t1 = time.perf_counter()
            steps.append({"start": t0, "end": t1, "loss": loss})
            return ts, metrics
        return timed

    torch.cuda.reset_peak_memory_stats()
    with swapped(cache_mod, make_decode_loader=timed_loader), \
            swapped(classifier_mod, make_classifier_train_step=timed_make_step), \
            swapped(torch.backends.cudnn, allow_tf32=True):
        t0 = time.perf_counter()
        train_lines = quiet(classify_main.main, ["--config-file", config, "--max-steps",
                                                 str(CLASSIFY_STEPS), *CLI_DEVICE_ARGS])
        line["train_s"] = time.perf_counter() - t0
    line["train_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    losses = [s["loss"] for s in steps]
    if len(losses) != CLASSIFY_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"classify_main losses {losses}")
    ckpts = sorted(glob.glob(os.path.join(root, "logs", "*", "checkpoints", "*.ckpt")))
    if not ckpts:
        raise AssertionError("classify_main wrote no checkpoint")
    with np.load(ckpts[-1]) as data:
        if not any(k.startswith("opt/") for k in data.files):
            raise AssertionError(f"{ckpts[-1]} holds no opt/")
    step_ms = [(s["end"] - s["start"]) * 1e3 for s in steps]
    line.update(stdout=train_lines, losses=losses, step_ms=step_ms,
                steps_per_s=(len(steps) - 1) / (steps[-1]["end"] - steps[0]["end"]),
                decode_ms_per_step=decode_s[0] * 1e3 / len(steps),
                synchronized_step_ms_median=statistics.median(step_ms[1:]))

    # eval: top-1 and top-5 from the checkpoint; the top-1 count equal to
    # the model's argmax on the same decoded batches (same padding)
    with swapped(torch.backends.cudnn, allow_tf32=True):
        t0 = time.perf_counter()
        eval_lines = quiet(classify_main.main, ["--config-file", config, "--eval", "--topk", "5",
                                                *CLI_DEVICE_ARGS])
        line["eval_s"] = time.perf_counter() - t0
        counts = {}
        for text in eval_lines:
            if "accuracy" in text:
                k = text.split()[0]
                counts[k] = int(text.split("(")[1].split("/")[0])
        if set(counts) != {"top-1", "top-5"} or counts["top-5"] < counts["top-1"]:
            raise AssertionError(f"classify_main --eval: {eval_lines}")
        model = zoo.load_darknet_classifier(VGG_CFG, device=DEVICE)
        p, s, _, meta = load_recent_checkpoint_in_runs(os.path.join(root, "logs"),
                                                       *params_to_jax(model.state_dict()))
        params_from_jax(p, s, model=model)
        records = classify_main._load_records(os.path.join(root, "images"),
                                              os.path.join(root, "labels.csv"),
                                              [f"colour{i}" for i in range(CLASSIFY_CLASSES)])
        loader = cache_mod.make_decode_loader((size, size))
        direct, first = 0, None
        from yolodl_torch.data.records import FileRecord

        for i in range(0, len(records), batch):
            chunk = records[i:i + batch]
            n_real = len(chunk)
            chunk = chunk + [chunk[-1]] * (batch - n_real)
            images = torch.from_numpy(np.stack([loader.load(FileRecord(
                path=path, height=0, width=0, boxes_pixel=np.zeros((0, 4), np.float32),
                classes=np.zeros((0,), np.int32))).image for path, _ in chunk])).to(DEVICE)
            labels = torch.tensor([lbl for _, lbl in chunk], device=DEVICE)
            with torch.inference_mode():
                pred = model(images, train=False).reshape(batch, -1).argmax(-1)
            direct += int((pred[:n_real] == labels[:n_real]).sum())
            if first is None:
                first = (images, labels)
    if direct != counts["top-1"]:
        raise AssertionError(f"eval top-1 {counts['top-1']} != model -> argmax {direct}")
    line.update(eval_stdout=eval_lines, eval_counts=counts, direct_top1=direct,
                checkpoint_step=meta["step"])

    # one step at library level: events, then the profiler
    config_t = TrainConfig()
    ts, opt = train_init(model, config_t)
    step = classifier_mod.make_classifier_train_step(model, opt, config_t)
    with swapped(torch.backends.cudnn, allow_tf32=True):
        step(ts, *first)  # warm-up, then a profiled one and 3 timed
        line["library_step"] = step_profile(lambda: step(ts, *first), 3)
    del model, opt, ts, first, step
    torch.cuda.empty_cache()
    return line


def lstm_train_step() -> dict:
    """lstm.train.cfg at full width through make_classifier_train_step:
    LSTM_SEQUENCES sequences of its 576 time steps, time-major one-hot bytes
    of the repo's README.md + SURVEY.md, each label the next byte; f32,
    TrainConfig() (Adam); LSTM_WARMUP steps, the last one profiled, then
    LSTM_TIMED timed (step_profile).  Every loss finite, every parameter
    changed."""
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.models import zoo
    from yolodl_torch.train import TrainConfig, train_init
    from yolodl_torch.train.classifier import make_classifier_train_step

    darknet = dk.Darknet.load(LSTM_CFG)
    t, b = darknet.net.time_steps, LSTM_SEQUENCES
    text = b"".join(open(os.path.join(REPO, n), "rb").read() for n in ("README.md", "SURVEY.md"))
    data = np.frombuffer(text, np.uint8)
    span = (len(data) - 1) // b
    if span < t:
        raise AssertionError(f"{len(data)} bytes of text < {b} sequences of {t + 1}")
    idx = np.arange(t)[:, None] + (np.arange(b) * span)[None, :]  # [t, b], row t*b + j
    inputs = data[idx].reshape(-1)
    labels = data[idx + 1].reshape(-1)
    x = torch.zeros((t * b, 256, 1, 1))
    x[torch.arange(t * b), torch.from_numpy(inputs.astype(np.int64))] = 1.0
    x, y = x.to(DEVICE), torch.from_numpy(labels.astype(np.int64)).to(DEVICE)

    model = zoo.load_darknet_classifier(LSTM_CFG, device=DEVICE)
    config = TrainConfig()
    ts, opt = train_init(model, config)
    step = make_classifier_train_step(model, opt, config)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    losses = []

    def one():
        _, m = step(ts, x, y)
        losses.append(m["loss"])

    torch.cuda.reset_peak_memory_stats()
    for _ in range(LSTM_WARMUP - 1):
        one()
    prof = step_profile(one, LSTM_TIMED)  # its profiled step is the last warm-up
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"lstm.train losses {losses}")
    changed = sum(int(not torch.equal(v, p0[k])) for k, v in model.named_parameters())
    if changed != len(p0):
        raise AssertionError(f"{len(p0) - changed} of {len(p0)} lstm.train parameters did "
                             "not change")
    line = {"model": "lstm.train", "time_steps": t, "sequences": b, "rows": t * b,
            "parameters": sum(v.numel() for v in p0.values()), "dtype": "float32",
            "losses": losses, "peak_memory_gb": peak, **prof,
            "kernels_per_time_step": prof["kernels"] / t}
    del model, opt, ts, x, y, p0
    torch.cuda.empty_cache()
    return line


def occlusion_track_detect(root, iou) -> dict:
    """detect_main on yolov3-tiny_occlusion_track.cfg at its own 416² from
    a seed-0 .weights file (written by the port's saver, read back through
    zoo.load_darknet_model bit-identical), batch 20 (its time_steps) over
    OCCLUSION_FRAMES frames of one synthetic sequence (a square moving over
    a smooth field), B1's counters zeroed right before and read right
    after: each kernel once per batch."""
    from PIL import Image

    from yolodl_torch.bridge import params_to_jax
    from yolodl_torch.cli import detect_main
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.models import zoo
    from yolodl_torch.models.weights import save_darknet_weights

    darknet = dk.Darknet.load(OCCLUSION_CFG)
    batch = darknet.net.time_steps
    weights = os.path.join(root, "occlusion_track.weights")
    seeded = zoo.load_darknet_model(OCCLUSION_CFG, seed=0, device=DEVICE)
    save_darknet_weights(darknet, *params_to_jax(seeded.state_dict()), weights)
    loaded = zoo.load_darknet_model(OCCLUSION_CFG, weights, device=DEVICE)
    want = seeded.state_dict()
    if not all(torch.equal(v, want[k]) for k, v in loaded.state_dict().items()):
        raise AssertionError("occlusion_track .weights round trip changed the state_dict")
    del seeded, loaded, want

    frames = os.path.join(root, "frames")
    os.makedirs(frames)
    rng = np.random.default_rng(7)
    h, w = 480, 640
    low = rng.integers(0, 256, (h // 40 + 2, w // 40 + 2, 3), dtype=np.uint8)
    field = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR), np.int16)
    rows = ["image_file,class_name,cy,cx,h,w"]
    for i in range(OCCLUSION_FRAMES):
        cy, cx = 120 + 4 * i, 100 + 10 * i
        pixels = field + rng.integers(-12, 13, (h, w, 3))
        pixels[cy - 40:cy + 40, cx - 50:cx + 50] = (230, 40, 40)
        Image.fromarray(np.clip(pixels, 0, 255).astype(np.uint8)).save(
            os.path.join(frames, f"{i:03d}.jpg"), quality=90)
        rows.append(f"{i:03d}.jpg,object,{cy}.00,{cx}.00,80.00,100.00")
    with open(os.path.join(root, "frames.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "frames_classes.txt"), "w") as f:
        f.write("object\n")
    out_dir = os.path.join(root, "out_occlusion")
    config = write_json(os.path.join(root, "detect_occlusion.json5"), {
        "version": "0.1.0",
        "model": {"kind": "Darknet", "cfg_file": OCCLUSION_CFG, "minibatch_size": batch,
                  "devices": ["cuda:0"]},
        "input": {"kind": {"type": "Csv", "image_size": OCCLUSION_SIZE, "image_dir": frames,
                           "label_file": os.path.join(root, "frames.csv"),
                           "classes_file": os.path.join(root, "frames_classes.txt")}},
        "preprocess": {"out_of_bound_tolerance": 1.0},
        "output": {"output_dir": out_dir, "nms_iou_thresh": NMS_IOU,
                   "nms_conf_thresh": CLI_CONF}})
    kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)
    batches = -(-OCCLUSION_FRAMES // batch)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    lines = quiet(detect_main.main, ["--config-file", config, "--weights", weights,
                                     *CLI_DEVICE_ARGS])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    drawn = len(os.listdir(out_dir))
    if set(launches.values()) != {batches} or drawn != OCCLUSION_FRAMES:
        raise AssertionError(f"occlusion_track detect_main: launches {launches}, "
                             f"{drawn} images, {batches} batches")
    return {"model": "yolov3-tiny_occlusion_track", "image_size": OCCLUSION_SIZE,
            "batch": batch, "frames": OCCLUSION_FRAMES, "img_per_s": OCCLUSION_FRAMES / seconds,
            "seconds": seconds, "stdout": lines, "launches": launches,
            "weights_mb": os.path.getsize(weights) / 1e6}


def phase_classify(iou) -> dict:
    """The dense and recurrent node kinds (ROADMAP A12) and classify_main
    (A11d) on the card; see the module docstring.  Returns B1's launches
    on occlusion_track's detect path."""
    import shutil

    root = CLASSIFY_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    line = {"phase": "classify"}
    try:
        line["card_vs_cpu"] = {name: dense_card_vs_cpu(name, count)
                               for name, count in CLASSIFY_CARD_VS_CPU}
        line["vgg16_classify_main"] = vgg_classify_main(root)
        line["lstm_train_step"] = lstm_train_step()
        line["occlusion_track_detect"] = occlusion_track_detect(root, iou)
        line["card"] = card_line()
        emit(line)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"occlusion_track_detect": line["occlusion_track_detect"]["launches"]}


# -- phase dp: data-parallel training and multi-device inference (A14a)

def param_digest(model) -> str:
    """sha256 over every parameter's and buffer's bytes, in state_dict order."""
    import hashlib

    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_step_runs(model_fn, config, batch, steps, timed, mesh=None):
    """``steps`` steps of the flagship from ``model_fn()``, then ``timed``
    more: the plain step (``mesh`` None) or make_dp_train_step over
    ``mesh`` → (the first ``steps`` losses, the state dict on the host
    after them, the median ms by events of the timed steps)."""
    from yolodl_torch.parallel import make_dp_train_step, replicate_state
    from yolodl_torch.train import make_train_step, train_init

    model = model_fn()
    ts, opt = train_init(model, config)
    if mesh is None:
        step = make_train_step(model, opt, config)
    else:
        ts = replicate_state(mesh, ts)
        step = make_dp_train_step(model, opt, config, mesh)
    losses = [float(step(ts, *batch)[1]["total_loss"]) for _ in range(steps)]
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    ms = statistics.median(timed_ms(lambda: step(ts, *batch), DEVICE) for _ in range(timed))
    return losses, state, ms


def timed_ms(fn, device) -> float:
    """ms of one ``fn()`` by CUDA events on a card (under gloo the host
    blocks inside it, and the events span that too), by the host clock on
    the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def all_reduce_ms(mesh, numel, n=5) -> float:
    """Median ms of one all-reduce of a flat f32 buffer of ``numel`` on
    ``mesh``'s device, after one untimed."""
    buf = torch.ones(numel, dtype=torch.float32, device=mesh.device)
    return statistics.median([timed_ms(lambda: mesh.all_reduce_(buf), mesh.device)
                              for _ in range(n + 1)][1:])


def dp_world_one(darknet) -> dict:
    """make_dp_train_step at world size 1 over NCCL against the plain step,
    bit for bit after DP_STEPS steps (each run deterministic: cuDNN's
    deterministic algorithms, and the plain step run twice as a control)."""
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.models import YoloModel
    from yolodl_torch.parallel.mesh import destroy_process_group, free_port, init_process_group
    from yolodl_torch.train import TrainConfig

    def model_fn():
        return YoloModel(graph_from_darknet(darknet), device=DEVICE,
                         generator=torch.Generator().manual_seed(0))

    images, boxes, classes, mask = synthetic_batch(TRAIN_BATCH, IMAGE_SIZE)
    batch = (torch.from_numpy(images).to(torch.bfloat16).to(DEVICE),
             *(torch.from_numpy(a).to(DEVICE) for a in (boxes, classes, mask)))
    mesh = init_process_group(DEVICE, init_method=f"tcp://127.0.0.1:{free_port()}",
                              rank=0, world_size=1)
    want = "nccl" if DEVICE == "cuda" else "gloo"
    if mesh.backend != want:
        raise AssertionError(f"world size 1 on {DEVICE}: backend {mesh.backend}, not {want}")
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {name: dp_step_runs(model_fn, TrainConfig(), batch, DP_STEPS, DP_TIMED,
                                   mesh if name == "dp" else None)
                for name in ("plain", "plain_again", "dp")}
        numel = sum(v.numel() for k, v in runs["plain"][1].items()
                    if not k.endswith((".mean", ".var")))  # the parameters
        reduce_ms = all_reduce_ms(mesh, numel)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        destroy_process_group()
    torch.cuda.empty_cache()

    def same(a, b):
        return a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1])

    control = same(runs["plain"], runs["plain_again"])
    if not control:
        raise AssertionError("the plain flagship step is not bit-reproducible here, so "
                             "the world-size-1 step cannot be held to it bit for bit")
    if not same(runs["dp"], runs["plain"]):
        worst = max(float((runs["dp"][1][k].float() - v.float()).abs().max())
                    for k, v in runs["plain"][1].items())
        raise AssertionError(f"world size 1 DP step != plain step: losses {runs['dp'][0]} vs "
                             f"{runs['plain'][0]}, max|d| {worst}")
    return {"backend": mesh.backend, "steps": DP_STEPS, "bit_identical": True,
            "losses": runs["dp"][0], "timed_steps": DP_TIMED,
            "plain_step_ms_median": runs["plain"][2],
            "plain_again_step_ms_median": runs["plain_again"][2],
            "dp_step_ms_median": runs["dp"][2], "all_reduce_ms": reduce_ms,
            "all_reduce_mb": 4 * numel / 1e6}


def dp_rank() -> None:
    """One rank of phase dp's 2-rank run (``python3 -c "import chip_smoke;
    chip_smoke.dp_rank()"`` under launch_ranks' variables): the flagship at
    b16 over 2 ranks of 8 rows on this rank's device, then yolov4-tiny at
    64² (seeded BN, as the CPU tests' weights) one SGD step on the card and
    on the CPU; results to
    DP_ROOT/rank<r>.json and .npz.  The device and sizes come from
    DP_ROOT/spec.json, written by the parent."""
    sys.path.insert(0, REPO)
    with open(os.path.join(DP_ROOT, "spec.json")) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.models import YoloModel
    from yolodl_torch.parallel import (init_process_group, make_dp_train_step, replicate_state,
                                       shard_batch)
    from yolodl_torch.parallel.mesh import destroy_process_group
    from yolodl_torch.train import TrainConfig, train_init
    from yolodl_torch.train.lr_schedule import LrScheduleConfig

    mesh = init_process_group(spec["device"])
    on_card = mesh.device.type == "cuda"
    out = {"rank": mesh.rank, "backend": mesh.backend, "reason": mesh.reason,
           "device": str(mesh.device)}

    # the flagship, bf16, default TrainConfig(), 8 rows a rank
    model = YoloModel(graph_from_darknet(dk.Darknet.load(CFG)), device=mesh.device,
                      generator=torch.Generator().manual_seed(0))
    ts, opt = train_init(model, TrainConfig())
    ts = replicate_state(mesh, ts)
    step = make_dp_train_step(model, opt, TrainConfig(), mesh)
    images, boxes, classes, mask = shard_batch(
        mesh, synthetic_batch(spec["batch"], spec["image_size"]))
    batch = (torch.from_numpy(images).to(torch.bfloat16).to(mesh.device),
             *(torch.from_numpy(a).to(mesh.device) for a in (boxes, classes, mask)))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(1 + DP_RANK_TIMED):
        ms = timed_ms(lambda: losses.append(step(ts, *batch)[1]), mesh.device)
        if i:
            step_ms.append(ms)
    m = losses[-1]
    losses = [float(x["total_loss"]) for x in losses]
    out.update(rows=int(batch[0].shape[0]), losses=losses, step_ms=step_ms,
               num_matched=int(m["num_matched"]), digest=param_digest(model),
               all_reduce_ms=all_reduce_ms(mesh, sum(p.numel() for p in model.parameters())),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None)
    del model, opt, ts, batch
    if on_card:
        torch.cuda.empty_cache()

    # yolov4-tiny, 64², f32, one SGD step on the card, then on the CPU
    config = TrainConfig(optimizer="sgd", lr=LrScheduleConfig(kind="constant", lr=3e-4))
    tiny = shard_batch(mesh, synthetic_batch(spec["tiny_batch"], spec["tiny_size"], seed=2))
    arrays = {}
    for where in (mesh.device, torch.device("cpu")):
        model = YoloModel(graph_from_darknet(dk.Darknet.load(DP_TINY_CFG)), device=where,
                          generator=torch.Generator().manual_seed(0))
        randomize_bn(model, 0)  # BN away from init, as the CPU tests' weights
        ts, opt = train_init(model, config)
        ts = replicate_state(mesh, ts)
        ts, m = make_dp_train_step(model, opt, config, mesh)(
            ts, *(torch.from_numpy(a).to(where) for a in tiny))
        tag = where.type
        out[f"tiny_{tag}_loss"] = float(m["total_loss"])
        out[f"tiny_{tag}_num_matched"] = int(m["num_matched"])
        out[f"tiny_{tag}_digest"] = param_digest(model)
        arrays.update({f"{tag}/{k}": v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()})
    np.savez(os.path.join(DP_ROOT, f"rank{mesh.rank}.npz"), **arrays)
    with open(os.path.join(DP_ROOT, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    destroy_process_group()


def dp_two_ranks() -> dict:
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    device): the ranks' parameters bit-identical, card = CPU on yolov4-tiny."""
    from yolodl_torch.parallel.mesh import launch_ranks

    write_json(os.path.join(DP_ROOT, "spec.json"), {
        "device": f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE, "image_size": IMAGE_SIZE,
        "batch": TRAIN_BATCH, "tiny_size": DP_TINY_SIZE, "tiny_batch": DP_TINY_BATCH})
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    launch_ranks([sys.executable, "-c", "import chip_smoke; chip_smoke.dp_rank()"], 2,
                 env=env, cwd=REPO, timeout=DP_TIMEOUT)
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(DP_ROOT, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0, r1 = ranks
    want = "ranks share cuda:0" if DEVICE == "cuda" else "ranks run on the CPU"
    if r0["backend"] != "gloo" or r0["reason"] != want:
        raise AssertionError(f"2 ranks on one card: {r0['backend']} ({r0['reason']})")
    for key in ("digest", "losses", "tiny_cpu_digest", f"tiny_{DEVICE}_digest"):
        if r0[key] != r1[key]:
            raise AssertionError(f"the two ranks differ in {key}")
    if not all(np.isfinite(r0["losses"])) or r0["num_matched"] <= 0:
        raise AssertionError(f"flagship DP losses {r0['losses']}, matched {r0['num_matched']}")
    # card vs CPU, tests/test_torch_dp.py's limits
    l_card, l_cpu = r0[f"tiny_{DEVICE}_loss"], r0["tiny_cpu_loss"]
    if not abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu):
        raise AssertionError(f"tiny DP loss: card {l_card} vs cpu {l_cpu}")
    if r0[f"tiny_{DEVICE}_num_matched"] != r0["tiny_cpu_num_matched"]:
        raise AssertionError("tiny DP num_matched: card != cpu")
    with np.load(os.path.join(DP_ROOT, "rank0.npz")) as f:
        worst, worst_key = max((float(np.abs(f[f"{DEVICE}/{k[4:]}"] - f[k]).max())
                                / max(float(np.abs(f[k]).max()), 1e-30), k)
                               for k in f.files if k.startswith("cpu/"))
    if not worst <= DP_TINY_TOL:
        raise AssertionError(f"tiny DP state: card vs cpu {worst} of max at {worst_key} "
                             f"> {DP_TINY_TOL}")
    return {"backend": r0["backend"], "reason": r0["reason"], "rows_a_rank": r0["rows"],
            "losses": r0["losses"], "params_bit_identical": True,
            "step_ms": r0["step_ms"], "step_ms_rank1": r1["step_ms"],
            "all_reduce_ms": r0["all_reduce_ms"], "peak_memory_gb": r0["peak_memory_gb"],
            "tiny_card_vs_cpu": {"loss_card": l_card, "loss_cpu": l_cpu,
                                 "state_err_of_max": worst, "worst": worst_key},
            "wall_s": wall_s}


def dp_workspace(root) -> str:
    """A NEWSLAB training workspace: 8 PNGs of 48² with a red square, a
    three-conv model at 32², MultiDevice on cuda:0 twice, batch 4."""
    from PIL import Image

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(8):
        arr = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
        arr[10:30, 10:30] = (255, 0, 0)
        Image.fromarray(arr).save(os.path.join(root, "images", f"i{i}.png"))
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("square\n")
    with open(os.path.join(root, "label.csv"), "w") as f:
        f.write("\n".join(["image_file,class_name,cy,cx,h,w"]
                          + [f"i{i}.png,square,20,20,20,20" for i in range(8)]) + "\n")
    model = {"main_group": "m", "groups": {"m": [
        {"name": "input", "kind": "Input", "shape": ["_", 3, 32, 32]},
        {"kind": "ConvBn2D", "c": 8, "k": 3, "s": 2},
        {"kind": "ConvBn2D", "c": 12, "k": 3, "s": 2},
        {"name": "head", "kind": "ConvBn2D", "c": 6, "k": 1, "act": "linear",
         "bn": {"enabled": False}},
        {"name": "det", "kind": "Detect2D", "classes": 1, "anchors": [[0.4, 0.4]]},
        {"name": "output", "kind": "MergeDetect2D", "from": ["det"]}]}}
    write_json(os.path.join(root, "model.json5"), model)
    device = f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE
    return write_json(os.path.join(root, "train.json5"), {
        "version": "0.1.0",
        "model": {"kind": "NewslabV1", "cfg_file": "model.json5"},
        "dataset": {"kind": {"type": "Csv", "image_size": 32, "input_channels": 3,
                             "image_dir": os.path.join(root, "images"),
                             "label_file": os.path.join(root, "label.csv"),
                             "classes_file": os.path.join(root, "classes.txt")}},
        "logging": {"dir": os.path.join(root, "logs")},
        "preprocessor": {"mixup": {"mosaic_prob": 0.5, "mosaic_margin": 0.3}},
        "training": {"batch_size": 4, "save_checkpoint_steps": 1,
                     "device_config": {"type": "MultiDevice", "devices": [device, device]},
                     "load_checkpoint": {"type": "Disabled"}},
    })


def dp_train_main() -> dict:
    """train_main with MultiDevice [cuda:0, cuda:0] as a subprocess: exit 0,
    the gloo line, checkpoints from rank 0 only."""
    import glob

    config = dp_workspace(os.path.join(DP_ROOT, "train_main"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "yolodl_torch.cli.train_main", "--config-file",
                          config, "--max-steps", str(DP_TRAIN_MAIN_STEPS), *CLI_DEVICE_ARGS],
                         capture_output=True, text=True, cwd=REPO, timeout=DP_TIMEOUT,
                         env=dict(os.environ, PYTHONPATH=REPO))
    wall_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"train_main MultiDevice exited {res.returncode}:\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    want = ("ranks share cuda:0" if DEVICE == "cuda" else "ranks run on the CPU")
    if f"dp: 2 ranks, backend gloo ({want})" not in res.stdout:
        raise AssertionError(f"no backend line:\n{res.stdout[-2000:]}")
    logs = os.path.join(os.path.dirname(config), "logs")
    chief = glob.glob(os.path.join(logs, "*[0-9]", "checkpoints", "*.ckpt"))
    others = glob.glob(os.path.join(logs, "*-r1", "checkpoints", "*.ckpt"))
    if len(chief) != DP_TRAIN_MAIN_STEPS or others:
        raise AssertionError(f"checkpoints: rank 0 {len(chief)}, rank 1 {len(others)}")
    return {"exit_code": 0, "steps": DP_TRAIN_MAIN_STEPS, "rank0_checkpoints": len(chief),
            "rank1_checkpoints": 0, "wall_s": wall_s}


def dp_serve(iou, darknet) -> dict:
    """DetectionService with two replicas on one card against one replica
    at the replicas' batch: the same detections; one launch of each B1
    kernel per replica per served batch."""
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.loss import nms as nms_mod
    from yolodl_torch.models import YoloModel
    from yolodl_torch.serve import DetectionService

    nms_kind, nms_beta = nms_mod.nms_options_from_darknet(darknet)
    model = YoloModel(graph_from_darknet(darknet), device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
    device = f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE
    frames = [np.random.default_rng(100 + i).integers(0, 256, (IMAGE_SIZE, IMAGE_SIZE, 3),
                                                      dtype=np.uint8)
              for i in range(DP_SERVE_FRAMES)]
    kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)
    out, results = {}, {}
    for name, kw in (("two_replicas", dict(devices=[device, device], batch_size=BATCH)),
                     ("one_replica_half_batch", dict(batch_size=BATCH // 2)),
                     ("one_replica", dict(batch_size=BATCH))):
        svc = DetectionService(model, image_size=IMAGE_SIZE, window_ms=500.0,
                               nms_kind=nms_kind, nms_beta=nms_beta, device=device, **kw)
        svc.warmup()
        got = [None] * len(frames)

        def client(i):
            got[i] = svc.submit_u8(frames[i], timeout=300)

        for fn in kernels:
            fn.launches = 0
        svc.start()
        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,)) for i in range(len(frames))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
            snap = svc.stats.snapshot(svc.batch_size)
        finally:
            svc.shutdown()
        launches = {fn.__name__: fn.launches for fn in kernels}
        replicas = len(svc.devices)
        if snap["errors"] or any(r is None for r in got):
            raise AssertionError(f"{name}: serving failed: {snap}")
        if DEVICE == "cuda" and set(launches.values()) != {replicas * snap["batches"]}:
            raise AssertionError(f"{name}: launches {launches} != {replicas} x "
                                 f"{snap['batches']} batches")
        results[name] = got
        out[name] = {"replicas": replicas, "batches": snap["batches"],
                     "launches": launches, "img_per_s": len(frames) / wall,
                     "p50_ms": snap.get("latency_ms", {}).get("p50"),
                     "detections": sum(len(r) for r in got)}
    if results["two_replicas"] != results["one_replica_half_batch"]:
        raise AssertionError("two replicas' detections != one replica's at their batch")
    same = sum(a == b for a, b in zip(results["two_replicas"], results["one_replica"]))
    out["images_equal_to_one_replica_full_batch"] = f"{same}/{len(frames)}"
    del model
    torch.cuda.empty_cache()
    return out


def phase_dp(iou) -> dict:
    """Data-parallel training and multi-device inference (ROADMAP A14a)."""
    import shutil

    from yolodl_torch.config import darknet_cfg as dk

    shutil.rmtree(DP_ROOT, ignore_errors=True)
    os.makedirs(DP_ROOT)
    darknet = dk.Darknet.load(CFG)
    try:
        world_one = dp_world_one(darknet)
        two_ranks = dp_two_ranks()
        train_main = dp_train_main()
        serve = dp_serve(iou, darknet)
    finally:
        shutil.rmtree(DP_ROOT, ignore_errors=True)
    emit({"phase": "dp", "model": "yolov4-csp", "image_size": IMAGE_SIZE,
          "batch": TRAIN_BATCH, "dtype": "bfloat16", "world_size_1": world_one,
          "two_ranks_one_card": two_ranks, "train_main_multidevice": train_main,
          "serve": serve, "card": card_line()})
    return {"dp_serve_two_replicas": serve["two_replicas"]["launches"],
            "dp_serve_one_replica_half_batch": serve["one_replica_half_batch"]["launches"],
            "dp_serve_one_replica": serve["one_replica"]["launches"]}


def zero_world_one(darknet) -> dict:
    """make_zero_train_step at world size 1 over NCCL against the plain
    step: TP_ZERO_STEPS steps of the flagship, cuDNN deterministic."""
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.models import YoloModel
    from yolodl_torch.parallel import make_zero_train_step, place_zero_state, zero_init
    from yolodl_torch.parallel.mesh import destroy_process_group, free_port, init_process_group
    from yolodl_torch.train import TrainConfig, make_train_step, train_init

    images, boxes, classes, mask = synthetic_batch(TRAIN_BATCH, IMAGE_SIZE)
    batch = (torch.from_numpy(images).to(torch.bfloat16).to(DEVICE),
             *(torch.from_numpy(a).to(DEVICE) for a in (boxes, classes, mask)))
    mesh = init_process_group(DEVICE, init_method=f"tcp://127.0.0.1:{free_port()}",
                              rank=0, world_size=1)
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for name in ("plain", "zero"):
            model = YoloModel(graph_from_darknet(darknet), device=DEVICE,
                              generator=torch.Generator().manual_seed(0))
            if name == "zero":
                ts, opt = zero_init(model, TrainConfig(), mesh)
                ts = place_zero_state(mesh, ts)
                step = make_zero_train_step(model, opt, TrainConfig(), mesh)
            else:
                ts, opt = train_init(model, TrainConfig())
                step = make_train_step(model, opt, TrainConfig())
            losses = [float(step(ts, *batch)[1]["total_loss"]) for _ in range(TP_ZERO_STEPS)]
            runs[name] = (losses, {k: v.detach().cpu().clone()
                                   for k, v in model.state_dict().items()})
            del model, opt, ts, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        destroy_process_group()
    (l_plain, s_plain), (l_zero, s_zero) = runs["plain"], runs["zero"]

    def worst(keys):
        return max(float((s_zero[k].float() - s_plain[k].float()).abs().max()) for k in keys)

    stats = [k for k in s_plain if k.endswith((".mean", ".var"))]
    params = [k for k in s_plain if k not in stats]
    d_params, d_stats = worst(params), worst(stats)
    if not (np.allclose(l_zero, l_plain, rtol=1e-5, atol=0) and d_params <= 1e-6
            and d_stats <= 1e-6):
        raise AssertionError(f"ZeRO-1 at world size 1 vs the plain step: losses {l_zero} vs "
                             f"{l_plain}, parameters max|d| {d_params}, BN {d_stats}")
    return {"backend": mesh.backend, "steps": TP_ZERO_STEPS, "losses": l_zero,
            "plain_losses": l_plain, "params_max_abs_diff": d_params,
            "bn_max_abs_diff": d_stats}


def _state_bytes(optimizer) -> int:
    return sum(v.numel() * v.element_size() for st in optimizer.state.values()
               for v in st.values() if isinstance(v, torch.Tensor) and v.dim())


def _counting(axis, log) -> None:
    """Count and time (host clock) every collective of a mesh axis: under
    gloo a card's tensors are staged through the host, and the call
    returns when they are back."""
    for name in ("all_reduce_", "all_gather"):
        fn = getattr(axis, name)

        def wrapped(*args, _fn=fn, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            log.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(axis, name, wrapped)


def tp_rank() -> None:
    """One rank of phase tp's 2-rank run (``python3 -c "import chip_smoke;
    chip_smoke.tp_rank()"`` under launch_ranks' variables): ZeRO-1 and DP
    on the flagship, then tensor parallelism 1×2; results to
    TP_ROOT/rank<r>.json.  The device and sizes come from
    TP_ROOT/spec.json, written by the parent."""
    sys.path.insert(0, REPO)
    with open(os.path.join(TP_ROOT, "spec.json")) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.kernels import iou
    from yolodl_torch.loss import non_max_suppression
    from yolodl_torch.models import YoloModel
    from yolodl_torch.parallel import (gather_train_state, init_process_group,
                                       make_dp_train_step, make_tp_infer, make_tp_mesh,
                                       make_tp_train_step, make_zero_train_step,
                                       place_tp_state, place_zero_state, replicate_state,
                                       shard_batch, shard_batch_tp, tp_shardings, zero_init)
    from yolodl_torch.parallel.mesh import destroy_process_group, reduce_scatter_route
    from yolodl_torch.parallel.zero import FlatShard
    from yolodl_torch.train import TrainConfig, make_train_step, train_init
    from yolodl_torch.train.lr_schedule import LrScheduleConfig

    mesh = init_process_group(spec["device"])
    device, on_card = mesh.device, mesh.device.type == "cuda"
    darknet = dk.Darknet.load(CFG)

    def flagship():
        return YoloModel(graph_from_darknet(darknet), device=device,
                         generator=torch.Generator().manual_seed(0))

    out = {"rank": mesh.rank, "backend": mesh.backend, "reason": mesh.reason,
           "reduce_scatter_route": reduce_scatter_route(mesh.backend)}

    # ZeRO-1 against DP, the flagship at 8 rows a rank, bf16
    images, boxes, classes, mask = shard_batch(
        mesh, synthetic_batch(spec["batch"], spec["image_size"]))
    batch = (torch.from_numpy(images).to(torch.bfloat16).to(device),
             *(torch.from_numpy(a).to(device) for a in (boxes, classes, mask)))
    for name in ("zero", "dp"):
        model = flagship()
        if name == "zero":
            ts, opt = zero_init(model, TrainConfig(), mesh)
            ts = place_zero_state(mesh, ts)
            step = make_zero_train_step(model, opt, TrainConfig(), mesh)
        else:
            ts, opt = train_init(model, TrainConfig())
            ts = replicate_state(mesh, ts)
            step = make_dp_train_step(model, opt, TrainConfig(), mesh)
        metrics, step_ms = [], []
        for i in range(1 + TP_RANK_TIMED):
            ms = timed_ms(lambda: metrics.append(step(ts, *batch)[1]), device)
            if i:
                step_ms.append(ms)
        out[name] = {"losses": [float(m["total_loss"]) for m in metrics], "step_ms": step_ms,
                     "num_matched": int(metrics[-1]["num_matched"]),
                     "digest": param_digest(model), "optimizer_state_bytes": _state_bytes(opt)}
        if name == "zero":
            shard = FlatShard(model, mesh, opt.param_groups[0]["params"][0])
            flat = torch.ones(shard.padded, dtype=torch.float32, device=device)
            part = torch.ones(shard.per_shard, dtype=torch.float32, device=device)
            out[name].update(
                padded=shard.padded, per_shard=shard.per_shard,
                reduce_scatter_ms=statistics.median(
                    [timed_ms(lambda: mesh.reduce_scatter(flat), device) for _ in range(6)][1:]),
                all_gather_ms=statistics.median(
                    [timed_ms(lambda: mesh.all_gather(part), device) for _ in range(6)][1:]))
        del model, opt, ts, step
        if on_card:
            torch.cuda.empty_cache()

    # tensor parallelism 1×2: one f32 SGD step against rank 0's single process
    sgd = TrainConfig(optimizer="sgd", lr=LrScheduleConfig(kind="constant", lr=1e-2))
    global_batch = synthetic_batch(spec["tp_batch"], spec["image_size"], seed=4)
    ref = None
    if mesh.rank == 0:  # rank 1 waits in make_tp_mesh meanwhile
        ref = {}
        for name, nudge in (("single", False), ("control", True)):
            model = flagship()
            ts, opt = train_init(model, sgd)
            t_batch = [torch.from_numpy(a).to(device) for a in global_batch]
            if nudge:  # the same step on images 1 ulp up: rounding alone
                t_batch[0] = torch.nextafter(t_batch[0], torch.tensor(float("inf"), device=device))
            _, m = make_train_step(model, opt, sgd)(ts, *t_batch)
            ref[name] = {
                "loss": float(m["total_loss"]),
                "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                "grad": {k: opt.state[p]["momentum_buffer"].detach().cpu().clone()
                         for k, p in model.named_parameters()},
                "bytes": sum(v.numel() * v.element_size() for v in model.parameters())
                + _state_bytes(opt)}
            del model, opt, ts, t_batch
            if on_card:
                torch.cuda.empty_cache()
    tp = make_tp_mesh(1, 2)
    log = []
    _counting(tp.model, log)
    _counting(tp.data, log)
    model = flagship()
    plan = tp_shardings(tp, model)
    ts, opt = train_init(model, sgd)
    ts = place_tp_state(tp, ts)
    rows = shard_batch_tp(tp, [torch.from_numpy(a).to(device) for a in global_batch])
    _, m = make_tp_train_step(model, opt, sgd, tp)(ts, *rows)
    tp_out = {"sharded_leaves": sum(v is not None for v in plan.values()),
              "leaves": len(plan), "loss": float(m["total_loss"]),
              "param_moment_bytes": sum(v.numel() * v.element_size()
                                        for v in model.parameters()) + _state_bytes(opt)}
    full = gather_train_state(tp, ts, sgd)
    if full is not None:
        def errors(state, grad, single):
            """max|d| / max|ref| of every tensor and gradient against ``single``."""
            out = {}
            for prefix, tensors, refs in (("", state, single["state"]),
                                          ("grad/", grad, single["grad"])):
                for k, v in tensors.items():
                    r = refs[k]
                    out[prefix + k] = float((v.cpu() - r).abs().max()) / max(
                        float(r.abs().max()), 1e-30)
            return out

        mine = errors(full.model.state_dict(),
                      {k: full.optimizer.state[p]["momentum_buffer"]
                       for k, p in full.model.named_parameters()}, ref["single"])
        control = errors(ref["control"]["state"], ref["control"]["grad"], ref["single"])
        worst, c_worst = max(mine, key=mine.get), max(control, key=control.get)
        tp_out.update(single_loss=ref["single"]["loss"], control_loss=ref["control"]["loss"],
                      single_bytes=ref["single"]["bytes"], tensors=len(mine),
                      err_of_max=mine[worst], worst=worst,
                      control_err_of_max=control[c_worst], control_worst=c_worst,
                      within_tol=sum(e <= TP_F32_TOL for e in mine.values()),
                      control_within_tol=sum(e <= TP_F32_TOL for e in control.values()))
    # make_tp_infer (f32) against the unsharded forward of the same weights
    pred = make_tp_infer(model, tp)(rows[0][:1])
    if full is not None:
        with torch.no_grad():
            whole = full.model(rows[0][:1])
        tp_out["infer_err_of_max"] = float((pred.cycxhw - whole.cycxhw).abs().max()) / float(
            whole.cycxhw.abs().max())
        for fn in (iou.nms_conflict_bits, iou.nms_keep_from_bits):
            fn.launches = 0
        nms = non_max_suppression(pred, iou_threshold=NMS_IOU, class_mode="argmax")
        if on_card:
            torch.cuda.synchronize()
        tp_out["nms_launches"] = {fn.__name__: fn.launches
                                  for fn in (iou.nms_conflict_bits, iou.nms_keep_from_bits)}
        tp_out["nms_kept"] = int(nms.valid.sum())
        del full, whole
    # the bf16 step (default TrainConfig()), one warm-up and TP_TIMED timed
    ts, opt = train_init(model, TrainConfig())
    step = make_tp_train_step(model, opt, TrainConfig(), tp)
    bf16 = (rows[0].to(torch.bfloat16), *rows[1:])
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    step_ms, counts, host_ms, losses = [], [], [], []
    for i in range(1 + TP_TIMED):
        log.clear()
        ms = timed_ms(lambda: losses.append(float(step(ts, *bf16)[1]["total_loss"])), device)
        if i:
            step_ms.append(ms)
            counts.append(len(log))
            host_ms.append(sum(log))
    tp_out.update(bf16_losses=losses, bf16_step_ms=step_ms, collectives_per_step=counts,
                  collective_host_ms_per_step=host_ms,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None)
    out["tp"] = tp_out
    with open(os.path.join(TP_ROOT, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    destroy_process_group()


def tp_two_ranks() -> dict:
    """ZeRO-1 and TP 1×2 on two ranks sharing one card over gloo; checks."""
    from yolodl_torch.parallel.mesh import launch_ranks

    write_json(os.path.join(TP_ROOT, "spec.json"), {
        "device": f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE, "image_size": IMAGE_SIZE,
        "batch": TRAIN_BATCH, "tp_batch": TP_BATCH})
    t0 = time.perf_counter()
    launch_ranks([sys.executable, "-c", "import chip_smoke; chip_smoke.tp_rank()"], 2,
                 env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=TP_TIMEOUT)
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(TP_ROOT, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0, r1 = ranks
    want = "ranks share cuda:0" if DEVICE == "cuda" else "ranks run on the CPU"
    if r0["backend"] != "gloo" or r0["reason"] != want:
        raise AssertionError(f"2 ranks on one card: {r0['backend']} ({r0['reason']})")
    z, dp = r0["zero"], r0["dp"]
    if z["digest"] != r1["zero"]["digest"] or z["losses"] != r1["zero"]["losses"]:
        raise AssertionError("the two ZeRO-1 ranks differ")
    if not np.allclose(z["losses"], dp["losses"], rtol=1e-5, atol=0) or \
            z["num_matched"] != dp["num_matched"]:
        raise AssertionError(f"ZeRO-1 losses {z['losses']} vs DP {dp['losses']}")
    t = r0["tp"]
    if not abs(t["loss"] - t["single_loss"]) <= 1e-4 * abs(t["single_loss"]):
        raise AssertionError(f"TP 1x2 f32 loss {t['loss']} vs single {t['single_loss']}")
    bound = max(TP_F32_TOL, TP_CONTROL_FACTOR * t["control_err_of_max"])
    if not t["err_of_max"] <= bound:
        raise AssertionError(f"TP 1x2 f32: {t['err_of_max']} of max at {t['worst']} > {bound} "
                             f"(the 1-ulp control: {t['control_err_of_max']})")
    if not t["infer_err_of_max"] <= TP_F32_TOL:
        raise AssertionError(f"make_tp_infer vs unsharded: {t['infer_err_of_max']} of max")
    if DEVICE == "cuda" and set(t["nms_launches"].values()) != {1}:
        raise AssertionError(f"NMS after make_tp_infer: launches {t['nms_launches']}")
    if not all(np.isfinite(t["bf16_losses"])):
        raise AssertionError(f"TP bf16 losses {t['bf16_losses']}")
    return {"backend": r0["backend"], "reason": r0["reason"],
            "zero": {**z, "route": r0["reduce_scatter_route"],
                     "rank1_step_ms": r1["zero"]["step_ms"], "params_bit_identical": True,
                     "dp_losses": dp["losses"], "dp_step_ms": dp["step_ms"],
                     "dp_optimizer_state_bytes": dp["optimizer_state_bytes"]},
            "tp_1x2": {**t, "rank1_param_moment_bytes": r1["tp"]["param_moment_bytes"],
                       "rank1_bf16_step_ms": r1["tp"]["bf16_step_ms"]},
            "wall_s": wall_s}


def tp_train_main_rank(root=TP_ROOT) -> None:
    """One rank of a train_main run of phase tp or pp: B1's counters zeroed,
    the CLI's main with ``root``/train_main.json's argv, then the counters
    and the rank's stdout to ``root``/train_main.r<rank>.json."""
    import contextlib

    sys.path.insert(0, REPO)
    from yolodl_torch.cli import train_main
    from yolodl_torch.kernels import iou

    with open(os.path.join(root, "train_main.json")) as f:
        argv = json.load(f)
    kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)
    for fn in kernels:
        fn.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_main.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    write_json(os.path.join(root, f"train_main.r{os.environ['RANK']}.json"),
               {"launches": {fn.__name__: fn.launches for fn in kernels},
                "stdout": buf.getvalue()})
    # leave as cli/_guard.py's run leaves a rank: the data threads may be
    # inside native code, which the interpreter's teardown would abort
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def tp_train_main(name, training, expect, root=TP_ROOT) -> tuple:
    """train_main MultiDevice [cuda:0, cuda:0] with ``training`` on the toy
    workspace under ``root``/``name``, 3 steps, an evaluation at step 3 →
    (summary, rank 0's B1 launches, the last checkpoint)."""
    import glob

    from yolodl_torch.bridge import params_from_jax
    from yolodl_torch.graph import Graph
    from yolodl_torch.models import YoloModel
    from yolodl_torch.parallel.mesh import launch_ranks
    from yolodl_torch.train.checkpoint import load_checkpoint

    workspace = os.path.join(root, name)
    config = dp_workspace(workspace)
    with open(config) as f:
        raw = json.load(f)
    raw["training"].update(training)
    raw["evaluation"] = {"interval": TP_TRAIN_MAIN_STEPS, "batch_size": TP_EVAL_BATCH}
    write_json(config, raw)
    write_json(os.path.join(root, "train_main.json"),
               ["--config-file", config, "--max-steps", str(TP_TRAIN_MAIN_STEPS),
                *CLI_DEVICE_ARGS])
    t0 = time.perf_counter()
    code = launch_ranks(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.tp_train_main_rank({root!r})"],
        2, env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=TP_TIMEOUT)
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"train_main.r{r}.json")) as f:
            ranks.append(json.load(f))
    if expect not in ranks[0]["stdout"]:
        raise AssertionError(f"{name}: no {expect!r} line:\n{ranks[0]['stdout'][-2000:]}")
    logs = os.path.join(workspace, "logs")
    chief = sorted(glob.glob(os.path.join(logs, "*[0-9]", "checkpoints", "*.ckpt")))
    others = glob.glob(os.path.join(logs, "*-r1", "checkpoints", "*.ckpt"))
    if len(chief) != TP_TRAIN_MAIN_STEPS or others:
        raise AssertionError(f"{name}: checkpoints rank 0 {len(chief)}, rank 1 {len(others)}")
    model = YoloModel(Graph.load_newslab_v1_json(os.path.join(workspace, "model.json5")),
                      device=DEVICE)
    from yolodl_torch.bridge import params_to_jax

    params_t, state_t = params_to_jax(model.state_dict())
    params, state, _, meta = load_checkpoint(chief[-1], params_t, state_t)
    params_from_jax(params, state, model=model)
    with torch.no_grad():
        pred = model(torch.zeros((1, 3, 32, 32), device=DEVICE))
    if meta["step"] != TP_TRAIN_MAIN_STEPS or not bool(torch.isfinite(pred.cycxhw).all()):
        raise AssertionError(f"{name}: the last checkpoint (step {meta['step']}) in a "
                             "single-device model")
    batches = -(-8 // TP_EVAL_BATCH)  # dp_workspace's 8 images
    launches = ranks[0]["launches"]
    if DEVICE == "cuda" and (set(launches.values()) != {batches}
                             or set(ranks[1]["launches"].values()) != {0}):
        raise AssertionError(f"{name}: B1 launches {launches} (rank 1 "
                             f"{ranks[1]['launches']}), want {batches} = evaluation batches")
    return ({"exit_code": code, "steps": TP_TRAIN_MAIN_STEPS, "rank0_checkpoints": len(chief),
             "rank1_checkpoints": 0, "evaluation_batches": batches, "launches": launches,
             "wall_s": wall_s}, launches, chief[-1])


def phase_tp() -> dict:
    """ZeRO-1 and tensor parallelism (ROADMAP A14b)."""
    import shutil

    from yolodl_torch.config import darknet_cfg as dk

    t0 = time.perf_counter()
    shutil.rmtree(TP_ROOT, ignore_errors=True)
    os.makedirs(TP_ROOT)
    try:
        world_one = zero_world_one(dk.Darknet.load(CFG))
        two_ranks = tp_two_ranks()
        tp_cli, tp_launches, _ = tp_train_main(
            "tensor_parallel", {"tensor_parallel": 2}, "mesh: data=1 x model=2 (tensor parallel)")
        zero_cli, zero_launches, _ = tp_train_main(
            "zero_optimizer", {"zero_optimizer": True},
            "zero: optimizer state over 2 ranks, reduce-scatter by ")
    finally:
        shutil.rmtree(TP_ROOT, ignore_errors=True)
    emit({"phase": "tp", "model": "yolov4-csp", "image_size": IMAGE_SIZE,
          "zero_world_size_1": world_one, "two_ranks_one_card": two_ranks,
          "train_main_tensor_parallel": tp_cli, "train_main_zero_optimizer": zero_cli,
          "seconds": time.perf_counter() - t0, "card": card_line()})
    return {"tp_infer_nms": two_ranks["tp_1x2"]["nms_launches"],
            "tp_train_main_eval": tp_launches, "zero_train_main_eval": zero_launches}


def pp_rank() -> None:
    """One rank of phase pp's 2-rank run (``python3 -c "import chip_smoke;
    chip_smoke.pp_rank()"`` under launch_ranks' variables): rank 0 first
    takes the single-process accumulation steps alone, then both ranks the
    same steps as a 2-stage pipeline; results to PP_ROOT/rank<r>.json.  The
    device and sizes come from PP_ROOT/spec.json, written by the parent."""
    sys.path.insert(0, REPO)
    with open(os.path.join(PP_ROOT, "spec.json")) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    from yolodl_torch.bridge import params_to_jax
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.models import YoloModel
    from yolodl_torch.parallel import (PipelineModel, PipelineTrainStep, init_process_group,
                                       make_pp_mesh)
    from yolodl_torch.parallel import pipeline
    from yolodl_torch.parallel.mesh import destroy_process_group
    from yolodl_torch.train import TrainConfig, make_train_step, train_init
    from yolodl_torch.train.lr_schedule import LrScheduleConfig

    world = init_process_group(spec["device"])
    device, on_card = world.device, world.device.type == "cuda"
    darknet = dk.Darknet.load(CFG)

    def flagship():
        return YoloModel(graph_from_darknet(darknet), device=device,
                         generator=torch.Generator().manual_seed(0))

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    def fresh():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: np.asarray(v)})
        return out

    out = {"rank": world.rank, "backend": world.backend, "reason": world.reason}
    sgd = TrainConfig(optimizer="sgd", lr=LrScheduleConfig(kind="constant", lr=1e-2))
    bf16 = TrainConfig(compute_dtype="bfloat16")
    batch = [torch.from_numpy(a).to(device)
             for a in synthetic_batch(spec["batch"], spec["image_size"], seed=6)]
    ref = {}
    if world.rank == 0:  # rank 1 waits in make_pp_mesh meanwhile
        for name, nudge in (("single", False), ("control", True)):
            fresh()
            model = flagship()
            ts, opt = train_init(model, sgd)
            t_batch = list(batch)
            if nudge:  # the same step on images 1 ulp up: rounding alone
                t_batch[0] = torch.nextafter(t_batch[0], torch.tensor(float("inf"), device=device))
            _, m = make_train_step(model, opt, sgd, accum=PP_ACCUM)(ts, *t_batch)
            params, state = params_to_jax(model.state_dict())
            ref[name] = {"loss": float(m["total_loss"]), "tensors": flat({**params, **{
                f"state/{k}": v for k, v in state.items()}}), "peak_gb": peak_gb()}
            del model, opt, ts, t_batch
        fresh()
        model = flagship()
        ts, opt = train_init(model, bf16)
        step = make_train_step(model, opt, bf16, accum=PP_ACCUM)
        step_ms = [timed_ms(lambda: step(ts, *batch), device) for _ in range(1 + PP_TIMED)][1:]
        out["single_bf16"] = {"step_ms": step_ms, "peak_gb": peak_gb()}
        del model, opt, ts, step
    mesh = make_pp_mesh(2, 1)

    def pipeline_step(config):
        pp = PipelineModel(flagship(), mesh)
        step = PipelineTrainStep(pp, config, PP_ACCUM)
        ts = step.init_opt()
        rows = batch if mesh.stage == 0 else [
            torch.empty(t.shape, dtype=t.dtype, device="meta") for t in batch]
        return pp, ts, step.step_fn(), rows

    # the f32 SGD step against rank 0's single process
    fresh()
    pp, ts, step, rows = pipeline_step(sgd)
    ts, m = step(ts, *rows)
    trees = ts.merged(pp, sgd)
    out["f32"] = {"stage_keys": [len(p.keys) for p in pp.stages],
                  "boundary": [pp.model._pname[k] for k in pp.stages[1].in_keys],
                  "peak_gb": peak_gb(), "loss": float(m["total_loss"])}
    if trees is not None:
        params, state = trees[0], trees[1]
        mine = flat({**params, **{f"state/{k}": v for k, v in state.items()}})

        def errors(tensors):
            r = ref["single"]["tensors"]
            return {k: float(np.abs(tensors[k] - r[k]).max()) / max(float(np.abs(r[k]).max()),
                                                                     1e-30) for k in r}

        got, control = errors(mine), errors(ref["control"]["tensors"])
        worst, c_worst = max(got, key=got.get), max(control, key=control.get)
        out["f32"].update(
            single_loss=ref["single"]["loss"], control_loss=ref["control"]["loss"],
            single_peak_gb=ref["single"]["peak_gb"], tensors=len(got), worst=worst,
            err_of_max=got[worst], max_abs_err=float(np.abs(
                mine[worst] - ref["single"]["tensors"][worst]).max()),
            control_worst=c_worst, control_err_of_max=control[c_worst],
            bit_identical=sum(e == 0 for e in got.values()))
    del pp, ts, step, rows, trees

    # the bf16 step timed, with the share of its host-staged transfers
    log = []

    def timing(fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            log.append((time.perf_counter() - t0) * 1e3)
            return result
        return wrapped

    saved = pipeline.send_tensors, pipeline.recv_tensors
    pipeline.send_tensors, pipeline.recv_tensors = map(timing, saved)
    try:
        fresh()
        pp, ts, step, rows = pipeline_step(bf16)
        step_ms, p2p_ms, calls, losses = [], [], [], []
        for i in range(1 + PP_TIMED):
            log.clear()
            ms = timed_ms(lambda: losses.append(float(step(ts, *rows)[1]["total_loss"])),
                          device)
            if i:
                step_ms.append(ms)
                p2p_ms.append(sum(log))
                calls.append(len(log))
    finally:
        pipeline.send_tensors, pipeline.recv_tensors = saved
    specs = pp.specs(pp.stages[1].in_keys, spec["batch"] // PP_ACCUM, spec["image_size"],
                     spec["image_size"], torch.bfloat16)
    out["bf16"] = {"step_ms": step_ms, "p2p_host_ms": p2p_ms, "p2p_calls": calls,
                   "losses": losses, "peak_gb": peak_gb(),
                   "boundary_mb_per_micro_batch": sum(
                       int(np.prod(shape)) * 2 for shape, _ in specs) / 1e6,
                   "stage_parameters": sum(p.numel() for p in pp.model.parameters())}
    with open(os.path.join(PP_ROOT, f"rank{world.rank}.json"), "w") as f:
        json.dump(out, f)
    destroy_process_group()


def pp_two_ranks() -> dict:
    """The flagship as a 2-stage pipeline on two ranks sharing one card over
    gloo; checks."""
    from yolodl_torch.parallel.mesh import launch_ranks

    write_json(os.path.join(PP_ROOT, "spec.json"), {
        "device": f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE, "image_size": IMAGE_SIZE,
        "batch": TRAIN_BATCH})
    t0 = time.perf_counter()
    launch_ranks([sys.executable, "-c", "import chip_smoke; chip_smoke.pp_rank()"], 2,
                 env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=PP_TIMEOUT)
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(PP_ROOT, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0, r1 = ranks
    want = "ranks share cuda:0" if DEVICE == "cuda" else "ranks run on the CPU"
    if r0["backend"] != "gloo" or r0["reason"] != want:
        raise AssertionError(f"2 ranks on one card: {r0['backend']} ({r0['reason']})")
    f32 = r0["f32"]
    if not abs(f32["loss"] - f32["single_loss"]) <= 1e-5 * abs(f32["single_loss"]) or \
            f32["loss"] != r1["f32"]["loss"]:
        raise AssertionError(f"pipeline f32 loss {f32['loss']} (last stage "
                             f"{r1['f32']['loss']}) vs single {f32['single_loss']}")
    # the same arithmetic in another order of processes: held at
    # PP_F32_TOL alone; the control is printed, not used
    if not f32["err_of_max"] <= PP_F32_TOL:
        raise AssertionError(f"pipeline f32: {f32['err_of_max']} of max at {f32['worst']} > "
                             f"{PP_F32_TOL} (the 1-ulp control, printed only: "
                             f"{f32['control_err_of_max']})")
    if not all(np.isfinite(r0["bf16"]["losses"])) or r0["bf16"]["losses"] != r1["bf16"]["losses"]:
        raise AssertionError(f"pipeline bf16 losses {r0['bf16']['losses']} "
                             f"(last stage {r1['bf16']['losses']})")
    return {"backend": r0["backend"], "reason": r0["reason"], "f32": f32,
            "single_bf16": r0["single_bf16"],
            "bf16": {"rank0": r0["bf16"], "rank1": r1["bf16"]},
            "peak_gb": {"single_f32": f32["single_peak_gb"], "rank0_f32": f32["peak_gb"],
                        "rank1_f32": r1["f32"]["peak_gb"],
                        "single_bf16": r0["single_bf16"]["peak_gb"],
                        "rank0_bf16": r0["bf16"]["peak_gb"], "rank1_bf16": r1["bf16"]["peak_gb"]},
            "wall_s": wall_s}


def pp_detect_main(workspace, ckpt) -> dict:
    """detect_main on the toy workspace's model from the pipeline run's last
    checkpoint, over its 8 images: one launch of each B1 kernel a batch."""
    from yolodl_torch.cli import detect_main
    from yolodl_torch.kernels import iou

    out_dir = os.path.join(workspace, "detect_out")
    config = write_json(os.path.join(workspace, "detect.json5"), {
        "version": "0.1.0",
        "model": {"kind": "NewslabV1", "cfg_file": os.path.join(workspace, "model.json5"),
                  "minibatch_size": TP_EVAL_BATCH, "devices": ["cuda:0"]},
        "input": {"kind": {"type": "Csv", "image_size": 32, "input_channels": 3,
                           "image_dir": os.path.join(workspace, "images"),
                           "label_file": os.path.join(workspace, "label.csv"),
                           "classes_file": os.path.join(workspace, "classes.txt")}},
        "preprocess": {"out_of_bound_tolerance": 1.0},
        "output": {"output_dir": out_dir, "nms_iou_thresh": NMS_IOU,
                   "nms_conf_thresh": CLI_CONF}})
    kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    quiet(detect_main.main, ["--config-file", config, "--checkpoint", ckpt, *CLI_DEVICE_ARGS])
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    batches = -(-8 // TP_EVAL_BATCH)  # dp_workspace's 8 images
    drawn = len(os.listdir(out_dir))
    if (DEVICE == "cuda" and set(launches.values()) != {batches}) or drawn != 8:
        raise AssertionError(f"detect_main on the pipeline checkpoint: launches {launches}, "
                             f"{drawn} images, {batches} batches")
    return {"images": drawn, "batches": batches, "launches": launches, "seconds": seconds}


def phase_pp() -> dict:
    """GPipe pipeline parallelism (ROADMAP A14c)."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(PP_ROOT, ignore_errors=True)
    os.makedirs(PP_ROOT)
    try:
        two_ranks = pp_two_ranks()
        cli, cli_launches, ckpt = tp_train_main(
            "pipeline_parallel", {"pipeline_parallel": 2, "accumulation_steps": PP_ACCUM},
            f"pipeline: 2 stages (2 nodes, 4 nodes) x dp=1, {PP_ACCUM} microbatches/step",
            root=PP_ROOT)
        detect = pp_detect_main(os.path.join(PP_ROOT, "pipeline_parallel"), ckpt)
    finally:
        shutil.rmtree(PP_ROOT, ignore_errors=True)
    emit({"phase": "pp", "model": "yolov4-csp", "image_size": IMAGE_SIZE, "batch": TRAIN_BATCH,
          "micro_batches": PP_ACCUM, "two_ranks_one_card": two_ranks,
          "train_main_pipeline_parallel": cli, "detect_main_on_its_checkpoint": detect,
          "seconds": time.perf_counter() - t0, "card": card_line()})
    return {"pp_train_main_eval": cli_launches, "pp_detect_main": detect["launches"]}


def bn_digest(model) -> str:
    """sha256 over every BN running statistic's bytes, in state_dict order."""
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        if k.endswith((".mean", ".var")):
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def timed_row_gathers(log):
    """Time (host clock) each forward and backward of the recurrent nodes'
    row gather (``parallel/mesh.py`` ``gather_rows_summed``): under gloo a
    card's rows are staged through the host, and the call returns when
    they are back."""
    from yolodl_torch.parallel import mesh

    cls = mesh._GatherRowsSummed
    saved = cls.__dict__["forward"], cls.__dict__["backward"]

    def timing(fn):
        def wrapped(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            log.append((time.perf_counter() - t0) * 1e3)
            return out
        return staticmethod(wrapped)

    cls.forward, cls.backward = timing(saved[0].__func__), timing(saved[1].__func__)
    try:
        yield
    finally:
        cls.forward, cls.backward = saved


def step_tensors(state, grads) -> dict:
    """A step's outcome as phase tp compares it: every state_dict tensor
    after the step and every parameter's gradient (SGD's momentum buffer
    after one step), on the host."""
    out = {k: v.detach().cpu() for k, v in state.items()}
    out.update({f"grad/{k}": v.detach().cpu() for k, v in grads.items()})
    return out


def of_max_errors(tensors, ref) -> dict:
    """max|d| / max|ref| of every tensor of ``ref``."""
    return {k: float((tensors[k].to(torch.float64) - r.to(torch.float64)).abs().max())
            / max(float(r.abs().max()), 1e-30) for k, r in ref.items()}


def rp_rank() -> None:
    """One rank of phase recurrent_parallel's 4-rank run (``python3 -c
    "import chip_smoke; chip_smoke.rp_rank()"`` under launch_ranks'
    variables): rank 0 first takes the single-process steps alone (f32 SGD
    and its 1-ulp control, bf16 timed), then all four ranks the same steps
    under tensor parallelism 2×2 and as a pipeline of 2 stages × dp 2;
    results to RP_ROOT/rank<r>.json.  The device and sizes come from
    RP_ROOT/spec.json, written by the parent."""
    sys.path.insert(0, REPO)
    with open(os.path.join(RP_ROOT, "spec.json")) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    from yolodl_torch.bridge import params_from_jax
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.kernels import iou
    from yolodl_torch.loss import non_max_suppression
    from yolodl_torch.models import YoloModel
    from yolodl_torch.parallel import (PipelineModel, PipelineTrainStep, gather_train_state,
                                       init_process_group, make_pp_mesh, make_tp_infer,
                                       make_tp_mesh, make_tp_train_step, place_tp_state,
                                       shard_batch_tp, tp_shardings)
    from yolodl_torch.parallel.mesh import destroy_process_group
    from yolodl_torch.parallel.tp import _RECURRENT
    from yolodl_torch.train import TrainConfig, make_train_step, train_init
    from yolodl_torch.train.loop import _optax_layout
    from yolodl_torch.train.lr_schedule import LrScheduleConfig

    world = init_process_group(spec["device"])
    device, on_card = world.device, world.device.type == "cuda"
    darknet = dk.Darknet.load(OCCLUSION_CFG)
    size, rows = spec["image_size"], spec["rows"]

    def model_fn():
        return YoloModel(graph_from_darknet(darknet), device=device,
                         generator=torch.Generator().manual_seed(0))

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    def fresh():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def batch_of(n, seed):  # the cfg has one class
        images, boxes, classes, mask = synthetic_batch(n, size, seed)
        return [torch.from_numpy(a).to(device)
                for a in (images, boxes, np.zeros_like(classes), mask)]

    sgd = TrainConfig(optimizer="sgd", lr=LrScheduleConfig(kind="constant", lr=1e-2))
    bf16 = TrainConfig(compute_dtype="bfloat16")
    batches = {"tp": (batch_of(rows, 8), 1), "pp": (batch_of(rows * spec["accum"], 9),
                                                     spec["accum"])}
    out = {"rank": world.rank, "backend": world.backend, "reason": world.reason}
    ref = {}
    if world.rank == 0:  # the other ranks wait in make_tp_mesh meanwhile
        for mode, (batch, accum) in batches.items():
            for name, nudge in (("single", False), ("control", True)):
                fresh()
                model = model_fn()
                ts, opt = train_init(model, sgd)
                b = list(batch)
                if nudge:  # the same step on images 1 ulp up: rounding alone
                    b[0] = torch.nextafter(b[0], torch.tensor(float("inf"), device=device))
                _, m = make_train_step(model, opt, sgd, accum=accum)(ts, *b)
                ref[mode, name] = {
                    "loss": float(m["total_loss"]), "peak_gb": peak_gb(),
                    "tensors": step_tensors(model.state_dict(), {
                        k: opt.state[p]["momentum_buffer"]
                        for k, p in model.named_parameters()})}
                if mode == "tp" and not nudge:  # rank 0 holds the first half of the rows
                    with torch.no_grad():
                        ref["infer"] = model(batch[0]).cycxhw[:rows // 2].cpu()
                del model, opt, ts, b
            fresh()
            model = model_fn()
            ts, opt = train_init(model, bf16)
            step = make_train_step(model, opt, bf16, accum=accum)
            out[f"{mode}_single_bf16"] = {
                "step_ms": [timed_ms(lambda: step(ts, *batch), device)
                            for _ in range(1 + spec["timed"])][1:], "peak_gb": peak_gb()}
            del model, opt, ts, step

    def checked(mode, loss, tensors):
        """The f32 step's loss and every tensor and gradient on rank 0
        against the single process's, beside its 1-ulp control's: phase
        tp's rule, each within max(RP_F32_TOL, RP_CONTROL_FACTOR × the
        control's worst) of its max."""
        single, control = ref[mode, "single"], ref[mode, "control"]
        got = of_max_errors(tensors, single["tensors"])
        ctl = of_max_errors(control["tensors"], single["tensors"])
        worst, c_worst = max(got, key=got.get), max(ctl, key=ctl.get)
        bound = max(RP_F32_TOL, RP_CONTROL_FACTOR * ctl[c_worst])
        return {"loss": loss, "single_loss": single["loss"], "control_loss": control["loss"],
                "tensors": len(got), "worst": worst, "err_of_max": got[worst],
                "control_worst": c_worst, "control_err_of_max": ctl[c_worst], "bound": bound,
                "over_bound": sorted(k for k in got if got[k] > bound),
                "worst_over_own_control": max(got[k] / max(RP_F32_TOL, ctl[k]) for k in got),
                "single_f32_peak_gb": single["peak_gb"]}

    def timed_steps(step, ts, batch):
        log, step_ms, gather_ms, gathers, losses = [], [], [], [], []
        fresh()
        with timed_row_gathers(log):
            for i in range(1 + spec["timed"]):
                log.clear()
                ms = timed_ms(lambda: losses.append(float(step(ts, *batch)[1].get(
                    "total_loss", float("nan")))), device)
                if i:
                    step_ms.append(ms)
                    gather_ms.append(sum(log))
                    gathers.append(len(log))
        return {"bf16_step_ms": step_ms, "gather_host_ms": gather_ms, "gathers": gathers,
                "bf16_losses": losses, "bf16_peak_gb": peak_gb()}

    # tensor parallelism 2×2: one f32 SGD step, make_tp_infer + NMS, bf16
    tp = make_tp_mesh(2, 2)
    batch, _ = batches["tp"]
    model = model_fn()
    plan = tp_shardings(tp, model)
    ts, opt = train_init(model, sgd)
    ts = place_tp_state(tp, ts)
    local = shard_batch_tp(tp, batch)
    fresh()
    _, m = make_tp_train_step(model, opt, sgd, tp)(ts, *local)
    tp_out = {"sharded_leaves": sum(v is not None for v in plan.values()), "leaves": len(plan),
              "f32_peak_gb": peak_gb(), "loss": float(m["total_loss"]),
              "bn_digest": bn_digest(model), "digest": param_digest(model)}
    full = gather_train_state(tp, ts, sgd)
    pred = make_tp_infer(model, tp)(local[0])
    if full is not None:
        tp_out.update(checked("tp", tp_out["loss"], step_tensors(full.model.state_dict(), {
            k: full.optimizer.state[p]["momentum_buffer"]
            for k, p in full.model.named_parameters()})))
        tp_out["infer_err_of_max"] = float((pred.cycxhw.cpu() - ref["infer"]).abs().max()) / \
            float(ref["infer"].abs().max())
        for fn in (iou.nms_conflict_bits, iou.nms_keep_from_bits):
            fn.launches = 0
        nms = non_max_suppression(pred, iou_threshold=NMS_IOU, class_mode="argmax")
        if on_card:
            torch.cuda.synchronize()
        tp_out["nms_launches"] = {fn.__name__: fn.launches
                                  for fn in (iou.nms_conflict_bits, iou.nms_keep_from_bits)}
        tp_out["nms_kept"] = int(nms.valid.sum())
        del full
    ts, opt = train_init(model, bf16)
    tp_out.update(timed_steps(make_tp_train_step(model, opt, bf16, tp), ts, local))
    out["tp"] = tp_out
    del model, opt, ts, pred

    # the pipeline, 2 stages x dp 2, 2 micro-batches: one f32 SGD step, bf16
    mesh = make_pp_mesh(2, 2)
    batch, accum = batches["pp"]
    local = shard_batch_tp(mesh, batch, accum)
    if mesh.stage:
        local = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in local]
    fresh()
    pp = PipelineModel(model_fn(), mesh)
    ts = PipelineTrainStep(pp, sgd, accum).init_opt()
    ts, m = PipelineTrainStep(pp, sgd, accum).step_fn()(ts, *local)
    pp_out = {"stage_nodes": [len(p.keys) for p in pp.stages],
              "boundary": [pp.model._pname[k] for k in pp.stages[1].in_keys],
              "recurrent_by_stage": [[pp.model._pname[k] for k in p.keys
                                      if isinstance(pp.model.graph.nodes[k].config, _RECURRENT)]
                                     for p in pp.stages],
              "f32_peak_gb": peak_gb(), "bn_digest": bn_digest(pp.model),
              "digest": param_digest(pp.model)}
    trees = ts.merged(pp, sgd)
    if trees is not None:
        whole = model_fn()
        params_from_jax(trees[0], trees[1], model=whole)
        moments = trees[2]
        for key in _optax_layout(sgd)[0].split("/"):
            moments = moments[key]
        pp_out.update(checked("pp", float(m["total_loss"]), step_tensors(
            whole.state_dict(), params_from_jax(moments[".trace"], {}))))
        del whole
    del pp, ts
    pp = PipelineModel(model_fn(), mesh)
    step = PipelineTrainStep(pp, bf16, accum)
    pp_out.update(timed_steps(step.step_fn(), step.init_opt(), local))
    out["pp"] = pp_out
    with open(os.path.join(RP_ROOT, f"rank{world.rank}.json"), "w") as f:
        json.dump(out, f)
    destroy_process_group()


def rp_four_ranks() -> dict:
    """TP 2×2 and the pipeline of 2 stages × dp 2 on four ranks sharing one
    card over gloo → (summary, the list of failed gates)."""
    from yolodl_torch.parallel.mesh import launch_ranks

    write_json(os.path.join(RP_ROOT, "spec.json"), {
        "device": f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE, "image_size": OCCLUSION_SIZE,
        "rows": RP_ROWS, "accum": RP_ACCUM, "timed": RP_TIMED})
    t0 = time.perf_counter()
    launch_ranks([sys.executable, "-c", "import chip_smoke; chip_smoke.rp_rank()"], 4,
                 env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=RP_TIMEOUT)
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(4):
        with open(os.path.join(RP_ROOT, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    failed = []
    want = "ranks share cuda:0" if DEVICE == "cuda" else "ranks run on the CPU"
    if r0["backend"] != "gloo" or r0["reason"] != want:
        failed.append(f"4 ranks on one card: {r0['backend']} ({r0['reason']})")
    # the ranks of one data group: TP's data ranks of one model index (r, r + 2),
    # the pipeline's of one stage (2s, 2s + 1)
    groups = {"tp": ((0, 2), (1, 3)), "pp": ((0, 1), (2, 3))}
    for mode in ("tp", "pp"):
        g = r0[mode]
        if not abs(g["loss"] - g["single_loss"]) <= RP_LOSS_TOL * abs(g["single_loss"]):
            failed.append(f"{mode} f32 loss {g['loss']} vs one process {g['single_loss']}")
        if g["over_bound"]:
            failed.append(f"{mode} f32: {len(g['over_bound'])} tensors over {g['bound']} of "
                          f"max, worst {g['worst']} {g['err_of_max']} (the 1-ulp control's "
                          f"worst: {g['control_worst']} {g['control_err_of_max']})")
        for a, b in groups[mode]:
            if ranks[a][mode]["bn_digest"] != ranks[b][mode]["bn_digest"]:
                failed.append(f"{mode}: BN running statistics differ between ranks {a} and {b}")
        losses = [x for r in ranks for x in r[mode]["bf16_losses"] if not np.isnan(x)]
        if not losses or not all(np.isfinite(losses)):
            failed.append(f"{mode} bf16 losses {losses}")
    t = r0["tp"]
    if not t["infer_err_of_max"] <= RP_F32_TOL:
        failed.append(f"make_tp_infer vs one process: {t['infer_err_of_max']} of max")
    if DEVICE == "cuda" and set(t["nms_launches"].values()) != {1}:
        failed.append(f"NMS after make_tp_infer: launches {t['nms_launches']}")
    summary = {"backend": r0["backend"], "reason": r0["reason"], "wall_s": wall_s}
    for mode in ("tp", "pp"):
        summary[mode] = {**r0[mode], "single_bf16": r0[f"{mode}_single_bf16"],
                         "ranks_bn_equal": [ranks[a][mode]["bn_digest"] == ranks[b][mode][
                             "bn_digest"] for a, b in groups[mode]],
                         "ranks_state_equal": [ranks[a][mode]["digest"] == ranks[b][mode][
                             "digest"] for a, b in groups[mode]],
                         "rank_peak_gb": [{"f32": r[mode]["f32_peak_gb"],
                                           "bf16": r[mode]["bf16_peak_gb"]} for r in ranks],
                         "rank_bf16_step_ms": [r[mode]["bf16_step_ms"] for r in ranks],
                         "rank_gather_host_ms": [r[mode]["gather_host_ms"] for r in ranks]}
        for key in ("bn_digest", "digest"):
            summary[mode].pop(key)
    return summary, failed


def phase_recurrent_parallel() -> dict:
    """Recurrent nodes under tensor and pipeline parallelism over several
    data ranks: yolov3-tiny_occlusion_track (two [crnn] with BN, its
    time_steps 20) at 416², a global micro-batch of RP_ROWS rows (2
    sequences), seed-0 weights; TP 2×2 and the pipeline of 2 stages × dp 2
    (RP_ACCUM micro-batches) on four ranks sharing the card.  Gates: the
    f32 step's loss within RP_LOSS_TOL of one process's, every tensor and
    gradient within max(RP_F32_TOL, RP_CONTROL_FACTOR × the 1-ulp
    control's worst) of max, the BN running statistics equal on all data
    ranks,
    make_tp_infer within RP_F32_TOL of one process's forward and one launch
    of each B1 kernel for its NMS, finite bf16 losses.  Every failed gate
    is printed in the phase line, then the phase raises."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(RP_ROOT, ignore_errors=True)
    os.makedirs(RP_ROOT)
    try:
        summary, failed = rp_four_ranks()
    finally:
        shutil.rmtree(RP_ROOT, ignore_errors=True)
    emit({"phase": "recurrent_parallel", "model": "yolov3-tiny_occlusion_track",
          "image_size": OCCLUSION_SIZE, "rows": RP_ROWS, "micro_batches": RP_ACCUM,
          **summary, "failed": failed, "seconds": time.perf_counter() - t0,
          "card": card_line()})
    if failed:
        raise AssertionError("phase recurrent_parallel: " + "; ".join(failed))
    return {"recurrent_tp_infer_nms": summary["tp"]["nms_launches"]}


def spatial_rank() -> None:
    """One rank of phase spatial's 2-rank run (``python3 -c "import
    chip_smoke; chip_smoke.spatial_rank()"`` under launch_ranks' variables):
    the height of yolov4-csp cut over a space mesh of 2, inference at each
    of SPATIAL_INFER's sizes and one train step on a 1 × 2 mesh, rank 0
    first taking the single-process forward and step alone; results to
    SPATIAL_ROOT/rank<r>.json.  The device comes from SPATIAL_ROOT/spec.json,
    written by the parent."""
    sys.path.insert(0, REPO)
    with open(os.path.join(SPATIAL_ROOT, "spec.json")) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    import dataclasses
    import hashlib

    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.kernels import iou
    from yolodl_torch.loss import non_max_suppression
    from yolodl_torch.models import YoloModel
    from yolodl_torch.parallel import init_process_group
    from yolodl_torch.parallel import mesh as mesh_mod
    from yolodl_torch.parallel.mesh import destroy_process_group
    from yolodl_torch.parallel.spatial_model import (make_data_space_mesh, make_spatial_infer,
                                                     make_spatial_train_step, plan_spatial_prefix,
                                                     shard_batch_2d)
    from yolodl_torch.train import TrainConfig, loop, make_train_step, train_init
    from yolodl_torch.train.lr_schedule import LrScheduleConfig

    world = init_process_group(spec["device"])
    device, on_card, chief = world.device, world.device.type == "cuda", world.rank == 0
    darknet = dk.Darknet.load(CFG)
    mesh = make_data_space_mesh(1, 2)

    def flagship(size):
        net = dataclasses.replace(darknet.net, width=size, height=size)
        model = YoloModel(graph_from_darknet(dataclasses.replace(darknet, net=net)),
                          device=device, generator=torch.Generator().manual_seed(0))
        randomize_bn(model, 0)
        return model

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def fresh():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    def rel(a, b) -> float:  # max|a - b| / max|b|
        return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()),
                                                                1e-30)

    # the host ms inside the transfers, by kind
    log = []

    def timing(kind, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            log.append((kind, (time.perf_counter() - t0) * 1e3))
            return result
        return wrapped

    saved = (mesh_mod.neighbour_exchange, mesh_mod.DataMesh.all_gather,
             mesh_mod.DataMesh.reduce_scatter, mesh_mod.DataMesh.all_reduce_)
    mesh_mod.neighbour_exchange = timing("halo", saved[0])
    mesh_mod.DataMesh.all_gather = timing("gather", saved[1])
    mesh_mod.DataMesh.reduce_scatter = timing("reduce_scatter", saved[2])
    mesh_mod.DataMesh.all_reduce_ = timing("all_reduce", saved[3])

    def transfers():
        kinds = collections.defaultdict(float)
        for kind, ms in log:
            kinds[kind] += ms
        return {"calls": len(log), "host_ms": sum(kinds.values()), "by_kind": dict(kinds)}

    def timed(fn, n):
        """ms of each of ``n`` calls after one warm-up, and the transfers'
        host ms of each."""
        ms, moved = [], []
        for i in range(1 + n):
            log.clear()
            t = timed_ms(fn, device)
            if i:
                ms.append(t)
                moved.append(transfers())
        return ms, moved

    def nms_diff(a, b) -> dict:
        """Entries of each field that differ, and the (instance, class)
        pairs kept by one and not the other, over the batch."""
        def kept(n, i):
            v = n.valid[i]
            return set(zip(n.instances[i][v].tolist(), n.classes[i][v].tolist()))
        return {**{f: int((getattr(a, f) != getattr(b, f)).sum())
                   for f in ("valid", "classes", "instances")},
                "kept_pairs_not_shared": sum(len(kept(a, i) ^ kept(b, i))
                                             for i in range(a.valid.shape[0]))}

    def digest(pred) -> str:
        h = hashlib.sha256()
        for f in ("cycxhw", "obj_logit", "class_logit"):
            h.update(getattr(pred, f).detach().cpu().numpy().tobytes())
        return h.hexdigest()

    nms_kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)
    out = {"rank": world.rank, "backend": world.backend, "reason": world.reason,
           "route": mesh.route, "infer": [], "nms_launches": {fn.__name__: 0 for fn in nms_kernels}}
    for size, batch in spec["infer"]:
        model = flagship(size)
        sharded, cut = plan_spatial_prefix(model, 2)
        infer = make_spatial_infer(model, mesh)
        x = torch.from_numpy(np.random.default_rng(size).uniform(
            0, 1, (batch, 3, size, size)).astype(np.float32)).to(device)
        line = {"size": size, "batch": batch, "sharded_nodes": len(sharded),
                "nodes": len(model.graph.order),
                "cut": {model._pname[k]: model.graph.nodes[k].output_shape.tensor_shape()[2].size
                        for k in cut}}
        pred = infer(x)  # f32
        if chief:
            with torch.no_grad():
                ref = model(x)
            line["f32_err_of_max"] = {f: rel(getattr(pred, f), getattr(ref, f))
                                      for f in ("cycxhw", "obj_logit", "class_logit")}
            for fn in nms_kernels:
                fn.launches = 0
            kept = non_max_suppression(pred, iou_threshold=NMS_IOU, class_mode="argmax")
            sync()
            launches = {fn.__name__: fn.launches for fn in nms_kernels}
            for name, n in launches.items():
                out["nms_launches"][name] += n
            want = non_max_suppression(ref, iou_threshold=NMS_IOU, class_mode="argmax")
            # the same forward on images 1 ulp up: how far rounding alone
            # moves the outputs and the suppression (printed, not used)
            with torch.no_grad():
                nudged = model(torch.nextafter(x, torch.tensor(float("inf"), device=device)))
            line.update(nms_launches=launches, kept=int(kept.valid.sum()),
                        nms_differences=nms_diff(kept, want),
                        control_err_of_max={f: rel(getattr(nudged, f), getattr(ref, f))
                                            for f in ("cycxhw", "obj_logit", "class_logit")},
                        control_nms_differences=nms_diff(non_max_suppression(
                            nudged, iou_threshold=NMS_IOU, class_mode="argmax"), want))
            del ref, want, kept, nudged
        line["digest"] = digest(pred)
        del pred
        # bf16 activations (the service's): one process on rank 0 alone,
        # then the two ranks
        xb = x.to(torch.bfloat16)
        if chief:
            fresh()
            with torch.no_grad():
                line["one_process_bf16_ms"] = timed(lambda: model(xb), 3)[0]
            line["one_process_bf16_peak_gb"] = peak_gb()
        mesh.base.agree(False)
        fresh()
        line["bf16_ms"], line["bf16_transfers"] = timed(lambda: infer(xb), 3)
        line["bf16_peak_gb"] = peak_gb()
        out["infer"].append(line)
        del model, infer, x, xb

    def changes(model, init) -> dict:  # Δ: what the step changed, per tensor
        return {k: v.detach() - init[k] for k, v in model.state_dict().items()}

    def delta_err(delta, one) -> dict:  # ‖Δ − Δ_one‖₂ / ‖Δ_one‖₂ per tensor
        errs = {}
        for k, d1 in one.items():
            n1 = float(torch.linalg.vector_norm(d1.double()))
            nd = float(torch.linalg.vector_norm((delta[k] - d1).double()))
            errs[k] = nd / n1 if n1 > 0 else (0.0 if nd == 0 else float("inf"))
        return errs

    # one f32 SGD step of a 1 x 2 mesh against one process (rank 0 alone)
    size, batch = spec["train"]
    preds = []
    real_loss = loop.yolo_loss

    def capturing(pred, *args, **kwargs):
        preds.append({f: getattr(pred, f).detach().clone()
                      for f in ("cycxhw", "obj_logit", "class_logit")})
        return real_loss(pred, *args, **kwargs)

    loop.yolo_loss = capturing
    sgd = TrainConfig(optimizer="sgd", lr=LrScheduleConfig(kind="constant", lr=1e-2))
    data = [torch.from_numpy(a).to(device) for a in synthetic_batch(batch, size, seed=6)]
    model = flagship(size)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ref = {}
    if chief:
        for name, nudge in (("single", False), ("control", True)):
            model.load_state_dict(init)
            fresh()
            ts, opt = train_init(model, sgd)
            rows = list(data)
            if nudge:  # the same step on images 1 ulp up: rounding alone
                rows[0] = torch.nextafter(rows[0], torch.tensor(float("inf"), device=device))
            preds.clear()
            _, m = make_train_step(model, opt, sgd)(ts, *rows)
            ref[name] = {"loss": float(m["total_loss"]), "pred": preds[0], "peak_gb": peak_gb(),
                         "delta": changes(model, init)}
            del ts, opt
    mesh.base.agree(False)
    model.load_state_dict(init)
    fresh()
    ts, opt = train_init(model, sgd)
    preds.clear()
    log.clear()
    _, m = make_spatial_train_step(model, opt, sgd, mesh)(ts, *shard_batch_2d(mesh, data))
    train = {"size": size, "batch": batch, "loss": float(m["total_loss"]),
             "num_matched": int(m["num_matched"]), "peak_gb": peak_gb(),
             "f32_transfers": transfers()}
    if chief:
        single = ref["single"]
        mine = delta_err(changes(model, init), single["delta"])
        control = delta_err(ref["control"]["delta"], single["delta"])
        worst, c_worst = max(mine, key=mine.get), max(control, key=control.get)
        train.update(
            single_loss=single["loss"], control_loss=ref["control"]["loss"],
            single_peak_gb=single["peak_gb"], tensors=len(mine), worst=worst,
            delta_err=mine[worst], control_worst=c_worst, control_delta_err=control[c_worst],
            pred_err_of_max={f: rel(preds[0][f], single["pred"][f]) for f in single["pred"]},
            control_pred_err_of_max={f: rel(ref["control"]["pred"][f], single["pred"][f])
                                     for f in single["pred"]})
        del ref, single
    del ts, opt
    loop.yolo_loss = real_loss
    # the same step in float64, where f32 rounding cannot reach the change
    # gate: at 608² one f32 step on images 1 ulp up already moves a BN
    # scale's change by 3e-2 of its norm
    model.double()
    init64 = {k: v.double() for k, v in init.items()}
    data64 = [data[0].double(), *data[1:]]
    if chief:
        model.load_state_dict(init64)
        fresh()
        ts, opt = train_init(model, sgd)
        _, m = make_train_step(model, opt, sgd)(ts, *data64)
        one64 = {"loss": float(m["total_loss"]), "delta": changes(model, init64),
                 "peak_gb": peak_gb()}
        del ts, opt
    mesh.base.agree(False)
    model.load_state_dict(init64)
    fresh()
    ts, opt = train_init(model, sgd)
    _, m = make_spatial_train_step(model, opt, sgd, mesh)(ts, *shard_batch_2d(mesh, data64))
    train["f64"] = {"loss": float(m["total_loss"]), "peak_gb": peak_gb()}
    if chief:
        errs = delta_err(changes(model, init64), one64["delta"])
        worst = max(errs, key=errs.get)
        train["f64"].update(single_loss=one64["loss"], single_peak_gb=one64["peak_gb"],
                            tensors=len(errs), worst=worst, delta_err=errs[worst])
        del one64
    del ts, opt, init64, data64
    model.float()
    # bf16 steps (compute_dtype bf16, SGD): one process on rank 0 alone,
    # then the 1 x 2 mesh
    bf16 = TrainConfig(optimizer="sgd", compute_dtype="bfloat16",
                       lr=LrScheduleConfig(kind="constant", lr=1e-2))
    if chief:
        model.load_state_dict(init)
        fresh()
        ts, opt = train_init(model, bf16)
        step = make_train_step(model, opt, bf16)
        train["one_process_bf16_ms"] = timed(lambda: step(ts, *data), 3)[0]
        train["one_process_bf16_peak_gb"] = peak_gb()
        del ts, opt, step
    mesh.base.agree(False)
    model.load_state_dict(init)
    fresh()
    ts, opt = train_init(model, bf16)
    step = make_spatial_train_step(model, opt, bf16, mesh)
    rows = shard_batch_2d(mesh, data)
    losses = []
    train["bf16_ms"], train["bf16_transfers"] = timed(
        lambda: losses.append(float(step(ts, *rows)[1]["total_loss"])), 3)
    train.update(bf16_losses=losses, bf16_peak_gb=peak_gb())
    out["train"] = train
    (mesh_mod.neighbour_exchange, mesh_mod.DataMesh.all_gather,
     mesh_mod.DataMesh.reduce_scatter, mesh_mod.DataMesh.all_reduce_) = saved
    with open(os.path.join(SPATIAL_ROOT, f"rank{world.rank}.json"), "w") as f:
        json.dump(out, f)
    destroy_process_group()


def phase_spatial() -> dict:
    """Spatial parallelism (ROADMAP A14d): 2 ranks on one card over gloo;
    checks."""
    import shutil

    from yolodl_torch.parallel.mesh import launch_ranks

    t0 = time.perf_counter()
    shutil.rmtree(SPATIAL_ROOT, ignore_errors=True)
    os.makedirs(SPATIAL_ROOT)
    try:
        write_json(os.path.join(SPATIAL_ROOT, "spec.json"), {
            "device": f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE,
            "infer": SPATIAL_INFER, "train": SPATIAL_TRAIN})
        launch_ranks([sys.executable, "-c", "import chip_smoke; chip_smoke.spatial_rank()"], 2,
                     env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=SPATIAL_TIMEOUT)
        ranks = []
        for r in range(2):
            with open(os.path.join(SPATIAL_ROOT, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(SPATIAL_ROOT, ignore_errors=True)
    r0, r1 = ranks
    failures = []
    want = "ranks share cuda:0" if DEVICE == "cuda" else "ranks run on the CPU"
    if r0["backend"] != "gloo" or r0["reason"] != want:
        failures.append(f"2 ranks on one card: {r0['backend']} ({r0['reason']})")
    for line, other in zip(r0["infer"], r1["infer"]):
        where = f"spatial inference at {line['size']}², b{line['batch']}"
        worst = max(line["f32_err_of_max"].values())
        if not worst <= SPATIAL_F32_TOL:
            failures.append(f"{where}, f32: {line['f32_err_of_max']} of max > {SPATIAL_F32_TOL}")
        if line["digest"] != other["digest"]:
            failures.append(f"{where}: the two ranks' outputs differ")
        if line["nms_differences"]["valid"]:
            failures.append(f"{where}: NMS keep masks differ from the unsharded forward's: "
                            f"{line['nms_differences']} (the 1-ulp control: "
                            f"{line['control_nms_differences']})")
        if DEVICE == "cuda" and set(line["nms_launches"].values()) != {1}:
            failures.append(f"{where}: NMS launches {line['nms_launches']} for one batch")
    t = r0["train"]
    if not abs(t["loss"] - t["single_loss"]) <= 1e-5 * abs(t["single_loss"]) or \
            t["loss"] != r1["train"]["loss"]:
        failures.append(f"spatial f32 step: loss {t['loss']} (rank 1 {r1['train']['loss']}) "
                        f"vs one process {t['single_loss']}")
    if not max(t["pred_err_of_max"].values()) <= SPATIAL_F32_TOL:
        failures.append(f"spatial f32 step: forward {t['pred_err_of_max']} of max (the 1-ulp "
                        f"control, printed only: {t['control_pred_err_of_max']})")
    # each tensor's change, held in float64 (the f32 step's and its 1-ulp
    # control's are printed: f32 rounding alone reaches 3e-2 of a norm)
    f64 = t["f64"]
    if not f64["delta_err"] <= SPATIAL_DELTA_TOL or f64["loss"] != r1["train"]["f64"]["loss"]:
        failures.append(f"spatial float64 step: |Δ - Δ_one| = {f64['delta_err']} |Δ_one| at "
                        f"{f64['worst']} > {SPATIAL_DELTA_TOL}, or the ranks' losses differ "
                        f"({f64['loss']}, {r1['train']['f64']['loss']})")
    if not all(np.isfinite(t["bf16_losses"])) or t["bf16_losses"] != r1["train"]["bf16_losses"]:
        failures.append(f"spatial bf16 losses {t['bf16_losses']} "
                        f"(rank 1 {r1['train']['bf16_losses']})")
    emit({"phase": "spatial", "model": "yolov4-csp", "backend": r0["backend"],
          "reason": r0["reason"], "route": r0["route"],
          "infer": {"rank0": r0["infer"], "rank1": [
              {k: line[k] for k in ("size", "bf16_ms", "bf16_transfers", "bf16_peak_gb")}
              for line in r1["infer"]]},
          "train": {"rank0": t, "rank1": {k: r1["train"][k] for k in (
              "loss", "peak_gb", "f64", "bf16_ms", "bf16_transfers", "bf16_peak_gb")}},
          "failures": failures, "seconds": time.perf_counter() - t0, "card": card_line()})
    if failures:
        raise AssertionError("phase spatial: " + "; ".join(failures))
    return {"spatial_infer_nms": r0["nms_launches"]}


def layout_nms_gaps(kept, ref, pred, ref_pred) -> list:
    """The (instance, class) pairs kept by one NMS and not the other, each
    with its score under both predictions and each NMS's top-k cut (its
    lowest candidate score): a pair at the cut, or beside a box that one
    side suppresses, is a near-tie."""
    conf, ref_conf = pred.confidence(), ref_pred.confidence()
    rows = []
    for i in range(kept.valid.shape[0]):
        pairs = {}
        for side, n in (("knob", kept), ("off", ref)):
            v = n.valid[i]
            for inst, cls in zip(n.instances[i][v].tolist(), n.classes[i][v].tolist()):
                pairs.setdefault((inst, cls), set()).add(side)
        for (inst, cls), sides in sorted(pairs.items()):
            if len(sides) == 1:
                rows.append({"image": i, "instance": inst, "class": cls,
                             "kept_by": sides.pop(),
                             "score_knob": float(conf[i, inst, cls]),
                             "score_off": float(ref_conf[i, inst, cls]),
                             "topk_cut_knob": float(kept.confidence[i].min()),
                             "topk_cut_off": float(ref.confidence[i].min())})
    return rows


def packed_wgrad_bound(b, ho, ci, co, k, s, itemsize):
    """(bound_ms, bound_by) of one packed dW: the pre-padded input read once
    (``(ho−1)s + k`` rows and columns), g read once, dW written once in f32,
    against 2·B·Ho·Wo·k²·Ci·Co operations at the inputs' peak."""
    hp = (ho - 1) * s + k
    t_bytes = (b * hp * hp * ci * itemsize + b * ho * ho * co * itemsize
               + 4 * k * k * ci * co) / HBM_BYTES_PER_S
    t_ops = 2 * b * ho * ho * k * k * ci * co / (BF16_FLOPS if itemsize == 2 else F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def layout_wgrad() -> None:
    """conv2d_packed_wgrad (ops/wgrad.py) at phase wgrad's eight stride-1
    shapes and the flagship's two stride-2 convs, b8, bf16: the forward
    equal to F.conv2d, dW within WGRAD_LIB_TOL of f32 conv2d_weight; ms
    and peak bytes of the packed dW beside B2, B3 (stride 1) and
    conv2d_weight on the same operands."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight

    from yolodl_torch.kernels import wgrad_db, wgrad_lowch
    from yolodl_torch.ops.wgrad import conv2d_packed_wgrad, mm_route, wgrad_im2col

    gen = torch.Generator(device=DEVICE).manual_seed(5)  # drawn on the card: 10^8 values
    b = BATCH

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    for h, ci, co, k, s in [(*shape, 1) for shape in WGRAD_SHAPES] + LAYOUT_WGRAD_STRIDE2:
        pad = (k - 1) // 2
        ho = (h + 2 * pad - k) // s + 1
        x = randn(b, ci, h, h).to(torch.bfloat16)
        w = randn(co, ci, k, k) / (k * k * ci) ** 0.5
        gy = randn(b, co, ho, ho).to(torch.bfloat16)
        wr = w.clone().requires_grad_(True)
        y = conv2d_packed_wgrad(x, wr, k, s)
        y.backward(gy)
        row = {"shape": [b, h, ci, co, k, s], "dtype": "bfloat16",
               "mm_route": mm_route(x.device, x.dtype), "dw_dtype": str(wr.grad.dtype)}
        if not torch.equal(y, F.conv2d(x, w.to(torch.bfloat16), stride=s, padding=pad)):
            raise AssertionError(f"conv2d_packed_wgrad {row['shape']}: forward != F.conv2d")
        lib32 = conv2d_weight(x.float(), (co, ci, k, k), gy.float(), stride=s, padding=pad)
        row["lib_rel_err"] = rel_err(wr.grad, lib32)
        if wr.grad.dtype != torch.float32 or not row["lib_rel_err"] <= WGRAD_LIB_TOL:
            raise AssertionError(f"conv2d_packed_wgrad {row['shape']}: dW {wr.grad.dtype}, "
                                 f"rel err {row['lib_rel_err']} against f32 conv2d_weight")
        del y, wr, lib32
        xp = F.pad(x, (pad,) * 4)[:, :, :(ho - 1) * s + k, :(ho - 1) * s + k]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        wgrad_im2col(xp, gy, k, s)
        torch.cuda.synchronize()
        row["packed_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        row["packed_ms"] = median_ms(lambda: wgrad_im2col(xp, gy, k, s), n=20)
        row["library_ms"] = median_ms(
            lambda: conv2d_weight(x, (co, ci, k, k), gy, stride=s, padding=pad), n=20)
        if s == 1:
            xp_nhwc = xp.permute(0, 2, 3, 1).contiguous()
            g_nhwc = gy.permute(0, 2, 3, 1).contiguous()
            for name, fn in (("wgrad_lowch", wgrad_lowch), ("wgrad_db", wgrad_db)):
                row[f"{name}_ms"] = median_ms(
                    lambda fn=fn: fn(xp_nhwc, g_nhwc, k, device=DEVICE), n=20)
            del xp_nhwc, g_nhwc
        row["bound_ms"], row["bound_by"] = packed_wgrad_bound(b, ho, ci, co, k, s, 2)
        emit({"phase": "layout", "part": "conv2d_packed_wgrad", **row})
        del x, w, gy, xp
    torch.cuda.empty_cache()


def phase_layout(iou) -> dict:
    """The layout rewrites (ROADMAP A15): yolov4-csp-608 with each knob
    against ``off``; see the module docstring."""
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.loss import non_max_suppression, yolo_loss
    from yolodl_torch.models import YoloModel
    from yolodl_torch.models.builder import module_key
    from yolodl_torch.train import TrainConfig, make_train_step, train_init

    t0 = time.perf_counter()
    part_seconds = {}

    def lap(part):  # wall seconds of each part of the phase
        part_seconds[part] = time.perf_counter() - t0 - sum(part_seconds.values())

    graph = graph_from_darknet(dk.Darknet.load(CFG))
    models = {}
    for name, knob in LAYOUT_KNOBS:
        models[name] = YoloModel(graph, device=DEVICE, generator=torch.Generator().manual_seed(0),
                                 **knob)
        if name == "off":
            randomize_bn(models[name], 0)
            sd0 = {k: v.clone() for k, v in models[name].state_dict().items()}
        models[name].load_state_dict(sd0)
    off = models["off"]
    lap("build")

    def rewritten(m) -> tuple:  # conv node keys a knob runs packed or folded
        return (m._spd_pair or ())[1:] + (m._spd_res or ())[:2] + m._fold_convs

    def prefixes(m):
        return tuple(f"layers.{module_key(m._pname[k])}." for k in rewritten(m))

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()

    failures, lines = [], {name: {"knob": name, "rewritten": [off._pname[k] for k in rewritten(m)]}
                           for name, m in models.items()}

    # eval, f32, b8: the raw heads and NMS (B1's counters zeroed right
    # before and read right after each model's suppression)
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.uniform(0, 1, (BATCH, 3, IMAGE_SIZE, IMAGE_SIZE))
                         .astype(np.float32)).to(DEVICE)
    heads = tuple(graph.detect_head_input_keys())
    out_key = graph.output_node().key
    nms_kernels = (iou.nms_conflict_bits, iou.nms_keep_from_bits)
    nms_launches = {fn.__name__: 0 for fn in nms_kernels}
    outs, kept = {}, {}

    def nms(pred):
        return non_max_suppression(pred, iou_threshold=NMS_IOU, class_mode="argmax",
                                   kind="diou", beta=NMS_BETA)

    for name, m in models.items():
        with torch.no_grad():
            outs[name] = m(x, output_keys=heads + (out_key,))
        for fn in nms_kernels:
            fn.launches = 0
        kept[name] = nms(outs[name][out_key])
        sync()
        launches = {fn.__name__: fn.launches for fn in nms_kernels}
        for fn_name, n in launches.items():
            nms_launches[fn_name] += n
        lines[name]["nms_launches"] = launches
        if DEVICE == "cuda" and set(launches.values()) != {1}:
            failures.append(f"{name}: NMS launches {launches} for one batch")
    with torch.no_grad():  # rounding alone: off on images 1 ulp up (printed only)
        nudged = off(torch.nextafter(x, torch.tensor(float("inf"), device=x.device)))
    nudged_kept = nms(nudged)
    for name in models:
        if name == "off":
            continue
        line = lines[name]
        line["f32_head_err_of_max"] = max(rel_err(outs[name][k], outs["off"][k]) for k in heads)
        if not line["f32_head_err_of_max"] <= LAYOUT_F32_TOL:
            failures.append(f"{name}: f32 heads {line['f32_head_err_of_max']} of max")
        a, r = kept[name], kept["off"]
        gaps = layout_nms_gaps(a, r, outs[name][out_key], outs["off"][out_key])
        line["nms"] = {"valid_differ": int((a.valid != r.valid).sum()), "kept": int(a.valid.sum()),
                       "kept_pairs_not_shared": len(gaps), "gaps": gaps[:8]}
    control_nms = {"kept_pairs_not_shared": len(layout_nms_gaps(
        nudged_kept, kept["off"], nudged, outs["off"][out_key]))}
    del outs, kept, nudged, nudged_kept
    lap("f32_eval_nms")

    # one train-mode forward and backward, f32, b8, bench's kind of batch:
    # the loss, the rewritten nodes' new BN statistics and gradients against
    # off's, the gradients held to 10x off's own move on images 1 ulp up
    images, boxes, classes, mask = (torch.from_numpy(a).to(DEVICE)
                                    for a in synthetic_batch(BATCH, IMAGE_SIZE, seed=3))
    config = TrainConfig()

    touched = tuple(set().union(*(prefixes(m) for m in models.values())))

    def train_once(m, imgs):
        m.load_state_dict(sd0)
        m.zero_grad(set_to_none=True)
        out, _ = yolo_loss(m(imgs, train=True), boxes, classes, mask, config.loss)
        out.total_loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in m.named_parameters()
                 if k.startswith(touched)}
        stats = {k: v.clone() for k, v in m.state_dict().items()
                 if k.endswith((".mean", ".var"))}
        m.zero_grad(set_to_none=True)
        return float(out.total_loss.detach()), grads, stats

    ref_loss, ref_grads, ref_stats = train_once(off, images)
    _, ctl_grads, _ = train_once(off, torch.nextafter(
        images, torch.tensor(float("inf"), device=images.device)))
    for name, m in models.items():
        if name == "off":
            continue
        loss, grads, stats = train_once(m, images)
        line = lines[name]
        line["loss"], line["loss_off"] = loss, ref_loss
        if not abs(loss - ref_loss) <= LAYOUT_LOSS_TOL * abs(ref_loss):
            failures.append(f"{name}: f32 loss {loss} vs off {ref_loss}")
        mine = prefixes(m)
        worst_stat = max(rel_err(v, ref_stats[k]) for k, v in stats.items() if k.startswith(mine))
        line["bn_stat_err_of_max"] = worst_stat
        if not worst_stat <= LAYOUT_F32_TOL:
            failures.append(f"{name}: new BN statistics {worst_stat} of max")
        worst = {}
        for k, g in grads.items():
            if not k.startswith(mine):
                continue
            err = float((g - ref_grads[k]).abs().max())
            control = float((ctl_grads[k] - ref_grads[k]).abs().max())
            scale = float(ref_grads[k].abs().max())
            worst[k] = {"err_of_max": err / max(scale, 1e-30),
                        "control_err_of_max": control / max(scale, 1e-30)}
            if not (err <= LAYOUT_F32_TOL * scale or err <= LAYOUT_CONTROL_FACTOR * control):
                failures.append(f"{name}: gradient {k} {err} (off's 1-ulp control {control}, "
                                f"max {scale})")
        line["grad_err"] = worst
    del images, ref_grads, ctl_grads, ref_stats
    lap("f32_train")

    # bf16: the serve forward at b8 and the train step at b16 (TrainConfig())
    xb = x.to(torch.bfloat16)
    images, boxes, classes, mask = synthetic_batch(TRAIN_BATCH, IMAGE_SIZE)
    batch = (torch.from_numpy(images).to(torch.bfloat16).to(DEVICE),
             *(torch.from_numpy(a).to(DEVICE) for a in (boxes, classes, mask)))
    for name, m in models.items():
        line = lines[name]
        with torch.no_grad():
            ms = [timed_ms(lambda: m(xb), DEVICE) for _ in range(3 + LAYOUT_TIMED)][3:]
            line["serve_ms"] = statistics.median(ms)
            lap(f"bf16_serve_{name}")
            line["serve"] = profile_calls(lambda: m(xb))
            lap(f"bf16_serve_profile_{name}")
        ts, opt = train_init(m, TrainConfig())
        step = make_train_step(m, opt, TrainConfig())
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i in range(2 + LAYOUT_STEPS):
            def one():
                nonlocal ts
                ts, metrics = step(ts, *batch)
                losses.append(float(metrics["total_loss"]))
            t = timed_ms(one, DEVICE)
            if i >= 2:
                ms.append(t)
        line["step_ms"] = statistics.median(ms)
        line["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        lap(f"bf16_step_{name}")
        line["step_kernels"], line["step_device_ms"] = device_profile(lambda: step(ts, *batch))
        lap(f"bf16_step_profile_{name}")
        if not all(np.isfinite(losses)):
            failures.append(f"{name}: bf16 losses {losses}")
        del ts, opt, step
        torch.cuda.empty_cache()
    for name, line in lines.items():
        for key in ("copies", "layout_copies"):
            line["serve"][f"{key}_beyond_off"] = line["serve"][key] - lines["off"]["serve"][key]
        emit({"phase": "layout", **line})
    del models, off, xb, batch
    torch.cuda.empty_cache()

    layout_wgrad()
    lap("conv2d_packed_wgrad")
    emit({"phase": "layout", "nms_launches": nms_launches, "control_nms": control_nms,
          "failures": failures, "seconds": time.perf_counter() - t0,
          "part_seconds": part_seconds, "card": card_line()})
    if failures:
        raise AssertionError("phase layout: " + "; ".join(failures))
    return {"layout": nms_launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "yolodl_torch")):
        print("chip_smoke: yolodl_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # f32 comparisons on the card are exact f32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from yolodl_torch.kernels import _build, iou

    emit({"phase": "build", "seconds": _build.build_all(),
          "libraries": [str(_build.library_path(n).relative_to(REPO))
                        for n in (*_build.SOURCES, *_build.host_libraries())],
          "compile_seconds": _build.BUILD_SECONDS})
    seconds = {}

    def run(name, fn, *args):  # each phase's wall seconds, for the timing line
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    try:
        k = run("kernel", phase_kernel, iou)
        launches = run("serve", phase_serve, iou)
        # B1's launches on each path that runs it
        by_path = {"serve": {n: launches[n] for n in ("nms_conflict_bits", "nms_keep_from_bits")},
                   "serve_dense_route": {"pairwise_iou": launches["pairwise_iou"]},
                   **run("cli", phase_cli, iou)}
        train_main_launches, train_main_summary = run("train_main", phase_train_main, iou)
        by_path.update(train_main_launches)
        run("native_loader", phase_native_loader)
        by_path.update(run("augment", phase_augment, iou, train_main_summary))
        wgrad_launches, wgrad = run("wgrad", phase_wgrad)
        train_ms = run("train", phase_train)
        by_path.update(run("darknet_loss", phase_darknet_loss, iou, train_ms))
        by_path.update(run("deploy", phase_deploy, iou))
        by_path.update(run("classify", phase_classify, iou))
        by_path.update(run("dp", phase_dp, iou))
        by_path.update(run("tp", phase_tp))
        by_path.update(run("pp", phase_pp))
        by_path.update(run("recurrent_parallel", phase_recurrent_parallel))
        by_path.update(run("spatial", phase_spatial))
        by_path.update(run("layout", phase_layout, iou))
    finally:  # also when a phase fails
        emit({"phase": "timing", "seconds_by_phase": seconds,
              "seconds": sum(seconds.values())})

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    # B1: the conflict tile (the Pallas IoU tile with NMS's conflict formula
    # around it) and the resolution (an XLA scan, no Pallas kernel) launch on
    # the serving path; pairwise_iou only on the breakdown's dense route
    b1 = {"nms_conflict_bits": {"replaces": "yolodl_tpu/kernels/iou_pallas.py:32",
                                "replaces_also": "yolodl_tpu/loss/nms.py:86-101"},
          "nms_keep_from_bits": {"replaces": "yolodl_tpu/loss/nms.py:113-147",
                                 "replaces_kind": "an XLA scan (fori_loop + while_loop), "
                                                  "not a Pallas kernel"},
          "pairwise_iou": {"replaces": "yolodl_tpu/kernels/iou_pallas.py:32",
                           "launched_by": "the serve breakdown's dense postprocess route"}}
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": "yolodl_torch/csrc/iou.cu", **extra,
        "launches": sum(p.get(name, 0) for p in by_path.values()),
        "launches_by_path": {path: p[name] for path, p in by_path.items() if name in p},
        "max_abs_err": k[name]["max_abs_err"],
        "ms": k[name]["ms"], "kernel_ms": k[name]["ms"], "plain_ms": k[name]["plain_ms"],
        "bound_ms": k[name]["bound_ms"], "bound_by": k[name]["bound_by"], "library_ms": None}
        for name, extra in b1.items()] + [{
        "name": name, "route": "cuda", "source": f"yolodl_torch/csrc/{name}.cu",
        "replaces": replaces, "launches": wgrad_launches[name],
        "max_abs_err": wgrad[name]["max_abs_err"], "ms": wgrad[name]["ms"],
        "kernel_ms": wgrad[name]["ms"], "plain_ms": wgrad[name]["plain_ms"],
        "bound_ms": wgrad[name]["bound_ms"], "bound_by": wgrad[name]["bound_by"],
        "library_ms": wgrad[name]["library_ms"]}
        for name, replaces in (("wgrad_lowch", "yolodl_tpu/kernels/wgrad_pallas.py:49"),
                               ("wgrad_db", "yolodl_tpu/kernels/wgrad_db.py:79"))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
