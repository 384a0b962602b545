#!/usr/bin/env python3
"""Drive the port (mxnet_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --forward-case lm    # build, one case of phase 2
    python3 chip_smoke.py --backward-case lm   # build, one case of phase 4
    python3 chip_smoke.py --conv-case main     # build, cases of phase 6
    python3 chip_smoke.py --phases 7,8         # build, phases 7 and 8 only
    python3 chip_smoke.py --phases 10          # build, Module.fit only
    python3 chip_smoke.py --phases 11          # build, serving only
    python3 chip_smoke.py --phases 12          # build, the Module remainder
    python3 chip_smoke.py --phases 13          # build, Gluon only
    python3 chip_smoke.py --phases 14,15,16    # build, the PTB LSTM LM,
                                               # gluon.rnn, the factories
    python3 chip_smoke.py --phases 17,18,19    # build, the last 50 ops,
                                               # ImageRecordIter -> fit,
                                               # VGG16-SSD300
    python3 chip_smoke.py --phases 20          # build, the serving fleet
    python3 chip_smoke.py --phases 21,22       # build, training across
                                               # worker processes
    python3 chip_smoke.py --phases 23,24,25    # build, the train -> serve
                                               # loop, the router, the
                                               # artifact and the C API
    python3 chip_smoke.py --phases 26,27       # build, the LM through the
                                               # mesh, four ranks sharing
                                               # the card over gloo
    python3 chip_smoke.py --phases 28,29       # build, Module over a data
                                               # mesh, ZeRO-1
    python3 chip_smoke.py --phases 30,31       # build, the fused Gluon
                                               # step, sparse tables
    python3 chip_smoke.py --phases 32,33,34    # build, the LM in two
                                               # pipeline stages, the
                                               # pipelined trainers, MoE
    python3 chip_smoke.py --phases 35,36       # build, hybrid workers and
                                               # the reductions over the
                                               # batch, the Custom head
    python3 chip_smoke.py --phases 37,38       # build, the native runtime
                                               # and the C training API
    python3 chip_smoke.py --mutants            # phases 2, 4 and 6 against
                                               # broken kernels

Phases, each of which exits non-zero on failure:

1. build: compile every kernel from mxnet_tpu_torch/csrc with nvcc; the
   SASS of every instance of the tensor-core kernels (SM90_KERNELS: the
   flash kernels in bf16 and float16, the conv in bf16) must hold HGMMA,
   and ptxas must report no serialised wgmma (C7520);
2. kernels: launch the forward kernel on the card at the LM's shapes in
   bf16 and float16 (and decode-shaped cases, a ragged float32 one,
   head_dim 192, a ragged head_dim 100 in both dtypes, and head_dim 320),
   hold it against its plain PyTorch version (16-bit: the online
   recurrence at the kernel's 64-key tile, element by element, the same
   bits on a second launch), and time it beside its bound, the plain
   version and, where one exists, one PyTorch call that computes the
   same function;
3. lm: the transformer LM forward at GPT-2-medium width (vocab 50257,
   dim 1024, 16 heads, 24 layers, bf16, seeded random weights) answers
   four requests of 8 x 1024 tokens on the flash kernel; the launch
   count must rise by one per layer per request, the logits must be
   finite, the mean NLL near ln(vocab), and one request must agree with
   the same model on plain attention; then the same check for one
   request at dim 768 with 4 heads (head_dim 192) and 2 layers, and for
   one request in float16 at full width and 4 layers;
4. backward kernels: launch the dK/dV and dQ kernels on the card at the
   shapes of phase 2 (and a rectangular float32 case with a nonzero lse
   cotangent), hold each against its plain PyTorch version element by
   element, check that the autograd Function gives the kernels'
   gradients, and time each beside its bound, its plain version and the
   backward of scaled_dot_product_attention;
5. train: the train step at the widths of phase 3, bf16, on one batch
   of 8 x 1024 tokens. Every parameter's gradient must be finite and
   nonzero on the flash path and on plain attention and agree between
   the two; then a warm-up step, whose update must be w - lr * g, and
   four timed steps, each of which must launch the forward, dK/dV and
   dQ kernels once per layer; a torch.profiler breakdown of one step;
   then one float16 step at full width and 4 layers, whose gradients
   must agree with plain attention's and which must launch each kernel
   once per layer; last, five float32 steps at full width and 4 layers
   on one batch, whose loss must fall;
6. conv + BatchNorm statistics: the kernels (bf16 on the tensor cores,
   float32 on FMAs) against their plain version, element by element, at
   the main ResNet-50 shape (3x3, 64 -> 64 at 56^2, batch 256, bf16), a
   strided 1x1, a ragged float32 case and a stem-like 7x7 stride-2 one,
   and the same bits on a second run; the autograd Function's dx and dw
   against the fold of the statistics' cotangents and the transposed
   convs on the plain version's y; then the bench path
   (mxnet_tpu_torch.tools.bench_conv_bn) over all 19 conv shapes of the
   ResNet-50 body at batch 256 in bf16, each of whose result calls must
   launch the kernel once, timed beside its bound, its plain version,
   cuDNN's conv with the statistics summed after it, cuDNN's conv alone
   and the Function's backward;
7. the NDArray core: every op that mxnet_tpu_torch/ops/tensor.py
   registers (aliases included) runs once on gpu(0) and once on cpu(0)
   on the same seeded float32 inputs, n x n = 1024 x 1024 where it takes
   a matrix, and the two must agree (tools/op_consistency.py: exact for
   data movement and integer results, rtol 1e-5 / atol 1e-6 for
   elementwise float math, rtol 1e-4 for reductions and products, TF32
   off); each sampler of mx.random on gpu(0), its mean and variance
   within 5 standard errors of its distribution's; then the host time
   of one small nd op beside the same torch call;
8. mx.rtc: each RTC_CASES kernel, CUDA source compiled by NVRTC for
   sm_90a, pushed on gpu(0) and held against its plain version; a second
   push at the same key compiles nothing; saxpy1 timed beside its bound,
   its plain version and torch.addcmul; then the imperative training
   loop (logistic regression under autograd.record() with the SGD step
   through sgd_update's Rtc), whose accuracy must pass 0.9 in 100 steps,
   each launching the kernel once;
9. resnet: the bf16 ResNet-50 v2 (models.resnet.get_symbol, 1000
   classes, 3x224x224) bound by simple_bind on gpu(0) at batch 256, data
   and label without gradient, seeded He-normal weights. An eval forward
   must launch the conv + BN statistics kernel 0 times and each train
   forward_backward exactly 32 times (its 33 train-mode conv -> BatchNorm
   pairs but the stem's, which the stem split takes; 33 with
   MXNET_TPU_STEM_SPLIT=0); every weight gradient finite and nonzero but bn_data_gamma's,
   exactly zero (fix_gamma); the step with the pair route off (cuDNN's
   conv, BatchNorm's own sums) within RESNET_LOSS_ATOL in loss and
   RESNET_OUT_REL / RESNET_AUX_REL in relative norm, its gradients'
   distance reported (at initialisation the whole network amplifies
   bf16 rounding past any useful gradient bound); the kernel against its
   plain version at every shape the route gives it; at each of those
   shapes a one-pair bf16 graph through the executor with the route on
   against the route off, output, moving statistics and every gradient
   (data, weight, gamma, beta) within RESNET_OUT_REL, RESNET_AUX_REL and
   RESNET_GRAD_REL; the cut ResNet of tests/test_torch_resnet.py in
   bf16 on gpu(0) against cpu(0) (output and statistics gated, gradients
   reported); then a warm-up and RESNET_STEPS timed steps of
   forward_backward and w -= lr / batch * g through nd ops (median ms,
   images/s, peak memory; the loss on the one batch must fall), the same
   with the pair route off, timed eval forwards, and one step's
   torch.profiler breakdown;
10. module: Module.fit trains the network of phase 9 (mx.mod.Module on
   gpu(0), batch 256, bf16) for MODULE_EPOCHS epochs of MODULE_BATCHES
   seeded batches staged by io.prefetch_to_device: momentum SGD with
   weight decay on float32 masters (FusedSGD), a MultiFactorScheduler
   step inside the run, Xavier initialisation, acc and top-5 metrics, a
   Speedometer and do_checkpoint. Gated (module_gate): 32 kernel
   launches a fit step (the stem split on), 0 in predict and score and in an epoch with the
   pair route off; the lr schedule; weight decay on *_weight and *_gamma
   only; float32 masters for exactly the bf16 parameters; every state
   finite; one Module step against the executor step and the per-key
   registered update ops (bf16 weights within one bf16 step, float32
   states within MODULE_STATE_REL); three steps on staged batches equal
   to the same steps on batches copied in the step; the loss on one
   batch falling over MODULE_LOSS_STEPS steps; save_checkpoint with the
   optimizer states, Module.load and one step equal to the uninterrupted
   step bit for bit. Printed: the step time and images/s with the route
   on and off, the Speedometer's rate, the update's host and device
   time, update_metric's, the H2D copy of a batch, the staging stall,
   peak memory, and one step's profile beside phase 9's;
11. serve: the network of phase 9 (SERVE_RESIDUAL_SCALE on each residual
   branch's last conv, BatchNorm statistics from one seeded batch) saved
   with model.save_checkpoint, loaded by Predictor.from_checkpoint with
   no ctx (it must bind to cuda:0) and served by pred.serve(max_batch=32,
   max_wait_us=2000), the ladder 1-32 at depth 2: SERVE_CLIENTS threads
   send SERVE_REQUESTS requests each of 1-4 seeded images; then the same
   traffic through an int8 engine and an engine over a Module bound for
   inference at batch 32; serial Predictor.forward at batch 32 and 1
   timed beside them. Gated (serving_gate): every request and row
   counted and answered with its own rows (each answer row nearest its
   own reference row), a full-bucket request equal bit for bit to the
   serial forward, a padded one to the padded serial forward, a
   request's rows the same bits whatever they are batched with, a
   70-row request equal to the serial forward of its chunks, no rung
   built after warmup, batch fill in (0, 1], the int8 engine within its
   parity gate with codes taking half the bf16 bytes plus scales, the
   Module engine equal to the Predictor engine, close() joining both
   threads and refusing later work, every NN op of the second ops slice
   equal on gpu(0) and cpu(0), and no flash or conv kernel launched.
   Printed: requests/s, images/s, latency p50/p99, fill, padded rows,
   queue depth, the service-ms EMA, the host ms of a dispatch (assembly,
   staging, the walk's launches, the completion's copy), a window's
   device time by kernel class and device-busy share, peak memory,
   memory_cost and resident bytes;
12. bucketing: the Module remainder on the network of phase 9. A
   BucketingModule whose sym_gen gives it at image side 224 (the default
   key) and 160, both ladder rungs (no padding), the 160 bucket bound
   with the 224 bucket's parameters (one copy) and one FusedSGD state,
   both warmed up at init_optimizer; steps alternating between the
   buckets, each launching the kernel 32 times (the stem split on); the
   kernel against its plain version at every pair shape of the 160
   bucket's route (sides 40, 20, 10, 5); a step on 160 changing what 224
   reads; no rung built after warm-up. Then Module.bulk_step of 4 batches
   against 4 per-step steps from one state under deterministic cuDNN
   (weights, moving statistics, momenta, masters and the acc / top-5
   sums bit for bit, the lr of each step with a FactorScheduler boundary
   inside the dispatch, the dispatch under
   torch.cuda.set_sync_debug_mode('error')); fit(bulk=4) for one epoch
   on a Module and on the BucketingModule (one dispatch of 4 steps, one
   queued metric pair and one host read a dispatch); the network bound
   with the stem split on and off (32 and 33 launches, loss, output and
   statistics within phase 9's bounds, the backward's ms); and a
   two-group graph (cpu(0) and the card) bound with group2ctx against
   the one-device bind (output and gradients within GROUP_TOL). Gated
   by bucketing_gate. Printed: each bucket's step ms and images/s, the
   bulk step's ms against the per-step ms, peak memory;
13. gluon: model_zoo.vision.resnet50_v1 (1000 classes, float32),
   initialize(Xavier) with no ctx (it must land on cuda:0), hybridized,
   Trainer('sgd', momentum 0.9, wd 1e-4) with SoftmaxCrossEntropyLoss
   under autograd.record() on a DataLoader over SyntheticImageDataset
   at batch 64: a warm-up and 5 timed steps, then 5 steps on one batch
   whose loss must fall; the hybridized forward equal to the imperative
   one bit for bit (eval and train); save_params / load_params and
   save_states / load_states, then one step equal to the uninterrupted
   step bit for bit; every other zoo family one forward at batch 2 on the
   card against cpu(0); no hand-written kernel launched. Gated by
   gluon_gate. Printed: the step ms and images/s, the hybridized and
   imperative forward ms;
14. ptb: the PTB LSTM language model of examples/rnn/lstm_bucketing.py
   at the reference's widths (FusedRNNCell(200, 2 layers, lstm), embed
   200, vocab 10,000, batch 32, buckets 10-60, float32) on a seeded
   synthetic corpus encoded by mx.rnn.encode_sentences and batched by
   BucketSentenceIter: BucketingModule.fit with Xavier, adam (lr 0.01)
   and Perplexity(None) for 2 epochs. Gated by ptb_gate: the perplexity
   falls, no hand-written kernel launched, the buckets share their
   parameters, the unfused SequentialRNNCell of LSTMCells with
   unpack_weights's weights within 1e-5 of the fused op, a batch on the
   card within 1e-5 of cpu(0) (output and every gradient), fit(bulk=4)
   over bucket_major batches bit-equal to the same batches stepped one
   by one (momentum SGD, deterministic algorithms) in its dispatches, and
   save_rnn_checkpoint / load_rnn_checkpoint equal in every tensor.
   Printed: tokens/s by bucket, one bucket-60 step's kernel launches and
   device-busy share, peak memory;
15. gluon_lm: the medium word LM of Zaremba et al. 2014 in Gluon
   (gluon.rnn.LSTM(650, 2 layers, dropout 0.5), embed 650, vocab
   10,000, bptt 35, batch 20, untied), six Trainer('sgd') steps with the
   global-norm clip. Gated by gluon_lm_gate: the loss falls, no
   hand-written kernel launched, LSTMCell.unroll over the layer's
   weights within 1e-5 of the layer in eval mode, the dropout mask's
   kept share within 5 standard errors and its scale exact. Printed:
   tokens/s, peak memory;
16. factories: Inception-v3 (3x299x299) and ResNeXt-50 32x4d (224) in
   bf16 through Module at batch 128, three steps each: every step
   launches the conv + statistics kernel once a conv -> BatchNorm pair,
   the pairs counted from the graph's JSON (94 and 37; ResNeXt's 16
   grouped convs stay on cuDNN); the kernel against its plain version
   at every distinct routed shape (1x7, 7x1, 1x3, 3x1 and 5x5 taps
   among them); one train step with the route on against off, on
   conditioned weights (gated as phase 9 gates it) and on He-normal ones
   (reported). LeNet, MLP (1x28x28, batch 64), AlexNet, VGG-16 and
   Inception-BN (224, batch 32-64) one float32 step each, and a batch of
   2 on the card against cpu(0). Gated by factories_gate;
17. contrib: every name of ops/extra.py, ops/spatial.py and
   ops/contrib_ops.py (50 with the aliases) and the case table's
   variants (tools/op_consistency.py) on gpu(0) against cpu(0), forward
   and gradient, at the sizes of the examples that use them
   (MultiBoxPrior on SSD300's six maps, MultiBoxTarget and Detection at
   8,732 anchors and batch 32, Proposal and MultiProposal at Faster
   R-CNN's RPN, 300 rois, a 512-channel deformable 3x3 at 38x50, the
   OCR example's CTC, 512 64x64 SPD matrices): integer, mask, id, order
   and selection results equal, floats within their class; the host ms
   of a call printed;
18. record: RECORD_IMAGES seeded JPEGs (sides 256-500, 1,000 classes)
   written on the card by recordio.pack_img (nvJPEG, quality 95) into a
   .rec and .idx; mx.io.ImageRecordIter as
   examples/image_classification/common/data.py makes it (shuffle, random
   crop and mirror, 8 decode workers each on its own CUDA stream,
   nvJPEG) feeds Module.fit on phase 10's bf16 ResNet-50 for 2 epochs of
   3 batches, then score on the val iterator (resize 256, centre crop).
   Gated by record_gate: 32 kernel launches a fit step, 0 in score; (a)
   one step on an ImageRecordIter batch bit-equal to the same batch
   through NDArrayIter; (b) each image of a batch decoded within 30 dB
   PSNR of its pixels; (c) the augmentation on the card against cpu(0)
   (crop and flip equal, resize within a level); (d) an epoch on 2
   workers equal to one on 8; (e) the kernel against its plain version
   at every pair shape of the step. Printed: fit images/s beside phase
   10's, the iterator alone, nvJPEG's decode ms, the input stall, the
   device-busy share, peak memory;
19. ssd: 256 seeded detection JPEGs (1-6 boxes of 20 classes) written
   on the card; mx.image.ImageDetIter (batch 32, 3x300x300, random crop
   0.5, pad 0.5, mirror, mean) feeds Module.fit on
   models.ssd.get_symbol_train(num_classes=20) in float32 (Xavier, SGD
   lr 0.002, momentum 0.9, wd 5e-4) for 2 epochs of 8 batches; then the
   detection symbol (nms 0.45, topk 400) on the trained weights. Gated
   by ssd_gate: MultiBoxTarget and MultiBoxDetection on the card
   against cpu(0) on one step's inputs (targets, masks, ids and order
   equal, floats within 1e-5), a train step at batch 2 on the card
   against cpu(0) within cpu(0)'s own spread, finite losses, no
   hand-written kernel launched. Printed: step ms and images/s,
   MultiBoxTarget's device ms, the detection forward's ms and NMS's,
   kernel launches a step, the device-busy share, peak memory, the loc
   loss by epoch.
20. fleet: one serving_fleet.ModelRegistry on gpu(0) holds phase 11's
   bf16 ResNet-50 checkpoint three ways (resnet50, SLO 50 ms priority
   1; resnet50-int8, quantize='int8'; resnet50-paged, page_dtype='int8',
   paged in from an int8 image in pinned host memory), ptb-lstm (a
   ContinuousEngine over the PTB LSTM LM's cell at phase 14's widths,
   stepped once a token and scoring the next one, 32 slots,
   tick_chunk='auto') and a pinned gpt2-medium scorer (TransformerLM at
   phase 3's widths, bf16, on the flash kernel: 24 launches a request),
   under a byte budget of gpt2 + resnet50 + ptb-lstm + half of
   resnet50-int8, so that one ResNet tenant is resident at a time. An
   HttpFront on 127.0.0.1 takes 16 client threads for 20 s (8 1-image
   resnet50 clients, 4 4-image clients alternating resnet50-int8 and
   resnet50-paged, 2 sending 256 PTB sentences, 2 sending 1024-token
   scoring requests), then a 3 s burst at 4 times the clients. Gated by
   fleet_gate: (a) every answer agrees with a direct serve (ResNet
   within SERVE_SERIAL_REL_TOL of a serial forward, the scorer and
   ptb-lstm bit for bit); (b) 3 evict / re-warm cycles of each ResNet
   tenant, no program built after warm-up, the peak resident bytes
   within the budget, and an eviction giving back 90 % of the tenant's
   bytes to the allocator; (c) every reply 200 or 429, each 429 with
   Retry-After, /healthz and /statsz parsing, an Overloaded shed in the
   burst; (d) ptb-lstm bit-equal co-resident against solo, at K = 4
   and 16 against 1, staged against serialized and across an
   export_state / admit_state hand-over; (e) one 60-token sequence
   within 1e-5 of cell.unroll(60) on the card and within cpu(0)'s own
   spread of cpu(0)'s engine; (f) the flash kernel against its plain
   version at (1, 16, 1024, 64) bf16, 24 launches a scorer request, no
   backward or conv launch. Printed: per tenant requests, p50 / p99,
   answers/s and 429s; the registry's loads, evictions, page-ins and
   their ms, resident and peak bytes; ptb-lstm's ticks, chunks, auto-K,
   boundary wait, lone path, launches and host / device ms a tick, the
   chunk ladder K = 1, 4, 16, 32 and the convoy baseline; the scorer's
   ms a request; the device-busy share and peak memory.
21. dist_ps: `python -m mxnet_tpu_torch.tools.launch -n 2 -s 1 --launcher
   local` runs two worker processes of this script on gpu(0) and one
   CPU parameter server (`python -m mxnet_tpu_torch.kvstore_server`);
   each worker trains the bf16 ResNet-50 of phase 10 at full width on 64
   images a step of its own half of a seeded set with
   Module.fit(kvstore='dist_sync') and phase 10's momentum SGD, 1
   warm-up, 6 timed and 2 profiled steps. Gated: (a) 32 conv launches a
   worker step; (b) the ranks' weights bit-equal at the end; (c) the
   server's first update of conv0_weight, stage3_unit1_conv2_weight and
   fc1_weight bit-equal to the port's optimizer on cpu(0) over the sum
   of the two workers' pushes; (d) a server that never initialized CUDA.
   Printed: each rank's median step ms, the wire bytes of a worker step,
   the server's update ms a round, the device's busy share.
22. dist_coord: the same network through `tools.launch -s 0` and the
   coordinator's allreduce, 32 images a rank and step, a
   CheckpointManager(every_n_steps=2, incremental=2) each; arms:
   straight (world 1, 10 steps); elastic (world 2 on the same batches,
   MXNET_TPU_FAULT_KILL_AT_STEP=7 on rank 1, --elastic --elastic-shrink:
   rank 0 sees the death by heartbeat, commits, prints PREEMPTED and
   exits 75, the relaunch at world 1 resumes and ends bit-equal to the
   straight arm); shard (world 2 on the ring, each rank its own half:
   the ranks bit-equal, the allreduced probe gradients the bit-exact
   sum of the ranks'). Then, on the card, the straight arm's last commit
   exported by export_serving_checkpoint answers bit-equal to its final
   parameters, and InferenceEngine.apply_delta of the last delta on an
   engine serving the commit before it answers bit-equal to an engine
   loaded in full. Printed: each arm's length and step ms; phase 21
   also the frame MAC the workers and the server ran.
23. train_serve: a fleet_supervisor.FleetSupervisor of two replica
   processes on gpu(0) serves phase 11's bf16 ResNet-50 checkpoint
   (max_batch 4); in this process Module.fit trains the same network
   from it at 64 images a step (phase 10's 256 cut so that three
   processes share the card), a CheckpointManager(every_n_steps=2)
   committing and a CheckpointPusher(frac=0.5, delta=True) pushing each
   commit into the fleet as a canary while 2 closed-loop clients, each
   a process of its own, post post_with_backoff predicts through the
   router. Knobs: heartbeat
   0.25 s, dead after 1.5 s, canary min samples 6, promote samples 12,
   MXNET_TPU_FAULT_CANARY_DEGRADE_MS='@v1:100' in the replicas. Gated
   by loop_gate: 32 conv launches every trainer step; the trainer sees
   the first candidate rolled back; a replica SIGKILLed while a later
   push is judged respawns and serves the promoted arm; a candidate
   promoted; at least one push as a delta and one in full, none
   refused; no request lost, every reply 200; the router's answers
   after the promotion within SERVE_SERIAL_REL_TOL of a Predictor on
   gpu(0) over the last promoted export. Printed: the replicas' boot
   s, push -> verdict s per candidate, delta bytes against full bytes,
   the router's p50 / p99 during the pushes, SIGKILL -> healthy respawn
   s, the trainer's step ms with the fleet up and alone, commits
   skipped by the writer, fleet_supervisor_stats() and loop_stats().
24. router: two in-process ReplicaServers on gpu(0), each serving a
   FleetScorer over phase 20's GPT-2-medium TransformerLM on the flash
   kernel (registered by loader=), behind one FleetRouter; a shadow
   arm with the same weights tees the traffic; then one replica closes
   while 2 clients send. Gated by router_gate: every answer bit-equal
   to the scorer called directly, 24 flash launches a request, no
   shadow divergence, the requests in flight at the close answered 200
   or a typed 502 / 503 within the deadline and none hung, the
   survivor bit-equal after it.
25. artifact: Predictor.export_artifact writes phase 11's checkpoint as
   a .pt2 and a .manifest; `python3 -I` importing torch alone loads it
   with torch.export.load and runs it on cuda:0 (held against
   Predictor.forward within SERVE_SERIAL_REL_TOL; bit-equality
   reported); export_compiled(batch_buckets=(1, 8, 32)) twice, the
   second all exec_cache hits; the C predict API built by g++
   (_build.c_predict_library), and examples/c_predict/predict.c
   linked against it classifying a seeded image as the Predictor does,
   on the CPU (dev_type 1, as written) and on the card (dev_type 2,
   through a shim compiled beside it). No hand-written kernel launches
   here. Gated by artifact_gate.
26. mesh_step: the train step of phase 5 (GPT-2-medium widths, bf16, 24
   layers, 8 x 1024 tokens) through the mesh path: one rank in an NCCL
   group (parallel.mesh.init_process_group, a file:// rendezvous), mesh
   {'data': 1, 'sp': 1, 'model': 1}, place_params, make_train_step(cfg,
   mesh), attention on the flash kernels (an sp axis of one rank runs no
   ring). Gated: NCCL; its loss within LM_NLL_ATOL of the one-device
   step's on the same weights and tokens, every gathered updated
   parameter within MESH_W_RTOL (one bf16 step) of the one-device step's;
   24 forward, 24 dK/dV and 24 dQ launches a step; no byte staged
   through the host; in float32 at FP32_LAYERS layers one step's updates
   within MESH_UPDATE_RTOL of the one-device step's (updates_within).
   Printed: the step ms beside phase 5's, the device-busy share.
27. ring: MESH_RANKS processes (parallel.mesh.spawn) share the card in
   a gloo group, mesh {'data': 1, 'sp': 2, 'model': 2}: 8 heads a model
   shard, 512 tokens an sp shard, the ring's hops on the flash kernels,
   the collectives staged through pinned host memory. Gated by
   ring_gate: 24 forward, dK/dV and dQ launches a step on each sp-rank-0
   process and 48 on each sp-rank-1 process (144 forward launches over
   the ranks); the bf16 loss, the same on every rank, within LM_NLL_ATOL
   of the one-device loss; in float32 at FP32_LAYERS layers one step's
   gathered parameters within F32_TOL and its updates within
   MESH_UPDATE_RTOL of the one-device step's; on each rank the diagonal
   hop's kernels (hop 0, causal) and on each sp-rank-1 rank the past
   hop's (sp-rank 0's block, unmasked), at the main path's shape: the
   forward against its plain version (FWD_TOL, LSE_TOL), the dK/dV and
   dQ kernels with the ring's merged lse and D against theirs (BWD_TOL);
   attention(impl='ring') against impl='full' in float32 at
   dryrun_multichip phase (j)'s shape over sp = 4, plain and flash,
   within F32_TOL. Printed: each rank's step ms and device ms of one
   profiled step, the bytes staged through the host a step, the card's
   busy share (the ranks' device ms summed over the slowest median step).
28. dp_mesh: phase 10's bf16 ResNet-50 (batch 256, seeded He-normal)
   through Module(context=[gpu(0)]) as the one rank of a data mesh over
   NCCL (world 1): DP_STEPS steps with ZeRO 0, its optimizer states
   carried into ZeRO 1 for DP_STEPS more, then fit(bulk=2) on
   io.prefetch_to_device(mesh=). Gated: the parameters and moving
   statistics against the one-device Module's on the same batches
   (MESH_W_RTOL; bit-equal expected), 32 conv launches a step, no byte
   staged. Printed: the step ms beside the one-device Module's, the
   optimizer-state bytes with ZeRO 0 and 1.
29. dp_ranks: DP_RANKS workers of the port's tools/launch.py with
   MXNET_TPU_DIST_JAX=1 share the card over gloo and train the same
   network through Module(context=[gpu(0), gpu(1)]) at global batch
   256, ZeRO 1 (dp_worker). Gated by dp_gate: on each rank 32 conv
   launches a step and the kernel at each of its pair shapes (batch
   128) against its plain version; the first step's loss and gathered
   outputs within DP_LOSS_ATOL / DP_OUT_ATOL of phase 28's world-1 step;
   parameters and moving statistics equal on both ranks; a rank's
   optimizer state at most DP_STATE_SHARE of phase 28's ZeRO-0 bytes;
   a float32 step of the cut ResNet's updates within MESH_UPDATE_RTOL
   of the one-device step's, which per-rank statistics planted must
   fail; the ranks' elastic ZeRO checkpoint restored at world 1 with
   the gathered momenta and masters bit for bit. Printed: each rank's
   step ms, collectives and bytes staged a step, the card's busy share.
30. gluon_fused: gluon.fuse_step trains gluon.model_zoo.vision.
   resnet50_v1 (1000 classes, 3x224x224) in bf16 at batch 256, SGD
   momentum 0.9, wd 1e-4, float32 masters, seeded Xavier weights: GF_STEPS
   single fused steps, then from the same weights bulk(GF_BULK) and a
   step_ahead-0 step. Gated by gf_gate: GF_PAIRS (21, counted from the
   code by gf_pairs) conv launches and routed pairs a step; the kernel at
   every routed shape against its plain version; the first loss within
   GF_LOSS_ATOL of the unfused step's (autograd.record + Trainer.step,
   phase 13's path) on the same weights and batch; bulk(2) bit-equal to
   two single steps, and the step_ahead-0 step's loss and weights to the
   step_ahead-1 run's; a float32 cut v1 ResNet's step with its pairs on
   the (float32) kernel within MESH_UPDATE_RTOL (updates_within) of the
   unrouted step, which statistics planted from the wrong pair must
   fail. Printed: the step ms and images/s, bulk's.
31. sparse: matrix factorization at MovieLens-20M's counts (138,493
   users, 27,278 movies, rank 64, float32, both tables sparse_grad)
   through Module on gpu(0), batches of 4096 Zipf-skewed (user, item)
   pairs, SGD momentum 0.9. Gated by mf_gate: after MF_STEPS rows-only
   steps the rows no batch touched, weight and momentum, unchanged; a
   plain-SGD step bit-equal to the dense Module's; the embed_* counters'
   touched bytes as the rungs give them, below the dense update's; two
   runs bit-equal; then MF_RANKS workers of the launcher
   (MXNET_TPU_DIST_JAX=1) share the card over gloo with the tables
   striped over the data mesh: a rank's table bytes within MF_SHARE of
   world 1's, the step's updates within MESH_UPDATE_RTOL of world 1's on
   the same global batch, their elastic checkpoint restored at world 1
   bit for bit; last InferenceEngine(hot_rows=8192) serves the predict
   symbol from pinned host tables, bit-equal to the full-table engine.
   Printed: the step ms, the touched share, the ranks' table shares, the
   hot-row hits, misses and device table bytes against the full tables'.
32. pipe: the bf16 GPT-2-medium LM in two pipeline stages (blocks 0-11
   and 12-23), two launcher workers sharing the card over gloo on a
   {'data': 1, 'pipe': 2} mesh, parallel/pipeline.make_pipe_step_fn
   over transformer.pipe_lm_fns: PIPE_STEPS steps of BATCH x SEQ in
   PIPE_MICRO microbatches, SGD momentum 0.9. Gated by pipe_gate: each
   rank launches each flash kernel PIPE_STAGE_LAUNCHES (48) times a step
   (no bubble tick runs anything); the bytes a rank stages a step equal
   pipe_staged_bytes' count from the code; the bubble the engine
   recorded from its stage calls 0.2 and the parameter bytes of the
   leaves it returned below world 1's; the first loss within LM_NLL_ATOL
   of the tied one-device LM's, every loss of the one-device steps' of
   the same untied function, their updates within PIPE_UPDATE_RTOL
   (updates_within, PIPE_STEPS roundings), and a float32 run at
   FP32_LAYERS layers within MESH_UPDATE_RTOL; each fault of
   PIPE_PLANTS (microbatch 1 dropped, counted twice, the stem and head
   gradients not summed over 'pipe') planted into the float32 run fails
   that gate against the clean run, and microbatch 1 dropped from the
   bf16 run fails the bf16 gate; the flash forward and backward kernels
   at a microbatch's shape (2, 16, 1024, 64), bf16 and float32, within
   phases 2 and 4's tolerances of their plain versions. Printed: a
   rank's step ms and the card's busy share.
33. pipe4: four launcher workers on a {'data': 2, 'pipe': 2} mesh train
   a float32 net of a Dense stem, 8 identical Dense(1024, tanh) and a
   head by fuse_step(pipeline=(2, 4)), with and without ZeRO-1, and its
   symbol by Module.fit(pipeline=(2, 4)). Gated by pipe4_gate: each
   within atol 3e-6 / rtol 1e-4 of the one-device step, ZeRO-1's state
   half the replicated arm's, a re-created trainer the same bits with
   the same computation fingerprint and step signatures.
34. moe: gluon.nn.MoE at Switch-Base-8's widths (d_model 768, d_ff
   3072, 8 experts, capacity factor 1.25) between two Dense layers by
   fuse_step on 4096 tokens a step, at world 1 twice and over a data
   mesh of phase 32's two ranks (4 experts each), and one
   make_moe_train_step over an 'expert' axis of 2. Gated by moe_gate:
   routed + dropped tokens are the tokens fed, the per-expert tables and
   the blocks' counts equal the profiler's, the ranks within atol 3e-6 /
   rtol 1e-4 of world 1, two runs bit-equal.
35. hybrid: `tools.launch -n 2 -s 1 --ranks-per-worker 2`: two workers of
   two ranks each (four processes sharing the card over gloo), each
   worker's ranks a data mesh of their own, one CPU parameter server;
   every rank checks the probe key's sync-SGD arithmetic, then
   Module(context=[gpu(0), gpu(1)]) trains the bf16 ResNet-50 at 64
   images a rank step (256 in all) with kvstore 'dist_sync', 1 warm-up,
   2 timed and 1 profiled step; then the reductions over the batch
   (HYBRID_BR_CASES) on the worker's mesh against one device, and a
   bf16 ResNet-50 step whose loss is MakeLoss(mean(softmax_cross_
   entropy)). Gated by hybrid_gate: the probe exact, 32 conv launches a
   rank step, one push a key and round from each worker's leader and
   none from the other rank, the pushed gradient the sum of the
   worker's two ranks' own, the four ranks' weights bit-equal, the
   server's update bit-equal to the optimizer on cpu(0), a server that
   never initialized CUDA, the kernel at a rank's shapes, every
   reduction within the CPU tests' tolerance, the loss step within
   DP_LOSS_ATOL of one device, each rank finished and exiting 0 through
   the interpreter;
36. custom: the bf16 ResNet-50 at batch 256 through Module with a Custom
   numpy softmax-loss head (examples/numpy_ops/custom_softmax.py's) for
   two steps against SoftmaxOutput(normalization='batch'), a legacy
   NumpyOp step, and test_utils.check_consistency of a conv ->
   BatchNorm pair over cpu float32, gpu float32 and gpu bfloat16.
   Gated by custom_gate: 32 conv launches a step, both steps' losses,
   the float32 weights and masters within MODULE_STATE_REL of the
   SoftmaxOutput steps' (the bf16 weights and momenta reported) and a
   head whose backward is planted x1.5 outside it, the NumpyOp
   bit-exact, check_consistency within 1e-1 with bfloat16 and
   1e-3 over float32 alone;
37. native: the native runtime (csrc/native/, host C++ on OpenCV, built
   by _build.native_library beside phases 2 on): mx.engine on the native
   ThreadedEngine (writes in push order, readers between two writes,
   duplicate variables refused, ENGINE_PUSHES seeded pushes over
   ENGINE_VARS variables ending as on NaiveEngine), RecordIO between the
   C writer and reader and recordio.MXRecordIO both ways, then
   ImageRecordIter(use_native=True, 8 threads) over phase 18's .rec:
   alone against the nvJPEG iterator (images/s), NATIVE_RESETS resets
   mid-epoch each followed by an epoch bit-equal to the first, and
   Module.fit on the bf16 ResNet-50 at batch 256 fed by it. Gated by
   native_gate: 32 conv launches a step, finite losses whose last
   epoch's mean is below the first's;
38. c_train: C_TRAIN_PROGRAM, a C program with no Python in its source,
   linked against the port's C API library, loads the bf16 ResNet-50's
   symbol JSON and seeded parameters, binds it on the card (dev_type 2,
   batch 64, grad_req write: the stem's pair stays on the route, 33
   launches a step) and takes C_TRAIN_STEPS SGD steps fed by
   MXTDataIterCreate("ImageRecordIter", use_native=1) through
   MXTNDArrayCopyFromNDArray, in a process of its own beside phases
   28-37; the same program's function then runs twice in this process
   through ctypes, where the conv launches are counted, and its first
   run's steps are made again past the C API (c_train_replay:
   Executor.forward_backward on the recorded batches, an SGD updater
   made in Python). Gated by c_train_gate: the two runs here bit-equal,
   the program's batches, outputs and weights bit-equal to the first
   run's and the replay's to the program's (phase 36's bounds instead
   only where C_TRAIN_NONDETERMINISTIC names a kernel); cpp-package's
   rec_train.cpp, as written, trains on the CPU through the same
   library.

The phases do not run in their numbers' order. After phase 20 the
launches of phases 21, 22 (its three arms), 31 and 33 start together
and share the card, and phases 7 and 14-17, which gate no time, run
beside them; phase 29's launch starts as soon as phase 21's has ended,
phase 32's (phase 34's ranks too) as soon as phase 31's has, and phase
23 once every launch has ended. Phase 35's launch starts after phase 24
and runs beside phase 25, which gates no time. Their host times and the
ranks' step times are taken beside each other's. Phase 25's runner and C programs run
beside its export, and the SASS is dumped during phases 2-3. Phase 18
keeps its .rec for phases 37 and 38, which run last: phase 38's C
program and rec_train.cpp start after phase 27 and run beside phases
28-37. Each
phase's host seconds are printed as it ends, and all of them on a
"phase seconds" line before the kernels line.

It prints one JSON line with every kernel's numbers, then the card's
name and power limit from nvidia-smi, and last
{"ok": true, "device": {...}}. It imports neither JAX nor mxnet_tpu, and
needs a CUDA device and the repository beside it.

--mutants builds each of FWD_MUTANTS and BWD_MUTANTS (a rounding left
out, a tile skipped, the causal mask widened, the forward's running
correction left out), CONV_MUTANTS of the float32 kernel (a tap skipped,
the padding one pixel off, one M tile's statistics left out) and
CONV_SM90_MUTANTS of the bf16 one (a K step skipped, a tap's copy one
pixel off, one tile's partials left out, y truncated) in a copy of the
port under build/mutants/ and fails unless phase 2's LM case fails every
forward mutant, phase 4's LM case every backward mutant, phase 6's
ragged float32 case every FMA conv mutant, its bf16 main case every
tensor-core conv mutant, and the unchanged copy passes all four.
"""
import atexit
import contextlib
import faulthandler
import json
import math
import os
import random
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

SEED = 0
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense
# bf16 and fp16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float16': 989e12, 'float32': 67e12}

GPT2_MEDIUM = dict(vocab=50257, dim=1024, heads=16, layers=24, mlp_mult=4)
BATCH, SEQ, REQUESTS = 8, 1024, 4

# the float32 forward kernel against its plain version, max |difference|
# allowed: the JAX package's own flash tolerance (tests/test_parallel.py);
# lse is float32 from the same inputs in both.
F32_TOL = dict(rtol=2e-4, atol=2e-5)
LSE_TOL = {'float32': dict(rtol=2e-4, atol=2e-5),
           'bfloat16': dict(rtol=0.0, atol=1e-3),
           'float16': dict(rtol=0.0, atol=1e-3)}
# the 16-bit forward kernel against the online plain version at its
# 64-key tile (cuda_ops.flash_attention_online_reference), element by
# element, as BWD_TOL below: both round p to v's type before P.V and the
# output to q's, so they differ only where another fp32 summing order of
# s or of P.V moves a value across a rounding: one 16-bit step of the
# value plus 1e-3 of the largest. The share that differs at all is set
# from a CPU emulation of that order (s summed in 16-product blocks as
# the tensor cores add; `python tests/test_torch_flash_forward_sm90.py`):
# 0.04-0.11 % of bf16 outputs, but 0.96 % of float16 ones at
# (1, 8, 512, 64) and 2.98 % at decode, since a float16 step is 8 times
# finer; p left unrounded moves over 37 % in both.
FWD_TOL = {'bfloat16': dict(rtol=2.0 ** -7, atol=0.0, atol_of_max=1e-3,
                            differ=1e-2),
           'float16': dict(rtol=2.0 ** -10, atol=0.0, atol_of_max=1e-3,
                           differ=0.1)}
# the kernel's key tile (BN in csrc/flash_attention_sm90.cu)
FWD_BLOCK_K = 64
# flash against plain attention through 24 bf16 layers: logits of size
# up to about 4, where a bf16 step is 1/32
LM_LOGIT_ATOL = 0.125
LM_NLL_ATOL = 5e-3
# a backward kernel against its plain version, element by element:
# |got - ref| <= rtol * |ref| + atol + atol_of_max * max|ref|, and at
# most a share `differ` of the elements may differ at all. float32 at
# the JAX package's flash-gradient tolerance (tests/test_parallel.py);
# every element may differ there, in the last bits of another summing
# order. bfloat16: the kernel and its plain version take the same
# roundings (p and ds to bf16 before their products, the gradient on
# output), so they differ only where another fp32 summing order moves a
# value across a bf16 rounding: one bf16 step of the value (2^-7 of it
# at most), plus 1e-3 of the largest gradient for elements near 0 and
# for a flipped rounding of one p or ds. Such flips are rare, under
# 0.1 % of the elements when the sums run in float64 instead, while a
# missing rounding of p or ds moves over 30 % of its gradient by a step
# (both emulated on the CPU in tests/test_torch_flash_backward.py), so
# at most 1 % may differ.
# float16: one float16 step, and at most 5 %: the same emulation moves
# 0.3-0.7 % of float16 gradients, where a rounding left out moves 40 %
# (tests/test_torch_flash_forward_sm90.py, the backward's emulation).
BWD_TOL = {'float32': dict(rtol=2e-4, atol=2e-5, atol_of_max=0.0,
                           differ=1.0),
           'bfloat16': dict(rtol=2.0 ** -7, atol=0.0, atol_of_max=1e-3,
                            differ=1e-2),
           'float16': dict(rtol=2.0 ** -10, atol=0.0, atol_of_max=1e-3,
                           differ=5e-2)}
# the LM's gradients on the flash kernels against plain attention, both
# bf16, as ||g_flash - g_plain|| / ||g_plain|| per parameter: plain
# attention rounds its scores and softmax to bf16 (2^-8) where the
# kernels keep fp32, and those differences add through 24 layers of
# backward (0.018 at most on an H100 at this seed, about five bf16
# steps); a gradient that is cut or wrong gives about 1
GRAD_REL_TOL = 0.05
TRAIN_STEPS = 4
LR = 0.1                 # the JAX package's make_train_step default
FP32_LAYERS, FP32_STEPS = 4, 5

# phase 2: name -> (q shape, kv length, dtype, iterations), all causal.
# 16-bit runs on the tensor-core kernel, float32 on the FMA one: the LM's
# shape and decode (a 64-row tile of which 48 rows are padding) in both
# 16-bit types, a ragged float32 one, head_dim 192 (column groups of 128
# and 64), a ragged head_dim of 100 (not a multiple of 8: plain loads
# instead of TMA) in both kernels, and head_dim 320 in both (the
# contraction in chunks of 128; column groups of 256 in the FMA kernel)
FWD_CASES = {
    'lm': ((BATCH, 16, SEQ, 64), SEQ, 'bfloat16', 20),
    'lm_f16': ((BATCH, 16, SEQ, 64), SEQ, 'float16', 20),
    'decode': ((BATCH, 16, 16, 64), SEQ, 'bfloat16', 50),
    'decode_f16': ((BATCH, 16, 16, 64), SEQ, 'float16', 50),
    'ragged_f32': ((2, 4, 1000, 128), 1000, 'float32', 20),
    'head192': ((BATCH, 4, SEQ, 192), SEQ, 'bfloat16', 10),
    'head100_f32': ((2, 3, 300, 100), 300, 'float32', 20),
    'head100': ((2, 3, 300, 100), 300, 'bfloat16', 20),
    'head320': ((2, 4, 512, 320), 512, 'bfloat16', 10),
    'head320_f32': ((1, 2, 200, 320), 200, 'float32', 10),
}
# phase 4: name -> (q shape, kv length, dtype, lse cotangent, iterations),
# all causal. 16-bit runs on the tensor-core kernels, float32 on the FMA
# ones: the LM's shape (bf16 and float16), decode, head_dim 192 (groups of
# 128 and 64), a ragged head_dim of 100 (plain loads instead of TMA;
# columns padded to 112; bf16 and float16), rectangular with an lse
# cotangent, head_dim 320 (the contraction in chunks of 128), and float32
# cases of each kind
BWD_CASES = {
    'lm': ((BATCH, 16, SEQ, 64), SEQ, 'bfloat16', False, 10),
    'lm_f16': ((BATCH, 16, SEQ, 64), SEQ, 'float16', False, 10),
    'decode': ((BATCH, 16, 16, 64), SEQ, 'bfloat16', False, 20),
    'ragged_f32': ((2, 4, 1000, 128), 1000, 'float32', False, 10),
    'rect_glse_f32': ((2, 4, 300, 64), 700, 'float32', True, 10),
    'head192': ((BATCH, 4, SEQ, 192), SEQ, 'bfloat16', False, 5),
    'head100_f32': ((2, 3, 300, 100), 300, 'float32', False, 10),
    'head100': ((2, 3, 300, 100), 300, 'bfloat16', False, 10),
    'head100_f16': ((2, 3, 300, 100), 300, 'float16', False, 10),
    'rect_glse': ((2, 4, 300, 64), 700, 'bfloat16', True, 10),
    'head320': ((2, 4, 512, 320), 512, 'bfloat16', False, 5),
    'head320_f32': ((1, 2, 200, 320), 200, 'float32', False, 5),
}
# output columns of one block of the backward kernels: the tensor-core
# (16-bit) kernels' groups, the FMA (float32) kernels' groups
BWD_GROUP = {'bfloat16': 128, 'float16': 128, 'float32': 256}
# phase 3's second model: head_dim 192 through the whole LM
LM_WIDE_HEADS = dict(GPT2_MEDIUM, dim=768, heads=4, layers=2)
# phases 3 and 5 in float16: full width, cut depth. The train step's
# embedding is drawn at std 0.05, not 0.02: at 0.02 the activations'
# mean square (4e-4) makes RMSNorm's backward overflow float16
# (rsqrt(var)^3 = 1.25e5 > 65504) into NaN gradients, in the JAX package
# as in the port (tests/test_torch_flash_forward_sm90.py), on either
# attention path; at 0.05 (8e3) every gradient is finite.
# The flash and plain gradients are compared on the loss times
# F16_LOSS_SCALE, as float16 training scales its loss (torch.amp's
# GradScaler): the loss is a mean over 8192 tokens, and without the scale
# most of layer 0's float16 gradients fall below float16's smallest normal
# (6.1e-5), where each path rounds them to a few bits and the two differ
# by 7.55 % in relative norm (an H100 run of this script), with no kernel
# at fault (the plain versions alone on the CPU:
# `python tests/test_torch_flash_forward_sm90.py`).
F16_LAYERS = 4
F16_EMBED_STD = 0.05
F16_LOSS_SCALE = 2.0 ** 12
# --mutants: edits of csrc/flash_attention_bwd_sm90.cu (text,
# replacement), the kernels of phase 4's bf16 LM case, each of which that
# case must catch: p or ds rounded toward zero (fp32 bits cut to bf16), the
# first q tile of dK/dV or the last k tile of dQ skipped, the causal mask
# one key wide
_TRUNCATE = ('[](float lo, float hi) { return (__float_as_uint(lo) >> 16) | '
             '(__float_as_uint(hi) & 0xffff0000u); }(')
BWD_MUTANTS = {
    'p_truncated': ('pt[ks][i] = pack2_rn<T16>(', 'pt[ks][i] = ' + _TRUNCATE),
    'dkdv_ds_truncated': ('dst[ks][i] = pack2_rn<T16>(',
                          'dst[ks][i] = ' + _TRUNCATE),
    'dq_ds_truncated': ('ds[ks][i] = pack2_rn<T16>(',
                        'ds[ks][i] = ' + _TRUNCATE),
    'dkdv_q_tile_skipped': ('max(r0 - offset, 0) / BN : 0;',
                            'max(r0 - offset, 0) / BN + 1 : 0;'),
    'dq_k_tile_skipped': ('return make_int2(0, last + 1);',
                          'return make_int2(0, last);'),
    'mask_one_key_wide': ('k <= q + offset)', 'k <= q + offset + 1)'),
}
# --mutants: edits of csrc/flash_attention_sm90.cu, the kernel of phase
# 2's bf16 LM case, each of which that case must catch: p rounded toward
# zero, the running correction of acc left out, the last live k tile (the
# diagonal's) skipped, the causal mask one key wide
FWD_MUTANTS = {
    'fwd_p_truncated': ('pa[ks][i] = pack2_rn<T16>(',
                        'pa[ks][i] = ' + _TRUNCATE),
    'fwd_correction_left_out': ('e < 2; ++e) acc[4 * j + 2 * h + e] *= corr;',
                                'e < 2; ++e) (void)corr;'),
    'fwd_last_tile_skipped': ('const int last = last_k_tile(r0, p);',
                              'const int last = last_k_tile(r0, p) - 1;'),
    'fwd_mask_one_key_wide': ('(!p.causal || k <= q + offset));',
                              '(!p.causal || k <= q + offset + 1));'),
}
# the tensor-core kernels and the 16-bit types each is instantiated for,
# every instance of which must hold tensor-core instructions (HGMMA) in its
# SASS
SM90_KERNELS = {'flash_fwd_sm90': ('bfloat16', 'float16'),
                'flash_bwd_dkdv_sm90': ('bfloat16', 'float16'),
                'flash_bwd_dq_sm90': ('bfloat16', 'float16'),
                'conv_bn_stats_sm90': ('bfloat16',)}
# a 16-bit type as it appears in a mangled instance name; the conv kernel
# is templated on its tile width alone, so its instances name no type
SM90_TYPES = {'bfloat16': '__nv_bfloat16', 'float16': '6__half'}
SM90_UNTYPED = frozenset({'conv_bn_stats_sm90'})

# phase 6: name -> (x NHWC, w HWIO, stride, pad, dtype): the main
# ResNet-50 shape, a strided 1x1 of the ResNet-50 body, a ragged float32
# case (M = 507 and Cout = 96 fill no tile, Cin = 24 no chunk), and a
# stem-like 7x7 stride-2 conv on a non-square image whose Cin = 3 and
# Cout = 30 take the kernel's element-wise loads and stores
CONV_BATCH = 256
CONV_CASES = {
    'main': ((CONV_BATCH, 56, 56, 64), (3, 3, 64, 64), (1, 1), (1, 1),
             'bfloat16'),
    'strided': ((CONV_BATCH, 56, 56, 256), (1, 1, 256, 512), (2, 2), (0, 0),
                'bfloat16'),
    'ragged_f32': ((3, 13, 13, 24), (3, 3, 24, 96), (1, 1), (1, 1),
                   'float32'),
    'odd_bf16': ((2, 15, 17, 3), (7, 7, 3, 30), (2, 2), (3, 3), 'bfloat16'),
}
CONV_GRAD_CASE = 'strided'
# the conv's y against its plain version, element by element. bf16: both
# round the same fp32 sum of the same products, taken in another order,
# so they differ only where that order moves a value across a rounding:
# one bf16 step of the value (2^-7 of it at most), plus 1e-3 of the
# largest for values near 0, and at most 1 % of the elements may differ
# at all (a tap skipped or the padding moved changes most of them).
# float32: two summing orders of the K = kh*kw*Cin products each lie
# within K * 2^-24 of the sum of the products' magnitudes, (|x| conv |w|)
# at that element, so |got - ref| <= 2 * K * 2^-24 * (|x| conv |w|).
CONV_Y_TOL = dict(rtol=2.0 ** -7, atol=0.0, atol_of_max=1e-3, differ=1e-2)
CONV_F32_ORDERS = 2
# s1 and s2 against the plain version's, relative to sum |y| and sum y^2
# per channel. The longest chain of float32 additions behind a sum: in the
# bf16 tensor-core kernel (csrc/conv_bn_stats_sm90.cu) a thread's 2 rows
# (1 add), the lanes of its column (3), the 8 warps of the 128-row tile
# (8); in the float32 FMA kernel (csrc/conv_bn_stats.cu) 8 rows, then 16
# row groups; then, for both, the finalize kernel's 8 groups of up to 784
# tiles at batch 256, and the 8 groups: at most 1 + 3 + 8 + 784 + 8 = 804
# (bf16) or 8 + 16 + 784 + 8 = 816 (float32) adds, under 1,024, so each
# lies within 1024 * 2^-24 = 2^-14 of the exact sum on that scale, and the
# plain version's tree sums closer. One 128-row tile of 802,816 left out
# moves s2 by about 1.6e-4 of it.
CONV_STATS_RTOL = 2.0 ** -14
# --mutants: edits of csrc/conv_bn_stats.cu, the float32 (FMA) kernel and
# the finalize both kernels share, each of which phase 6's ragged float32
# case (CONV_FMA_MUTANT_CASE) must catch: a tap skipped, the padding one
# pixel off, one M tile's partials left out of the second pass
CONV_FMA_MUTANT_CASE = 'ragged_f32'
CONV_MUTANTS = {
    'conv_tap_skipped': ('wi >= 0 && wi < s.w;',
                         'wi >= 0 && wi < s.w && tap != taps / 2;'),
    'conv_pad_off_by_one': ('const int hbase = ho * s.sh - s.ph;',
                            'const int hbase = ho * s.sh - s.ph + 1;'),
    'conv_partial_left_out': (
        'for (int b = g; b < m_tiles; b += FIN_GROUPS) {',
        'for (int b = g; b < m_tiles; b += FIN_GROUPS) {'
        ' if (b == m_tiles / 2) continue;'),
}
# --mutants: edits of csrc/conv_bn_stats_sm90.cu, the bf16 tensor-core
# kernel, each of which phase 6's main case must catch: one K step's
# products (the middle tap's) skipped, the middle tap's im2col copy one
# pixel off along w, one M tile's partials left out (written as 0), y
# rounded toward zero instead of to nearest in the 64-wide instance, the
# main case's (in the 128-wide one too, the edit left ptxas short of
# registers for the wgmma pipeline, C7511, which phase 1 refuses before
# any case runs)
CONV_SM90_MUTANTS = {
    'sm90_k_step_skipped': (
        'const int ksteps = (min(p.cin - c0, BK) + 15) / 16;',
        'const int ksteps = (min(p.cin - c0, BK) + 15) / 16 * (it != nt / 2);'),
    'sm90_tap_coordinate_off': (
        'img, (uint16_t)dx,', 'img, (uint16_t)(dx + (tap == taps / 2)),'),
    'sm90_partial_left_out': (
        'for (int wp = 0; wp < WARPS; ++wp)',
        'for (int wp = 0; wp < WARPS * (m_tile != p.m_tiles / 2); ++wp)'),
    'sm90_y_truncated': ('pack2_rn<__nv_bfloat16>(v[0], v[1]);',
                         '(BN == 128 ? pack2_rn<__nv_bfloat16>(v[0], v[1]) '
                         ': ' + _TRUNCATE + 'v[0], v[1]));'),
}

ALL_PHASES = frozenset(range(2, 39))
# phase 7: the imperative NDArray path's size (n x n inputs)
ND_SIZE = 1024
ND_HOST_CALLS = 2000
# draws of each sampler on the card, held to its mean and variance
# within 5 standard errors
ND_SAMPLES = 1 << 20

# phase 8: the kernels of mx.rtc's path, CUDA bodies compiled by NVRTC,
# each beside its plain PyTorch version (`rtc_plain`). name -> inputs,
# outputs, dtype, shape on the card, and the largest difference from the
# plain version allowed, in units in the last place of the plain value:
# - ref_exp, the reference's GPU test kernel (tests/python/gpu/test_rtc.py):
#   one block of 10 threads through shared memory, y = expf(5 x); x * 5.0
#   is exact in double, so the two differ only by their expf (CUDA's is
#   within 2 ulp);
# - saxpy1, the JAX test's function (tests/test_observability.py), over
#   2^26 elements with a grid-stride loop; NVRTC contracts x * y + 1.0f to
#   one FMA, rounded once, where the plain version rounds x * y and then
#   the sum: the two may differ by 1 ulp of the result plus half an ulp of
#   x * y (`rtc_slack`), which is many ulps of a result near 0;
# - dbl2d, a 2-D bf16 kernel over (3000, 1000) on a 2-D grid of 32 x 16
#   blocks whose edge blocks are ragged in both dimensions, guarded by
#   x_dims[]; doubling is exact;
# - sgd_update, w = w - lr g in place (outs=[w]), with __fmul_rn and
#   __fsub_rn, which NVRTC never contracts, so it rounds as the plain
#   version does and must be exact. RTC_LR is the 0.1f in its body.
RTC_LR = 0.1
RTC_CASES = {
    'ref_exp': dict(ins=('x',), outs=('y',), dtype='float32', shape=(10,),
                    ulp=2, body="""
    __shared__ float s_rec[10];
    s_rec[threadIdx.x] = x[threadIdx.x];
    y[threadIdx.x] = expf(s_rec[threadIdx.x] * 5.0);"""),
    'saxpy1': dict(ins=('x', 'y'), outs=('out',), dtype='float32',
                   shape=(1 << 26,), ulp=1, body="""
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < x_dims[0]; i += (long long)blockDim.x * gridDim.x)
      out[i] = x[i] * y[i] + 1.0f;"""),
    'dbl2d': dict(ins=('x',), outs=('out',), dtype='bfloat16',
                  shape=(3000, 1000), ulp=0, body="""
    const int r = blockIdx.y * blockDim.y + threadIdx.y;
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < x_dims[0] && c < x_dims[1])
      out[r * x_dims[1] + c] =
          __float2bfloat16(2.0f * __bfloat162float(x[r * x_dims[1] + c]));"""),
    'sgd_update': dict(ins=('w', 'g'), outs=('out',), dtype='float32',
                       shape=(1024,), ulp=0, in_place=True, body="""
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < w_dims[0]; i += (long long)blockDim.x * gridDim.x)
      out[i] = __fsub_rn(w[i], __fmul_rn(0.1f, g[i]));"""),
}
# saxpy1's grid: at most 16 blocks of 256 threads an SM on the H100's 132
RTC_GRID_BLOCKS = 132 * 16
# the imperative loop: logistic regression on two seeded Gaussian blobs
SGD_ROWS, SGD_FEATURES, SGD_STEPS = 8192, 1024, 100


def rtc_launch_dims(name, shape):
    """(grid_dims, block_dims) of RTC_CASES[name] at `shape`."""
    if name == 'ref_exp':
        return (1,), (shape[0],)
    if name == 'dbl2d':
        return (-(-shape[1] // 32), -(-shape[0] // 16)), (32, 16)
    return (min(-(-shape[0] // 256), RTC_GRID_BLOCKS),), (256,)


def rtc_inputs(name, shape, seed):
    """Seeded float32 numpy inputs of RTC_CASES[name] at `shape`, uniform
    in [-1, 1)."""
    rng = np.random.default_rng([seed, len(name), shape[0]])
    return [rng.uniform(-1, 1, shape).astype(np.float32)
            for _ in RTC_CASES[name]['ins']]


def rtc_plain(name, *ins):
    """The plain PyTorch version of RTC_CASES[name] on torch tensors."""
    if name == 'ref_exp':
        x, = ins
        return (x * 5.0).exp()
    if name == 'saxpy1':
        x, y = ins
        return x * y + 1.0
    if name == 'dbl2d':
        x, = ins
        return x * 2
    w, g = ins
    return w - RTC_LR * g


def ulp_of(torch, t):
    """The spacing of float32 values at |t|, element by element."""
    mag = t.float().abs()
    return torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag


def rtc_slack(torch, name, ins):
    """The rounding the plain version of RTC_CASES[name] takes that its
    kernel does not, element by element: half an ulp of saxpy1's x * y,
    which the FMA keeps unrounded; None for the other cases."""
    if name != 'saxpy1':
        return None
    x, y = ins
    return 0.5 * ulp_of(torch, x * y)


def ulp_mismatch(torch, got, ref, ulps, slack=None):
    """got against ref, element by element: |got - ref| within `ulps`
    units in the last place of ref plus `slack` (0 ulps and no slack: the
    same bits). The largest difference in ulps of ref, and ok when no
    element is over its limit."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if ulps == 0 and slack is None:
        same = torch.equal(got, ref)
        return dict(max_abs_err=float(err.max()),
                    max_ulps=0.0 if same else None, ok=same)
    ulp = ulp_of(torch, ref)
    limit = ulps * ulp + (0 if slack is None else slack)
    return dict(max_abs_err=float(err.max()),
                max_ulps=float((err / ulp).max()),
                over_limit=int((err > limit).sum()),
                ok=bool(torch.isfinite(got).all()) and
                bool((err <= limit).all()))


def fail(msg):
    print('chip_smoke: FAILED: ' + msg, file=sys.stderr)
    sys.exit(1)


class PhaseClock:
    """The host seconds of each phase of a run, printed as each ends; a
    phase started again adds to its count."""

    def __init__(self):
        self.seconds, self._phase, self._t0 = {}, None, None
        self.t_start = time.perf_counter()

    def start(self, phase):
        self.stop()
        self._phase, self._t0 = phase, time.perf_counter()

    def stop(self):
        if self._phase is not None:
            s = self.seconds.get(self._phase, 0.0) + \
                time.perf_counter() - self._t0
            self.seconds[self._phase] = round(s, 1)
            print('phase %d: %.1f s' % (self._phase, s), flush=True)
            self._phase = None


def cuda_ms(torch, fn, iters):
    """Mean device time of fn over iters launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(event):
    """A profiler event's own device time in us (the attribute was
    self_cuda_time_total before torch 2.4)."""
    return getattr(event, 'self_device_time_total', None) or \
        getattr(event, 'self_cuda_time_total', 0)


def device_events(torch, fn, iters=1):
    """The kernels fn launches over iters calls, by name, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if str(getattr(e, 'device_type', '')).endswith('CUDA')]


def profiled_ms(torch, fn, iters):
    """Mean device time of fn over iters calls, summed over its kernels,
    after one warm-up: for a call whose host work may outlast its
    kernels, where CUDA events around the calls would time the host."""
    fn()
    torch.cuda.synchronize()
    return sum(device_us(e) for e in device_events(torch, fn, iters)) \
        / 1e3 / iters


def attention_bound(b, h, tq, tk, d, dtype_name, causal):
    """Least time for one attention forward: q, k, v read once, O and
    lse written once, against the two products over the live (row, key)
    pairs of this shape."""
    itemsize = 4 if dtype_name == 'float32' else 2
    nbytes = (2 * b * h * tq * d + 2 * b * h * tk * d) * itemsize \
        + b * h * tq * 4
    flops = 4.0 * b * h * live_pairs(tq, tk, causal) * d
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations',
            nbytes, flops)


def live_pairs(tq, tk, causal):
    """(row, key) pairs that causal masking leaves, per (batch, head)."""
    if not causal:
        return tq * tk
    offset = tk - tq
    return sum(min(tk, i + offset + 1) for i in range(tq))


def backward_bounds(b, h, tq, tk, d, dtype_name, causal):
    """Least time of each backward kernel and of the whole backward:
    q, k, v, dO, lse and D read once, the kernel's gradients written
    once, against its products over the live pairs (S, dP, dV, dK for
    dK/dV; S, dP, dQ for dQ; five for the function)."""
    itemsize = 4 if dtype_name == 'float32' else 2
    reads = (2 * b * h * tq * d + 2 * b * h * tk * d) * itemsize \
        + 2 * b * h * tq * 4
    per_product = 2.0 * b * h * live_pairs(tq, tk, causal) * d
    out = {}
    for name, writes, products in (
            ('dkdv', 2 * b * h * tk * d, 4), ('dq', b * h * tq * d, 3),
            ('whole', b * h * (tq + 2 * tk) * d, 5)):
        nbytes = reads + writes * itemsize
        flops = products * per_product
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by='bytes' if t_bytes >= t_ops
                         else 'operations', bytes=nbytes, flops=flops)
    return out


def backward_flops_done(b, h, tq, tk, d, dtype_name, causal):
    """The operations each backward kernel really does over the live
    pairs: S and dP once per column group of BWD_GROUP (each group sums
    them over the whole head), then dV and dK, or dQ, once."""
    groups = -(-d // BWD_GROUP[dtype_name])
    per_product = 2.0 * b * h * live_pairs(tq, tk, causal) * d
    return dict(dkdv=(2 * groups + 2) * per_product,
                dq=(2 * groups + 1) * per_product)


def sass_start(lib_path):
    """The built library's SASS (cuobjdump -sass), dumped in the
    background while phases 2-3 run; sass_check reads it."""
    tool = shutil.which('cuobjdump') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    return Background([tool, '-sass', str(lib_path)], 300)


def sass_check(job, build_log):
    """Phase 1: the tensor-core kernels run on the tensor cores: every
    instance of each of SM90_KERNELS, in each of its 16-bit types, in the
    built library's SASS (sass_start's job) holds HGMMA instructions, and
    ptxas serialised no wgmma (warning C7520) in the build log."""
    res, _ = job.wait()
    if res.returncode != 0:
        fail('cuobjdump -sass exited %d: %s' % (res.returncode,
                                                res.stderr[-2000:]))
    sass = res.stdout
    functions = sass.split('Function : ')[1:]
    found = {}
    for name, types in SM90_KERNELS.items():
        found[name] = {}
        for dtype_name in types:
            mangled = '' if name in SM90_UNTYPED else SM90_TYPES[dtype_name]
            bodies = [f for f in functions
                      if name in f.split('\n', 1)[0] and
                      mangled in f.split('\n', 1)[0]]
            found[name][dtype_name] = dict(
                instances=len(bodies),
                with_hgmma=sum('HGMMA' in f for f in bodies),
                hgmma=sum(f.count('HGMMA') for f in bodies))
    serialised = [line for line in build_log.splitlines()
                  if 'C7520' in line or 'serialized' in line]
    print('sass ' + json.dumps(dict(found, c7520_lines=serialised)))
    for name, rows in found.items():
        for dtype_name, row in rows.items():
            if row['instances'] == 0 or \
                    row['with_hgmma'] != row['instances']:
                fail('%s (%s): %d of %d instances hold HGMMA in the SASS'
                     % (name, dtype_name, row['with_hgmma'],
                        row['instances']))
    if serialised:
        fail('ptxas serialised wgmma: %s' % serialised[:4])
    return found


def kernel_case(torch, cuda_ops, name, shape_q, tk, dtype, causal, iters):
    """Phase 2, one shape: the forward kernel against its plain version
    (16-bit: the online recurrence at the kernel's tile, element by
    element under FWD_TOL, and the same bits on a second launch; float32:
    the dense version under F32_TOL), and the times."""
    import torch.nn.functional as F
    b, h, tq, d = shape_q
    dtype_name = str(dtype).split('.')[-1]
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    q = torch.randn(shape_q, generator=gen, device='cuda', dtype=dtype)
    k = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)
    v = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)

    out, lse = cuda_ops.flash_attention_with_lse(q, k, v, causal=causal)
    again = cuda_ops.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    same_bits = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    del again
    if dtype_name == 'float32':
        plain = lambda: cuda_ops.flash_attention_reference(q, k, v, causal)
    else:
        plain = lambda: cuda_ops.flash_attention_online_reference(
            q, k, v, causal, block_k=FWD_BLOCK_K)
    ref_out, ref_lse = plain()
    lse_err = (lse - ref_lse).abs()
    ltol = LSE_TOL[dtype_name]
    ok_lse = bool((lse_err <= ltol['atol'] + ltol['rtol'] *
                   ref_lse.abs()).all())
    if dtype_name == 'float32':
        tol = F32_TOL
        err = (out.float() - ref_out.float()).abs()
        ok_out = bool((err <= tol['atol'] + tol['rtol'] *
                       ref_out.float().abs()).all())
        check = dict(max_abs_err=float(err.max()))
    else:
        tol = FWD_TOL[dtype_name]
        check = grad_mismatch(torch, out, ref_out, tol)
        ok_out = check['ok']
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())

    ms = cuda_ms(torch, lambda: cuda_ops.flash_attention_with_lse(
        q, k, v, causal=causal), iters)
    plain_ms = cuda_ms(torch, plain, max(2, iters // 4))
    library_ms = None
    if tq == tk:   # SDPA's is_causal aligns top-left: same function only
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), iters)
    bound_ms, bound_by, nbytes, flops = attention_bound(
        b, h, tq, tk, d, dtype_name, causal)
    row = dict(case=name, q=list(shape_q), tk=tk, dtype=dtype_name,
               causal=causal, **check, tol=tol,
               plain='dense' if dtype_name == 'float32' else
               'online, %d-key tiles' % FWD_BLOCK_K,
               lse_max_abs_err=float(lse_err.max()), lse_tol=ltol,
               same_bits_twice=same_bits, ms=ms, tflops=flops / ms / 1e9,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops)
    print('kernel case ' + json.dumps(row))
    if not (ok_out and ok_lse):
        fail('%s: kernel disagrees with its plain version: out %s '
             '(tol %s), lse %.3g (tol %s)' % (name, check, tol,
                                             row['lse_max_abs_err'], ltol))
    if not finite:
        fail('%s: non-finite kernel output' % name)
    if not same_bits:
        fail('%s: a second launch of the forward kernel gave other bits'
             % name)
    return row


def grad_mismatch(torch, got, ref, tol):
    """A gradient against its plain version under `tol` (a BWD_TOL
    entry): the largest error and reference, the elements over their
    tolerance and the share that differ at all; ok when finite, none is
    over and no more than tol['differ'] differ."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    size = float(ref.abs().max())
    limit = tol['rtol'] * ref.abs() + tol['atol'] + tol['atol_of_max'] * size
    over = int((err > limit).sum())
    differ = float((err > 0).float().mean())
    finite = bool(torch.isfinite(got).all())
    return dict(max_abs_err=float(err.max()), max_abs_ref=size,
                over_tol=over, share_differ=differ, finite=finite,
                ok=finite and over == 0 and differ <= tol['differ'])


def bwd_case(torch, cuda_ops, name, shape_q, tk, dtype, causal, with_glse,
             iters):
    """Phase 4, one shape: each backward kernel against its plain
    version on the same inputs (the kernel forward's out and lse, a
    seeded dO and lse cotangent), the autograd Function against the
    kernels, and the times."""
    import torch.nn.functional as F
    b, h, tq, d = shape_q
    dtype_name = str(dtype).split('.')[-1]
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    q = torch.randn(shape_q, generator=gen, device='cuda', dtype=dtype)
    k = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)
    v = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)
    do = torch.randn(shape_q, generator=gen, device='cuda', dtype=dtype)
    glse = None
    if with_glse:
        glse = torch.randn((b * h, tq, 1), generator=gen, device='cuda')
    out, lse = cuda_ops.flash_attention_with_lse(q, k, v, causal=causal)
    dd = cuda_ops.attention_bwd_delta(out, do, glse).contiguous()
    args = (q, k, v, do, lse, dd, causal, scale)

    dk, dv = cuda_ops.flash_attention_bwd_dkdv_cuda(*args)
    dq = cuda_ops.flash_attention_bwd_dq_cuda(*args)
    again = (cuda_ops.flash_attention_bwd_dq_cuda(*args),
             *cuda_ops.flash_attention_bwd_dkdv_cuda(*args))
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))
    del again
    ref_dk, ref_dv = cuda_ops.flash_attention_bwd_dkdv_reference(*args)
    ref_dq = cuda_ops.flash_attention_bwd_dq_reference(*args)
    errs = {gname: grad_mismatch(torch, got, ref, BWD_TOL[dtype_name])
            for gname, got, ref in (('dq', dq, ref_dq), ('dk', dk, ref_dk),
                                    ('dv', dv, ref_dv))}
    ok = all(e['ok'] for e in errs.values())

    # the Function's backward is these kernels on these inputs
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o2, l2 = cuda_ops.flash_attention_with_lse(*leaves, causal=causal)
    outs, cots = ((o2, l2), (do, glse)) if with_glse else ((o2,), (do,))
    fn_grads = torch.autograd.grad(outs, leaves, cots)
    same = all(torch.equal(a, b) for a, b in zip(fn_grads, (dq, dk, dv)))

    dkdv_ms = cuda_ms(torch, lambda: cuda_ops.flash_attention_bwd_dkdv_cuda(
        *args), iters)
    dq_ms = cuda_ms(torch, lambda: cuda_ops.flash_attention_bwd_dq_cuda(
        *args), iters)
    plain_iters = max(2, iters // 4)
    dkdv_plain_ms = cuda_ms(
        torch, lambda: cuda_ops.flash_attention_bwd_dkdv_reference(*args),
        plain_iters)
    dq_plain_ms = cuda_ms(
        torch, lambda: cuda_ops.flash_attention_bwd_dq_reference(*args),
        plain_iters)
    library_ms = None
    if tq == tk and not with_glse:   # SDPA's is_causal aligns top-left
        sq, sk, sv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(sq, sk, sv,
                                                  is_causal=causal)
        # device time: the autograd engine's host work per call can
        # outlast these kernels
        library_ms = profiled_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (sq, sk, sv), do, retain_graph=True), iters)
    bounds = backward_bounds(b, h, tq, tk, d, dtype_name, causal)
    done = backward_flops_done(b, h, tq, tk, d, dtype_name, causal)
    rates = {key: dict(tflops=bounds[key]['flops'] / ms / 1e9,
                       tflops_done=done[key] / ms / 1e9,
                       flops_done=done[key])
             for key, ms in (('dkdv', dkdv_ms), ('dq', dq_ms))}
    row = dict(case=name, q=list(shape_q), tk=tk, dtype=dtype_name,
               causal=causal, glse=with_glse, tol=BWD_TOL[dtype_name],
               errors=errs, same_bits_twice=same_bits,
               function_equals_kernels=same,
               dkdv_ms=dkdv_ms, dq_ms=dq_ms, dkdv_plain_ms=dkdv_plain_ms,
               dq_plain_ms=dq_plain_ms, sdpa_backward_ms=library_ms,
               bounds=bounds, rates=rates)
    print('backward case ' + json.dumps(row))
    if not ok:
        fail('%s: a backward kernel disagrees with its plain version: %s'
             % (name, errs))
    if not same_bits:
        fail('%s: a second launch of the backward kernels gave other bits'
             % name)
    if not same:
        fail('%s: the autograd Function does not give the kernels\' '
             'gradients' % name)
    return row


def reset_counts(cuda_ops):
    cuda_ops.FLASH_FWD_LAUNCHES = 0
    cuda_ops.FLASH_BWD_DKDV_LAUNCHES = 0
    cuda_ops.FLASH_BWD_DQ_LAUNCHES = 0


def read_counts(cuda_ops):
    return (cuda_ops.FLASH_FWD_LAUNCHES, cuda_ops.FLASH_BWD_DKDV_LAUNCHES,
            cuda_ops.FLASH_BWD_DQ_LAUNCHES)


def profile_device(torch, fn, label, top):
    """Run fn once under torch.profiler; print and return the device time
    (ms), the heaviest `top` kernels, and the share of PyTorch's copy
    kernel (direct_copy_kernel_cuda: .contiguous(), dtype casts)."""
    events = device_events(torch, fn)
    total_us = sum(device_us(e) for e in events)
    print('%s: device time %.3f ms in %d kernels' % (
        label, total_us / 1e3, len(events)))
    rows = []
    for e in sorted(events, key=lambda e: -device_us(e))[:top]:
        print('  %9.3f ms  %5d x  %s' % (device_us(e) / 1e3, e.count,
                                          e.key[:110]))
        rows.append(dict(kernel=e.key[:200], ms=device_us(e) / 1e3,
                         count=e.count))
    copies = [e for e in events if 'direct_copy_kernel' in e.key]
    copy = dict(ms=sum(device_us(e) for e in copies) / 1e3,
                launches=sum(e.count for e in copies))
    copy['share'] = copy['ms'] / max(total_us / 1e3, 1e-9)
    print('  copies (direct_copy_kernel_cuda): %.3f ms in %d launches, '
          '%.1f %% of the device time' % (copy['ms'], copy['launches'],
                                          100 * copy['share']))
    return total_us / 1e3, rows, copy


def wrapper_copy_ms(torch):
    """Device time of the flash wrapper's own copies for one layer at the
    LM's shape: q, k and v, each a (batch, heads, seq, head_dim) view of
    the (batch, seq, 3 * dim) projection, made contiguous in the forward
    (cuda_ops._FlashAttention.forward), and dO made contiguous in the
    backward; bf16, CUDA events over 50 runs."""
    b, t, h = BATCH, SEQ, GPT2_MEDIUM['heads']
    dh = GPT2_MEDIUM['dim'] // h
    x = torch.randn((b, t, 3 * h * dh), device='cuda', dtype=torch.bfloat16)
    views = [z.reshape(b, t, h, dh).transpose(1, 2) for z in x.chunk(3, -1)]
    fwd = cuda_ms(torch, lambda: [z.contiguous() for z in views], 50)
    bwd = cuda_ms(torch, lambda: views[0].contiguous(), 50)
    return dict(forward_ms_per_layer=fwd, backward_ms_per_layer=bwd,
                layers=GPT2_MEDIUM['layers'],
                step_ms=(fwd + bwd) * GPT2_MEDIUM['layers'])


def flash_vs_plain_grads(torch, tfm, cfg, params, tokens, targets,
                         loss_scale=1.0):
    """Every parameter's gradient of the loss (times loss_scale) on the
    flash kernels and on plain attention, same weights: (the check's row,
    what is wrong). Each must be finite and nonzero, and the two within
    GRAD_REL_TOL in relative norm; the losses within LM_NLL_ATOL."""
    grads, losses, peaks = {}, {}, {}
    for use_flash in (True, False):
        model = tfm.TransformerLM(dict(cfg, use_flash=use_flash), params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = model.loss(tokens, targets)
        (loss * loss_scale).backward()
        torch.cuda.synchronize()
        peaks[use_flash] = torch.cuda.max_memory_allocated()
        losses[use_flash] = loss.item()
        grads[use_flash] = {n: p.grad for n, p in model.named_parameters()}
        del model, loss
    bad, rel = [], {}
    for name, gf in grads[True].items():
        gp = grads[False][name]
        if gf is None or gp is None:
            bad.append('%s: no gradient (flash %s, plain %s)' % (
                name, gf is None, gp is None))
            continue
        gf, gp = gf.float(), gp.float()
        if not (bool(torch.isfinite(gf).all()) and
                bool(torch.isfinite(gp).all())):
            bad.append('%s: non-finite gradient' % name)
        if not (float(gf.abs().max()) > 0 and float(gp.abs().max()) > 0):
            bad.append('%s: zero gradient' % name)
        rel[name] = float((gf - gp).norm() / gp.norm())
        if not rel[name] <= GRAD_REL_TOL:
            bad.append('%s: flash vs plain gradient %.4g (tol %g)' % (
                name, rel[name], GRAD_REL_TOL))
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    grad_check = dict(parameters=len(grads[True]), loss_flash=losses[True],
                      loss_plain=losses[False], rel_err_max=worst[0][1],
                      rel_err_worst=worst, rel_tol=GRAD_REL_TOL,
                      wqkv_grad_norm_flash=float(
                          grads[True]['layers.0.wqkv'].float().norm()),
                      peak_bytes_flash=peaks[True],
                      peak_bytes_plain=peaks[False], loss_scale=loss_scale)
    if abs(losses[True] - losses[False]) > LM_NLL_ATOL:
        bad.append('loss flash %.5f vs plain %.5f (tol %g)' % (
            losses[True], losses[False], LM_NLL_ATOL))
    return grad_check, bad


def train_phase(torch, cuda_ops, tfm, params, batch):
    """Phase 5: the bf16 train step at full width and depth on `params`
    (updated in place), then one float16 step and the float32 loss check
    at cut depth."""
    cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
    tokens, targets = batch

    # gradients on the flash kernels and on plain attention, same weights
    grad_check, bad = flash_vs_plain_grads(torch, tfm, cfg, params, tokens,
                                           targets)
    print('train grad check ' + json.dumps(grad_check))
    if bad:
        fail('train gradients: ' + '; '.join(bad[:10]))

    # the warm-up step, whose update is checked on layer 0's wqkv
    model = tfm.TransformerLM(cfg, params)
    step = tfm.make_train_step(cfg, lr=LR)
    w = model.layers[0].wqkv
    before = w.detach().clone()
    step(model, tokens, targets)
    torch.cuda.synchronize()
    update_exact = torch.equal(w.detach(), before - LR * w.grad)
    moved = int((w.detach() != before).sum())
    del before

    # the main path: TRAIN_STEPS steps, counted and timed
    reset_counts(cuda_ops)
    times, step_losses, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        counts = read_counts(cuda_ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step_losses.append(float(loss))
        per_step.append([a - b for a, b in zip(read_counts(cuda_ops),
                                                counts)])
    launches = read_counts(cuda_ops)
    peak_step = torch.cuda.max_memory_allocated()
    dev_ms, top, copies = profile_device(
        torch, lambda: step(model, tokens, targets),
        'train profile, one step', 12)
    del model
    wrapper_copies = wrapper_copy_ms(torch)

    step_ms = sorted(times)[len(times) // 2] * 1e3
    train = dict(config='gpt2-medium widths, %d layers, bf16' % cfg['layers'],
                 batch=BATCH, seq=SEQ, lr=LR, steps=TRAIN_STEPS,
                 step_ms=[t * 1e3 for t in times], step_ms_median=step_ms,
                 tokens_per_s=BATCH * SEQ / (step_ms / 1e3),
                 losses=step_losses, launches=launches,
                 launches_per_step=per_step, update_exact=update_exact,
                 wqkv_elements_moved=moved, peak_bytes_step=peak_step,
                 profiled_device_ms=dev_ms,
                 device_busy_share=dev_ms / step_ms, profile_top=top,
                 copies=copies, flash_wrapper_copies=wrapper_copies)
    print('train ' + json.dumps(train))
    want = [cfg['layers']] * 3
    if per_step != [want] * TRAIN_STEPS:
        fail('launches (fwd, dK/dV, dQ) per step %s, expected %s each'
             % (per_step, want))
    if not update_exact:
        fail('the update of layers.0.wqkv is not w - lr * g')
    if not all(math.isfinite(x) for x in step_losses):
        fail('non-finite train loss %s' % step_losses)

    f16 = train_f16_check(torch, cuda_ops, tfm, batch)

    # float32 at full width, cut depth: the loss falls on one batch
    cfg32 = tfm.lm_config(use_flash=True,
                          **dict(GPT2_MEDIUM, layers=FP32_LAYERS))
    model = tfm.TransformerLM(cfg32, tfm.params_from_jax(
        seeded_tree(cfg32, SEED + 3), dtype=torch.float32, device='cuda'))
    step = tfm.make_train_step(cfg32, lr=LR)
    counts = read_counts(cuda_ops)
    fp32_losses = [float(step(model, tokens, targets))
                   for _ in range(FP32_STEPS)]
    fp32_launches = [a - b for a, b in zip(read_counts(cuda_ops), counts)]
    del model
    fp32 = dict(config='gpt2-medium widths, %d layers, float32'
                % FP32_LAYERS, lr=LR, losses=fp32_losses,
                launches=fp32_launches)
    print('train fp32 ' + json.dumps(fp32))
    if not all(math.isfinite(x) for x in fp32_losses) or \
            not fp32_losses[-1] < fp32_losses[0]:
        fail('float32 loss did not fall over %d steps: %s'
             % (FP32_STEPS, fp32_losses))
    if fp32_launches != [FP32_LAYERS * FP32_STEPS] * 3:
        fail('float32 steps launched %s kernels, expected %d each'
             % (fp32_launches, FP32_LAYERS * FP32_STEPS))
    return dict(train, grad_check=grad_check, fp32=fp32, f16=f16)


def train_f16_check(torch, cuda_ops, tfm, batch):
    """Phase 5 in float16: at full width and F16_LAYERS layers, every
    gradient of the loss times F16_LOSS_SCALE on the flash kernels
    against plain attention's, then one train step (unscaled, as
    make_train_step takes it), which must launch the forward, dK/dV and
    dQ kernels once per layer and give a finite loss."""
    cfg = tfm.lm_config(use_flash=True,
                        **dict(GPT2_MEDIUM, layers=F16_LAYERS))
    params = tfm.params_from_jax(
        seeded_tree(cfg, SEED + 8, embed_std=F16_EMBED_STD),
        dtype=torch.float16, device='cuda')
    tokens, targets = batch
    grad_check, bad = flash_vs_plain_grads(torch, tfm, cfg, params, tokens,
                                           targets, F16_LOSS_SCALE)
    model = tfm.TransformerLM(cfg, params)
    step = tfm.make_train_step(cfg, lr=LR)
    counts = read_counts(cuda_ops)
    loss = float(step(model, tokens, targets))
    launches = [a - b for a, b in zip(read_counts(cuda_ops), counts)]
    del model
    row = dict(config='gpt2-medium widths, %d layers, float16'
               % F16_LAYERS, grad_check=grad_check, step_loss=loss,
               launches=launches)
    print('train f16 ' + json.dumps(row))
    if bad:
        fail('float16 train gradients: ' + '; '.join(bad[:10]))
    if launches != [F16_LAYERS] * 3 or not math.isfinite(loss):
        fail('float16 step: launches (fwd, dK/dV, dQ) %s, expected %d '
             'each; loss %s' % (launches, F16_LAYERS, loss))
    return row


def seeded_tree(cfg, seed, embed_std=0.02):
    """A JAX-layout parameter tree of numpy float32 arrays: weights
    normal * 0.02, norm scales one (the JAX package's init_params); the
    embedding normal * embed_std."""
    rng = np.random.default_rng(seed)
    D, V, H = cfg['dim'], cfg['vocab'], cfg['mlp_mult'] * cfg['dim']

    def normal(*shape, std=0.02):
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= np.float32(std)
        return w

    ones = lambda n: np.ones((n,), np.float32)
    return {'embed': normal(V, D, std=embed_std), 'ln_f': ones(D),
            'layers': [{'ln1': ones(D), 'wqkv': normal(D, 3 * D),
                        'wo': normal(D, D), 'ln2': ones(D),
                        'w1': normal(D, H), 'w2': normal(H, D)}
                       for _ in range(cfg['layers'])]}


def backward_phase(torch, cuda_ops, names):
    """Phase 4: the named BWD_CASES, in order."""
    rows = []
    for name in names:
        shape_q, tk, dtype_name, with_glse, iters = BWD_CASES[name]
        rows.append(bwd_case(torch, cuda_ops, name, shape_q, tk,
                             getattr(torch, dtype_name), True, with_glse,
                             iters))
    return rows


def conv_inputs(torch, name, seed):
    """Seeded x and w of CONV_CASES[name] on the card: w scaled by 0.05,
    so y is of size about 1 at the ResNet-50 depths."""
    xs, ws, stride, pad, dtype_name = CONV_CASES[name]
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn(xs, generator=gen, device='cuda', dtype=dtype)
    w = torch.randn(ws, generator=gen, device='cuda', dtype=dtype) * 0.05
    return x, w, stride, pad, dtype_name


def conv_y_mismatch(torch, cuda_conv, got, ref, x, w, stride, pad):
    """y against the plain version's under CONV_Y_TOL (bf16) or the
    float32 depth bound; the fields of `grad_mismatch`."""
    if got.dtype == torch.bfloat16:
        return grad_mismatch(torch, got, ref, CONV_Y_TOL)
    depth = w.shape[0] * w.shape[1] * w.shape[2]
    magnitude = cuda_conv.conv_bn_stats_plain(x.abs(), w.abs(), stride,
                                              pad)[0]
    limit = CONV_F32_ORDERS * depth * 2.0 ** -24 * magnitude
    err = (got - ref).abs()
    over = int((err > limit).sum())
    finite = bool(torch.isfinite(got).all())
    return dict(max_abs_err=float(err.max()),
                max_abs_ref=float(ref.abs().max()), over_tol=over,
                share_differ=float((err > 0).float().mean()), finite=finite,
                ok=finite and over == 0)


def stats_mismatch(torch, got, ref, scale):
    """A statistic against the plain version's, as the largest
    |got - ref| / scale over the channels; ok when finite and within
    CONV_STATS_RTOL."""
    err = float(((got - ref).abs() / scale.clamp_min(1e-30)).max())
    finite = bool(torch.isfinite(got).all())
    return dict(rel_err=err, ok=finite and err <= CONV_STATS_RTOL)


def conv_case(torch, cuda_conv, name):
    """Phase 6, one case: the kernel against its plain version on the same
    inputs, element by element, and the same bits on a second run."""
    x, w, stride, pad, dtype_name = conv_inputs(torch, name, SEED + 4)
    y, s1, s2 = cuda_conv.conv_bn_stats_cuda(x, w, stride, pad)
    again = cuda_conv.conv_bn_stats_cuda(x, w, stride, pad)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))
    del again
    py, p1, p2 = cuda_conv.conv_bn_stats_plain(x, w, stride, pad)
    pf = py.float()
    y_check = conv_y_mismatch(torch, cuda_conv, y, py, x, w, stride, pad)
    s1_check = stats_mismatch(torch, s1, p1, pf.abs().sum((0, 1, 2)))
    s2_check = stats_mismatch(torch, s2, p2, (pf * pf).sum((0, 1, 2)))
    ok = y_check['ok'] and s1_check['ok'] and s2_check['ok']
    row = dict(case=name, x=list(x.shape), w=list(w.shape),
               stride=list(stride), pad=list(pad), dtype=dtype_name,
               y=y_check, s1=s1_check, s2=s2_check,
               y_tol=CONV_Y_TOL if dtype_name == 'bfloat16' else
               '%d * K * 2^-24 * (|x| conv |w|)' % CONV_F32_ORDERS,
               stats_rtol=CONV_STATS_RTOL, same_bits_twice=same_bits)
    print('conv case ' + json.dumps(row))
    if not ok:
        fail('conv %s: the kernel disagrees with its plain version: y %s, '
             's1 %s, s2 %s' % (name, y_check, s1_check, s2_check))
    if not same_bits:
        fail('conv %s: a second run of the kernel gave other bits' % name)
    return row


def conv_grad_check(torch, cuda_conv):
    """Phase 6: dx and dw of the autograd Function on the card (kernel
    forward, seeded dy, ds1, ds2) against the statistics' cotangents
    folded into dy on the plain version's y, dy + ds1 + 2 y ds2, and
    PyTorch's transposed convs, written out here."""
    name = CONV_GRAD_CASE
    x, w, stride, pad, dtype_name = conv_inputs(torch, name, SEED + 5)
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y, s1, s2 = cuda_conv.conv2d_bn_stats(xl, wl, stride, pad)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 6)
    dy = torch.randn(y.shape, generator=gen, device='cuda', dtype=y.dtype)
    ds1 = torch.randn(s1.shape, generator=gen, device='cuda')
    ds2 = torch.randn(s2.shape, generator=gen, device='cuda') * 0.1
    dx, dw = torch.autograd.grad((y, s1, s2), (xl, wl), (dy, ds1, ds2))

    py = cuda_conv.conv_bn_stats_plain(x, w, stride, pad)[0]
    tot = (dy.float() + ds1 + 2.0 * py.float() * ds2).to(y.dtype)
    tot = tot.permute(0, 3, 1, 2)
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    ref_dx = torch.nn.grad.conv2d_input(xn.shape, wn, tot, stride,
                                        pad).permute(0, 2, 3, 1)
    ref_dw = torch.nn.grad.conv2d_weight(xn, wn.shape, tot, stride,
                                         pad).permute(2, 3, 1, 0)
    tol = BWD_TOL[dtype_name]
    errs = {'dx': grad_mismatch(torch, dx, ref_dx, tol),
            'dw': grad_mismatch(torch, dw, ref_dw, tol)}
    row = dict(case=name, tol=tol, errors=errs)
    print('conv grad check ' + json.dumps(row))
    if not all(e['ok'] for e in errs.values()):
        fail('conv gradients of the Function disagree with the fold and '
             'transposes on the plain version: %s' % errs)
    return row


def conv_bench_phase(torch, cuda_ops, cuda_conv, bench_conv_bn):
    """Phase 6's path: the bench over every ResNet-50 conv shape at batch
    CONV_BATCH in bf16, its launch counts read from zero."""
    reset_counts(cuda_ops)
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    bench = bench_conv_bn.run(batch=CONV_BATCH, dtype='bfloat16',
                              log=lambda line: print('conv bench ' + line))
    launches = cuda_conv.CONV_BN_STATS_LAUNCHES
    flash = read_counts(cuda_ops)
    rows = bench['rows']
    print('conv bench ' + json.dumps(dict(bench, launches=launches)))
    bad = []
    for r in rows:
        where = tuple(r['shape'])
        if r['launches'] != 1:
            bad.append('%s: the result call launched %d kernels, expected 1'
                       % (where, r['launches']))
        if not r['y_finite'] or r['y_share_differ'] > CONV_Y_TOL['differ'] \
                or r['y_max_abs_err'] > (CONV_Y_TOL['rtol'] +
                                         CONV_Y_TOL['atol_of_max']) * \
                r['y_max_abs']:
            bad.append('%s: y disagrees with the plain version: max err %.3g '
                       'of max %.3g, %.2g differ' % (
                           where, r['y_max_abs_err'], r['y_max_abs'],
                           r['y_share_differ']))
        if not max(r['s1_err'], r['s2_err']) <= CONV_STATS_RTOL:
            bad.append('%s: statistics disagree with the plain version: s1 '
                       '%.3g, s2 %.3g (tol %g)' % (where, r['s1_err'],
                                                   r['s2_err'],
                                                   CONV_STATS_RTOL))
    if len(rows) != len(cuda_conv.RESNET50_CONVS):
        bad.append('%d shapes ran of %d' % (len(rows),
                                             len(cuda_conv.RESNET50_CONVS)))
    counted = sum(r['launches'] + r['timed_launches'] for r in rows)
    if launches != counted:
        bad.append('the bench launched %d kernels; its rows count %d'
                   % (launches, counted))
    if flash != (0, 0, 0):
        bad.append('the bench launched flash kernels: %s' % (flash,))
    if bad:
        fail('conv bench: ' + '; '.join(bad))
    return dict(bench, launches=launches,
                launches_per_body_forward=sum(r['count'] * r['launches']
                                              for r in rows))


def conv_phase(torch, cuda_ops, cuda_conv, bench_conv_bn):
    """Phase 6: CONV_CASES, the gradient check and the bench path."""
    cases = [conv_case(torch, cuda_conv, name) for name in CONV_CASES]
    grad = conv_grad_check(torch, cuda_conv)
    bench = conv_bench_phase(torch, cuda_ops, cuda_conv, bench_conv_bn)
    return dict(cases=cases, grad=grad, bench=bench)


def conv_kernel_entry(conv, sass, resnet, module, serve, bucketing,
                      gluon_run, ptb, gluon_lm, factories, record, dist_ps,
                      dist_coord, loop, dp_mesh, dp_ranks, gluon_fused,
                      hybrid, custom, native, c_train):
    """The conv_bn_stats entry of the kernels line: times at the main
    case's shape from the bench, errors from the cases, launches from the
    ResNet-50 train steps of phase 9 (its main path), of phase 10's
    Module.fit, of phase 11's serving (0), of phase 12's bucket steps, of
    phase 13's Gluon training (0), of phases 14 and 15's LSTM LMs (0),
    of phase 16's Inception-v3 and ResNeXt-50 steps, of phase 18's
    Module.fit fed by ImageRecordIter, of the worker processes of
    phases 21 and 22 (each counts its own and reports them), of phase
    23's trainer, of phase 28's Module as the one rank of a data mesh
    (its steps and fit), of phase 29's two ranks (their sum), of phase
    30's fused Gluon steps, of phase 35's four ranks of two hybrid
    workers (their sum), of phase 36's Custom-head Module steps, of
    phase 37's Module.fit fed by the native iterator and of phase 38's
    C program's steps made in this process (its first run); its checks
    at phase 30's and phase 35's routed shapes beside the others."""
    xs, ws = CONV_CASES['main'][:2]
    main_shape = [xs[1], xs[3], ws[3], ws[0], CONV_CASES['main'][2][0]]
    bench = conv['bench']
    row = next(r for r in bench['rows'] if r['shape'] == main_shape)
    cases = [dict(case=c['case'], x=c['x'], w=c['w'], dtype=c['dtype'],
                  max_abs_err=c['y']['max_abs_err'],
                  share_differ=c['y']['share_differ'],
                  s1_rel_err=c['s1']['rel_err'],
                  s2_rel_err=c['s2']['rel_err'], y_tol=c['y_tol'],
                  stats_rtol=c['stats_rtol'],
                  same_bits_twice=c['same_bits_twice'])
             for c in conv['cases']]
    return dict(
        name='conv_bn_stats', route='cuda',
        source='mxnet_tpu_torch/csrc/conv_bn_stats_sm90.cu',
        float32_source='mxnet_tpu_torch/csrc/conv_bn_stats.cu',
        routes=dict(bfloat16='conv_bn_stats_sm90 (wgmma fed by TMA), '
                             'csrc/conv_bn_stats_sm90.cu',
                    float32='conv_bn_stats_kernel (fp32 FMA), '
                            'csrc/conv_bn_stats.cu, which holds the C '
                            'entry that routes by dtype and the finalize '
                            'kernel both share'),
        sass=sass['conv_bn_stats_sm90'],
        replaces='mxnet_tpu/pallas_conv.py:101',
        launches=resnet['train_path_launches'],
        launches_by_path=dict(resnet_train=resnet['train_path_launches'],
                              module_fit=module['fit_launches'],
                              resnet_serve=serve['launches']['conv'],
                              bucketing_train=bucketing['path_launches'],
                              gluon_train=gluon_run['kernel_launches'][
                                  'conv_bn_stats'],
                              lstm_ptb_train=ptb['kernel_launches'][
                                  'conv_bn_stats'],
                              gluon_lstm_train=gluon_lm['kernel_launches'][
                                  'conv_bn_stats'],
                              inception_v3_train=factories['bf16'][
                                  'inception_v3']['path_launches'],
                              resnext50_train=factories['bf16'][
                                  'resnext50']['path_launches'],
                              imagerecord_fit=record['fit_launches'],
                              dist_ps_train=dist_ps['path_launches'],
                              dist_coordinator_train=dist_coord[
                                  'path_launches'],
                              train_serve_fit=loop['path_launches'],
                              resnet_dp_mesh=dp_mesh['launches'],
                              resnet_dp_ranks=dp_ranks['launches'],
                              gluon_fused=gluon_fused['launches'],
                              resnet_hybrid_workers=hybrid['launches'],
                              resnet_custom_head=custom['launches'],
                              native_iter_fit=sum(native['fit']['launches'])
                              if native['image']['built'] else None,
                              c_train_api=c_train['inprocess']['first'][
                                  'launches'],
                              conv_bn_bench=bench['launches']),
        stem_split=resnet['stem_split'],
        launches_per_train_step=resnet['train_launches'],
        launches_per_body_forward=bench['launches_per_body_forward'],
        resnet_shape_checks=[dict(x=r['x'], w=r['w'], stride=r['stride'],
                                  pairs=r['pairs'],
                                  max_abs_err=r['y']['max_abs_err'],
                                  s1_rel_err=r['s1']['rel_err'],
                                  s2_rel_err=r['s2']['rel_err'])
                             for r in resnet['kernel_checks'] +
                             bucketing['kernel_checks']],
        gluon_fused_shape_checks=gluon_fused['kernel_checks'],
        hybrid_shape_checks=next(r['kernel_checks'] for r in hybrid['ranks']
                                 if r.get('kernel_checks')),
        imagerecord_shape_checks=[dict(x=r['x'], w=r['w'],
                                       stride=r['stride'], pairs=r['pairs'],
                                       max_abs_err=r['y']['max_abs_err'],
                                       ok=r['ok'])
                                  for r in record['kernel_checks']],
        factory_shape_checks={
            name: [dict(x=r['x'], w=r['w'], stride=r['stride'],
                        pad=r['pad'], pairs=r['pairs'],
                        max_abs_err=r['y']['max_abs_err'],
                        s1_rel_err=r['s1']['rel_err'],
                        s2_rel_err=r['s2']['rel_err'], ms=r['ms'],
                        library_ms=r['library_ms'],
                        bound_ms=r['bound_ms'], bound_by=r['bound_by'])
                   for r in f['kernel_checks']]
            for name, f in factories['bf16'].items()},
        max_abs_err=cases[0]['max_abs_err'], ms=row['ms'],
        plain_ms=row['plain_ms'], bound_ms=row['bound_ms'],
        bound_by=row['bound_by'], library_ms=row['library_ms'],
        library_call='cuDNN F.conv2d on channels-last tensors, then the '
                     'float32 sum and sum of squares of y per channel',
        cudnn_ms=row['cudnn_ms'], backward_ms=row['backward_ms'],
        tflops=row['tflops'],
        main_shape=dict(x=list(xs), w=list(ws), dtype='bfloat16'),
        totals=bench['totals'], grad_check=conv['grad']['errors'],
        cases=cases)


def mutant_check(root):
    """--mutants: build each of FWD_MUTANTS, BWD_MUTANTS, CONV_MUTANTS and
    CONV_SM90_MUTANTS in its own copy of the port under build/mutants/ and
    run there, all at once, phase 2's LM case (a forward mutant), phase
    4's LM case (a backward mutant), phase 6's ragged float32 case (an FMA
    conv mutant) or its bf16 main case (a tensor-core conv mutant); each
    must fail its case and the copy with no edit must pass all four. Times
    from these runs mean nothing: they share the card."""
    import shutil
    base = root / 'build' / 'mutants'
    shutil.rmtree(base, ignore_errors=True)
    fwd = ('flash_attention_sm90.cu', ['--forward-case', 'lm'])
    bwd = ('flash_attention_bwd_sm90.cu', ['--backward-case', 'lm'])
    conv = ('conv_bn_stats.cu', ['--conv-case', CONV_FMA_MUTANT_CASE])
    sm90 = ('conv_bn_stats_sm90.cu', ['--conv-case', 'main'])
    plan = [('unchanged', None, None,
             fwd[1] + bwd[1] + conv[1] + sm90[1][1:])]
    plan += [(name, edit, fwd[0], fwd[1])
             for name, edit in FWD_MUTANTS.items()]
    plan += [(name, edit, bwd[0], bwd[1])
             for name, edit in BWD_MUTANTS.items()]
    plan += [(name, edit, conv[0], conv[1])
             for name, edit in CONV_MUTANTS.items()]
    plan += [(name, edit, sm90[0], sm90[1])
             for name, edit in CONV_SM90_MUTANTS.items()]
    runs = []
    for name, edit, source, case in plan:
        copy = base / name
        shutil.copytree(root / 'mxnet_tpu_torch', copy / 'mxnet_tpu_torch',
                        ignore=shutil.ignore_patterns('__pycache__'))
        shutil.copy2(root / 'chip_smoke.py', copy)
        if edit:
            src = copy / 'mxnet_tpu_torch' / 'csrc' / source
            text = src.read_text()
            if text.count(edit[0]) != 1:
                fail('mutant %s: %r is not in the source once' % (name,
                                                                    edit[0]))
            src.write_text(text.replace(edit[0], edit[1]))
        with open(copy / 'run.log', 'w') as log:
            runs.append((name, copy, subprocess.Popen(
                [sys.executable, 'chip_smoke.py'] + case,
                cwd=copy, stdout=log, stderr=subprocess.STDOUT)))
    try:
        rcs = [proc.wait(timeout=600) for _, _, proc in runs]
    finally:
        for _, _, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wrong = []
    for (name, copy, _), rc in zip(runs, rcs):
        text = (copy / 'run.log').read_text()
        errors = {}
        for line in text.splitlines():
            if line.startswith('kernel case '):
                row = json.loads(line[len('kernel case '):])
                errors.update(out={k: row.get(k) for k in (
                    'max_abs_err', 'over_tol', 'share_differ')},
                    lse=row['lse_max_abs_err'])
            elif line.startswith('backward case '):
                row = json.loads(line[len('backward case '):])
                errors.update({g: {k: e[k] for k in (
                    'max_abs_err', 'over_tol', 'share_differ')}
                    for g, e in row['errors'].items()})
            elif line.startswith('conv case '):
                row = json.loads(line[len('conv case '):])
                errors.update(case=row['case'], y={k: row['y'][k] for k in (
                    'max_abs_err', 'over_tol', 'share_differ')},
                    s1=row['s1']['rel_err'], s2=row['s2']['rel_err'])
        failed_check = rc == 1 and 'disagrees with its plain' in text
        print('mutant ' + json.dumps(dict(mutant=name, rc=rc,
                                          caught=failed_check,
                                          errors=errors)))
        if (name == 'unchanged') != (rc == 0) or \
                (name != 'unchanged' and not failed_check):
            wrong.append('%s (rc %d):\n%s' % (name, rc, text[-3000:]))
    if wrong:
        fail('mutant check: ' + '\n'.join(wrong))
    print('mutants: all %d forward mutants caught by phase 2\'s LM case, '
          'all %d backward mutants by phase 4\'s, all %d FMA conv mutants '
          'by the %s conv case and all %d tensor-core conv mutants by the '
          'main one; the unchanged copy passes all four'
          % (len(FWD_MUTANTS), len(BWD_MUTANTS), len(CONV_MUTANTS),
             CONV_FMA_MUTANT_CASE, len(CONV_SM90_MUTANTS)))


def lm_variant_check(torch, cuda_ops, tfm, request, widths, dtype, seed,
                     label):
    """Phase 3 at other widths or in another dtype: one request through
    the LM of `widths` on the flash kernel and on plain attention, same
    seeded weights, at phase 3's tolerances."""
    cfg = tfm.lm_config(use_flash=True, **widths)
    params = tfm.params_from_jax(seeded_tree(cfg, seed), dtype=dtype,
                                 device='cuda')
    tokens, targets = request
    model = tfm.TransformerLM(cfg, params).eval()
    dense = tfm.TransformerLM(dict(cfg, use_flash=False), params).eval()
    with torch.inference_mode():
        before = cuda_ops.FLASH_FWD_LAUNCHES
        flash_logits = model(tokens).float()
        launches = cuda_ops.FLASH_FWD_LAUNCHES - before
        dense_logits = dense(tokens).float()
        finite = bool(torch.isfinite(flash_logits).all())
        err = float((flash_logits - dense_logits).abs().max())
        nll_flash = float(tfm.nll(flash_logits, targets))
        nll_plain = float(tfm.nll(dense_logits, targets))
    row = dict(config='dim %d, %d heads of %d, %d layers, %s' % (
        cfg['dim'], cfg['heads'], cfg['head_dim'], cfg['layers'],
        str(dtype).split('.')[-1]),
        launches=launches, max_abs_logit_err=err, logit_atol=LM_LOGIT_ATOL,
        nll_flash=nll_flash, nll_plain=nll_plain, nll_atol=LM_NLL_ATOL)
    print('lm %s ' % label + json.dumps(row))
    if launches != cfg['layers'] or not finite:
        fail('%s LM: %d flash launches (expected %d), finite %s'
             % (label, launches, cfg['layers'], finite))
    if err > LM_LOGIT_ATOL or abs(nll_flash - nll_plain) > LM_NLL_ATOL:
        fail('%s LM: flash and plain attention disagree: logits %.4g (tol '
             '%g), nll %.5f vs %.5f (tol %g)' % (
                 label, err, LM_LOGIT_ATOL, nll_flash, nll_plain,
                 LM_NLL_ATOL))
    return row


def host_us(torch, fn, calls):
    """Host time of one call of fn in us, over `calls` calls after 100
    warm-up calls; the device is synchronised after the clock stops."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def tensor_op_names():
    """Every name, aliases included, that the port's ops/tensor.py
    registers."""
    from mxnet_tpu_torch.ops import registry
    ops = {n for n, op in registry._OP_REGISTRY.items()
           if op.fcompute.__module__ == 'mxnet_tpu_torch.ops.tensor'}
    return ops | {a for a, n in registry._OP_ALIASES.items() if n in ops}


def nd_phase(torch, mx):
    """Phase 7: every tensor op on gpu(0) against cpu(0) on the same
    seeded inputs (tools/op_consistency.py), the samplers' moments on
    gpu(0), then the host time of a small nd op beside the same torch
    call."""
    from mxnet_tpu_torch.tools import op_consistency as oc
    names = tensor_op_names()
    t0 = time.perf_counter()
    count, bad = oc.run(mx.nd, mx.gpu(0), mx.cpu(0), ND_SIZE, seed=SEED)
    seconds = time.perf_counter() - t0
    samplers = oc.run_samplers(mx, mx.gpu(0), ND_SAMPLES, seed=SEED)
    a = mx.nd.ones((16,), ctx=mx.gpu(0))
    b = mx.nd.ones((16,), ctx=mx.gpu(0))
    ta, tb = a.handle, b.handle
    nd_us = host_us(torch, lambda: a + b, ND_HOST_CALLS)
    torch_us = host_us(torch, lambda: ta + tb, ND_HOST_CALLS)
    row = dict(ops_run=count, ops_registered=len(names),
               size=[ND_SIZE, ND_SIZE], tol=oc.TOL, tf32=False,
               mismatches=bad, seconds=seconds,
               samplers=sorted(oc.SAMPLERS) + ['multinomial'],
               sampler_draws=ND_SAMPLES, sampler_mismatches=samplers,
               host_us_nd_add_16=nd_us, host_us_torch_add_16=torch_us,
               host_calls=ND_HOST_CALLS)
    print('ndarray ' + json.dumps(row))
    if set(oc.CASES) != names or count != len(names) + len(oc.VARIANTS):
        fail('phase 7 ran %d cases; ops/tensor.py registers %d ops, and %d '
             'variants (missing %s)' % (count, len(names), len(oc.VARIANTS),
                                        sorted(names - set(oc.CASES))[:10]))
    if bad:
        fail('ops disagree between gpu(0) and cpu(0): %s' % bad)
    if samplers:
        fail('samplers on gpu(0) off their distributions: %s' % samplers)
    return row


def rtc_case(torch, mx, name):
    """Phase 8, one RTC_CASES kernel: pushed on gpu(0), held against its
    plain version on the same inputs; the first push compiles once, a
    second at the same key compiles nothing."""
    from mxnet_tpu_torch import rtc
    spec = RTC_CASES[name]
    shape = spec['shape']
    arrays = [mx.nd.array(a, ctx=mx.gpu(0), dtype=spec['dtype'])
              for a in rtc_inputs(name, shape, SEED + 9)]
    plain_ins = [a.handle.clone() for a in arrays]
    plain = rtc_plain(name, *plain_ins)
    slack = rtc_slack(torch, name, plain_ins)
    grid, block = rtc_launch_dims(name, shape)
    kern = rtc.Rtc(name, spec['ins'], spec['outs'], spec['body'])
    outs = [arrays[0]] if spec.get('in_place') else None
    compiles = rtc.RTC_COMPILES
    t0 = time.perf_counter()
    res = kern.push(arrays, outs=outs, grid_dims=grid, block_dims=block)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    compiled = rtc.RTC_COMPILES - compiles
    got = res[0].handle if outs else res.handle
    check = ulp_mismatch(torch, got, plain, spec['ulp'], slack)
    in_place = not outs or got.data_ptr() == arrays[0].handle.data_ptr()
    kern.push(arrays, outs=outs, grid_dims=grid, block_dims=block)
    torch.cuda.synchronize()
    recompiled = rtc.RTC_COMPILES - compiles - compiled
    row = dict(case=name, shape=list(shape), dtype=spec['dtype'],
               grid_dims=list(grid), block_dims=list(block),
               ulp_tol=spec['ulp'], first_push_ms=first_ms,
               compiles_first_push=compiled,
               compiles_second_push=recompiled, in_place=in_place, **check)
    print('rtc case ' + json.dumps(row))
    if not check['ok'] or not in_place:
        fail('rtc %s disagrees with its plain version: %s' % (name, row))
    if compiled != 1 or recompiled != 0:
        fail('rtc %s: %d compiles on the first push, %d on the second at '
             'the same key (expected 1 and 0)' % (name, compiled,
                                                  recompiled))
    return row


def rtc_saxpy_times(torch, mx):
    """saxpy1 at 2^26 float32 elements: the kernel's device time by
    torch.profiler, a push's time by CUDA events and by the host clock,
    its plain version and torch.addcmul by CUDA events, beside the bound:
    x and y read once and out written once."""
    from mxnet_tpu_torch import rtc
    spec = RTC_CASES['saxpy1']
    shape = spec['shape']
    x, y = [mx.nd.array(a, ctx=mx.gpu(0))
            for a in rtc_inputs('saxpy1', shape, SEED + 9)]
    out = mx.nd.empty(shape, ctx=mx.gpu(0))
    grid, block = rtc_launch_dims('saxpy1', shape)
    kern = rtc.Rtc('saxpy1', spec['ins'], spec['outs'], spec['body'])
    def push():
        kern.push([x, y], outs=[out], grid_dims=grid, block_dims=block)

    ms = profiled_ms(torch, push, 20)
    push_ms = cuda_ms(torch, push, 50)
    push_host_us = host_us(torch, push, 200)
    tx, ty = x.handle, y.handle
    plain_ms = cuda_ms(torch, lambda: rtc_plain('saxpy1', tx, ty), 20)
    one = torch.ones((), device=tx.device)
    library_ms = cuda_ms(torch, lambda: torch.addcmul(one, tx, ty), 50)
    n = shape[0]
    nbytes = 3 * n * 4
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2.0 * n / PEAK_FLOPS['float32'] * 1e3
    return dict(ms=ms, push_event_ms=push_ms, push_host_us=push_host_us,
                plain_ms=plain_ms, library_ms=library_ms,
                library_call='torch.addcmul(one, x, y) with a 0-d one',
                bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                bytes=nbytes, flops=2 * n, elements=n)


def rtc_sgd_loop(torch, mx):
    """Phase 8's path: logistic regression on two seeded Gaussian blobs
    (SGD_ROWS x SGD_FEATURES float32 on gpu(0), means +-mu with |mu| about
    2), the loss under autograd.record(), backward(), and each SGD step
    through sgd_update's Rtc in place; RTC_LAUNCHES is read from 0. Each
    step is timed by the host clock to a synchronise; the first pays for
    torch's one-time imports of its first autograd.grad."""
    from mxnet_tpu_torch import autograd, rtc
    nd, gpu = mx.nd, mx.gpu(0)
    rng = np.random.default_rng(SEED + 10)
    labels = rng.integers(0, 2, SGD_ROWS)
    mu = rng.standard_normal(SGD_FEATURES) * (2.0 / math.sqrt(SGD_FEATURES))
    xs = rng.standard_normal((SGD_ROWS, SGD_FEATURES)) + \
        np.where(labels[:, None] == 1, mu, -mu)
    X = nd.array(xs.astype(np.float32), ctx=gpu)
    Y = nd.array(labels.astype(np.float32), ctx=gpu)
    w = nd.zeros((SGD_FEATURES,), ctx=gpu)
    w.attach_grad()
    spec = RTC_CASES['sgd_update']
    sgd = rtc.Rtc('sgd_update', spec['ins'], spec['outs'], spec['body'])
    grid, block = rtc_launch_dims('sgd_update', (SGD_FEATURES,))

    def accuracy():
        return float(((nd.dot(X, w) > 0) == Y).mean().asscalar())

    acc0 = accuracy()
    rtc.RTC_LAUNCHES = 0
    losses, times = [], []
    for step in range(SGD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            p = nd.sigmoid(nd.dot(X, w))
            loss = -(Y * nd.log(p + 1e-7) +
                     (1 - Y) * nd.log(1 - p + 1e-7)).mean()
        loss.backward()
        sgd.push([w, w.grad], outs=[w], grid_dims=grid, block_dims=block)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if step in (0, SGD_STEPS - 1):
            losses.append(float(loss.asscalar()))
    launches = rtc.RTC_LAUNCHES
    acc = accuracy()

    def one_step():
        with autograd.record():
            p = nd.sigmoid(nd.dot(X, w))
            loss = -(Y * nd.log(p + 1e-7) +
                     (1 - Y) * nd.log(1 - p + 1e-7)).mean()
        loss.backward()
        sgd.push([w, w.grad], outs=[w], grid_dims=grid, block_dims=block)

    dev_ms, top, _ = profile_device(torch, one_step,
                                    'rtc imperative sgd profile, one step',
                                    8)
    step_ms = sorted(times[1:])[len(times) // 2] * 1e3
    row = dict(rows=SGD_ROWS, features=SGD_FEATURES, steps=SGD_STEPS,
               lr=RTC_LR, accuracy_before=acc0, accuracy=acc,
               loss_first=losses[0], loss_last=losses[-1],
               rtc_launches=launches, first_step_ms=times[0] * 1e3,
               step_ms_median=step_ms, profiled_device_ms=dev_ms,
               device_busy_share=dev_ms / step_ms, profile_top=top,
               w_device=str(w.handle.device))
    print('rtc imperative sgd ' + json.dumps(row))
    if not acc > 0.9 or launches != SGD_STEPS or \
            w.handle.device != gpu.torch_device:
        fail('imperative SGD through mx.rtc: accuracy %.4f (must pass 0.9), '
             '%d rtc launches (expected %d), w on %s' % (
                 acc, launches, SGD_STEPS, w.handle.device))
    return row


def rtc_phase(torch, mx):
    """Phase 8: RTC_CASES, saxpy1's times, then the imperative loop."""
    from mxnet_tpu_torch import _nvrtc, rtc
    print('rtc: NVRTC %d.%d from %s, target %s' % (
        _nvrtc.version() + (_nvrtc.nvrtc_path(), _nvrtc.ARCH)))
    before = rtc.RTC_LAUNCHES
    cases = [rtc_case(torch, mx, name) for name in RTC_CASES]
    case_launches = rtc.RTC_LAUNCHES - before
    saxpy = rtc_saxpy_times(torch, mx)
    print('rtc saxpy1 ' + json.dumps(saxpy))
    sgd = rtc_sgd_loop(torch, mx)
    return dict(cases=cases, case_launches=case_launches, saxpy=saxpy,
                sgd=sgd)


def rtc_kernel_entry(rtc_run, ptb, gluon_lm):
    """The rtc entry of the kernels line: saxpy1's times, the launches of
    the imperative loop (the path), of the case checks and of phases 14
    and 15's LSTM LMs (0)."""
    saxpy = rtc_run['saxpy']
    first = {c['case']: c for c in rtc_run['cases']}
    return dict(
        name='rtc', route='nvrtc', source='chip_smoke.py',
        wrapper='mxnet_tpu_torch/rtc.py', replaces='mxnet_tpu/rtc.py:60',
        launches=rtc_run['sgd']['rtc_launches'],
        launches_by_path=dict(rtc_cases=rtc_run['case_launches'],
                              imperative_sgd=rtc_run['sgd']['rtc_launches'],
                              lstm_ptb_train=ptb['kernel_launches']['rtc'],
                              gluon_lstm_train=gluon_lm['kernel_launches'][
                                  'rtc']),
        max_abs_err=first['saxpy1']['max_abs_err'],
        max_ulps=first['saxpy1']['max_ulps'],
        ms=saxpy['ms'], plain_ms=saxpy['plain_ms'],
        bound_ms=saxpy['bound_ms'], bound_by=saxpy['bound_by'],
        library_ms=saxpy['library_ms'], library_call=saxpy['library_call'],
        main_shape=dict(case='saxpy1', elements=saxpy['elements'],
                        dtype='float32'),
        compile_ms=first['saxpy1']['first_push_ms'],
        cases=rtc_run['cases'])


# ---------------------------------------------------------------------------
# Phase 9: the bf16 ResNet-50 v2 through Symbol, simple_bind and the
# executor, its train-mode conv -> BatchNorm pairs on the conv + BN
# statistics kernel
# ---------------------------------------------------------------------------

RESNET = dict(num_classes=1000, num_layers=50, image_shape='3,224,224',
              dtype='bfloat16')
RESNET_BATCH = 256
# the stem's conv0 -> bn0 and conv1 -> bn2, conv2 -> bn3 of each of the 16
# bottleneck units; conv3 and the shortcuts feed an elemwise_add
RESNET_PAIRS = 33
RESNET_STEPS = 4            # timed steps, after one warm-up
RESNET_EVAL_ITERS = 4       # timed eval forwards, after one warm-up
# SGD on the summed loss (SoftmaxOutput normalization 'null'), rescaled by
# 1 / batch as MXNet's optimizers take rescale_grad
RESNET_LR = 0.1
# the step with the pair route off (the conv by cuDNN, BatchNorm's own
# bf16 one-pass sums of the rounded y) against the step with it on: the
# loss within RESNET_LOSS_ATOL, the output and each moving statistic
# within its bound in relative norm. The whole network's gradients are
# reported, not gated: at initialisation it amplifies bf16 rounding into
# them (the unfused bf16 step is 1.20 apart from float32, median), so the
# gradient bound (the LM's) holds the route on one pair at each shape
RESNET_LOSS_ATOL = 5e-3
RESNET_OUT_REL, RESNET_GRAD_REL, RESNET_AUX_REL = 0.02, 0.05, 0.02
# the cut ResNet of tests/test_torch_resnet.py, gpu(0) against cpu(0)
CUT_RESNET = dict(units=[1, 1, 1, 1], num_stages=4,
                  filter_list=[8, 32, 64, 128, 256], num_classes=10,
                  image_shape=(3, 64, 64), bottle_neck=True)
CUT_RESNET_BATCH = 4
CUT_RESNET_PAIRS = 1 + 2 * len(CUT_RESNET['units'])
NO_GRAD = ('data', 'softmax_label')


def stem_split_on():
    """The executor's stem split (MXNET_TPU_STEM_SPLIT, on by default)."""
    import os
    return os.environ.get('MXNET_TPU_STEM_SPLIT', '1') not in ('0', '')


def route_pairs(pairs, split):
    """The pairs the route takes of a ResNet's `pairs`: with the stem
    split on, the stem's conv0 -> bn0 leaves it (its conv runs as
    conv(x^ gamma) + conv(beta 1), whose sums the kernel cannot give)."""
    return pairs - 1 if split else pairs


def split_word(split):
    return 'stem split %s' % ('on' if split else 'off')


def resnet_params(symbol, shapes, num_classes, seed):
    """Seeded numpy values by name: He-normal weights, gamma near 1, small
    beta, biases and moving statistics, normal images, integer labels."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    rng = np.random.default_rng(seed)
    args, auxs = {}, {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name == 'softmax_label':
            args[name] = rng.integers(0, num_classes, shape)
        elif name.endswith('_weight'):
            fan_in = int(np.prod(shape[1:]))
            args[name] = rng.standard_normal(shape, dtype=np.float32) * \
                math.sqrt(2.0 / fan_in)
        elif name.endswith('_gamma'):
            args[name] = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == 'data':
            args[name] = rng.standard_normal(shape, dtype=np.float32)
        else:
            args[name] = 0.1 * rng.standard_normal(shape)
    for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
        auxs[name] = 0.1 * rng.standard_normal(shape) \
            if name.endswith('_mean') else 1.0 + 0.1 * rng.random(shape)
    return ({k: np.asarray(v, np.float32) for k, v in args.items()},
            {k: np.asarray(v, np.float32) for k, v in auxs.items()})


def bind_resnet(mx, symbol, ctx, batch, image_shape, params):
    """simple_bind on ctx, the data and label with grad_req null, and the
    seeded parameters copied in."""
    req = {n: 'null' if n in NO_GRAD else 'write'
           for n in symbol.list_arguments()}
    ex = symbol.simple_bind(ctx, grad_req=req,
                            data=(batch,) + tuple(image_shape))
    ex.copy_params_from(*params)
    return ex


def resnet_state(torch, ex):
    """The output, every gradient and every moving statistic of the last
    step, float32 copies by name."""
    state = {'output': ex.outputs[0].handle.float().clone()}
    for name, g in ex.grad_dict.items():
        state['grad ' + name] = g.handle.float().clone()
    for name, a in ex.aux_dict.items():
        state['aux ' + name] = a.handle.float().clone()
    return state


def rel_err(torch, got, ref):
    """||got - ref|| / ||ref|| in float64 (on got's device)."""
    got = got.double().to(ref.device)
    ref = ref.double()
    return float(torch.linalg.vector_norm(got - ref) /
                 torch.linalg.vector_norm(ref).clamp_min(1e-300))


def compare_states(torch, got, ref):
    """Relative errors of every quantity of `got` against `ref`, as
    dict(out_rel, grad_rel={name: x}, aux_rel={name: x}); bn_data_gamma's
    gradient (exactly zero under fix_gamma) is left out."""
    out = dict(out_rel=rel_err(torch, got['output'], ref['output']),
               grad_rel={}, aux_rel={})
    for key, v in ref.items():
        kind, _, name = key.partition(' ')
        if kind == 'grad' and name != 'bn_data_gamma':
            out['grad_rel'][name] = rel_err(torch, got[key], v)
        elif kind == 'aux':
            out['aux_rel'][name] = rel_err(torch, got[key], v)
    return out


def spread(errs):
    """Median and largest of a {name: relative error} dict."""
    vals = sorted(errs.values())
    return dict(median=vals[len(vals) // 2], max=vals[-1],
                worst=max(errs, key=errs.get))


def nll(torch, ex, label):
    """Mean negative log-likelihood of the labels under the SoftmaxOutput
    probabilities of the last forward."""
    p = ex.outputs[0].handle.float()
    picked = p.gather(1, label.long().view(-1, 1)).clamp_min(1e-30)
    return float(-picked.log().mean())


def restore(ex, saved):
    """Put the parameters and moving statistics back (`saved` from
    `save_params`), so that two steps start alike."""
    for name, t in saved.items():
        holder = ex.arg_dict[name] if name in ex.arg_dict else \
            ex.aux_dict[name]
        holder.handle.copy_(t)


def save_params(ex):
    return {n: a.handle.clone() for n, a in
            list(ex.arg_dict.items()) + list(ex.aux_dict.items())}


def pair_shapes(symbol, batch, image_shape, executor, pairs=None):
    """The distinct pairs of the bound graph as (x NHWC, w HWIO, stride,
    pad) in the symbol's own channels, with the convs of each: every
    conv -> BatchNorm pair of the graph, or those of `pairs` (an
    executor's `pairs`, the ones its route takes)."""
    from mxnet_tpu_torch.ops import nn as nn_ops
    topo = symbol._topo()
    _, _, entries = symbol._run_shape_inference(
        {'data': (batch,) + tuple(image_shape)}, want_entries=True)
    shapes = {}
    if pairs is None:
        pairs = executor.conv_bn_pairs(topo, symbol._outputs)
    for ci in sorted(pairs):
        conv = topo[ci]
        n, c, h, w = entries[(id(conv.inputs[0][0]), conv.inputs[0][1])]
        o, _, kh, kw = entries[(id(conv.inputs[1][0]), 0)]
        _, stride, _, pad, _ = nn_ops.conv_params(conv.attrs)
        key = ((n, h, w, c), (kh, kw, c, o), tuple(stride), tuple(pad))
        shapes.setdefault(key, []).append(conv.name)
    return shapes


def resnet_kernel_checks(torch, cuda_conv, executor, shapes,
                         device='cuda'):
    """The kernel against its plain version at each shape the pair route
    gives it (Cin zero-padded as executor.padded_cin pads it; seeded x
    and w, w scaled by 0.05): y element by element (CONV_Y_TOL), s1 and
    s2 within CONV_STATS_RTOL; and the kernel's device time beside the
    bound of the symbol's conv and cuDNN's conv with the statistics
    summed after it (bench_conv_bn's yardstick) on the unpadded
    tensors."""
    from mxnet_tpu_torch.tools import bench_conv_bn as bench
    rows = []
    for i, ((xs, ws, stride, pad), convs) in enumerate(sorted(
            shapes.items())):
        gen = torch.Generator(device=device).manual_seed(SEED + 40 + i)
        cin = executor.padded_cin(xs[3])
        x = torch.randn(xs, generator=gen, device=device,
                        dtype=torch.bfloat16)
        w = torch.randn(ws, generator=gen, device=device,
                        dtype=torch.bfloat16) * 0.05
        xk = torch.nn.functional.pad(x, (0, cin - xs[3])).contiguous()
        wk = torch.nn.functional.pad(
            w, (0, 0, 0, cin - xs[3])).contiguous()
        y, s1, s2 = cuda_conv.conv_bn_stats_cuda(xk, wk, stride, pad)
        py, p1, p2 = cuda_conv.conv_bn_stats_plain(xk, wk, stride, pad)
        pf = py.float()
        y_check = conv_y_mismatch(torch, cuda_conv, y, py, xk, wk, stride,
                                  pad)
        s1_check = stats_mismatch(torch, s1, p1, pf.abs().sum((0, 1, 2)))
        s2_check = stats_mismatch(torch, s2, p2, (pf * pf).sum((0, 1, 2)))
        row = dict(x=list(xs), w=list(ws), kernel_cin=cin,
                   stride=list(stride), pad=list(pad), pairs=len(convs),
                   convs=convs, y=y_check, s1=s1_check, s2=s2_check,
                   ok=y_check['ok'] and s1_check['ok'] and s2_check['ok'])
        del y, py, pf
        row.update(bench.conv_bound(xs, ws, stride, pad, 'bfloat16'))
        row['ms'] = bench.cuda_ms(lambda: cuda_conv.conv_bn_stats_cuda(
            xk, wk, stride, pad), 5)
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row['library_ms'] = bench.cuda_ms(
            lambda: bench.yardstick(x_cl, w_cl, stride, pad), 5)
        print('resnet kernel %-40s x%d  kernel %8.4f ms  cudnn+stats '
              '%8.4f ms  bound %7.4f ms (%s)%s' % (
                  '%s %s s%d' % (tuple(xs), tuple(ws), stride[0]),
                  len(convs), row['ms'], row['library_ms'],
                  row['bound_ms'], row['bound_by'],
                  '  (Cin padded to %d)' % cin if cin != xs[3] else ''))
        rows.append(row)
        del x, w, xk, wk
    torch.cuda.synchronize()
    return rows


def pair_symbol(mx, ws, stride, pad):
    """One conv -> train-mode BatchNorm pair in bf16: float32 data cast to
    bfloat16, then the conv (no bias) and the BatchNorm."""
    data = mx.sym.Cast(mx.sym.Variable('data'), dtype='bfloat16')
    conv = mx.sym.Convolution(data, kernel=tuple(ws[:2]), num_filter=ws[3],
                              stride=tuple(stride), pad=tuple(pad),
                              no_bias=True, name='conv')
    return mx.sym.BatchNorm(conv, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name='bn')


def pair_executor_checks(torch, mx, cuda_conv, shapes, ctx):
    """At each pair shape, the one-pair graph of `pair_symbol` bound by
    simple_bind on ctx, every argument with a gradient, seeded data,
    He-normal weight, gamma, beta and head gradient: one train forward and
    backward with the executor's pair route on (one call of the conv +
    statistics Function) and one with it off (the conv and the
    BatchNorm's own sums). The output, the moving statistics and the
    gradients of data, weight, gamma and beta, in relative norm. One
    layer deep, bf16 rounding is not amplified, so this holds the route
    (its gradient through the statistics) where the whole network
    cannot."""
    device = ctx.torch_device
    on_card = device.type == 'cuda'
    rows = []
    for i, ((xs, ws, stride, pad), convs) in enumerate(sorted(
            shapes.items())):
        n, h, w, c = xs
        sym = pair_symbol(mx, ws, stride, pad)
        ex = sym.simple_bind(ctx, grad_req='write', data=(n, c, h, w))
        gen = torch.Generator(device=device).manual_seed(SEED + 70 + i)
        fan_in = ws[0] * ws[1] * ws[2]
        cout = ws[3]

        def randn(shape, scale=1.0, shift=0.0):
            return torch.randn(shape, generator=gen, device=device) * \
                scale + shift
        ex.copy_params_from(
            dict(data=randn((n, c, h, w)),
                 conv_weight=randn(ex.arg_dict['conv_weight'].shape,
                                   math.sqrt(2.0 / fan_in)),
                 bn_gamma=randn((cout,), 0.1, 1.0),
                 bn_beta=randn((cout,), 0.1)),
            dict(bn_moving_mean=randn((cout,), 0.1),
                 bn_moving_var=randn((cout,), 0.1).abs() + 1.0))
        saved = save_params(ex)
        states, launches = {}, {}
        for route in (True, False):
            restore(ex, saved)
            ex._pair_route = route
            before = (cuda_conv.CONV_BN_STATS_LAUNCHES if on_card else
                      cuda_conv.CONV_BN_STATS_PLAIN_CALLS)
            ex.forward(is_train=True)
            cot = torch.randn(ex.outputs[0].shape, device=device,
                              generator=torch.Generator(
                                  device=device).manual_seed(SEED + 90 + i))
            ex.backward(out_grads=mx.nd.NDArray(cot, ctx))
            launches[route] = (cuda_conv.CONV_BN_STATS_LAUNCHES if on_card
                               else cuda_conv.CONV_BN_STATS_PLAIN_CALLS) - \
                before
            states[route] = resnet_state(torch, ex)
        ex._pair_route = True
        got, ref = states[True], states[False]
        rows.append(dict(
            x=list(xs), w=list(ws), stride=list(stride), pad=list(pad),
            pairs=len(convs), launches_route=launches[True],
            launches_unfused=launches[False],
            finite=all(bool(torch.isfinite(v).all()) for v in got.values()),
            rel_err={k: rel_err(torch, got[k], ref[k]) for k in ref}))
        del ex, states, got, ref
    return rows


def pair_bound(name):
    """The bound of a quantity of a pair check, by its state key."""
    if name.startswith('grad '):
        return RESNET_GRAD_REL
    return RESNET_OUT_REL if name == 'output' else RESNET_AUX_REL


def resnet_gate(run):
    """Phase 9's checks on a run's numbers: a list of what failed, empty
    when it passed. `run` holds the launches of the eval forward and of
    each train step, the gradients' finiteness and which are zero, the
    unfused step's and the cut ResNet's relative errors (their gradients'
    are reported, not gated), the losses of the steps on one batch, the
    kernel checks and the one-pair executor checks."""
    bad = []
    split = run['stem_split']
    want = route_pairs(RESNET_PAIRS, split)
    if run['eval_launches'] != 0:
        bad.append('the eval forward launched the kernel %d times, '
                   'expected 0' % run['eval_launches'])
    for i, n in enumerate(run['train_launches']):
        if n != want:
            bad.append('train step %d launched the kernel %d times, '
                       'expected %d (%s)' % (i, n, want, split_word(split)))
    if not run['grad_finite']:
        bad.append('a gradient is not finite')
    if run['grad_zero'] != ['bn_data_gamma'] or \
            not run['bn_data_gamma_zero']:
        bad.append('zero gradients: %s; only bn_data_gamma (fix_gamma) '
                   'should be, and exactly' % run['grad_zero'])
    for what in ('unfused', 'unfused_split'):
        unfused = run[what]
        if unfused['launches'] != 0:
            bad.append('%s: the step with the pair route off launched the '
                       'kernel %d times' % (what, unfused['launches']))
        if not unfused['loss_err'] <= RESNET_LOSS_ATOL:
            bad.append('%s: loss differs by %.3g (bound %.3g)'
                       % (what, unfused['loss_err'], RESNET_LOSS_ATOL))
    cut_want = route_pairs(CUT_RESNET_PAIRS, split)
    if run['cut']['launches'] != cut_want:
        bad.append('cut: the gpu step launched the kernel %d times, '
                   'expected %d (%s)' % (run['cut']['launches'], cut_want,
                                         split_word(split)))
    for what in ('unfused', 'unfused_split', 'cut'):
        cmp_ = run[what]
        errs = dict(cmp_['aux_rel'], output=cmp_['out_rel'])
        for name, err in errs.items():
            bound = RESNET_OUT_REL if name == 'output' else RESNET_AUX_REL
            if not err <= bound:
                bad.append('%s: %s differs by %.3g (bound %.3g)'
                           % (what, name, err, bound))
    losses = run['losses']
    if not losses[-1] < losses[0]:
        bad.append('the loss on one batch did not fall: %s' % losses)
    for row in run['kernel_checks']:
        if not row['ok']:
            bad.append('the kernel disagrees with its plain version at %s'
                       % row)
    if not run['pair_checks']:
        bad.append('no one-pair executor check ran')
    for row in run['pair_checks']:
        where = '%s %s s%s' % (row['x'], row['w'], row['stride'])
        if row['launches_route'] != 1 or row['launches_unfused'] != 0:
            bad.append('pair %s: the route launched the kernel %d times '
                       'and the unfused pair %d, expected 1 and 0'
                       % (where, row['launches_route'],
                          row['launches_unfused']))
        if not row['finite']:
            bad.append('pair %s: a value is not finite' % where)
        for name, err in row['rel_err'].items():
            if not err <= pair_bound(name):
                bad.append('pair %s: %s differs by %.3g between the route '
                           'and the unfused pair (bound %.3g)'
                           % (where, name, err, pair_bound(name)))
    return bad


def route_comparison(torch, mx, cuda_conv, symbol, shape, params, ctx,
                     split, residual_scale):
    """One train step of the network with the pair route on and one with
    it off, from the same seeded values, bound with the stem split on or
    off, each residual branch's last conv scaled by `residual_scale`:
    their relative errors, loss difference and the off step's launches.

    Phase 9 gates two of these: the He-normal network with the split off
    (the comparison of PRs 8-10, made before the port had a split) and
    phase 11's conditioned network with the split on (the default). At
    initialisation the He-normal network amplifies any rounding of the
    route's statistics into its output, by an amount that depends on
    which roundings differ: with the split on, the 32 routed pairs'
    differences reach 0.033 of its train output, where the 33 pairs
    without the split gave 0.016 (PERF.md); phase 9 reports that
    reading."""
    import os
    args, auxs = params
    args = {n: (a * np.float32(residual_scale)
                if n.endswith('_conv3_weight') else a)
            for n, a in args.items()}
    old = os.environ.get('MXNET_TPU_STEM_SPLIT')
    os.environ['MXNET_TPU_STEM_SPLIT'] = '1' if split else '0'
    try:
        ex = bind_resnet(mx, symbol, ctx, RESNET_BATCH, shape, (args, auxs))
    finally:
        if old is None:
            os.environ.pop('MXNET_TPU_STEM_SPLIT')
        else:
            os.environ['MXNET_TPU_STEM_SPLIT'] = old
    label = ex.arg_dict['softmax_label'].handle
    saved = save_params(ex)
    states, losses = {}, {}
    for route in (True, False):
        restore(ex, saved)
        ex._pair_route = route
        before = cuda_conv.CONV_BN_STATS_LAUNCHES
        ex.forward_backward()
        torch.cuda.synchronize()
        launches = cuda_conv.CONV_BN_STATS_LAUNCHES - before
        states[route] = resnet_state(torch, ex)
        losses[route] = nll(torch, ex, label)
    out = compare_states(torch, states[True], states[False])
    out.update(split=split, residual_scale=residual_scale,
               loss_err=abs(losses[True] - losses[False]),
               loss_fused=losses[True], loss_unfused=losses[False],
               launches=launches, grad_spread=spread(out['grad_rel']))
    del ex, states, saved
    torch.cuda.empty_cache()
    return out


def cut_resnet_check(torch, mx, cuda_conv, gpu):
    """The cut ResNet in bf16 with the pair route, one step on gpu(0)
    (the kernel) and one on cpu(0) (its plain version) from the same
    seeded values."""
    symbol = mx.models.resnet.resnet(dtype='bfloat16', **CUT_RESNET)
    shape = CUT_RESNET['image_shape']
    params = resnet_params(symbol, dict(data=(CUT_RESNET_BATCH,) + shape),
                           CUT_RESNET['num_classes'], SEED + 60)
    states = {}
    launches = None
    for key, ctx in (('gpu', gpu), ('cpu', mx.cpu(0))):
        ex = bind_resnet(mx, symbol, ctx, CUT_RESNET_BATCH, shape, params)
        before = cuda_conv.CONV_BN_STATS_LAUNCHES
        ex.forward_backward()
        if key == 'gpu':
            launches = cuda_conv.CONV_BN_STATS_LAUNCHES - before
        states[key] = {k: v.cpu() for k, v in resnet_state(torch, ex).items()}
    out = compare_states(torch, states['gpu'], states['cpu'])
    return dict(out, launches=launches, grad_spread=spread(out['grad_rel']))


def kernel_class(name):
    """The class of a CUDA kernel by its name, for phase 9's breakdown."""
    n = name.lower()
    if 'conv_bn_stats' in n:
        return 'conv_bn_stats kernel (and its finalize)'
    if 'direct_copy' in n:
        return 'copies (direct_copy_kernel_cuda)'
    if any(k in n for k in ('fprop', 'dgrad', 'wgrad', 'conv', 'nchwtonhwc',
                            'nhwctonchw', 'implicit')):
        return 'cuDNN convolutions'
    # cuBLAS's products run on xmma and cutlass kernels too: a gemm that
    # names no convolution is a product (FullyConnected, the RNN's)
    if 'gemm' in n:
        return 'GEMM (FullyConnected, the RNN\'s products)'
    if any(k in n for k in ('cudnn', 'xmma', 'cutlass')):
        return 'cuDNN convolutions'
    if 'pool' in n:
        return 'pooling'
    if 'reduce' in n:
        return 'reductions (BatchNorm statistics, sums)'
    if 'multi_tensor_apply' in n or 'foreach' in n:
        return 'optimizer update (torch._foreach_*)'
    if 'elementwise' in n:
        return 'elementwise (BatchNorm scale and shift, ReLU, adds, casts)'
    return 'other'


def op_device_ms(events, key):
    """Device time (ms) under the op or autograd node `key`, its children's
    kernels included."""
    total = 0.0
    for e in events:
        if e.key == key:
            total += (getattr(e, 'device_time_total', None) or
                      getattr(e, 'cuda_time_total', 0)) / 1e3
    return total


def resnet_profile(torch, step, step_ms):
    """One train step under torch.profiler: the device time by kernel
    class, the device time under the conv + statistics Function's backward
    and under the unpaired convs, and the device-busy share against the
    timed step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the copies (aten::copy_: casts, .contiguous(), .to()) by input shape
    copies = [dict(shapes=str(e.input_shapes)[:160], count=e.count,
                   ms=(getattr(e, 'device_time_total', None) or
                       getattr(e, 'cuda_time_total', 0)) / 1e3)
              for e in prof.key_averages(group_by_input_shape=True)
              if e.key == 'aten::copy_']
    copies = sorted(copies, key=lambda c: -c['ms'])[:10]
    kernels = [e for e in events
               if str(getattr(e, 'device_type', '')).endswith('CUDA')]
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    classes = {}
    for e in kernels:
        c = classes.setdefault(kernel_class(e.key), dict(ms=0.0, launches=0))
        c['ms'] += device_us(e) / 1e3
        c['launches'] += e.count
    for c in classes.values():
        c['share'] = c['ms'] / max(device_ms, 1e-9)
    ops = {
        'conv_bn_stats Function backward (fold, cuDNN dgrad and wgrad)':
            'autograd::engine::evaluate_function: _ConvBnStatsBackward',
        'unpaired convs, forward (cuDNN)': 'aten::cudnn_convolution',
        'unpaired convs, backward (cuDNN)':
            'autograd::engine::evaluate_function: ConvolutionBackward0',
    }
    by_op = {}
    for label, key in ops.items():
        ms = op_device_ms(events, key)
        by_op[label] = dict(op=key, ms=ms, share=ms / max(device_ms, 1e-9))
    top = [dict(kernel=e.key[:160], ms=device_us(e) / 1e3, count=e.count)
           for e in sorted(kernels, key=lambda e: -device_us(e))[:12]]
    return dict(device_ms=device_ms, step_ms=step_ms,
                device_busy_share=device_ms / step_ms, classes=classes,
                by_op=by_op, top=top, copies_by_shape=copies)


def resnet_phase(torch, mx, cuda_conv, ctx=None):
    """Phase 9: the bf16 ResNet-50 v2 at batch 256 through simple_bind on
    gpu(0): the eval forward (no kernel launch), the train step (32 with
    the stem split on, 33 with it off), its
    gradients, the step with the pair route off, the kernel and a one-pair
    graph through the executor at every shape the route gives it, the cut
    ResNet on gpu(0) against cpu(0), timed steps with the route on and
    off, timed eval forwards, and one step's profile."""
    from mxnet_tpu_torch import executor
    ctx = ctx or mx.gpu(0)
    t0 = time.perf_counter()
    symbol = mx.models.resnet.get_symbol(**RESNET)
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    params = resnet_params(symbol, dict(data=(RESNET_BATCH,) + shape),
                           RESNET['num_classes'], SEED + 50)
    ex = bind_resnet(mx, symbol, ctx, RESNET_BATCH, shape, params)
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    label = ex.arg_dict['softmax_label'].handle
    split = stem_split_on()
    if len(ex.pairs) != route_pairs(RESNET_PAIRS, split):
        fail('resnet: the executor routes %d conv -> BatchNorm pairs, '
             'expected %d (%s)' % (len(ex.pairs),
                                   route_pairs(RESNET_PAIRS, split),
                                   split_word(split)))
    saved = save_params(ex)

    # the eval forward: no pair route
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    ex.forward(is_train=False)
    torch.cuda.synchronize()
    eval_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
    probs = ex.outputs[0].handle
    eval_ok = tuple(probs.shape) == (RESNET_BATCH, RESNET['num_classes']) \
        and bool(torch.isfinite(probs).all())

    # the train step with the pair route, then without, from one start
    ex.forward_backward()
    fused = resnet_state(torch, ex)
    fused_loss = nll(torch, ex, label)
    grads = {k[5:]: v for k, v in fused.items() if k.startswith('grad ')}
    grad_finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    grad_zero = sorted(n for n, g in grads.items() if not bool(g.any()))
    bn_data_gamma_zero = not bool(grads['bn_data_gamma'].any())
    restore(ex, saved)
    ex._pair_route = False
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    ex.forward_backward()
    torch.cuda.synchronize()
    unfused_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
    unfused = resnet_state(torch, ex)
    unfused_loss = nll(torch, ex, label)
    ex._pair_route = True
    # the route on against off at the default (the split on) on this
    # seeded network: reported (route_comparison's docstring)
    unfused_he = compare_states(torch, fused, unfused)
    unfused_he.update(loss_err=abs(fused_loss - unfused_loss),
                      loss_fused=fused_loss, loss_unfused=unfused_loss,
                      launches=unfused_launches,
                      grad_spread=spread(unfused_he['grad_rel']))
    del fused, unfused, grads
    torch.cuda.empty_cache()
    unfused_cmp = route_comparison(torch, mx, cuda_conv, symbol, shape,
                                   params, ctx, False, 1.0)
    unfused_split = route_comparison(torch, mx, cuda_conv, symbol, shape,
                                     params, ctx, True, SERVE_RESIDUAL_SCALE)

    # the kernel, and one pair through the executor, at every shape the
    # path gives it
    shapes = pair_shapes(symbol, RESNET_BATCH, shape, executor)
    kernel_checks = resnet_kernel_checks(torch, cuda_conv, executor, shapes,
                                         ctx.torch_device)
    pair_checks = pair_executor_checks(torch, mx, cuda_conv, shapes, ctx)
    torch.cuda.empty_cache()

    # the cut ResNet, gpu(0) against cpu(0)
    cut = cut_resnet_check(torch, mx, cuda_conv, ctx)

    # timed steps: forward_backward and w -= lr / batch * g through nd ops
    def step():
        ex.forward_backward()
        for name, g in ex.grad_dict.items():
            ex.arg_dict[name] -= g * (RESNET_LR / RESNET_BATCH)

    def timed_steps():
        restore(ex, saved)
        losses, times, launches = [], [], []
        for i in range(1 + RESNET_STEPS):
            before = cuda_conv.CONV_BN_STATS_LAUNCHES
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            launches.append(cuda_conv.CONV_BN_STATS_LAUNCHES - before)
            losses.append(nll(torch, ex, label))
        return losses, times, launches

    # the main path: every count set to 0 just before it, read just after
    torch.cuda.reset_peak_memory_stats()
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    losses, times, train_launches = timed_steps()
    train_path_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
    peak_bytes = torch.cuda.max_memory_allocated()
    step_ms = sorted(times[1:])[len(times[1:]) // 2] * 1e3
    step_device_ms = sum(device_us(e) for e in device_events(
        torch, step)) / 1e3
    # the same steps with the pair route off
    ex._pair_route = False
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    _, off_times, _ = timed_steps()
    off_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
    off_ms = sorted(off_times[1:])[len(off_times[1:]) // 2] * 1e3
    off_device_ms = sum(device_us(e) for e in device_events(
        torch, step)) / 1e3
    ex._pair_route = True
    restore(ex, saved)

    # eval forwards
    eval_times = []
    for i in range(1 + RESNET_EVAL_ITERS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ex.forward(is_train=False)
        torch.cuda.synchronize()
        eval_times.append(time.perf_counter() - t1)
    eval_ms = sorted(eval_times[1:])[len(eval_times[1:]) // 2] * 1e3
    eval_device_ms = sum(device_us(e) for e in device_events(
        torch, lambda: ex.forward(is_train=False))) / 1e3

    profile = resnet_profile(torch, step, step_ms)
    for label_, c in sorted(profile['classes'].items(),
                            key=lambda kv: -kv[1]['ms']):
        print('resnet profile: %-62s %8.3f ms %5.1f %%  %5d launches'
              % (label_, c['ms'], 100 * c['share'], c['launches']))
    for label_, c in profile['by_op'].items():
        print('resnet profile: %-62s %8.3f ms %5.1f %%'
              % (label_, c['ms'], 100 * c['share']))

    run = dict(
        config=dict(RESNET, batch=RESNET_BATCH, pairs=len(ex.pairs),
                    convs=sum(1 for n in symbol._topo() if n.op is not None
                              and n.op.name == 'Convolution')),
        stem_split=split,
        bind_s=bind_s, eval_launches=eval_launches, eval_ok=eval_ok,
        train_launches=train_launches,
        train_path_launches=train_path_launches,
        grad_finite=grad_finite, grad_zero=grad_zero,
        bn_data_gamma_zero=bn_data_gamma_zero,
        unfused=unfused_cmp, unfused_split=unfused_split,
        unfused_split_he_normal=unfused_he, cut=cut, losses=losses,
        lr=RESNET_LR,
        step_ms=[t * 1e3 for t in times], step_ms_median=step_ms,
        step_device_ms=step_device_ms,
        images_per_s=RESNET_BATCH / (step_ms / 1e3),
        peak_bytes=peak_bytes,
        route_off=dict(step_ms=[t * 1e3 for t in off_times],
                       step_ms_median=off_ms, step_device_ms=off_device_ms,
                       images_per_s=RESNET_BATCH / (off_ms / 1e3),
                       launches=off_launches),
        eval_ms=[t * 1e3 for t in eval_times], eval_ms_median=eval_ms,
        eval_images_per_s=RESNET_BATCH / (eval_ms / 1e3),
        eval_device_ms=eval_device_ms,
        eval_device_busy_share=eval_device_ms / eval_ms,
        kernel_checks=kernel_checks, pair_checks=pair_checks,
        profile=profile)
    print('resnet ' + json.dumps(run))
    bad = resnet_gate(run)
    if not eval_ok:
        bad.append('the eval forward gave %s probabilities or non-finite '
                   'ones' % (tuple(probs.shape),))
    if off_launches:
        bad.append('the timed steps with the pair route off launched the '
                   'kernel %d times' % off_launches)
    if bad:
        fail('resnet: ' + '; '.join(bad))
    print('resnet: %.1f ms a train step (%.0f images/s, device %.1f ms), '
          'route off %.1f ms (device %.1f ms); %.1f ms an eval forward '
          '(%.0f images/s, device busy %.1f %%), peak %.2f GB, launches a '
          'step %s; whole-step gradients, route on against off: median '
          '%.3g, max %.3g (reported)'
          % (step_ms, run['images_per_s'], step_device_ms, off_ms,
             off_device_ms, eval_ms, run['eval_images_per_s'],
             100 * run['eval_device_busy_share'], peak_bytes / 1e9,
             train_launches, unfused_cmp['grad_spread']['median'],
             unfused_cmp['grad_spread']['max']))
    return run


# ---------------------------------------------------------------------------
# Phase 10: Module.fit trains the bf16 ResNet-50 v2 of phase 9 with
# multi-precision momentum SGD, its conv -> BatchNorm pairs on the conv +
# BN statistics kernel
# ---------------------------------------------------------------------------

MODULE_BATCHES = 6          # batches an epoch
MODULE_EPOCHS = 2
MODULE_OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                  multi_precision=True)
# the MultiFactorScheduler's milestone: lr x MODULE_LR_FACTOR after it
MODULE_LR_STEP, MODULE_LR_FACTOR = 8, 0.1
MODULE_SPEEDOMETER = 2      # Speedometer's period, in batches
MODULE_PREFETCH = 2
MODULE_LOSS_STEPS = 5       # steps on one fixed batch whose loss must fall
MODULE_TIMED = 4            # update / split timings, after one warm-up
# the Module step (FusedSGD) against the executor step and the per-key
# registered update ops: bf16 weights within one bf16 step, float32
# weights, masters and momenta within this relative norm
MODULE_STATE_REL = 1e-6


def module_symbol_params(mx):
    """The phase's network and its Xavier initializer, the example's
    (examples/image_classification/common/fit.py)."""
    symbol = mx.models.resnet.get_symbol(**RESNET)
    init = mx.init.Xavier(rnd_type='gaussian', factor_type='in', magnitude=2)
    return symbol, init


def module_data(num_classes, n, image_shape, seed):
    """Seeded synthetic images (float32, N(0, 1)) and integer labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + tuple(image_shape), dtype=np.float32)
    y = rng.integers(0, num_classes, n).astype(np.float32)
    return x, y


def module_optimizer_params(mx):
    return dict(MODULE_OPT, lr_scheduler=mx.lr_scheduler.MultiFactorScheduler(
        step=[MODULE_LR_STEP], factor=MODULE_LR_FACTOR))


def module_snapshot(mod):
    """Everything one step changes: bound weights and moving statistics,
    the FusedSGD's momenta and masters, the update counts and the
    schedule's state, as device clones. (Not the bound data and label: a
    batch already on the device is bound as it is, and writing into it
    would change the batch.)"""
    ex = mod._exec_group.executor
    fu = mod._fused_updater
    opt = mod._optimizer
    sched = opt.lr_scheduler
    return dict(
        args={n: ex.arg_dict[n].handle.clone() for n in fu.param_names},
        auxs={n: a.handle.clone() for n, a in ex.aux_dict.items()},
        moms={n: t.clone() for n, t in fu.states.items()},
        masters={n: None if t is None else t.clone()
                 for n, t in fu.masters.items()},
        counts=dict(opt._index_update_count), num_update=opt.num_update,
        sched=dict(sched.__dict__) if sched is not None else None)


def module_restore(mod, snap):
    ex = mod._exec_group.executor
    fu = mod._fused_updater
    opt = mod._optimizer
    for n, t in snap['args'].items():
        ex.arg_dict[n].handle.copy_(t)
    for n, t in snap['auxs'].items():
        ex.aux_dict[n].handle.copy_(t)
    fu.states = {n: t.clone() for n, t in snap['moms'].items()}
    fu.masters = {n: None if t is None else t.clone()
                  for n, t in snap['masters'].items()}
    opt._index_update_count = dict(snap['counts'])
    opt.num_update = snap['num_update']
    if snap['sched'] is not None:
        opt.lr_scheduler.__dict__.update(snap['sched'])
    mod._params_dirty = True


def module_state(mod):
    """Weights, moving statistics, momenta and masters after a step."""
    ex = mod._exec_group.executor
    fu = mod._fused_updater
    state = {'arg ' + n: ex.arg_dict[n].handle.clone()
             for n in fu.param_names}
    state.update(('aux ' + n, a.handle.clone())
                 for n, a in ex.aux_dict.items())
    state.update(('mom ' + n, t.clone()) for n, t in fu.states.items())
    state.update(('master ' + n, t.clone()) for n, t in fu.masters.items()
                 if t is not None)
    return state


def bf16_steps(torch, got, ref):
    """The largest |got - ref| in units of one bf16 step (the spacing of
    bf16 numbers at |ref|: 2^(e - 8) for |ref| in [2^(e-1), 2^e))."""
    ref32 = ref.float()
    _, exp = torch.frexp(ref32.abs())
    spacing = torch.ldexp(torch.ones_like(ref32), exp - 8)
    spacing = torch.where(ref32 == 0, torch.full_like(ref32, 2.0 ** -133),
                          spacing)
    return float(((got.float() - ref32).abs() / spacing).max())


def op_update(mx, mod):
    """The per-key update through the registered optimizer ops, on the
    FusedSGD's momenta and masters: mp_sgd_mom_update for the bf16
    weights, sgd_mom_update for the float32 ones, lr and wd from the
    module's optimizer, counted by name as FusedSGD counts."""
    ex = mod._exec_group.executor
    fu = mod._fused_updater
    opt = mod._optimizer
    ctx = ex._ctx
    hyper = dict(momentum=opt.momentum, rescale_grad=opt.rescale_grad)
    for name in fu.param_names:
        opt._update_count(name)
        lr, wd = opt._get_lr(name), opt._get_wd(name)
        w, g = ex.arg_dict[name], ex.grad_dict[name]
        mom = mx.nd.NDArray(fu.states[name], ctx)
        if fu.masters[name] is not None:
            w32 = mx.nd.NDArray(fu.masters[name], ctx)
            mx.nd.mp_sgd_mom_update(w, g, mom, w32, out=w, lr=lr, wd=wd,
                                    **hyper)
            fu.masters[name] = w32.handle
        else:
            mx.nd.sgd_mom_update(w, g, mom, out=w, lr=lr, wd=wd, **hyper)
        fu.states[name] = mom.handle


def module_update_check(torch, mx, mod, batch):
    """One Module step (forward_backward, then update through FusedSGD)
    against phase 9's executor step followed by the per-key registered
    ops, from one saved start on one batch."""
    snap = module_snapshot(mod)
    ex = mod._exec_group.executor
    mod.forward_backward(batch)
    grads = {n: ex.grad_dict[n].handle.clone()
             for n in mod._fused_updater.param_names}
    mod.update()
    fused = module_state(mod)
    module_restore(mod, snap)
    mod._exec_group.load_data_batch(batch)
    ex.forward_backward()
    grads_equal = all(torch.equal(ex.grad_dict[n].handle, g)
                      for n, g in grads.items())
    op_update(mx, mod)
    ops = module_state(mod)
    module_restore(mod, snap)
    weight_steps, rel = {}, {}
    for key, ref in ops.items():
        if key.startswith('arg ') and ref.dtype == torch.bfloat16:
            weight_steps[key[4:]] = bf16_steps(torch, fused[key], ref)
        elif not key.startswith('aux '):
            rel[key] = rel_err(torch, fused[key], ref)
    worst = max(rel, key=rel.get)
    return dict(grads_equal=grads_equal,
                weight_steps_max=max(weight_steps.values()),
                weight_steps_worst=max(weight_steps, key=weight_steps.get),
                state_rel_max=rel[worst], state_rel_worst=worst,
                bf16_weights=len(weight_steps), float32_states=len(rel))


def module_prefetch_check(torch, mx, mod, x, y, batches, ctx):
    """`batches` steps on batches staged by prefetch_to_device (copies on
    a side stream, the next batch staged while this one's step runs, no
    host sync between steps) against the same steps on batches copied in
    the step, from one start: the outputs must be the same bits."""
    snap = module_snapshot(mod)
    outs = {}
    for staged in (True, False):
        module_restore(mod, snap)
        it = mx.io.NDArrayIter(x, y, batch_size=RESNET_BATCH)
        if staged:
            it = mx.io.prefetch_to_device(it, size=MODULE_PREFETCH,
                                          device=ctx)
        got = []
        for i, batch in enumerate(it):
            if i == batches:
                break
            mod.forward_backward(batch)
            mod.update()
            got.append(mod.get_outputs()[0].handle.clone())
        if staged:
            it.close()
        outs[staged] = got
    module_restore(mod, snap)
    return all(torch.equal(a, b) for a, b in zip(outs[True], outs[False])) \
        and len(outs[True]) == batches


def module_resume_check(torch, mx, mod, batch, prefix, ctx):
    """save_checkpoint with the optimizer states, Module.load with them,
    one step: it must equal the uninterrupted module's next step bit for
    bit (weights, moving statistics, momenta, masters)."""
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    mod.forward_backward(batch)
    mod.update()
    ref = {k: v.cpu() for k, v in module_state(mod).items()}
    sym_ = mod.symbol
    data_shapes = mod.data_shapes
    label_shapes = mod.label_shapes
    resumed = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                 context=ctx)
    resumed.bind(data_shapes=data_shapes, label_shapes=label_shapes)
    resumed.init_optimizer(optimizer='sgd',
                           optimizer_params=module_optimizer_params(mx))
    resumed.forward_backward(batch)
    resumed.update()
    got = {k: v.cpu() for k, v in module_state(resumed).items()}
    differ = sorted(k for k in ref if k not in got or
                    not torch.equal(got[k], ref[k]))
    missing = sorted(set(got) - set(ref))
    same_symbol = sym_.tojson() == resumed.symbol.tojson()
    del resumed
    return dict(differ=differ + missing, compared=len(ref),
                same_symbol=same_symbol)


class _LogCapture:
    """The root logger's records while in use, at INFO."""

    def __init__(self):
        import logging
        self.records = []
        capture = self

        class Handler(logging.Handler):
            def emit(self, record):
                capture.records.append(record.getMessage())
        self._handler = Handler(logging.INFO)
        self._logging = logging

    def __enter__(self):
        root = self._logging.getLogger()
        self._level = root.level
        root.addHandler(self._handler)
        root.setLevel(self._logging.INFO)
        return self

    def __exit__(self, *exc):
        root = self._logging.getLogger()
        root.removeHandler(self._handler)
        root.setLevel(self._level)


def module_fit(mx, cuda_conv, mod, train, init, num_epoch, callbacks=(),
               epoch_end=None, begin_epoch=0):
    """mod.fit on `train` (a prefetch_to_device iterator), recording each
    batch's end time (host clock), kernel launches, lr and the host ms
    its next() waited for the batch; returns (times, launches, lrs,
    stalls, the metric's values)."""
    times, launches, lrs, stalls = [], [], [], []
    count = [cuda_conv.CONV_BN_STATS_LAUNCHES, 0.0]

    def record(param):
        times.append((param.epoch, time.perf_counter()))
        launches.append(cuda_conv.CONV_BN_STATS_LAUNCHES - count[0])
        stalls.append(train.input_stall_ms - count[1])
        count[:] = [cuda_conv.CONV_BN_STATS_LAUNCHES, train.input_stall_ms]
        lrs.append(mod._optimizer._get_lr(mod._fused_updater.param_names[0]))

    metric = mx.metric.create(['acc', mx.metric.TopKAccuracy(top_k=5)])
    mod.fit(train, eval_metric=metric, optimizer='sgd',
            optimizer_params=module_optimizer_params(mx),
            initializer=init,
            batch_end_callback=list(callbacks) + [record],
            epoch_end_callback=epoch_end, begin_epoch=begin_epoch,
            num_epoch=begin_epoch + num_epoch)
    return times, launches, lrs, stalls, [
        (n, float(v)) for n, v in metric.get_name_value()]


def step_intervals(times):
    """Host ms between consecutive batch ends of one epoch (the intervals
    across an epoch's end, which holds its checkpoint and callbacks, are
    left out)."""
    return [(t1 - t0) * 1e3 for (e0, t0), (e1, t1) in zip(times, times[1:])
            if e0 == e1]


def median(vals):
    vals = sorted(vals)
    return vals[len(vals) // 2]


def module_timings(torch, mod, batch, metric, device):
    """Host ms of forward_backward (to return, and to the end of its device
    work), update (to return; its device time by CUDA events, queued
    behind a spin), update_metric (which waits for the step and reads
    the outputs back) and of the metric alone on read-back outputs; and
    the H2D copy of one batch from pinned and from pageable memory."""
    from mxnet_tpu_torch.tools import bench_conv_bn as bench
    snap = module_snapshot(mod)
    rows = []
    for i in range(1 + MODULE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        mod.update()
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        mod.update_metric(metric, batch.label)
        t5 = time.perf_counter()
        mod.update_metric(metric, batch.label)
        t6 = time.perf_counter()
        rows.append(dict(fb_host_ms=(t1 - t0) * 1e3,
                         fb_total_ms=(t2 - t0) * 1e3,
                         update_host_ms=(t3 - t2) * 1e3,
                         update_total_ms=(t4 - t2) * 1e3,
                         metric_ms=(t5 - t4) * 1e3,
                         metric_again_ms=(t6 - t5) * 1e3))
    # the update's own device time: launches queued behind a spin, so
    # that the host's pace does not show in it
    update_device_ms = bench.cuda_ms(mod.update, MODULE_TIMED)
    module_restore(mod, snap)
    rows = rows[1:]
    out = {k: median([r[k] for r in rows]) for k in rows[0]}
    out['update_device_ms'] = update_device_ms
    host = batch.data[0].handle
    pinned = host.pin_memory()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    copies = []
    for src in (pinned, host):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        dst = src.to(device)
        ev1.record()
        torch.cuda.synchronize()
        copies.append(((time.perf_counter() - t0) * 1e3,
                       ev0.elapsed_time(ev1)))
        del dst
    t0 = time.perf_counter()
    host.pin_memory()
    out.update(h2d_pinned_ms=copies[0][0], h2d_pinned_device_ms=copies[0][1],
               h2d_pageable_ms=copies[1][0],
               h2d_pageable_device_ms=copies[1][1],
               pin_copy_ms=(time.perf_counter() - t0) * 1e3,
               batch_bytes=host.numel() * host.element_size())
    return out


def module_gate(run):
    """Phase 10's checks on a run's numbers: a list of what failed, empty
    when it passed."""
    bad = []
    split = run['stem_split']
    want = route_pairs(RESNET_PAIRS, split)
    for i, n in enumerate(run['train_launches']):
        if n != want:
            bad.append('fit step %d launched the kernel %d times, expected '
                       '%d (%s)' % (i, n, want, split_word(split)))
    if len(run['train_launches']) != MODULE_EPOCHS * MODULE_BATCHES:
        bad.append('fit ran %d steps, expected %d'
                   % (len(run['train_launches']),
                      MODULE_EPOCHS * MODULE_BATCHES))
    if run['fit_launches'] != want * len(run['train_launches']):
        bad.append('fit launched the kernel %d times in all'
                   % run['fit_launches'])
    if run['eval_launches'] != 0:
        bad.append('predict and score launched the kernel %d times, '
                   'expected 0' % run['eval_launches'])
    if run['route_off']['launches'] != 0:
        bad.append('fit with the pair route off launched the kernel %d '
                   'times' % run['route_off']['launches'])
    lrs, base = run['lrs'], MODULE_OPT['learning_rate']
    want = [base if i < MODULE_LR_STEP else base * MODULE_LR_FACTOR
            for i in range(len(lrs))]
    if any(abs(a - b) > 1e-12 for a, b in zip(lrs, want)):
        bad.append('the lr schedule gave %s, expected %s' % (lrs, want))
    for name, wd in run['wd'].items():
        decays = name.endswith(('_weight', '_gamma'))
        if wd != (MODULE_OPT['wd'] if decays else 0.0):
            bad.append('%s decays with wd %g' % (name, wd))
    if run['masters'] != run['low_precision_params']:
        bad.append('float32 masters for %s, but the bf16 parameters are %s'
                   % (run['masters'], run['low_precision_params']))
    if run['master_dtypes'] != ['float32']:
        bad.append('master dtypes %s' % run['master_dtypes'])
    if not run['finite']:
        bad.append('a weight, statistic or optimizer state is not finite')
    upd = run['update']
    if not upd['weight_steps_max'] <= 1.0:
        bad.append('update: the FusedSGD step and the per-key ops differ by '
                   '%.3g bf16 steps (%s)' % (upd['weight_steps_max'],
                                             upd['weight_steps_worst']))
    if not upd['state_rel_max'] <= MODULE_STATE_REL:
        bad.append('update: %s differs by %.3g (bound %g)'
                   % (upd['state_rel_worst'], upd['state_rel_max'],
                      MODULE_STATE_REL))
    if not run['prefetch_equal']:
        bad.append('the prefetched steps\' outputs differ from the '
                   'unprefetched ones')
    losses = run['losses']
    if not losses[-1] < losses[0]:
        bad.append('the loss on one batch did not fall: %s' % losses)
    resume = run['resume']
    if resume['differ'] or not resume['compared'] or \
            not resume['same_symbol']:
        bad.append('the resumed step differs from the uninterrupted one '
                   'in %s' % (resume['differ'][:8] or 'its symbol',))
    if not run['speedometer']:
        bad.append('the Speedometer logged no rate')
    if not run['score_finite']:
        bad.append('score gave %s' % run['score'])
    return bad


def module_phase(torch, mx, cuda_conv, root, resnet=None, ctx=None):
    """Phase 10: Module.fit trains the bf16 ResNet-50 at batch 256 on
    gpu(0); its launches, update, schedule, state, prefetch, loss and
    resume gated (module_gate), its times and profile printed beside
    phase 9's."""
    import shutil
    ctx = ctx or mx.gpu(0)
    torch.cuda.empty_cache()
    symbol, init = module_symbol_params(mx)
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    x, y = module_data(RESNET['num_classes'], MODULE_BATCHES * RESNET_BATCH,
                       shape, SEED + 100)
    ckpt_dir = root / 'build' / 'phase10'
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    prefix = str(ckpt_dir / 'resnet50')
    try:
        t0 = time.perf_counter()
        mod = mx.mod.Module(symbol, context=ctx)
        np.random.seed(SEED)
        speedo = mx.callback.Speedometer(RESNET_BATCH, MODULE_SPEEDOMETER,
                                         auto_reset=False)

        def train_iter():
            return mx.io.prefetch_to_device(
                mx.io.NDArrayIter(x, y, batch_size=RESNET_BATCH,
                                  shuffle=True),
                size=MODULE_PREFETCH, device=ctx)

        # the main path: the count set to 0 just before, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        train = train_iter()
        cuda_conv.CONV_BN_STATS_LAUNCHES = 0
        with _LogCapture() as logs:
            times, launches, lrs, stalls, train_metric = module_fit(
                mx, cuda_conv, mod, train, init, MODULE_EPOCHS,
                callbacks=[speedo],
                epoch_end=mx.callback.do_checkpoint(prefix))
        torch.cuda.synchronize()
        fit_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
        fit_s = time.perf_counter() - t0
        peak_bytes = torch.cuda.max_memory_allocated()
        stall = train.stall_ms_per_batch()
        speeds = [float(m.split('Speed: ')[1].split()[0])
                  for m in logs.records if 'Speed: ' in m]
        checkpoints = sorted(p.name for p in ckpt_dir.iterdir())
        fu = mod._fused_updater
        opt = mod._optimizer
        ex = mod._exec_group.executor
        step_ms = median(step_intervals(times))

        # eval: predict and score launch no kernel
        eval_iter = mx.io.NDArrayIter(x[:RESNET_BATCH], y[:RESNET_BATCH],
                                      batch_size=RESNET_BATCH)
        cuda_conv.CONV_BN_STATS_LAUNCHES = 0
        probs = mod.predict(eval_iter)
        score = [(n, float(v))
                 for n, v in mod.score(eval_iter, ['acc', 'ce'])]
        torch.cuda.synchronize()
        eval_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
        score_finite = tuple(probs.shape) == (RESNET_BATCH,
                                              RESNET['num_classes']) and \
            all(math.isfinite(v) for _, v in score)

        # the same fit, an epoch more, with the pair route off
        ex._pair_route = False
        off_train = train_iter()
        cuda_conv.CONV_BN_STATS_LAUNCHES = 0
        off_times, _, _, off_stalls, _ = module_fit(
            mx, cuda_conv, mod, off_train, init, 1, begin_epoch=MODULE_EPOCHS)
        torch.cuda.synchronize()
        off = dict(launches=cuda_conv.CONV_BN_STATS_LAUNCHES,
                   step_ms=step_intervals(off_times),
                   stall_ms_per_batch=off_train.stall_ms_per_batch(),
                   stall_ms=off_stalls)
        off['step_ms_median'] = median(off['step_ms'])
        off['images_per_s'] = RESNET_BATCH / (off['step_ms_median'] / 1e3)
        ex._pair_route = True

        # the state after training
        params = fu.param_names
        low = sorted(n for n in params
                     if ex.arg_dict[n].handle.dtype == torch.bfloat16)
        masters = sorted(n for n, t in fu.masters.items() if t is not None)
        tensors = [ex.arg_dict[n].handle for n in params] + \
            [a.handle for a in ex.aux_dict.values()] + \
            list(fu.states.values()) + [t for t in fu.masters.values()
                                        if t is not None]
        finite = all(bool(torch.isfinite(t).all()) for t in tensors)
        wd = {n: opt._get_wd(n) for n in params}

        # the gates that compare steps: deterministic cuDNN algorithms, so
        # that the same step gives the same bits
        batch = mx.io.NDArrayIter(x, y, batch_size=RESNET_BATCH).next()
        batch2 = mx.io.NDArrayIter(x[RESNET_BATCH:], y[RESNET_BATCH:],
                                   batch_size=RESNET_BATCH).next()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            update = module_update_check(torch, mx, mod, batch)
            prefetch_equal = module_prefetch_check(torch, mx, mod, x, y, 3,
                                                   ctx)
            split = module_timings(torch, mod, batch,
                                   mx.metric.create(
                                       ['acc', mx.metric.TopKAccuracy(
                                           top_k=5)]), ctx.torch_device)
            # the loss on one fixed batch over MODULE_LOSS_STEPS steps
            label = batch.label[0].handle.to(ctx.torch_device)
            losses = []
            for _ in range(MODULE_LOSS_STEPS):
                mod.forward_backward(batch)
                mod.update()
                losses.append(nll(torch, ex, label))
            resume = module_resume_check(torch, mx, mod, batch2, prefix,
                                         ctx)
        finally:
            torch.backends.cudnn.deterministic = deterministic

        # one fit step, its batch staged on the device as fit's are
        staged = mx.io.DataBatch(
            [mx.nd.NDArray(t, ctx) for t in mx.io.stage_to_device(
                batch.data, ctx)],
            [mx.nd.NDArray(t, ctx) for t in mx.io.stage_to_device(
                batch.label, ctx)])

        def one_step():
            mod.forward_backward(staged)
            mod.update()
            mod.update_metric(mx.metric.create('acc'), staged.label)
        profile = resnet_profile(torch, one_step, step_ms)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    run = dict(
        config=dict(RESNET, batch=RESNET_BATCH, batches=MODULE_BATCHES,
                    epochs=MODULE_EPOCHS, optimizer='sgd', **MODULE_OPT,
                    lr_step=MODULE_LR_STEP, lr_factor=MODULE_LR_FACTOR,
                    prefetch=MODULE_PREFETCH, params=len(params)),
        stem_split=stem_split_on(),
        fit_s=fit_s, train_launches=launches, fit_launches=fit_launches,
        eval_launches=eval_launches, lrs=lrs, train_metric=train_metric,
        score=score, score_finite=score_finite, step_ms=step_intervals(times),
        step_ms_median=step_ms, images_per_s=RESNET_BATCH / (step_ms / 1e3),
        speedometer=speeds, stall_ms_per_batch=stall, stall_ms=stalls,
        checkpoints=checkpoints,
        peak_bytes=peak_bytes,
        optimizer_state_bytes=fu.state_bytes_per_device(),
        route_off=off, wd=wd, masters=masters, low_precision_params=low,
        master_dtypes=sorted({str(t.dtype).replace('torch.', '')
                              for t in fu.masters.values() if t is not None}),
        finite=finite, update=update, prefetch_equal=prefetch_equal,
        split=split, losses=losses, resume=resume, profile=profile)
    print('module ' + json.dumps(run))
    for label_, c in sorted(profile['classes'].items(),
                            key=lambda kv: -kv[1]['ms']):
        beside = resnet['profile']['classes'].get(label_) if resnet else None
        print('module profile: %-62s %8.3f ms %5.1f %%  %5d launches'
              '  (phase 9: %s)' % (
                  label_, c['ms'], 100 * c['share'], c['launches'],
                  '%.3f ms' % beside['ms'] if beside else 'none'))
    bad = module_gate(run)
    if bad:
        fail('module: ' + '; '.join(bad))
    print('module: fit %.1f ms a step (%.0f images/s; Speedometer %s '
          'samples/s), route off %.1f ms (%.0f images/s); update %.2f ms '
          'host, %.2f ms device; update_metric %.1f ms (the metric alone '
          '%.1f ms); H2D of a batch %.1f ms pinned, %.1f ms pageable, '
          'stall %.2f ms a batch; peak %.2f GB; device busy %.1f %%; loss '
          'on one batch %s; resumed step equal in %d tensors'
          % (step_ms, run['images_per_s'], speeds, off['step_ms_median'],
             off['images_per_s'], split['update_host_ms'],
             split['update_device_ms'], split['metric_ms'],
             split['metric_again_ms'], split['h2d_pinned_device_ms'],
             split['h2d_pageable_device_ms'], stall, peak_bytes / 1e9,
             100 * profile['device_busy_share'], losses, resume['compared']))
    return run


# ---------------------------------------------------------------------------
# Phase 11: serving the bf16 ResNet-50 checkpoint
# ---------------------------------------------------------------------------

SERVE_BATCH = 32            # max_batch: the ladder 1, 2, 4, 8, 16, 32
SERVE_WAIT_US = 2000
SERVE_CLIENTS = 16
SERVE_REQUESTS = 32         # each client's, one after another
SERVE_ROWS = (1, 4)         # a request's rows, seeded uniform
SERVE_SPLIT_ROWS = 70       # a request over max_batch: 32 + 32 + 6
SERVE_SERIAL_ITERS = 8      # timed serial forwards at each batch
SERVE_PROFILE_REQUESTS = 8  # each client's, in the profiled window
# Largest |answer - serial forward| over the largest serial output: the
# traffic's rows run at the 1-16 rungs, the serial forward at 32, and
# cuDNN sums in another order at each batch. Sound runs on an H100 read
# 0.012-0.014 in bf16 and 1.7e-6 in the float32 control (PERF.md §6):
# the spread is bf16's rounding of those sums. The limit is 2.5 times the
# largest sound reading.
SERVE_SERIAL_REL_TOL = 0.035
# The seeded He-normal ResNet-50 is chaotic at initialisation: in eval
# mode bf16 rounding alone moves its softmax by a large share of its
# largest output (serve_conditioning measures it), where a trained
# network moves by far less, so no precision check (the int8 parity gate)
# could pass on it. The served checkpoint scales the last conv of each
# residual branch by this (zero-init-residual schemes set it to 0: Goyal
# et al. 2017; Zhang et al. 2019), and its BatchNorm moving statistics
# are those of one seeded batch (a train-mode forward at momentum 0), as
# a trained model's match its activations; plain He-normal statistics
# saturate the softmax to one class for every image.
SERVE_RESIDUAL_SCALE = 0.05
SERVE_CONDITION_BATCH = 8   # images of the conditioning check
# every newly ported NN op on gpu(0) against cpu(0): (op, attrs, inputs
# as (kind, shape), tolerance class: 'float' rtol 1e-5 / atol 1e-6, 'reduce'
# rtol 1e-4 / atol 1e-5 with TF32 off)
NN_OP_CASES = {
    'LeakyReLU/leaky': ('LeakyReLU', dict(act_type='leaky', slope=0.1),
                        [('normal', (8, 16, 32, 32))], 'float'),
    'LeakyReLU/elu': ('LeakyReLU', dict(act_type='elu', slope=0.3),
                      [('normal', (8, 16, 32, 32))], 'float'),
    'LeakyReLU/prelu': ('LeakyReLU', dict(act_type='prelu'),
                        [('normal', (8, 16, 32, 32)), ('normal', (16,))],
                        'float'),
    'LeakyReLU/rrelu': ('LeakyReLU', dict(act_type='rrelu'),
                        [('normal', (8, 16, 32, 32))], 'float'),
    'softmax': ('softmax', dict(axis=1, temperature=2.0),
                [('normal', (64, 1000))], 'reduce'),
    'log_softmax': ('log_softmax', {}, [('normal', (64, 1000))], 'reduce'),
    'SoftmaxActivation/channel': ('SoftmaxActivation', dict(mode='channel'),
                                  [('normal', (8, 16, 32, 32))], 'reduce'),
    'SoftmaxActivation/instance': ('SoftmaxActivation', {},
                                   [('normal', (8, 16, 8, 8))], 'reduce'),
    'LinearRegressionOutput': ('LinearRegressionOutput', {},
                               [('normal', (256, 64)), ('normal', (256, 64))],
                               'float'),
    'LogisticRegressionOutput': ('LogisticRegressionOutput', {},
                                 [('normal', (256, 64)),
                                  ('normal', (256, 64))], 'float'),
    'MAERegressionOutput': ('MAERegressionOutput', {},
                            [('normal', (256, 64)), ('normal', (256, 64))],
                            'float'),
    'softmax_cross_entropy': ('softmax_cross_entropy', {},
                              [('normal', (256, 1000)), ('class', (256,))],
                              'reduce'),
    'Deconvolution': ('Deconvolution',
                      dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1),
                           num_filter=32),
                      [('normal', (8, 16, 32, 32)), ('small', (16, 32, 4, 4)),
                       ('small', (32,))], 'reduce'),
    'InstanceNorm': ('InstanceNorm', {},
                     [('normal', (8, 16, 32, 32)), ('normal', (16,)),
                      ('normal', (16,))], 'reduce'),
    'L2Normalization/instance': ('L2Normalization', {},
                                 [('normal', (8, 16, 32, 32))], 'reduce'),
    'L2Normalization/channel': ('L2Normalization', dict(mode='channel'),
                                [('normal', (8, 16, 32, 32))], 'reduce'),
    'L2Normalization/spatial': ('L2Normalization', dict(mode='spatial'),
                                [('normal', (8, 16, 32, 32))], 'reduce'),
    'LRN': ('LRN', dict(nsize=5), [('normal', (8, 16, 32, 32))], 'reduce'),
    'Dropout/eval': ('Dropout', dict(p=0.5), [('normal', (8, 16, 32, 32))],
                     'float'),
    'SequenceLast': ('SequenceLast', dict(use_sequence_length=True),
                     [('normal', (32, 64, 128)), ('length', (64,))], 'float'),
    'SequenceMask': ('SequenceMask', dict(use_sequence_length=True,
                                          value=-1.0),
                     [('normal', (32, 64, 128)), ('length', (64,))], 'float'),
    'SequenceReverse': ('SequenceReverse', dict(use_sequence_length=True),
                        [('normal', (32, 64, 128)), ('length', (64,))],
                        'float'),
    'UpSampling/nearest': ('UpSampling', dict(scale=2),
                           [('normal', (8, 16, 32, 32))], 'float'),
    'UpSampling/bilinear': ('UpSampling', dict(scale=2,
                                               sample_type='bilinear',
                                               num_filter=16),
                            [('normal', (8, 16, 32, 32)),
                             ('small', (16, 1, 4, 4))], 'reduce'),
    'Crop': ('Crop', dict(h_w=(20, 24), center_crop=True),
             [('normal', (8, 16, 32, 32))], 'float'),
}
NN_TOL = {'float': dict(rtol=1e-5, atol=1e-6),
          'reduce': dict(rtol=1e-4, atol=1e-5)}


def nn_op_inputs(case, seed):
    """The seeded float32 inputs of one NN_OP_CASES case."""
    _, _, kinds, _ = NN_OP_CASES[case]
    rng = np.random.default_rng(seed)
    out = []
    for kind, shape in kinds:
        if kind == 'normal':
            out.append(rng.standard_normal(shape, dtype=np.float32))
        elif kind == 'small':
            out.append(0.1 * rng.standard_normal(shape, dtype=np.float32))
        elif kind == 'class':
            out.append(rng.integers(0, 1000, shape).astype(np.float32))
        else:                   # a sequence length in [1, T]
            out.append(rng.integers(1, 33, shape).astype(np.float32))
    return out


def nn_op_checks(mx, ctx_a, ctx_b):
    """Each NN_OP_CASES op on ctx_a against ctx_b from the same inputs:
    one row each, with its largest error and whether it is within its
    tolerance."""
    rows = []
    for i, (case, (op, attrs, _, tol)) in enumerate(sorted(
            NN_OP_CASES.items())):
        arrays = nn_op_inputs(case, SEED + 120 + i)
        outs = []
        for ctx in (ctx_a, ctx_b):
            got = getattr(mx.nd, op)(
                *[mx.nd.array(a, ctx=ctx) for a in arrays], **attrs)
            outs.append([o.asnumpy() for o in
                         (got if isinstance(got, list) else [got])])
        ok, err = True, 0.0
        for a, b in zip(*outs):
            ok = ok and a.shape == b.shape and np.allclose(
                a, b, **NN_TOL[tol])
            err = max(err, float(np.abs(a - b).max()) if a.size else 0.0)
        rows.append(dict(op=case, ok=bool(ok), max_abs_err=err, tol=tol))
    return rows


def serve_params(mx, symbol, shape, ctx, residual_scale, batch):
    """Seeded weights of `symbol` (a ResNet), each residual branch's last
    conv scaled by `residual_scale`, and BatchNorm moving statistics from
    one seeded batch of `batch` images: (args, auxs) by name."""
    args, auxs = resnet_params(symbol, dict(data=(1,) + shape),
                               RESNET['num_classes'], SEED + 110)
    args.pop('data')
    args.pop('softmax_label')
    for name in args:
        if name.endswith('_conv3_weight'):
            args[name] = args[name] * np.float32(residual_scale)
    calib = mx.sym.load_json(symbol.tojson().replace('"momentum": "0.9"',
                                                     '"momentum": "0"'))
    ex = calib.simple_bind(ctx, grad_req='null', data=(batch,) + shape)
    ex.copy_params_from(args, auxs)
    ex._pair_route = False      # the phase launches no conv kernel
    x = np.random.default_rng(SEED + 111).standard_normal(
        (batch,) + shape, dtype=np.float32)
    ex.forward(is_train=True, data=x)
    return args, {n: a.asnumpy() for n, a in ex.aux_dict.items()}


def serve_conditioning(mx, shape, ctx, residual_scale):
    """How far bf16 rounding moves the seeded network's eval softmax at
    `residual_scale`: the float32 network's statistics, its outputs and
    the bf16 network's on SERVE_CONDITION_BATCH seeded images; max |bf16
    - float32| over the largest float32 output, the largest probability
    and the number of distinct top classes."""
    from mxnet_tpu_torch.predictor import Predictor
    n = SERVE_CONDITION_BATCH
    kw = dict(RESNET, image_shape=','.join(map(str, shape)))
    args, auxs = serve_params(mx, mx.models.resnet.get_symbol(
        **dict(kw, dtype='float32')), shape, ctx, residual_scale, n)
    x = np.random.default_rng(SEED + 113).standard_normal(
        (n,) + shape, dtype=np.float32)
    outs = {}
    for dtype in ('float32', 'bfloat16'):
        pred = Predictor(symbol=mx.models.resnet.get_symbol(
            **dict(kw, dtype=dtype)), arg_params=args, aux_params=auxs,
            input_shapes={'data': (n,) + shape}, ctx=ctx)
        outs[dtype] = pred.predict(x)
    f32 = outs['float32']
    return dict(residual_scale=residual_scale,
                bf16_rel_diff=float(np.abs(outs['bfloat16'] - f32).max() /
                                    np.abs(f32).max()),
                max_prob=float(f32.max()),
                top_classes=int(len(set(f32.argmax(axis=1).tolist()))))


def serve_checkpoint(torch, mx, prefix, ctx):
    """The bf16 ResNet-50 of phase 9 with serve_params' weights and
    statistics, saved with model.save_checkpoint."""
    symbol = mx.models.resnet.get_symbol(**RESNET)
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    args, auxs = serve_params(mx, symbol, shape, ctx, SERVE_RESIDUAL_SCALE,
                              SERVE_BATCH)
    mx.model.save_checkpoint(
        prefix, 0, symbol,
        {n: mx.nd.array(a, ctx=mx.cpu()) for n, a in args.items()},
        {n: mx.nd.array(a, ctx=mx.cpu()) for n, a in auxs.items()})
    return symbol, shape


def serve_requests(shape):
    """Each client's SERVE_REQUESTS requests: seeded float32 normal images,
    rows uniform in SERVE_ROWS."""
    rng = np.random.default_rng(SEED + 112)
    return [[rng.standard_normal(
        (int(rng.integers(SERVE_ROWS[0], SERVE_ROWS[1] + 1)),) + shape,
        dtype=np.float32) for _ in range(SERVE_REQUESTS)]
        for _ in range(SERVE_CLIENTS)]


def drive(eng, requests):
    """SERVE_CLIENTS threads, each sending its requests one after
    another through eng.infer: (wall seconds, answers by client)."""
    import threading
    answers = [[None] * len(r) for r in requests]
    errors = []
    barrier = threading.Barrier(len(requests))

    def client(i):
        try:
            barrier.wait()
            for j, x in enumerate(requests[i]):
                answers[i][j] = eng.infer(x)[0]
        except Exception as e:      # raised by fail() below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail('serve: clients failed: %s' % errors[:3])
    return wall, answers


def coalesced(eng, arrays):
    """The answers of requests enqueued in one lock hold, so that the
    dispatcher batches them together (their rows fill max_batch)."""
    reqs = eng._submit_all([[a] for a in arrays])
    for r in reqs:
        r.event.wait()
        if r.error is not None:
            raise r.error
    return [r.outputs[0] for r in reqs]


def serial_outputs(pred, images):
    """The serial Predictor.forward of `images` in chunks of the
    predictor's batch (the last padded with zeros): (n, classes)."""
    batch = pred._executor.arg_dict['data'].shape[0]
    out = []
    for i in range(0, len(images), batch):
        chunk = images[i:i + batch]
        if len(chunk) < batch:
            pad = np.zeros((batch,) + chunk.shape[1:], np.float32)
            pad[:len(chunk)] = chunk
            chunk = pad
        out.append(pred.forward(data=chunk)[0].asnumpy()[:len(
            images[i:i + batch])])
    return np.concatenate(out)


def wrong_rows(torch, answers, refs):
    """(request, row) of every answer row whose nearest reference row is
    not its own: a row swapped between requests. Answers in request
    order, refs one row per image in the same order."""
    flat = np.concatenate([a for client in answers for a in client])
    got = torch.from_numpy(flat).cuda()
    ref = torch.from_numpy(refs).cuda()
    nearest = torch.cdist(got, ref).argmin(dim=1).cpu().numpy()
    own = np.arange(len(flat))
    bad = np.nonzero(nearest != own)[0]
    starts = np.cumsum([0] + [len(a) for client in answers
                              for a in client])
    where = [(int(np.searchsorted(starts, i, side='right') - 1),
              int(i - starts[np.searchsorted(starts, i, side='right') - 1]))
             for i in bad]
    return where, float(np.abs(flat - refs).max())


def engine_row(eng, requests, wall):
    """One engine's traffic numbers from its stats() and the answers."""
    st = eng.stats()
    n = sum(len(r) for r in requests)
    rows = sum(len(x) for r in requests for x in r)
    return dict(
        requests=st['requests'], rows=st['rows'], batches=st['batches'],
        requests_per_s=n / wall, images_per_s=rows / wall, wall_s=wall,
        latency_p50_ms=st['latency_p50_ms'],
        latency_p99_ms=st['latency_p99_ms'],
        batch_fill_avg=st['batch_fill_avg'],
        padded_rows=st['padded_rows'], pad_waste_frac=st['pad_waste_frac'],
        queue_depth_avg=st['queue_depth_avg'],
        service_ms_ema=st['service_ms_ema'], host_ms=st['host_ms'],
        compiles_after_warmup=st['compiles_after_warmup'],
        compile_s_after_warmup=st['compile_s_after_warmup'],
        answered_requests=n, answered_rows=rows,
        resident_bytes=eng.resident_bytes())


def serve_profile(torch, eng, requests):
    """A short window of traffic under torch.profiler: the device time by
    kernel class and the device-busy share of the window."""
    from torch.profiler import ProfilerActivity, profile
    window = [r[:SERVE_PROFILE_REQUESTS] for r in requests]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = drive(eng, window)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, 'device_type', '')).endswith('CUDA')]
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    classes = {}
    for e in kernels:
        c = classes.setdefault(kernel_class(e.key), dict(ms=0.0, launches=0))
        c['ms'] += device_us(e) / 1e3
        c['launches'] += e.count
    return dict(window_ms=wall * 1e3, device_ms=device_ms,
                device_busy_share=device_ms / (wall * 1e3),
                requests=sum(len(r) for r in window), classes=classes)


def float32_control(torch, mx, prefix, shape, requests):
    """The checkpoint's weights in the float32 network, served by an
    engine to SERVE_PROFILE_REQUESTS requests of each client and held
    against its serial forward at SERVE_BATCH: how far the rungs' sums
    alone move the answers, without bf16 rounding."""
    from mxnet_tpu_torch.predictor import Predictor
    _, args, auxs = mx.model.load_checkpoint(prefix, 0, ctx=mx.cpu())
    symbol = mx.models.resnet.get_symbol(**dict(RESNET, dtype='float32'))
    preds = [Predictor(symbol=symbol, arg_params=args, aux_params=auxs,
                       input_shapes={'data': (b,) + shape}, ctx=mx.gpu(0))
             for b in (1, SERVE_BATCH)]
    window = [r[:SERVE_PROFILE_REQUESTS] for r in requests]
    with preds[0].serve(max_batch=SERVE_BATCH,
                        max_wait_us=SERVE_WAIT_US) as eng:
        wall, answers = drive(eng, window)
        st = eng.stats()
    refs = serial_outputs(preds[1], np.concatenate(
        [x for client in window for x in client]))
    bad, err = wrong_rows(torch, answers, refs)
    return dict(requests=st['requests'], rows=st['rows'],
                images_per_s=st['rows'] / wall, wrong_rows=bad,
                max_abs_err_vs_serial=err,
                max_rel_err_vs_serial=err / float(np.abs(refs).max()))


def serving_gate(run):
    """Phase 11's checks on a run's numbers: a list of what failed, empty
    when it passed."""
    bad = []
    if run['default_device'] != 'cuda:0':
        bad.append('a Predictor with no ctx bound to %s, not cuda:0'
                   % run['default_device'])
    sent = SERVE_CLIENTS * SERVE_REQUESTS
    for name in ('bf16', 'int8', 'module'):
        e = run[name]
        if e['requests'] != sent or e['answered_requests'] != sent:
            bad.append('%s engine counted %d requests, answered %d, of %d'
                       % (name, e['requests'], e['answered_requests'], sent))
        if e['rows'] != run['sent_rows'] or \
                e['answered_rows'] != run['sent_rows']:
            bad.append('%s engine counted %d rows, answered %d, of %d'
                       % (name, e['rows'], e['answered_rows'],
                          run['sent_rows']))
        if e['wrong_rows']:
            bad.append('%s engine answered rows of other requests: %s'
                       % (name, e['wrong_rows'][:5]))
        if not e['max_rel_err_vs_serial'] <= SERVE_SERIAL_REL_TOL:
            bad.append('%s engine answers %.4g of the largest output from '
                       'the serial forward, over %.4g'
                       % (name, e['max_rel_err_vs_serial'],
                          SERVE_SERIAL_REL_TOL))
        if e['compiles_after_warmup'] != 0:
            bad.append('%s engine built %d rungs after warmup'
                       % (name, e['compiles_after_warmup']))
        if not 0 < e['batch_fill_avg'] <= 1:
            bad.append('%s engine batch fill %.3f' % (name,
                                                       e['batch_fill_avg']))
    for key, what in (('full_bucket_equal', 'a full-bucket request differs '
                       'from serial Predictor.forward'),
                      ('padded_equal', 'a padded request differs from the '
                       'padded serial forward'),
                      ('row_independent', 'a request\'s rows depend on what '
                       'they were batched with'),
                      ('split_equal', 'the split request differs from the '
                       'serial forward of its chunks'),
                      ('closed_joined', 'close() left a worker thread '
                       'running'),
                      ('closed_refuses', 'infer() after close() did not '
                       'raise')):
        if not run[key]:
            bad.append(what)
    c = run['float32']
    if c['wrong_rows'] or not c['max_rel_err_vs_serial'] <= \
            SERVE_SERIAL_REL_TOL:
        bad.append('the float32 control answers %.4g of the largest output '
                   'from its serial forward (wrong rows %s)'
                   % (c['max_rel_err_vs_serial'], c['wrong_rows'][:5]))
    q = run['int8']
    if not q['parity_measured'] <= q['parity_tol']:
        bad.append('int8 parity %.4g over its tolerance %.4g'
                   % (q['parity_measured'], q['parity_tol']))
    if q['quant_bytes'] * 2 != q['bf16_bytes'] or q['scale_bytes'] <= 0:
        bad.append('int8 weights take %d bytes (and %d of scales) for %d '
                   'bf16 bytes' % (q['quant_bytes'], q['scale_bytes'],
                                   q['bf16_bytes']))
    if run['module_max_abs_diff'] != 0.0:
        bad.append('the Module engine differs from the Predictor engine by '
                   '%.4g' % run['module_max_abs_diff'])
    if not run['nn_ops'] or not all(r['ok'] for r in run['nn_ops']):
        bad.append('NN ops disagree between gpu(0) and cpu(0): %s'
                   % [r['op'] for r in run['nn_ops'] if not r['ok']])
    for kernel, n in sorted(run['launches'].items()):
        if n:
            bad.append('serving launched the %s kernel %d times' % (kernel,
                                                                    n))
    return bad


def serve_phase(torch, mx, cuda_conv, cuda_ops, root):
    """Phase 11: the bf16 ResNet-50 checkpoint served on gpu(0) by
    Predictor.from_checkpoint(...).serve(), an int8 engine and an engine
    over a Module, under SERVE_CLIENTS threads of traffic; gated by
    serving_gate."""
    import shutil
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving import InferenceEngine
    torch.cuda.empty_cache()
    ckpt_dir = root / 'build' / 'phase11'
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    prefix = str(ckpt_dir / 'resnet50')
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        symbol, shape = serve_checkpoint(torch, mx, prefix, mx.gpu(0))
        requests = serve_requests(shape)
        images = np.concatenate([x for client in requests for x in client])
        print('serve: checkpoint and %d requests (%d images) made in %.1f s'
              % (SERVE_CLIENTS * SERVE_REQUESTS, len(images),
                 time.perf_counter() - t0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # the serving path's launch counts: from the Predictor's load to
        # the Module engine's close
        cuda_conv.CONV_BN_STATS_LAUNCHES = 0
        reset_counts(cuda_ops)
        # the Predictor, default device, and the serial references
        pred = Predictor.from_checkpoint(prefix, 0, {'data': (1,) + shape})
        devices = {str(a._data.device) for d in (
            pred._executor.arg_dict, pred._executor.aux_dict)
            for a in d.values()}
        default_device = devices.pop() if len(devices) == 1 else \
            str(sorted(devices))
        serial = Predictor.from_checkpoint(
            prefix, 0, {'data': (SERVE_BATCH,) + shape}, ctx=mx.gpu(0))
        refs = serial_outputs(serial, images)

        # the bf16 engine: traffic, then the gates that compare bits
        t0 = time.perf_counter()
        eng = pred.serve(max_batch=SERVE_BATCH, max_wait_us=SERVE_WAIT_US)
        warm_s = time.perf_counter() - t0
        wall, answers = drive(eng, requests)
        bf16 = engine_row(eng, requests, wall)
        bf16['warmup_s'] = warm_s
        bf16['wrong_rows'], bf16['max_abs_err_vs_serial'] = wrong_rows(
            torch, answers, refs)
        ref_max = float(np.abs(refs).max())
        bf16['max_rel_err_vs_serial'] = bf16['max_abs_err_vs_serial'] / \
            ref_max
        x32 = images[:SERVE_BATCH]
        full = eng.infer(x32)[0]
        full_bucket_equal = bool(np.array_equal(full, refs[:SERVE_BATCH]))
        a3, b29, c29 = images[40:43], images[100:129], images[200:229]
        with_b = coalesced(eng, [a3, b29])[0]
        with_c = coalesced(eng, [a3, c29])[0]
        row_independent = bool(np.array_equal(with_b, with_c))
        # 70 rows: chunks of 32, 32 and 6 (the last padded to the 8 rung)
        x70 = images[300:300 + SERVE_SPLIT_ROWS]
        split = eng.infer(x70)[0]
        padded = eng.infer(images[400:405])[0]
        split_ref = [serial_outputs(serial, x70[:2 * SERVE_BATCH])]
        serial.reshape({'data': (8,) + shape})
        split_ref.append(serial_outputs(serial, x70[2 * SERVE_BATCH:]))
        split_equal = bool(np.array_equal(split, np.concatenate(split_ref)))
        padded_equal = bool(np.array_equal(
            padded, serial_outputs(serial, images[400:405])))
        profile = serve_profile(torch, eng, requests)
        bf16['compiles_after_warmup'] = eng.stats()['compiles_after_warmup']
        workers = [eng._dispatcher, eng._completer]
        eng.close()
        closed_joined = not any(t.is_alive() for t in workers)
        try:
            eng.infer(images[:1])
            closed_refuses = False
        except mx.MXNetError:
            closed_refuses = True
        bf16_names = {n: a._data.numel() * a._data.element_size()
                      for n, a in pred._executor.arg_dict.items()}
        del eng

        # the int8 engine over a fresh Predictor (the swap is in place)
        qpred = Predictor.from_checkpoint(prefix, 0, {'data': (1,) + shape})
        t0 = time.perf_counter()
        qeng = qpred.serve(max_batch=SERVE_BATCH, max_wait_us=SERVE_WAIT_US,
                           quantize='int8')
        qwarm_s = time.perf_counter() - t0
        wall, qanswers = drive(qeng, requests)
        int8 = engine_row(qeng, requests, wall)
        int8['warmup_s'] = qwarm_s
        st = qeng.stats()['quantized']
        int8.update(parity_measured=st['parity_measured'],
                    parity_tol=st['parity_tol'], quant_names=st['weights'])
        qrefs = np.concatenate([qeng.infer(images[i:i + SERVE_BATCH])[0]
                                for i in range(0, len(images), SERVE_BATCH)])
        int8['wrong_rows'], int8['max_abs_err_vs_own_full_buckets'] = \
            wrong_rows(torch, qanswers, qrefs)
        # the int8 engine's serial reference: its own full buckets
        int8['max_rel_err_vs_serial'] = \
            int8['max_abs_err_vs_own_full_buckets'] / \
            float(np.abs(qrefs).max())
        int8['max_abs_diff_vs_bf16_serial'] = float(np.abs(qrefs -
                                                           refs).max())
        names = qeng._quant_names
        int8['quant_bytes'] = sum(
            qeng._base_ex.arg_dict[n]._data.numel() for n in names)
        int8['bf16_bytes'] = sum(bf16_names[n] for n in names)
        int8['scale_bytes'] = sum(s.numel() * s.element_size()
                                  for s in qeng._quant_scale_vals)
        int8['compiles_after_warmup'] = \
            qeng.stats()['compiles_after_warmup']
        qeng.close()
        del qeng, qpred

        # the engine over a Module bound for inference
        sym_, args, auxs = mx.model.load_checkpoint(prefix, 0, ctx=mx.cpu())
        mod = mx.mod.Module(sym_, context=mx.gpu(0))
        mod.bind(data_shapes=[('data', (SERVE_BATCH,) + shape)],
                 for_training=False)
        mod.set_params(args, auxs)
        meng = InferenceEngine(mod, max_batch=SERVE_BATCH,
                               max_wait_us=SERVE_WAIT_US)
        wall, manswers = drive(meng, requests)
        module = engine_row(meng, requests, wall)
        module['wrong_rows'], module['max_abs_err_vs_serial'] = wrong_rows(
            torch, manswers, refs)
        module['max_rel_err_vs_serial'] = \
            module['max_abs_err_vs_serial'] / ref_max
        module_max_abs_diff = float(np.abs(meng.infer(x32)[0] -
                                           full).max())
        module['compiles_after_warmup'] = \
            meng.stats()['compiles_after_warmup']
        meng.close()
        launches = dict(conv=cuda_conv.CONV_BN_STATS_LAUNCHES,
                        **dict(zip(('flash_fwd', 'flash_bwd_dkdv',
                                    'flash_bwd_dq'), read_counts(cuda_ops))))
        del meng, mod

        # serial Predictor.forward at batch 32 and 1, timed
        serial_ms = {}
        for b in (SERVE_BATCH, 1):
            serial.reshape({'data': (b,) + shape})
            serial.forward(data=images[:b])[0].asnumpy()
            t0 = time.perf_counter()
            for i in range(SERVE_SERIAL_ITERS):
                serial.forward(data=images[i * b:(i + 1) * b])[0].asnumpy()
            serial_ms[b] = (time.perf_counter() - t0) * 1e3 / \
                SERVE_SERIAL_ITERS
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        # the card's bytes of one eval forward at batch 32 (it resets the
        # peak statistics, so it comes after the peak is read)
        serial.reshape({'data': (SERVE_BATCH,) + shape})
        memory = serial._executor.memory_cost('forward')
        control = float32_control(torch, mx, prefix, shape, requests)
        nn_ops = nn_op_checks(mx, mx.gpu(0), mx.cpu(0))
        conditioning = [serve_conditioning(mx, shape, mx.gpu(0), scale)
                        for scale in (1.0, SERVE_RESIDUAL_SCALE)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    run = dict(
        config=dict(RESNET, max_batch=SERVE_BATCH, ladder=list(
            mx.exec_cache.batch_ladder(SERVE_BATCH)),
            max_wait_us=SERVE_WAIT_US, clients=SERVE_CLIENTS,
            requests_each=SERVE_REQUESTS, rows=list(SERVE_ROWS),
            residual_scale=SERVE_RESIDUAL_SCALE, depth=2),
        default_device=default_device, sent_rows=int(len(images)),
        bf16=bf16, int8=int8, module=module, float32=control,
        serial_max_output=ref_max,
        serial_ms={str(b): ms for b, ms in serial_ms.items()},
        serial_images_per_s={str(b): b / (ms / 1e3)
                             for b, ms in serial_ms.items()},
        full_bucket_equal=full_bucket_equal, padded_equal=padded_equal,
        row_independent=row_independent, split_equal=split_equal,
        module_max_abs_diff=module_max_abs_diff,
        closed_joined=closed_joined, closed_refuses=closed_refuses,
        memory_cost=memory, peak_bytes=peak_bytes, profile=profile,
        conditioning=conditioning, nn_ops=nn_ops, launches=launches)
    print('serve ' + json.dumps(run))
    for label_, c in sorted(profile['classes'].items(),
                            key=lambda kv: -kv[1]['ms']):
        print('serve profile: %-62s %8.3f ms %5d launches'
              % (label_, c['ms'], c['launches']))
    bad = serving_gate(run)
    if bad:
        fail('serve: ' + '; '.join(bad))
    print('serve: bf16 %.1f requests/s, %.1f images/s, p50 %.2f ms, p99 '
          '%.2f ms, fill %.3f, service %.3f ms a batch, host ms a dispatch '
          '%s; answers from the serial forward %.4g (bf16) / %.4g (float32 '
          'control) of the largest output; int8 %.1f images/s '
          '(parity %.4f); module %.1f images/s; serial forward %s ms; '
          'resident %d / %d bytes (bf16 / int8); peak %.2f GB; device busy '
          '%.1f %%'
          % (bf16['requests_per_s'], bf16['images_per_s'],
             bf16['latency_p50_ms'], bf16['latency_p99_ms'],
             bf16['batch_fill_avg'], bf16['service_ms_ema'],
             {k: round(v, 3) for k, v in bf16['host_ms'].items()},
             bf16['max_rel_err_vs_serial'],
             control['max_rel_err_vs_serial'],
             int8['images_per_s'], int8['parity_measured'],
             module['images_per_s'], run['serial_ms'],
             bf16['resident_bytes'], int8['resident_bytes'],
             peak_bytes / 1e9, 100 * profile['device_busy_share']))
    return run


# ---------------------------------------------------------------------------
# Phase 12: the Module remainder: BucketingModule over two image sides of
# the bf16 ResNet-50, bulk_step and fit(bulk=), the stem split, group2ctx
# ---------------------------------------------------------------------------

BUCKET_KEYS = (224, 160)    # image sides, both rungs; the first the default
BUCKET_STEPS = 3            # steps on each bucket, alternating
BULK_K = 4                  # steps a bulk dispatch
BULK_BATCHES = 8            # fit(bulk=BULK_K): two dispatches an epoch
# a FactorScheduler whose lr halves after every BULK_LR_STEP updates: a
# boundary inside the first dispatch
BULK_LR_STEP, BULK_LR_FACTOR = 2, 0.5
SPLIT_TIMED = 3             # timed forward / backward pairs, split on, off
# the grouped graph (one group on cpu(0), one on the card) against the
# one-device bind: float32 products, TF32 off
GROUP_SHAPE = (32, 100)
GROUP_TOL = dict(rtol=1e-5, atol=1e-6)


def bucket_sym_gen(mx):
    """The BucketingModule's sym_gen: the network of phase 9 at image
    side `side`."""
    def sym_gen(side):
        symbol = mx.models.resnet.get_symbol(
            **dict(RESNET, image_shape='3,%d,%d' % (side, side)))
        return symbol, ('data',), ('softmax_label',)
    return sym_gen


def bucket_batches(torch, mx, side, n, seed, ctx):
    """n seeded batches at image side `side` on ctx, bucket_key the side:
    N(0, 1) images and integer labels."""
    device = ctx.torch_device
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n):
        x = torch.randn((RESNET_BATCH, 3, side, side), generator=gen,
                        device=device)
        y = torch.randint(0, RESNET['num_classes'], (RESNET_BATCH,),
                          generator=gen, device=device).float()
        out.append(mx.io.DataBatch(
            [mx.nd.NDArray(x, ctx)], [mx.nd.NDArray(y, ctx)],
            bucket_key=side,
            provide_data=[mx.io.DataDesc('data', tuple(x.shape))],
            provide_label=[mx.io.DataDesc('softmax_label', (RESNET_BATCH,))]))
    return out


class ListIter:
    """A data iterator over a list of DataBatches (one epoch each pass),
    their shapes those of the first."""

    def __init__(self, batches):
        self.batches = batches
        self.provide_data = batches[0].provide_data
        self.provide_label = batches[0].provide_label
        self.batch_size = RESNET_BATCH

    def __iter__(self):
        return iter(self.batches)

    def reset(self):
        pass


def bulk_metric(mx):
    return mx.metric.create(['acc', mx.metric.TopKAccuracy(top_k=5)])


def count_metric_reads(metric):
    """Wrap the leaf metrics' update_device and _drain_device to count the
    pairs queued and the host reads of a pending pair."""
    counts = dict(queued=0, reads=0)
    for m in metric.metrics:
        queue, drain = m.update_device, m._drain_device

        def update_device(dsum, dcount, _queue=queue):
            counts['queued'] += 1
            _queue(dsum, dcount)

        def drain(_m=m, _drain=drain):
            if _m._pending_device is not None:
                counts['reads'] += 1
            _drain()
        m.update_device, m._drain_device = update_device, drain
    return counts


def bulk_optimizer_params(mx):
    return dict(MODULE_OPT, lr_scheduler=mx.lr_scheduler.FactorScheduler(
        step=BULK_LR_STEP, factor=BULK_LR_FACTOR))


def schedule_lrs(mx, first_update, k):
    """The lr a fresh copy of the bulk schedule gives updates
    first_update .. first_update + k - 1."""
    sched = mx.lr_scheduler.FactorScheduler(step=BULK_LR_STEP,
                                            factor=BULK_LR_FACTOR)
    sched.base_lr = MODULE_OPT['learning_rate']
    return [sched(n) for n in range(first_update, first_update + k)]


def bulk_check(torch, mx, cuda_conv, ctx, batches):
    """Module.bulk_step of BULK_K batches against BULK_K per-step steps
    from the same state, under deterministic cuDNN: weights, moving
    statistics, momenta, masters and the metric's sums bit for bit, the
    lr of every step (a FactorScheduler boundary inside the dispatch),
    the dispatch under torch.cuda.set_sync_debug_mode('error'), its
    launches, and the dispatch's ms against the per-step ms."""
    symbol, init = module_symbol_params(mx)
    mod = mx.mod.Module(symbol, context=ctx)
    mod.bind(batches[0].provide_data, batches[0].provide_label)
    mod.init_params(initializer=init)
    mod.init_optimizer(optimizer='sgd',
                       optimizer_params=bulk_optimizer_params(mx))
    # one per-step step and the programs' warm-up, so that neither path
    # pays cuDNN's or the allocator's first calls
    mod.forward_backward(batches[0])
    mod.update()
    mod.warmup_fused(bulk=BULK_K, eval_metric=bulk_metric(mx))
    fu = mod._fused_updater
    ex = mod._exec_group.executor
    captured = []
    prep_steps, prep = fu.host_prep_steps, fu.host_prep

    def host_prep_steps(weights, k, advance=True):
        out = prep_steps(weights, k, advance)
        captured.append([row[0] for row in out[2]])
        return out

    def host_prep(weights):
        out = prep(weights)
        captured.append([out[2][0]])
        return out
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        snap = module_snapshot(mod)
        first_update = mod._optimizer.num_update + 1
        metric_b = bulk_metric(mx)
        fu.host_prep_steps, fu.host_prep = host_prep_steps, host_prep
        d0 = ex.fused_dispatches
        torch.cuda.synchronize()
        before = cuda_conv.CONV_BN_STATS_LAUNCHES
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode('error')
        try:
            mod.bulk_step(batches=batches, eval_metric=metric_b)
        finally:
            torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
        bulk_ms = (time.perf_counter() - t0) * 1e3
        bulk_launches = cuda_conv.CONV_BN_STATS_LAUNCHES - before
        dispatches = ex.fused_dispatches - d0
        state_b = {k: v.cpu() for k, v in module_state(mod).items()}
        for m in metric_b.metrics:
            m.get()                # the host read of the device sums
        raw_b = [(float(m.sum_metric), m.num_inst)
                 for m in metric_b.metrics]
        lrs_bulk = captured.pop()
        del captured[:]
        module_restore(mod, snap)
        # the per-step loop: the host metric, and the same device fold on
        # each step's outputs (what the dispatch folds inside it)
        metric_s, metric_f = bulk_metric(mx), bulk_metric(mx)
        fold = mx.metric.device_fold(metric_f)
        carry = fold.init(ctx.torch_device)
        names = mod.output_names
        step_ms = []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric_s, b.label)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            carry = fold.update(
                carry, {'softmax_label': b.label[0].handle},
                dict(zip(names, [o.handle for o in mod.get_outputs()])))
        fold.commit(carry)
        for m in metric_f.metrics:
            m.get()
        lrs_step = [c[0] for c in captured]
        state_s = {k: v.cpu() for k, v in module_state(mod).items()}
        raw_s = [(float(m.sum_metric), m.num_inst) for m in metric_f.metrics]
        raw_host = [(float(m.sum_metric), m.num_inst)
                    for m in metric_s.metrics]
    finally:
        torch.backends.cudnn.deterministic = deterministic
        fu.host_prep_steps, fu.host_prep = prep_steps, prep
    differ = sorted(k for k in state_s if not torch.equal(state_b[k],
                                                         state_s[k]))
    return dict(
        dispatches=dispatches, launches=bulk_launches,
        differ=differ, compared=len(state_s),
        metric_bulk=[(float(a), int(b)) for a, b in raw_b],
        metric_steps=[(float(a), int(b)) for a, b in raw_s],
        metric_steps_host=[(float(a), int(b)) for a, b in raw_host],
        lrs_bulk=lrs_bulk, lrs_step=lrs_step,
        lrs_want=schedule_lrs(mx, first_update, BULK_K),
        bulk_ms=bulk_ms, bulk_ms_per_step=bulk_ms / len(batches),
        step_ms=step_ms, step_ms_median=median(step_ms))


def fit_bulk_check(torch, mx, cuda_conv, ctx, mod, train, expect_steps,
                   executors):
    """mod.fit(train, bulk=BULK_K) for one epoch with acc and top-5, a
    batch_end_callback reading the metric as a Speedometer does: the
    launches, the dispatches (fused_dispatches of `executors`), the pairs
    queued on the metric and its host reads, the rungs' compiles."""
    from mxnet_tpu_torch import profiler
    metric = bulk_metric(mx)
    counts = count_metric_reads(metric)
    callbacks = []

    def read(param):
        callbacks.append(param.nbatch)
        param.eval_metric.get_name_value()
    rungs0 = profiler.bucketing_stats()['train_rungs']
    d0 = sum(ex.fused_dispatches for ex in executors())
    torch.cuda.synchronize()
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    t0 = time.perf_counter()
    mod.fit(train, eval_metric=metric, optimizer='sgd',
            optimizer_params=bulk_optimizer_params(mx),
            initializer=module_symbol_params(mx)[1], batch_end_callback=read,
            num_epoch=1, bulk=BULK_K)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = cuda_conv.CONV_BN_STATS_LAUNCHES
    rungs1 = profiler.bucketing_stats()['train_rungs']
    compiles = {k: v['compiles'] - rungs0.get(k, {}).get('compiles', 0)
                for k, v in rungs1.items()}
    values = [(n, float(v)) for n, v in metric.get_name_value()]
    return dict(launches=launches, steps=expect_steps,
                dispatches=sum(ex.fused_dispatches
                               for ex in executors()) - d0,
                queued=counts['queued'], reads=counts['reads'],
                callbacks=callbacks, leaves=len(metric.metrics),
                compiles_during_steps=compiles, metric=values, fit_s=fit_s,
                finite=all(math.isfinite(v) for _, v in values))


def split_check(torch, mx, cuda_conv, ctx, residual_scale, resnet=None):
    """The network of phase 9 bound with the stem split on (the default)
    and off (MXNET_TPU_STEM_SPLIT=0), from the same seeded values, each
    residual branch's last conv scaled by `residual_scale` (1: phase 9's
    He-normal network; SERVE_RESIDUAL_SCALE: the conditioned one of phase
    11): the launches of a train step, the loss, output and moving
    statistics (the gradients' distance reported), and the median ms of
    the train forward and of the backward of each."""
    import os
    symbol = mx.models.resnet.get_symbol(**RESNET)
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    params = resnet_params(symbol, dict(data=(RESNET_BATCH,) + shape),
                           RESNET['num_classes'], SEED + 50)
    for name in params[0]:
        if name.endswith('_conv3_weight'):
            params[0][name] = params[0][name] * np.float32(residual_scale)
    out = {}
    states = {}
    old = os.environ.get('MXNET_TPU_STEM_SPLIT')
    for split in (True, False):
        os.environ['MXNET_TPU_STEM_SPLIT'] = '1' if split else '0'
        try:
            ex = bind_resnet(mx, symbol, ctx, RESNET_BATCH, shape, params)
        finally:
            if old is None:
                os.environ.pop('MXNET_TPU_STEM_SPLIT')
            else:
                os.environ['MXNET_TPU_STEM_SPLIT'] = old
        label = ex.arg_dict['softmax_label'].handle
        saved = save_params(ex)
        before = cuda_conv.CONV_BN_STATS_LAUNCHES
        ex.forward_backward()
        torch.cuda.synchronize()
        launches = cuda_conv.CONV_BN_STATS_LAUNCHES - before
        loss = nll(torch, ex, label)
        states[split] = resnet_state(torch, ex)
        fwd, bwd = [], []
        for _ in range(1 + SPLIT_TIMED):
            restore(ex, saved)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.forward(is_train=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ex.backward()
            torch.cuda.synchronize()
            fwd.append((t1 - t0) * 1e3)
            bwd.append((time.perf_counter() - t1) * 1e3)
        out[split] = dict(split_convs=len(ex._split_conv),
                          route_pairs=len(ex.pairs), launches=launches,
                          loss=loss, forward_ms=median(fwd[1:]),
                          backward_ms=median(bwd[1:]))
        del ex, saved
        torch.cuda.empty_cache()
    cmp_ = compare_states(torch, states[True], states[False])
    del states
    return dict(residual_scale=residual_scale, on=out[True], off=out[False],
                loss_err=abs(out[True]['loss'] - out[False]['loss']),
                out_rel=cmp_['out_rel'], aux_rel=cmp_['aux_rel'],
                grad_spread=spread(cmp_['grad_rel']),
                phase9_step_ms=resnet['step_ms_median'] if resnet else None)


def group_check(torch, mx, ctx):
    """A two-layer net with its first group on cpu(0) and its second on
    ctx, bound with group2ctx, against the same net bound on ctx alone:
    the train forward's output and every gradient, and where the groups
    ran."""
    with mx.AttrScope(ctx_group='dev1'):
        data = mx.sym.Variable('data')
        act = mx.sym.Activation(mx.sym.FullyConnected(
            data, num_hidden=64, name='fc1'), act_type='relu')
    with mx.AttrScope(ctx_group='dev2'):
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            act, num_hidden=10, name='fc2'), name='softmax')
    grouped = net.simple_bind(ctx, data=GROUP_SHAPE,
                              group2ctx={'dev1': mx.cpu(0), 'dev2': ctx})
    single = net.simple_bind(ctx, data=GROUP_SHAPE)
    rng = np.random.default_rng(SEED + 300)
    values = {n: (rng.integers(0, 10, a.shape).astype(np.float32)
                  if n == 'softmax_label' else
                  rng.standard_normal(a.shape).astype(np.float32) * 0.3)
              for n, a in single.arg_dict.items()}
    outs, grads = {}, {}
    for key, ex in (('grouped', grouped), ('single', single)):
        ex.copy_params_from(values)
        ex.forward(is_train=True)
        ex.backward()
        outs[key] = ex.outputs[0].asnumpy()
        grads[key] = {n: g.asnumpy() for n, g in ex.grad_dict.items()}
    errs = {'output': float(np.abs(outs['grouped'] - outs['single']).max())}
    ok = np.allclose(outs['grouped'], outs['single'], **GROUP_TOL)
    for n in grads['single']:
        errs['grad ' + n] = float(np.abs(grads['grouped'][n] -
                                         grads['single'][n]).max())
        ok = ok and np.allclose(grads['grouped'][n], grads['single'][n],
                                **GROUP_TOL)
    placed = sorted({str(c) for c in grouped._node_ctx.values()})
    return dict(ok=bool(ok), max_abs_err=errs, grouped=grouped._grouped,
                placed=placed, output_ctx=str(grouped.outputs[0].context),
                tol=GROUP_TOL)


def bucketing_gate(run):
    """Phase 12's checks on a run's numbers: a list of what failed."""
    bad = []
    split = run['stem_split']
    want = route_pairs(RESNET_PAIRS, split)
    for side, n in run['step_launches']:
        if n != want:
            bad.append('a step on bucket %d launched the kernel %d times, '
                       'expected %d (%s)' % (side, n, want,
                                             split_word(split)))
    if run['path_launches'] != want * len(run['step_launches']):
        bad.append('the bucket steps launched the kernel %d times in all'
                   % run['path_launches'])
    if not run['shared_params'] or not run['one_updater']:
        bad.append('the buckets do not share their parameters (%s) or '
                   'their optimizer state (%s)' % (run['shared_params'],
                                                   run['one_updater']))
    if not run['update_seen']:
        bad.append('a step on bucket %d did not change what bucket %d '
                   'reads' % (BUCKET_KEYS[1], BUCKET_KEYS[0]))
    if run['rungs_built_after_warmup'] or run['compiles_after_warmup']:
        bad.append('rungs were built after warm-up: %d programs, %s'
                   % (run['rungs_built_after_warmup'],
                      run['compiles_after_warmup']))
    if run['buckets'] != sorted(BUCKET_KEYS):
        bad.append('buckets bound: %s' % run['buckets'])
    sides = sorted({row['x'][1] for row in run['kernel_checks']})
    want_sides = [BUCKET_KEYS[1] // 32, BUCKET_KEYS[1] // 16,
                  BUCKET_KEYS[1] // 8, BUCKET_KEYS[1] // 4]
    if sides != want_sides:
        bad.append('the kernel was checked at sides %s of bucket %d, '
                   'expected %s' % (sides, BUCKET_KEYS[1], want_sides))
    for row in run['kernel_checks']:
        if not row['ok']:
            bad.append('the kernel disagrees with its plain version at %s'
                       % row)
    bulk = run['bulk']
    if bulk['dispatches'] != 1 or bulk['launches'] != want * BULK_K:
        bad.append('bulk_step: %d dispatches and %d launches for %d steps'
                   % (bulk['dispatches'], bulk['launches'], BULK_K))
    if bulk['differ'] or not bulk['compared']:
        bad.append('bulk_step differs from %d per-step steps in %s'
                   % (BULK_K, bulk['differ'][:8]))
    if bulk['metric_bulk'] != bulk['metric_steps']:
        bad.append('the metric sums differ: bulk %s, the per-step steps\' '
                   'folded %s' % (bulk['metric_bulk'], bulk['metric_steps']))
    # accuracy's host update agrees exactly (argmax takes the first of
    # tied scores on both sides); top-5's host argsort orders ties of the
    # bf16 network's scores otherwise than the fold's stable one, so its
    # host sums are reported, not gated
    if bulk['metric_bulk'][0] != bulk['metric_steps_host'][0]:
        bad.append('accuracy: bulk %s, per-step host update %s'
                   % (bulk['metric_bulk'][0], bulk['metric_steps_host'][0]))
    if bulk['lrs_bulk'] != bulk['lrs_step'] or \
            any(abs(a - b) > 1e-12 for a, b in zip(bulk['lrs_bulk'],
                                                   bulk['lrs_want'])) or \
            len(set(bulk['lrs_bulk'])) < 2:
        bad.append('the lr inside the dispatch %s, per step %s, expected '
                   '%s with a decay' % (bulk['lrs_bulk'], bulk['lrs_step'],
                                        bulk['lrs_want']))
    for what in ('fit_bulk', 'bucket_fit_bulk'):
        fit = run[what]
        dispatches = -(-fit['steps'] // BULK_K)
        if fit['launches'] != want * fit['steps']:
            bad.append('%s launched the kernel %d times for %d steps'
                       % (what, fit['launches'], fit['steps']))
        if fit['dispatches'] != dispatches:
            bad.append('%s ran %d dispatches, expected %d'
                       % (what, fit['dispatches'], dispatches))
        if fit['queued'] != dispatches * fit['leaves'] or \
                fit['reads'] != dispatches * fit['leaves']:
            bad.append('%s: %d metric pairs queued and %d host reads, '
                       'expected one of each a dispatch and leaf metric'
                       % (what, fit['queued'], fit['reads']))
        if any(fit['compiles_during_steps'].values()):
            bad.append('%s built programs during its steps: %s'
                       % (what, fit['compiles_during_steps']))
        if not fit['finite']:
            bad.append('%s: metric %s' % (what, fit['metric']))
    sc = run['split']
    if split and (sc['on']['launches'], sc['off']['launches']) != \
            (RESNET_PAIRS - 1, RESNET_PAIRS):
        bad.append('stem split on / off launched the kernel %d / %d times, '
                   'expected %d / %d' % (sc['on']['launches'],
                                         sc['off']['launches'],
                                         RESNET_PAIRS - 1, RESNET_PAIRS))
    if not sc['loss_err'] <= RESNET_LOSS_ATOL:
        bad.append('stem split on / off: the loss differs by %.3g (bound '
                   '%.3g)' % (sc['loss_err'], RESNET_LOSS_ATOL))
    errs = dict(sc['aux_rel'], output=sc['out_rel'])
    for name, err in errs.items():
        bound = RESNET_OUT_REL if name == 'output' else RESNET_AUX_REL
        if not err <= bound:
            bad.append('stem split on / off: %s differs by %.3g (bound '
                       '%.3g)' % (name, err, bound))
    grp = run['group2ctx']
    if not grp['ok'] or not grp['grouped'] or len(grp['placed']) != 2:
        bad.append('group2ctx: %s' % grp)
    return bad


def bucketing_phase(torch, mx, cuda_conv, resnet=None, ctx=None):
    """Phase 12: a BucketingModule over the bf16 ResNet-50 at image sides
    BUCKET_KEYS (both rungs: no padding), one parameter set and one
    FusedSGD state, warmed up at init_optimizer; alternating steps; the
    kernel against its plain version at the second bucket's pair
    shapes; bulk_step against the per-step loop; fit(bulk=) on a Module
    and on the BucketingModule; the stem split on against off; and
    group2ctx. Gated by bucketing_gate."""
    from mxnet_tpu_torch import exec_cache, executor
    ctx = ctx or mx.gpu(0)
    torch.cuda.empty_cache()
    split = stem_split_on()
    sides = BUCKET_KEYS
    batches = {side: bucket_batches(torch, mx, side, BULK_BATCHES // 2,
                                    SEED + 200 + side, ctx)
               for side in sides}
    descs = {side: (batches[side][0].provide_data,
                    batches[side][0].provide_label) for side in sides}
    _, init = module_symbol_params(mx)
    t0 = time.perf_counter()
    mod = mx.mod.BucketingModule(
        bucket_sym_gen(mx), default_bucket_key=sides[0], context=ctx,
        bucket_ladder=list(sides), mask_label=-1, warmup_buckets=True)
    mod.bind(*descs[sides[0]])
    mod.init_params(initializer=init)
    mod.switch_bucket(sides[1], *descs[sides[1]])
    mod.switch_bucket(sides[0], *descs[sides[0]])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # init_optimizer warms both rungs (their one-step programs)
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    mod.init_optimizer(optimizer='sgd',
                       optimizer_params=module_optimizer_params(mx))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
    exes = {side: mod._buckets[side]._exec_group.executor for side in sides}
    params = mod._buckets[sides[0]]._param_names
    shared = all(exes[sides[0]].arg_dict[n] is exes[sides[1]].arg_dict[n]
                 for n in params) and \
        all(exes[sides[0]].aux_dict[n] is exes[sides[1]].aux_dict[n]
            for n in exes[sides[0]].aux_dict)
    one_updater = len({id(m._fused_updater)
                       for m in mod._buckets.values()}) == 1
    stats0 = exec_cache.stats()
    from mxnet_tpu_torch import profiler
    rungs0 = profiler.bucketing_stats()['train_rungs']

    # the main path: every count set to 0 just before, read just after
    step_launches, step_ms = [], {side: [] for side in sides}
    seen = None
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    for i in range(2 * BUCKET_STEPS):
        side = sides[i % 2]
        b = batches[side][(i // 2) % len(batches[side])]
        if side == sides[1] and seen is None:
            w0 = exes[sides[0]].arg_dict['conv0_weight'].handle.clone()
        before = cuda_conv.CONV_BN_STATS_LAUNCHES
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mod.forward_backward(b)
        mod.update()
        torch.cuda.synchronize()
        step_ms[side].append((time.perf_counter() - t1) * 1e3)
        step_launches.append((side, cuda_conv.CONV_BN_STATS_LAUNCHES -
                              before))
        if side == sides[1] and seen is None:
            seen = not torch.equal(
                exes[sides[0]].arg_dict['conv0_weight'].handle, w0)
    path_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
    peak_bytes = torch.cuda.max_memory_allocated()
    stats1 = exec_cache.stats()
    rungs1 = profiler.bucketing_stats()['train_rungs']
    compiles = {k: v['compiles'] - rungs0.get(k, {}).get('compiles', 0)
                for k, v in rungs1.items()
                if v['compiles'] != rungs0.get(k, {}).get('compiles', 0)}

    # the kernel at the pairs the second bucket's route takes
    sym160 = mod._buckets[sides[1]].symbol
    shapes = pair_shapes(sym160, RESNET_BATCH, (3, sides[1], sides[1]),
                         executor, pairs=exes[sides[1]].pairs)
    kernel_checks = resnet_kernel_checks(torch, cuda_conv, executor, shapes,
                                         ctx.torch_device)

    # fit(bulk=) on the BucketingModule, its rungs' bulk programs warmed
    # before it (fit's own warm-up then finds them)
    mod.warmup_buckets(bulk=BULK_K, eval_metric=bulk_metric(mx))
    bucket_fit = fit_bulk_check(
        torch, mx, cuda_conv, ctx, mod,
        ListIter(batches[sides[0]] + batches[sides[1]]), BULK_BATCHES,
        lambda: [m._exec_group.executor for m in mod._buckets.values()])
    buckets = sorted(mod._buckets)
    del mod, exes
    torch.cuda.empty_cache()

    # bulk_step against the per-step loop, then fit(bulk=) on a Module
    bulk = bulk_check(torch, mx, cuda_conv, ctx, batches[sides[0]])
    torch.cuda.empty_cache()
    symbol, init = module_symbol_params(mx)
    fmod = mx.mod.Module(symbol, context=ctx)
    x, y = module_data(RESNET['num_classes'], BULK_BATCHES * RESNET_BATCH,
                       (3, sides[0], sides[0]), SEED + 210)
    train = mx.io.prefetch_to_device(
        mx.io.NDArrayIter(x, y, batch_size=RESNET_BATCH),
        size=MODULE_PREFETCH, device=ctx)
    fmod.bind(train.provide_data, train.provide_label)
    fit = fit_bulk_check(torch, mx, cuda_conv, ctx, fmod, train,
                         BULK_BATCHES,
                         lambda: [fmod._exec_group.executor])
    del fmod, train, x, y
    torch.cuda.empty_cache()

    # the split on against off, gated on the conditioned network: at
    # initialisation the He-normal one amplifies any rounding of its input
    # (split_he_normal: reported)
    split_cmp = split_check(torch, mx, cuda_conv, ctx, SERVE_RESIDUAL_SCALE,
                            resnet)
    split_he = split_check(torch, mx, cuda_conv, ctx, 1.0, resnet)
    group = group_check(torch, mx, ctx)

    run = dict(
        config=dict(RESNET, batch=RESNET_BATCH, buckets=list(sides),
                    steps=2 * BUCKET_STEPS, bulk=BULK_K,
                    bulk_batches=BULK_BATCHES, lr_step=BULK_LR_STEP,
                    lr_factor=BULK_LR_FACTOR),
        stem_split=split, warm_s=warm_s, warm_launches=warm_launches,
        step_launches=step_launches, path_launches=path_launches,
        step_ms={str(k): v for k, v in step_ms.items()},
        step_ms_median={str(k): median(v[1:] or v)
                        for k, v in step_ms.items()},
        images_per_s={str(k): RESNET_BATCH / (median(v[1:] or v) / 1e3)
                      for k, v in step_ms.items()},
        peak_bytes=peak_bytes, shared_params=shared,
        one_updater=one_updater, update_seen=bool(seen),
        rungs_built_after_warmup=stats1['misses'] - stats0['misses'],
        compile_s_after_warmup=stats1['total_compile_s'] -
        stats0['total_compile_s'],
        compiles_after_warmup=compiles, buckets=buckets,
        kernel_checks=kernel_checks, bulk=bulk, fit_bulk=fit,
        bucket_fit_bulk=bucket_fit, split=split_cmp,
        split_he_normal=dict(
            (k, split_he[k]) for k in ('loss_err', 'out_rel', 'aux_rel',
                                       'grad_spread', 'on', 'off')),
        group2ctx=group)
    print('bucketing ' + json.dumps(run))
    bad = bucketing_gate(run)
    if bad:
        fail('bucketing: ' + '; '.join(bad))
    print('bucketing: %s ms a step (%s images/s) on buckets %s, launches '
          'a step %s; bulk_step %.1f ms a step against %.1f ms per step; '
          'stem split backward %.1f ms on, %.1f ms off (phase 9 step %s '
          'ms); peak %.2f GB'
          % ([round(run['step_ms_median'][str(k)], 2) for k in sides],
             [round(run['images_per_s'][str(k)], 1) for k in sides],
             list(sides), sorted({n for _, n in step_launches}),
             bulk['bulk_ms_per_step'], bulk['step_ms_median'],
             split_cmp['on']['backward_ms'], split_cmp['off']['backward_ms'],
             split_cmp['phase9_step_ms'], peak_bytes / 1e9))
    return run


# ---------------------------------------------------------------------------
# Phase 13: Gluon trains ResNet-50 v1 (model_zoo) on the card
# ---------------------------------------------------------------------------

GLUON_BATCH = 64
GLUON_SIDE = 224
GLUON_CLASSES = 1000
GLUON_TIMED = 5             # timed steps, after one warm-up
GLUON_LOSS_STEPS = 5        # steps on one repeated batch, whose loss falls
GLUON_OPT = dict(learning_rate=0.01, momentum=0.9, wd=1e-4)
GLUON_WORKERS = 2           # the DataLoader's threads
GLUON_FWD_TIMED = 3         # timed forwards, hybridized and imperative
# every other family of the zoo, one forward at batch 2 on the card
# against cpu(0) (TF32 off): max |gpu - cpu| within GLUON_ZOO_TOL of the
# largest |cpu| output
GLUON_ZOO = (('resnet50_v2', 224), ('vgg11', 224), ('vgg11_bn', 224),
             ('alexnet', 224), ('squeezenet1.0', 224),
             ('squeezenet1.1', 224), ('densenet121', 224),
             ('inceptionv3', 299))
GLUON_ZOO_BATCH = 2
GLUON_ZOO_TOL = 1e-3


def gluon_transform(data, label):
    """An HWC uint8 image as CHW float32 in [-0.5, 0.5]."""
    return data.astype('float32').transpose((2, 0, 1)) / 255.0 - 0.5, label


def gluon_param_state(net):
    """Every parameter's value (moving statistics included), by name
    without the net's auto-prefix (so another instance takes it)."""
    n = len(net.prefix)
    return {k[n:]: p.data().handle.detach().clone()
            for k, p in net.collect_params().items()}


def gluon_set_state(net, state):
    n = len(net.prefix)
    for k, p in net.collect_params().items():
        p.data()._data = state[k[n:]].clone()


def gluon_zoo_check(torch, mx, ctx):
    """Each GLUON_ZOO family initialized on cpu(0) (Xavier), one eval
    forward there and one on ctx with the same parameters."""
    rows = []
    for name, side in GLUON_ZOO:
        net = mx.gluon.model_zoo.vision.get_model(name, classes=GLUON_CLASSES)
        mx.random.seed(SEED)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu(0))
        x = np.random.default_rng(SEED + 500).standard_normal(
            (GLUON_ZOO_BATCH, 3, side, side)).astype(np.float32)
        ref = net(mx.nd.array(x, ctx=mx.cpu(0))).asnumpy()
        net.collect_params().reset_ctx(ctx)
        got = net(mx.nd.array(x, ctx=ctx)).asnumpy()
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        rows.append(dict(model=name, side=side, shape=list(got.shape),
                         max_abs_err=err, max_abs_out=scale,
                         finite=bool(np.isfinite(got).all()),
                         ok=list(got.shape) == [GLUON_ZOO_BATCH,
                                                GLUON_CLASSES] and
                         bool(np.isfinite(got).all()) and
                         err <= GLUON_ZOO_TOL * scale))
        print('gluon zoo: %-14s max |gpu - cpu| %.3g of %.3g' % (
            name, err, scale))
        del net
    return rows


def gluon_gate(run):
    """Phase 13's checks on a run's numbers: a list of what failed."""
    bad = []
    if run['param_devices'] != ['cuda:0'] or run['param_ctxs'] != ['gpu(0)']:
        bad.append('initialize() without a ctx put the parameters on %s '
                   '(%s)' % (run['param_devices'], run['param_ctxs']))
    if run['kernel_launches'] != dict(conv_bn_stats=0, flash_fwd=0,
                                      flash_bwd_dkdv=0, flash_bwd_dq=0):
        bad.append('the Gluon phase launched hand-written kernels: %s'
                   % run['kernel_launches'])
    losses = run['losses']
    if not losses[-1] < losses[0]:
        bad.append('the loss on one repeated batch did not fall: %s'
                   % losses)
    if not all(math.isfinite(v) for v in run['timed_losses']):
        bad.append('timed steps: losses %s' % run['timed_losses'])
    for mode in ('eval', 'train'):
        if not run['hybrid_equal'][mode]:
            bad.append('the hybridized %s forward differs from the '
                       'imperative one' % mode)
    if run['resume']['differ'] or not run['resume']['compared']:
        bad.append('the step after load_params and load_states differs in '
                   '%s' % run['resume']['differ'][:8])
    for row in run['zoo']:
        if not row['ok']:
            bad.append('zoo %s: %s' % (row['model'], row))
    if run['batch_shape'] != [GLUON_BATCH, 3, GLUON_SIDE, GLUON_SIDE]:
        bad.append('the DataLoader gave batches of %s' % run['batch_shape'])
    return bad


def gluon_phase(torch, mx, cuda_conv, cuda_ops, root, ctx=None):
    """Phase 13: model_zoo.vision.resnet50_v1 in float32 at batch 64,
    initialized with no ctx (it must land on cuda:0), hybridized, trained
    by Trainer('sgd') on SoftmaxCrossEntropyLoss under autograd.record()
    from a DataLoader over SyntheticImageDataset; the hybridized forward
    against the imperative one; save_params / load_params and
    save_states / load_states against the uninterrupted step; every
    other zoo family on the card against cpu(0); no hand-written kernel
    launched. Gated by gluon_gate."""
    import shutil
    from mxnet_tpu_torch import autograd
    gluon = mx.gluon
    ctx = ctx or mx.gpu(0)
    torch.cuda.empty_cache()
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    reset_counts(cuda_ops)
    mx.random.seed(SEED)
    net = gluon.model_zoo.vision.resnet50_v1(classes=GLUON_CLASSES)
    net.initialize(mx.init.Xavier())
    params = net.collect_params()
    net.hybridize()
    trainer = gluon.Trainer(params, 'sgd', dict(GLUON_OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    dataset = gluon.data.vision.SyntheticImageDataset(
        num_samples=GLUON_BATCH * (1 + GLUON_TIMED),
        shape=(GLUON_SIDE, GLUON_SIDE, 3), num_classes=GLUON_CLASSES,
        transform=gluon_transform, seed=SEED + 400)
    loader = gluon.data.DataLoader(dataset, batch_size=GLUON_BATCH,
                                   num_workers=GLUON_WORKERS)

    def step(x, y):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(GLUON_BATCH)
        return loss

    torch.cuda.reset_peak_memory_stats()
    times, timed_losses = [], []
    it = iter(loader)
    batch_shape = None
    t_last = time.perf_counter()
    for i in range(1 + GLUON_TIMED):
        x, y = next(it)
        batch_shape = list(x.shape)
        loss = step(x, y)
        timed_losses.append(float(loss.mean().asscalar()))
        now = time.perf_counter()
        times.append((now - t_last) * 1e3)
        t_last = now
    peak_bytes = torch.cuda.max_memory_allocated()
    step_ms = median(times[1:])
    # where initialize() without a ctx put the parameters (their shapes
    # complete at the first forward)
    param_devices = sorted({str(p.data().handle.device)
                            for p in params.values()})
    param_ctxs = sorted({str(c) for p in params.values()
                         for c in p.list_ctx()})

    # the loss on one repeated batch
    losses = []
    for _ in range(GLUON_LOSS_STEPS):
        losses.append(float(step(x, y).mean().asscalar()))

    # the hybridized forward against the imperative one, eval and train
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ckpt = root / 'build' / 'phase13'
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    try:
        state = gluon_param_state(net)
        outs, fwd_ms = {}, {}
        for hybrid in (False, True):
            net.hybridize(hybrid)
            gluon_set_state(net, state)
            o_eval = net(x).handle.clone()
            with autograd.record():
                out = net(x)
            o_train = out.handle.detach().clone()
            out.backward()         # ends the recording
            outs[hybrid] = (o_eval, o_train)
            ts = []
            for _ in range(1 + GLUON_FWD_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net(x)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            fwd_ms['hybridized' if hybrid else 'imperative'] = \
                median(ts[1:])
        gluon_set_state(net, state)
        hybrid_equal = dict(
            eval=bool(torch.equal(outs[False][0], outs[True][0])),
            train=bool(torch.equal(outs[False][1], outs[True][1])))
        del outs

        # save and load: the next step equals the uninterrupted one
        fparams, fstates = str(ckpt / 'net.params'), str(ckpt / 'net.states')
        net.save_params(fparams)
        trainer.save_states(fstates)
        step(x, y)
        ref = {k: v.cpu() for k, v in gluon_param_state(net).items()}
        net.load_params(fparams, ctx=ctx)
        trainer.load_states(fstates)
        step(x, y)
        got = {k: v.cpu() for k, v in gluon_param_state(net).items()}
        resume = dict(differ=sorted(k for k in ref
                                    if not torch.equal(ref[k], got[k])),
                      compared=len(ref))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(ckpt, ignore_errors=True)
    del net, trainer, loader, dataset
    torch.cuda.empty_cache()

    zoo = gluon_zoo_check(torch, mx, ctx)
    torch.cuda.synchronize()
    launches = dict(conv_bn_stats=cuda_conv.CONV_BN_STATS_LAUNCHES,
                    flash_fwd=cuda_ops.FLASH_FWD_LAUNCHES,
                    flash_bwd_dkdv=cuda_ops.FLASH_BWD_DKDV_LAUNCHES,
                    flash_bwd_dq=cuda_ops.FLASH_BWD_DQ_LAUNCHES)
    run = dict(
        config=dict(model='resnet50_v1', dtype='float32', batch=GLUON_BATCH,
                    side=GLUON_SIDE, classes=GLUON_CLASSES, **GLUON_OPT),
        param_devices=param_devices, param_ctxs=param_ctxs,
        batch_shape=batch_shape, step_ms=times, step_ms_median=step_ms,
        images_per_s=GLUON_BATCH / (step_ms / 1e3), timed_losses=timed_losses,
        losses=losses, peak_bytes=peak_bytes, forward_ms=fwd_ms,
        hybrid_equal=hybrid_equal, resume=resume, zoo=zoo,
        kernel_launches=launches)
    print('gluon ' + json.dumps(run))
    bad = gluon_gate(run)
    if bad:
        fail('gluon: ' + '; '.join(bad))
    print('gluon: %.1f ms a step (%.1f images/s) with the DataLoader, '
          'forward %.1f ms hybridized, %.1f ms imperative (eval, batch %d); '
          'loss on one batch %s; peak %.2f GB; hand-written kernel '
          'launches %s'
          % (step_ms, run['images_per_s'], fwd_ms['hybridized'],
             fwd_ms['imperative'], GLUON_BATCH, losses, peak_bytes / 1e9,
             launches))
    return run


# ---------------------------------------------------------------------------
# Phase 14: the PTB LSTM language model through mx.rnn and BucketingModule
# ---------------------------------------------------------------------------

# examples/rnn/lstm_bucketing.py's graph at the reference's PTB widths
# (example/rnn/lstm_bucketing.py: 2 layers of 200, embed 200, batch 32,
# buckets 10-60; PTB's 10,000 words), in float32
PTB = dict(vocab=10000, embed=200, hidden=200, layers=2, batch=32,
           buckets=(10, 20, 30, 40, 50, 60))
PTB_SENTENCES = 1536        # about 8 batches a bucket, 48 an epoch
PTB_EPOCHS = 2
PTB_LR = 0.01               # adam, the example's default
PTB_ZIPF = 1.3              # the corpus's word draws
PTB_FOLLOW = 0.8            # the share of words that follow their rule
PTB_TIMED = 3               # timed steps on each bucket, after one warm-up
PTB_TOL = 1e-5              # fused against unfused, gpu against cpu
PTB_CPU_BUCKET = 20         # the bucket of the gpu-against-cpu batch
PTB_BULK_K = 4
PTB_BULK_OPT = dict(learning_rate=0.1, momentum=0.9)


def ptb_sentences(n, vocab, max_len, seed):
    """A seeded synthetic corpus with PTB's vocabulary size: n sentences
    of 1 to max_len words, the first Zipf-drawn, each next one with
    probability PTB_FOLLOW the successor (7 t + 13) mod (vocab - 1) + 1
    of the word before (a next-word structure the model can learn), else
    Zipf-drawn. Words are strings, for encode_sentences."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(1, max_len + 1))
        draws = np.minimum(rng.zipf(PTB_ZIPF, length), vocab - 1)
        follow = rng.random(length) < PTB_FOLLOW
        words = [int(draws[0])]
        for i in range(1, length):
            words.append((7 * words[-1] + 13) % (vocab - 1) + 1
                         if follow[i] else int(draws[i]))
        out.append(['w%d' % w for w in words])
    return out


def ptb_corpus(mx, seed):
    """The corpus encoded by mx.rnn.encode_sentences (0 the invalid
    label, words from 1): (sentences, vocab)."""
    words = ptb_sentences(PTB_SENTENCES, PTB['vocab'], max(PTB['buckets']),
                          seed)
    return mx.rnn.encode_sentences(words, invalid_label=0, start_label=1)


def ptb_iter(mx, sentences, bucket_major=False):
    """BucketSentenceIter over the corpus, its shuffles seeded."""
    random.seed(SEED + 300)
    np.random.seed(SEED + 301)
    return mx.rnn.BucketSentenceIter(sentences, PTB['batch'],
                                     buckets=list(PTB['buckets']),
                                     invalid_label=0,
                                     bucket_major=bucket_major)


def ptb_fused_cell(mx):
    return mx.rnn.FusedRNNCell(PTB['hidden'], num_layers=PTB['layers'],
                               mode='lstm', prefix='lstm_')


def ptb_unfused_cell(mx):
    """The same stack as unfused LSTMCells: their parameter names are
    those FusedRNNCell.unpack_weights gives."""
    stack = mx.rnn.SequentialRNNCell()
    for i in range(PTB['layers']):
        stack.add(mx.rnn.LSTMCell(PTB['hidden'], prefix='lstm_l%d_' % i))
    return stack


def ptb_sym_gen(mx, cell, hidden_only=False):
    """The example's sym_gen: Embedding, the cell unrolled over the
    bucket's length, FullyConnected to the vocabulary, SoftmaxOutput;
    with hidden_only, the cell's outputs alone."""
    def sym_gen(seq_len):
        data = mx.sym.Variable('data')
        label = mx.sym.Variable('softmax_label')
        embed = mx.sym.Embedding(data, input_dim=PTB['vocab'],
                                 output_dim=PTB['embed'], name='embed')
        outputs, _ = cell.unroll(seq_len, embed, layout='NTC',
                                 merge_outputs=True)
        if hidden_only:
            return outputs, ('data',), ()
        pred = mx.sym.Reshape(outputs, shape=(-1, PTB['hidden']))
        pred = mx.sym.FullyConnected(pred, num_hidden=PTB['vocab'],
                                     name='pred')
        lab = mx.sym.Reshape(label, shape=(-1,))
        return (mx.sym.SoftmaxOutput(pred, label=lab, name='softmax'),
                ('data',), ('softmax_label',))
    return sym_gen


def hand_written_launches(cuda_conv, cuda_ops):
    """Every hand-written kernel's launch count."""
    from mxnet_tpu_torch import rtc
    return dict(conv_bn_stats=cuda_conv.CONV_BN_STATS_LAUNCHES,
                flash_fwd=cuda_ops.FLASH_FWD_LAUNCHES,
                flash_bwd_dkdv=cuda_ops.FLASH_BWD_DKDV_LAUNCHES,
                flash_bwd_dq=cuda_ops.FLASH_BWD_DQ_LAUNCHES,
                rtc=rtc.RTC_LAUNCHES)


def reset_hand_written(cuda_conv, cuda_ops):
    from mxnet_tpu_torch import rtc
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    reset_counts(cuda_ops)
    rtc.RTC_LAUNCHES = 0


class RecordingIter:
    """A data iterator that hands out another's batches and keeps them."""

    def __init__(self, it):
        self.it = it
        self.batches = []
        self.provide_data = it.provide_data
        self.provide_label = it.provide_label

    def __iter__(self):
        for b in self.it:
            self.batches.append(b)
            yield b

    def reset(self):
        self.it.reset()


def bulk_dispatches(keys, k):
    """The dispatches of a BucketingModule's fit(bulk=k) over batches of
    these bucket keys: runs of one key in groups of k, each full group
    one dispatch (a shorter group takes the per-step path)."""
    count, run = 0, 0
    for i, key in enumerate(keys):
        run += 1
        if i + 1 == len(keys) or keys[i + 1] != key:
            count += run // k
            run = 0
    return count


def ptb_bulk_check(torch, mx, ctx, sentences, start):
    """fit(bulk=PTB_BULK_K) over bucket_major batches against the same
    batches stepped one by one, from the same parameters, with momentum
    SGD (FusedSGD; adam has no fused update and would take the per-step
    path), under deterministic algorithms: every parameter and momentum
    bit for bit, and the dispatches."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mods = []
        for _ in range(2):
            mod = mx.mod.BucketingModule(
                ptb_sym_gen(mx, ptb_fused_cell(mx)),
                default_bucket_key=max(PTB['buckets']), context=ctx)
            it = ptb_iter(mx, sentences, bucket_major=True)
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(arg_params={n: mx.nd.array(v, ctx=ctx)
                                        for n, v in start.items()})
            mods.append((mod, it))
        (bulk_mod, it), (step_mod, _) = mods
        rec = RecordingIter(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bulk_mod.fit(rec, eval_metric=mx.metric.Perplexity(None),
                     optimizer='sgd', optimizer_params=dict(PTB_BULK_OPT),
                     num_epoch=1, bulk=PTB_BULK_K)
        torch.cuda.synchronize()
        bulk_s = time.perf_counter() - t0
        dispatches = sum(m._exec_group.executor.fused_dispatches
                         for m in bulk_mod._buckets.values())
        step_mod.init_optimizer(optimizer='sgd',
                                optimizer_params=dict(PTB_BULK_OPT))
        t0 = time.perf_counter()
        for b in rec.batches:
            step_mod.forward_backward(b)
            step_mod.update()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        states = []
        for mod in (bulk_mod, step_mod):
            args, _ = mod.get_params()
            fu = mod._buckets[mod._default_bucket_key]._fused_updater
            state = {'arg ' + n: a.handle.detach().cpu()
                     for n, a in args.items()}
            state.update(('mom ' + n, t.detach().cpu())
                         for n, t in fu.states.items())
            states.append(state)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.use_deterministic_algorithms(False)
    keys = [b.bucket_key for b in rec.batches]
    got, ref = states
    return dict(steps=len(keys), keys=keys, dispatches=dispatches,
                dispatches_want=bulk_dispatches(keys, PTB_BULK_K),
                differ=sorted(k for k in ref if k not in got or
                              not torch.equal(got[k], ref[k])),
                compared=len(ref), moms=sum(k.startswith('mom ')
                                            for k in ref),
                bulk_s=bulk_s, step_s=step_s)


def ptb_unfused_check(torch, mx, ctx, args, batch):
    """The cell's outputs on one batch: the fused graph against the
    SequentialRNNCell of LSTMCells with FusedRNNCell.unpack_weights's
    weights, both bound on ctx."""
    seq_len = batch.bucket_key
    fused = ptb_fused_cell(mx)
    outs = []
    for cell, params in (
            (fused, {n: args[n] for n in ('embed_weight',
                                          'lstm_parameters')}),
            (ptb_unfused_cell(mx), fused.unpack_weights(
                {'embed_weight': args['embed_weight'],
                 'lstm_parameters': args['lstm_parameters']}))):
        symbol = ptb_sym_gen(mx, cell, hidden_only=True)(seq_len)[0]
        ex = symbol.simple_bind(ctx, grad_req='null',
                                data=(PTB['batch'], seq_len))
        ex.copy_params_from(params)
        ex.forward(is_train=False, data=batch.data[0])
        outs.append(ex.outputs[0].handle.detach().clone())
        del ex
    err = float((outs[0] - outs[1]).abs().max())
    return dict(bucket=seq_len, max_abs_err=err, tol=PTB_TOL,
                unfused_params=sorted(params), ok=err <= PTB_TOL)


def ptb_cpu_check(torch, mx, ctx, args, batch):
    """One train step of the LM on one batch on ctx and on cpu(0) from the
    same parameters: the output and every gradient, each within PTB_TOL
    of its largest cpu magnitude (1 at least)."""
    seq_len = batch.bucket_key
    symbol = ptb_sym_gen(mx, ptb_fused_cell(mx))(seq_len)[0]
    req = {n: 'null' if n in NO_GRAD else 'write'
           for n in symbol.list_arguments()}
    states = {}
    for key, c in (('gpu', ctx), ('cpu', mx.cpu(0))):
        ex = symbol.simple_bind(c, grad_req=req,
                                data=(PTB['batch'], seq_len),
                                softmax_label=(PTB['batch'], seq_len))
        ex.copy_params_from({n: mx.nd.array(v.asnumpy(), ctx=c)
                             for n, v in args.items()})
        ex.forward_backward(
            data=mx.nd.array(batch.data[0].asnumpy(), ctx=c),
            softmax_label=mx.nd.array(batch.label[0].asnumpy(), ctx=c))
        st = {'output': ex.outputs[0].handle.detach().cpu()}
        st.update(('grad ' + n, g.handle.detach().cpu())
                  for n, g in ex.grad_dict.items() if n not in NO_GRAD)
        states[key] = st
        del ex
    errs = {}
    for k, ref in states['cpu'].items():
        scale = max(1.0, float(ref.abs().max()))
        errs[k] = float((states['gpu'][k] - ref).abs().max()) / scale
    return dict(bucket=seq_len, rel_err=errs, tol=PTB_TOL,
                ok=all(e <= PTB_TOL for e in errs.values()))


def ptb_checkpoint_check(torch, mx, mod, root):
    """save_rnn_checkpoint of the module's parameters (the cell's unpacked
    per layer) and load_rnn_checkpoint: the same symbol and every tensor
    equal."""
    import shutil
    ckpt = root / 'build' / 'phase14'
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    try:
        cell = ptb_fused_cell(mx)
        args, auxs = mod.get_params()
        prefix = str(ckpt / 'ptb')
        symbol = mod._buckets[mod._default_bucket_key].symbol
        mx.rnn.save_rnn_checkpoint(cell, prefix, 1, symbol, args, auxs)
        with mx.cpu():
            stored = sorted(mx.nd.load('%s-0001.params' % prefix))
            sym2, args2, auxs2 = mx.rnn.load_rnn_checkpoint(cell, prefix, 1)
        differ = sorted(n for n in args if n not in args2 or not torch.equal(
            args[n].handle.detach().cpu(), args2[n].handle.detach().cpu()))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return dict(stored=stored, differ=differ, compared=len(args),
                extra=sorted(set(args2) - set(args)),
                same_symbol=sym2.tojson() == symbol.tojson(),
                unpacked='arg:lstm_l0_i2h_weight' in stored and
                'arg:lstm_parameters' not in stored)


def ptb_timings(torch, mx, mod, batches):
    """Each bucket's step (forward_backward and update) timed, after one
    warm-up: median ms and tokens/s; then one bucket-60 step's profile."""
    rows = {}
    for key in sorted(batches):
        b = batches[key]
        ts = []
        for _ in range(1 + PTB_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(b)
            mod.update()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        ms = median(ts[1:])
        rows[key] = dict(step_ms=ts, step_ms_median=ms,
                         tokens_per_s=PTB['batch'] * key / (ms / 1e3))
    top = max(batches)

    def step():
        mod.forward_backward(batches[top])
        mod.update()
    prof = resnet_profile(torch, step, rows[top]['step_ms_median'])
    prof['launches'] = sum(c['launches'] for c in prof['classes'].values())
    return rows, prof


def ptb_gate(run):
    """Phase 14's checks on a run's numbers: a list of what failed."""
    bad = []
    if any(run['kernel_launches'].values()):
        bad.append('the LSTM LM launched hand-written kernels: %s'
                   % run['kernel_launches'])
    ppl = run['epoch_perplexity']
    if len(ppl) != PTB_EPOCHS or not ppl[-1] < ppl[0] or \
            not all(math.isfinite(p) for p in ppl):
        bad.append('the perplexity did not fall over the epochs: %s' % ppl)
    if min(run['batches_per_epoch']) < 20:
        bad.append('epochs of %s batches, fewer than 20'
                   % run['batches_per_epoch'])
    if sorted(run['buckets_bound']) != sorted(PTB['buckets']):
        bad.append('buckets bound: %s' % run['buckets_bound'])
    if not run['shared_params']:
        bad.append('the buckets do not share their parameters')
    for what in ('unfused', 'cpu'):
        if not run[what]['ok']:
            bad.append('%s: %s' % (what, run[what]))
    bulk = run['bulk']
    if bulk['differ'] or not bulk['compared'] or not bulk['moms']:
        bad.append('fit(bulk=%d) differs from the per-step steps in %s '
                   '(%d compared)' % (PTB_BULK_K, bulk['differ'][:8],
                                      bulk['compared']))
    if bulk['dispatches'] != bulk['dispatches_want'] or \
            not bulk['dispatches']:
        bad.append('fit(bulk=%d) ran %d dispatches, expected %d'
                   % (PTB_BULK_K, bulk['dispatches'],
                      bulk['dispatches_want']))
    ck = run['checkpoint']
    if ck['differ'] or ck['extra'] or not ck['compared'] or \
            not ck['same_symbol'] or not ck['unpacked']:
        bad.append('the rnn checkpoint round trip: %s' % ck)
    return bad


def ptb_phase(torch, mx, cuda_conv, cuda_ops, root, ctx=None):
    """Phase 14: the PTB LSTM LM (FusedRNNCell(200, 2 layers), embed 200,
    vocab 10,000, batch 32, buckets 10-60) in float32 through
    BucketSentenceIter and BucketingModule.fit (Xavier, adam,
    Perplexity(None)) for PTB_EPOCHS epochs; the unfused cells against
    the fused op; a batch on ctx against cpu(0); fit(bulk=) over
    bucket_major batches against the per-step steps; the rnn checkpoint
    round trip; tokens/s per bucket and one step's profile. Gated by
    ptb_gate."""
    ctx = ctx or mx.gpu(0)
    torch.cuda.empty_cache()
    sentences, vocab = ptb_corpus(mx, SEED + 302)
    it = ptb_iter(mx, sentences)
    mod = mx.mod.BucketingModule(ptb_sym_gen(mx, ptb_fused_cell(mx)),
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    ppl_seen = []

    def record(param):
        ppl_seen.append((param.epoch, param.nbatch,
                         float(param.eval_metric.get()[1])))
    mx.random.seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: every count set to 0 just before, read just after
    reset_hand_written(cuda_conv, cuda_ops)
    t0 = time.perf_counter()
    mod.fit(it, eval_metric=mx.metric.Perplexity(None),
            num_epoch=PTB_EPOCHS, optimizer='adam',
            optimizer_params={'learning_rate': PTB_LR},
            initializer=mx.init.Xavier(), batch_end_callback=record)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = hand_written_launches(cuda_conv, cuda_ops)
    peak_bytes = torch.cuda.max_memory_allocated()
    epoch_ppl = [[p for e, _, p in ppl_seen if e == epoch][-1]
                 for epoch in range(PTB_EPOCHS)]
    per_epoch = [sum(1 for e, _, _ in ppl_seen if e == epoch)
                 for epoch in range(PTB_EPOCHS)]
    exes = {k: m._exec_group.executor for k, m in mod._buckets.items()}
    base = exes[mod._default_bucket_key]
    shared = all(ex.arg_dict[n] is base.arg_dict[n]
                 for ex in exes.values()
                 for n in ('embed_weight', 'lstm_parameters', 'pred_weight'))

    # one batch of each bucket, for the timings and the checks
    it.reset()
    batches = {}
    for b in it:
        batches.setdefault(b.bucket_key, b)
    rows, prof = ptb_timings(torch, mx, mod, batches)
    args, _ = mod.get_params()
    start = {n: a.asnumpy() for n, a in args.items()}
    unfused = ptb_unfused_check(torch, mx, ctx, args,
                                batches[max(PTB['buckets'])])
    cpu = ptb_cpu_check(torch, mx, ctx, args, batches[PTB_CPU_BUCKET])
    ckpt = ptb_checkpoint_check(torch, mx, mod, root)
    buckets_bound = sorted(mod._buckets)
    del mod, exes, base
    torch.cuda.empty_cache()
    bulk = ptb_bulk_check(torch, mx, ctx, sentences, start)

    run = dict(
        config=dict(PTB, sentences=PTB_SENTENCES, epochs=PTB_EPOCHS,
                    optimizer='adam', lr=PTB_LR, dtype='float32',
                    vocab_words=len(vocab)),
        fit_s=fit_s, batches_per_epoch=per_epoch,
        perplexity_by_batch=[p for _, _, p in ppl_seen],
        epoch_perplexity=epoch_ppl, kernel_launches=launches,
        peak_bytes=peak_bytes, shared_params=shared,
        buckets_bound=buckets_bound,
        buckets={str(k): v for k, v in rows.items()},
        profile=dict((k, prof[k]) for k in ('device_ms', 'step_ms',
                                            'device_busy_share',
                                            'launches', 'classes', 'top')),
        unfused=unfused, cpu=cpu, checkpoint=ckpt, bulk=bulk)
    print('ptb ' + json.dumps(run))
    bad = ptb_gate(run)
    if bad:
        fail('ptb: ' + '; '.join(bad))
    print('ptb: fit %.1f s for %d epochs of %s batches, perplexity %s; '
          'tokens/s by bucket %s; a bucket-%d step %.1f ms, %d kernel '
          'launches, device busy %.3f; peak %.2f GB; fused vs unfused %.3g, '
          'gpu vs cpu %.3g; fit(bulk=%d) %d dispatches, bit-equal'
          % (fit_s, PTB_EPOCHS, per_epoch, [round(p, 2) for p in epoch_ppl],
             {k: round(v['tokens_per_s']) for k, v in sorted(rows.items())},
             max(PTB['buckets']), prof['step_ms'], prof['launches'],
             prof['device_busy_share'], peak_bytes / 1e9,
             unfused['max_abs_err'], max(cpu['rel_err'].values()),
             PTB_BULK_K, bulk['dispatches']))
    return run


# ---------------------------------------------------------------------------
# Phase 15: gluon.rnn, the medium word LM of Zaremba et al. 2014
# ---------------------------------------------------------------------------

GLUON_LM = dict(vocab=10000, embed=650, hidden=650, layers=2, dropout=0.5,
                bptt=35, batch=20)
GLUON_LM_STEPS = 6
GLUON_LM_LR = 1.0           # SGD, Zaremba et al.'s
GLUON_LM_CLIP = 5.0         # the global norm of the per-token gradient
GLUON_LM_TOL = 1e-5         # the layer against LSTMCell.unroll
GLUON_DROPOUT_SE = 5.0      # the mask's kept share, in standard errors


def gluon_word_lm(mx):
    """The word LM of the Gluon example (untied): Embedding, dropout, the
    fused LSTM with dropout between its layers, dropout, Dense to the
    vocabulary."""
    gluon = mx.gluon
    cfg = GLUON_LM

    class WordLM(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(cfg['dropout'])
                self.encoder = gluon.nn.Embedding(cfg['vocab'], cfg['embed'])
                self.rnn = gluon.rnn.LSTM(cfg['hidden'],
                                          num_layers=cfg['layers'],
                                          dropout=cfg['dropout'],
                                          input_size=cfg['embed'])
                self.decoder = gluon.nn.Dense(cfg['vocab'], flatten=False,
                                              in_units=cfg['hidden'])

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            out, hidden = self.rnn(emb, hidden)
            return self.decoder(self.drop(out)), hidden

    return WordLM(prefix='lm_')


def gluon_lm_batches(mx, ctx, n):
    """n (bptt, batch) segments of one token stream (the corpus of phase
    14 laid end to end), each with its next-token targets."""
    sentences, _ = ptb_corpus(mx, SEED + 320)
    stream = np.array([w for s in sentences for w in s], dtype=np.float32)
    cfg = GLUON_LM
    cols = len(stream) // cfg['batch']
    grid = stream[:cols * cfg['batch']].reshape(cfg['batch'], cols).T
    if (cols - 1) < n * cfg['bptt']:
        fail('gluon lm: a stream of %d tokens is too short' % len(stream))
    out = []
    for i in range(n):
        seg = grid[i * cfg['bptt']:(i + 1) * cfg['bptt'] + 1]
        out.append((mx.nd.array(seg[:-1], ctx=ctx),
                    mx.nd.array(seg[1:], ctx=ctx)))
    return out


def gluon_unroll_check(torch, mx, ctx, model, x):
    """The model's LSTM in eval mode (dropout off) against an LSTMCell per
    layer, unrolled over the layer's own weights, on the embedded batch."""
    gluon = mx.gluon
    emb = model.encoder(x)
    layer = model.rnn
    out = layer(emb).handle.detach().clone()
    seq = mx.nd.swapaxes(emb, dim1=0, dim2=1)
    for i in range(GLUON_LM['layers']):
        width = GLUON_LM['embed'] if i == 0 else GLUON_LM['hidden']
        cell = gluon.rnn.LSTMCell(GLUON_LM['hidden'], input_size=width,
                                  prefix='unroll%d_' % i)
        cell.initialize(ctx=ctx)
        for part in ('i2h_weight', 'h2h_weight', 'i2h_bias', 'h2h_bias'):
            getattr(cell, part).set_data(
                getattr(layer, 'l%d_%s' % (i, part)).data(ctx))
        seq, _ = cell.unroll(GLUON_LM['bptt'], seq, layout='NTC',
                             merge_outputs=True)
    ref = mx.nd.swapaxes(seq, dim1=0, dim2=1).handle
    err = float((out - ref).abs().max())
    return dict(max_abs_err=err, tol=GLUON_LM_TOL, ok=err <= GLUON_LM_TOL)


def gluon_dropout_check(torch, mx, ctx):
    """The fused layer's dropout between its layers in train mode: an RNN
    (relu, 2 layers) whose input weights are the identity and whose
    recurrence and biases are 0, on ones, gives 0 where the mask drops a
    unit and 1 / (1 - p) where it keeps one: the kept share within
    GLUON_DROPOUT_SE standard errors of 1 - p, the kept values exact, two
    forwards different masks, and eval mode all ones."""
    from mxnet_tpu_torch import autograd
    cfg = GLUON_LM
    p, h = cfg['dropout'], cfg['hidden']
    layer = mx.gluon.rnn.RNN(h, num_layers=2, activation='relu', dropout=p,
                             input_size=h, prefix='mask_')
    layer.initialize(ctx=ctx)
    eye = mx.nd.array(np.eye(h, dtype=np.float32), ctx=ctx)
    zero = mx.nd.zeros((h, h), ctx=ctx)
    for i in range(2):
        getattr(layer, 'l%d_i2h_weight' % i).set_data(eye)
        getattr(layer, 'l%d_h2h_weight' % i).set_data(zero)
        for b in ('i2h_bias', 'h2h_bias'):
            getattr(layer, 'l%d_%s' % (i, b)).set_data(
                mx.nd.zeros((h,), ctx=ctx))
    x = mx.nd.ones((cfg['bptt'], cfg['batch'], h), ctx=ctx)
    with autograd.train_mode():
        a = layer(x).handle.detach()
        b = layer(x).handle.detach()
    kept = a != 0
    share = float(kept.float().mean())
    se = math.sqrt(p * (1 - p) / kept.numel())
    scale_err = float((a[kept] - 1.0 / (1 - p)).abs().max())
    ev = layer(x).handle
    return dict(p=p, kept_share=share, se=se,
                share_z=abs(share - (1 - p)) / se, scale_err=scale_err,
                masks_differ=bool((a != b).any()),
                eval_ones=bool((ev == 1).all()),
                ok=abs(share - (1 - p)) <= GLUON_DROPOUT_SE * se and
                scale_err <= 1e-6 and bool((a != b).any()) and
                bool((ev == 1).all()))


def gluon_lm_gate(run):
    """Phase 15's checks on a run's numbers: a list of what failed."""
    bad = []
    if any(run['kernel_launches'].values()):
        bad.append('the Gluon LM launched hand-written kernels: %s'
                   % run['kernel_launches'])
    losses = run['losses']
    if not all(math.isfinite(v) for v in losses) or \
            not min(losses[-2:]) < losses[0]:
        bad.append('the loss did not fall: %s' % losses)
    if run['param_devices'] != ['cuda:0']:
        bad.append('parameters on %s' % run['param_devices'])
    for what in ('unroll', 'dropout'):
        if not run[what]['ok']:
            bad.append('%s: %s' % (what, run[what]))
    return bad


def gluon_lm_phase(torch, mx, cuda_conv, cuda_ops, ctx=None):
    """Phase 15: the medium word LM of Zaremba et al. 2014 in Gluon
    (gluon.rnn.LSTM(650, 2 layers, dropout 0.5), embed 650, vocab 10,000,
    bptt 35, batch 20, untied) takes GLUON_LM_STEPS Trainer('sgd') steps
    with the global-norm clip under autograd.record(); LSTMCell.unroll
    over the layer's weights against the layer in eval mode; the dropout
    mask's statistics. Gated by gluon_lm_gate."""
    from mxnet_tpu_torch import autograd
    gluon = mx.gluon
    ctx = ctx or mx.gpu(0)
    cfg = GLUON_LM
    torch.cuda.empty_cache()
    mx.random.seed(SEED)
    model = gluon_word_lm(mx)
    model.initialize(mx.init.Xavier(), ctx=ctx)
    params = model.collect_params()
    trainer = gluon.Trainer(params, 'sgd', {'learning_rate': GLUON_LM_LR})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    batches = gluon_lm_batches(mx, ctx, GLUON_LM_STEPS)
    tokens = cfg['bptt'] * cfg['batch']
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: every count set to 0 just before, read just after
    reset_hand_written(cuda_conv, cuda_ops)
    hidden = model.rnn.begin_state(cfg['batch'], ctx=ctx)
    losses, norms, times = [], [], []
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden = [h.detach() for h in hidden]
        with autograd.record():
            out, hidden = model(x, hidden)
            loss = loss_fn(out.reshape((-1, cfg['vocab'])),
                           y.reshape((-1,)))
        loss.backward()
        grads = [p.grad(ctx) for p in params.values()
                 if p.grad_req != 'null']
        norms.append(float(gluon.utils.clip_global_norm(
            grads, GLUON_LM_CLIP * tokens)))
        trainer.step(tokens)
        losses.append(float(loss.mean().asscalar()))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = hand_written_launches(cuda_conv, cuda_ops)
    peak_bytes = torch.cuda.max_memory_allocated()
    param_devices = sorted({str(p.data(ctx).handle.device)
                            for p in params.values()})
    unroll = gluon_unroll_check(torch, mx, ctx, model, batches[0][0])
    dropout = gluon_dropout_check(torch, mx, ctx)
    step_ms = median(times[1:])
    run = dict(config=dict(cfg, steps=GLUON_LM_STEPS, lr=GLUON_LM_LR,
                           clip=GLUON_LM_CLIP, optimizer='sgd',
                           dtype='float32'),
               losses=losses, grad_norms=[n / tokens for n in norms],
               clipped=any(n > GLUON_LM_CLIP * tokens for n in norms),
               step_ms=times, step_ms_median=step_ms,
               tokens_per_s=tokens / (step_ms / 1e3), peak_bytes=peak_bytes,
               param_devices=param_devices, kernel_launches=launches,
               unroll=unroll, dropout=dropout)
    print('gluon_lm ' + json.dumps(run))
    bad = gluon_lm_gate(run)
    if bad:
        fail('gluon lm: ' + '; '.join(bad))
    print('gluon lm: losses %s; %.1f ms a step (%.0f tokens/s); peak %.2f '
          'GB; layer vs cell unroll %.3g; dropout kept share %.4f (%.2f '
          'standard errors from %.2f)'
          % ([round(v, 3) for v in losses], step_ms, run['tokens_per_s'],
             peak_bytes / 1e9, unroll['max_abs_err'], dropout['kept_share'],
             dropout['share_z'], 1 - dropout['p']))
    del model, trainer
    torch.cuda.empty_cache()
    return run


# ---------------------------------------------------------------------------
# Phase 16: the model factories, Inception-v3 and ResNeXt-50 on the conv
# kernel
# ---------------------------------------------------------------------------

# (name, factory, image shape): bf16 through Module on the pair route
FACTORY_BF16 = (('inception_v3', 'inception-v3', (3, 299, 299)),
                ('resnext50', 'resnext', (3, 224, 224)))
FACTORY_BATCH = 128
FACTORY_STEPS = 3
FACTORY_OPT = dict(learning_rate=0.01, momentum=0.9, wd=1e-4,
                   multi_precision=True)
# the conditioned weights: every BatchNorm's gamma scaled by this and its
# beta moved to 1 + 0.1 x, so that each ReLU takes its inputs in its
# linear range and the network does not amplify rounding (phase 11's
# reason; He-normal at gamma ~1 and beta ~0 is reported beside it), and
# the classifier's weight scaled by it too, so that the logits of those
# all-positive features stay near a uniform guess's (a peaked softmax
# turns the rounding of a tiny probability into a large loss difference)
FACTORY_GAMMA_SCALE = 0.1
# (name, factory, image shape, batch): one float32 train step each
FACTORY_F32 = (('lenet', 'lenet', (1, 28, 28), 64),
               ('mlp', 'mlp', (1, 28, 28), 64),
               ('alexnet', 'alexnet', (3, 224, 224), 64),
               ('vgg16', 'vgg', (3, 224, 224), 32),
               ('inception_bn', 'inception-bn', (3, 224, 224), 64))
FACTORY_CPU_BATCH = 2
# a batch of 2 on the card against cpu(0), TF32 off: the output and each
# moving statistic within FACTORY_CPU_TOL of the largest cpu magnitude.
# The gradients are chaotic at initialisation (ReLU masks flip; in the
# BatchNorm nets, tests/test_torch_models.py): scaling the input by
# 1 + FACTORY_CHAOS_NUDGE moves VGG-16's first weight gradient on cpu(0)
# by 4.0e-3 in relative norm. So the card's gradients are held to
# cpu(0)'s own spread under that nudge, measured in the run: the median
# and the largest relative-norm error over the gradients within
# FACTORY_CHAOS_FACTOR times cpu(0)'s plus FACTORY_CHAOS_SLACK
FACTORY_CPU_TOL = 1e-4
FACTORY_CHAOS_NUDGE = 2.0 ** -22
FACTORY_CHAOS_FACTOR, FACTORY_CHAOS_SLACK = 2.0, 1e-4


def graph_pairs(symbol):
    """The conv -> BatchNorm pairs of a symbol's JSON, counted without the
    executor: each Convolution with no_bias, a 2-D kernel, one group and
    no dilation whose output's only use is input 0 of a BatchNorm on axis
    1 without use_global_stats."""
    graph = json.loads(symbol.tojson())
    nodes = graph['nodes']
    uses = {}
    for i, n in enumerate(nodes):
        for src, idx, _ in n['inputs']:
            uses.setdefault((src, idx), []).append((i, n))
    for src, idx, _ in graph['heads']:
        uses.setdefault((src, idx), []).append((None, None))

    def attr(n, key, default):
        return n.get('attrs', {}).get(key, default)
    count = 0
    for i, n in enumerate(nodes):
        if n['op'] != 'Convolution':
            continue
        kernel = attr(n, 'kernel', '()').strip('()').split(',')
        dilate = [d for d in attr(n, 'dilate', '(1, 1)').strip('()').split(',')
                  if d.strip()]
        if attr(n, 'no_bias', 'False') != 'True' or \
                len([k for k in kernel if k.strip()]) != 2 or \
                int(attr(n, 'num_group', '1')) != 1 or \
                any(int(d) != 1 for d in dilate):
            continue
        users = uses.get((i, 0), [])
        if len(users) != 1 or users[0][1] is None:
            continue
        j, bn = users[0]
        if bn['op'] == 'BatchNorm' and bn['inputs'][0][0] == i and \
                int(attr(bn, 'axis', '1')) == 1 and \
                attr(bn, 'use_global_stats', 'False') != 'True':
            count += 1
    return count


def conditioned(args):
    """The seeded values with every BatchNorm in its linear-ReLU regime
    and the classifier (fc1) scaled down."""
    out = {}
    for n, a in args.items():
        if n.endswith('_gamma') or n == 'fc1_weight':
            a = a * np.float32(FACTORY_GAMMA_SCALE)
        elif n.endswith('_beta'):
            a = np.float32(1.0) + a
        out[n] = a
    return out


def factory_route_comparison(torch, mx, cuda_conv, symbol, shape, params,
                             ctx):
    """One train step with the pair route on and one with it off from the
    same values: relative errors, loss difference, the launches of each."""
    ex = bind_resnet(mx, symbol, ctx, FACTORY_BATCH, shape, params)
    label = ex.arg_dict['softmax_label'].handle
    saved = save_params(ex)
    states, losses, launches = {}, {}, {}
    for route in (True, False):
        restore(ex, saved)
        ex._pair_route = route
        before = cuda_conv.CONV_BN_STATS_LAUNCHES
        ex.forward_backward()
        torch.cuda.synchronize()
        launches[route] = cuda_conv.CONV_BN_STATS_LAUNCHES - before
        states[route] = resnet_state(torch, ex)
        losses[route] = nll(torch, ex, label)
    out = compare_states(torch, states[True], states[False])
    out.update(loss_err=abs(losses[True] - losses[False]),
               loss_fused=losses[True], loss_unfused=losses[False],
               launches_route=launches[True],
               launches_unfused=launches[False],
               grad_spread=spread(out['grad_rel']))
    del ex, states, saved
    torch.cuda.empty_cache()
    return out


def factory_bf16_run(torch, mx, cuda_conv, name, network, shape, ctx):
    """One bf16 network through Module at FACTORY_BATCH: FACTORY_STEPS
    steps (forward_backward, update) counting the kernel's launches; the
    route against route-off on conditioned and on He-normal weights; the
    kernel against its plain version at every distinct routed shape."""
    from mxnet_tpu_torch import executor
    symbol = mx.models.get_symbol(network, num_classes=1000,
                                  dtype='bfloat16')
    want = graph_pairs(symbol)
    mod = mx.mod.Module(symbol, context=ctx)
    mod.bind([mx.io.DataDesc('data', (FACTORY_BATCH,) + shape)],
             [mx.io.DataDesc('softmax_label', (FACTORY_BATCH,))])
    mod.init_params(initializer=mx.init.Xavier(
        rnd_type='gaussian', factor_type='in', magnitude=2))
    mod.init_optimizer(optimizer='sgd', optimizer_params=dict(FACTORY_OPT))
    ex = mod._exec_group.executor
    x, y = module_data(1000, FACTORY_BATCH, shape, SEED + 330)
    batch = mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                            [mx.nd.array(y, ctx=ctx)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, times, losses = [], [], []
    label = batch.label[0].handle
    for _ in range(FACTORY_STEPS):
        before = cuda_conv.CONV_BN_STATS_LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        losses.append(nll(torch, ex, label))
        mod.update()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(cuda_conv.CONV_BN_STATS_LAUNCHES - before)
    peak_bytes = torch.cuda.max_memory_allocated()
    pairs = dict(ex.pairs)
    shapes = pair_shapes(symbol, FACTORY_BATCH, shape, executor,
                         pairs=pairs)
    split = bool(ex._split_conv)
    grouped = sum(1 for n in ex._topo if n.op is not None and
                  n.op.name == 'Convolution' and
                  int(n.attrs.get('num_group', 1)) != 1)
    del mod, ex, batch
    torch.cuda.empty_cache()
    kernel_checks = resnet_kernel_checks(torch, cuda_conv, executor, shapes,
                                         ctx.torch_device)
    params = resnet_params(symbol, dict(data=(FACTORY_BATCH,) + shape),
                           1000, SEED + 340)
    cond = factory_route_comparison(
        torch, mx, cuda_conv, symbol, shape,
        (conditioned(params[0]), params[1]), ctx)
    he = factory_route_comparison(torch, mx, cuda_conv, symbol, shape,
                                  params, ctx)
    step_ms = median(times[1:])
    return dict(
        network=network, shape=list(shape), batch=FACTORY_BATCH,
        pairs_from_graph=want, pairs_routed=len(pairs),
        stem_split=split, grouped_convs=grouped, step_launches=launches,
        path_launches=sum(launches), losses=losses, step_ms=times,
        step_ms_median=step_ms,
        images_per_s=FACTORY_BATCH / (step_ms / 1e3), peak_bytes=peak_bytes,
        distinct_shapes=len(shapes), kernel_checks=kernel_checks,
        conditioned=cond,
        he_normal=dict((k, he[k]) for k in (
            'loss_err', 'out_rel', 'aux_rel', 'grad_spread',
            'launches_route', 'launches_unfused')))


def no_dropout(mx, symbol):
    """The symbol with every Dropout's p set to 0 (cpu(0) and the card
    draw different masks)."""
    return mx.sym.load_json(symbol.tojson().replace('"p": "0.5"',
                                                    '"p": "0"'))


def factory_f32_run(torch, mx, name, network, shape, batch, ctx):
    """One float32 train step of a factory's network through Module at
    `batch`, then a batch of FACTORY_CPU_BATCH on ctx against cpu(0) from
    the same seeded values (dropout at p 0)."""
    symbol = mx.models.get_symbol(network, num_classes=1000
                                  if network not in ('lenet', 'mlp') else 10)
    classes = 10 if network in ('lenet', 'mlp') else 1000
    mod = mx.mod.Module(symbol, context=ctx)
    mod.bind([mx.io.DataDesc('data', (batch,) + shape)],
             [mx.io.DataDesc('softmax_label', (batch,))])
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer='sgd', optimizer_params=dict(
        learning_rate=0.01, momentum=0.9))
    x, y = module_data(classes, batch, shape, SEED + 350)
    db = mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                         [mx.nd.array(y, ctx=ctx)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.forward_backward(db)
    mod.update()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    out = mod.get_outputs()[0].handle
    finite = bool(torch.isfinite(out).all())
    del mod, db
    plain = no_dropout(mx, symbol)
    cshape = (FACTORY_CPU_BATCH,) + shape
    args, auxs = resnet_params(plain, dict(data=cshape), classes, SEED + 360)
    nudged = dict(args, data=args['data'] *
                  np.float32(1.0 + FACTORY_CHAOS_NUDGE))
    states = {}
    for key, c, a in (('gpu', ctx, args), ('cpu', mx.cpu(0), args),
                      ('cpu_nudged', mx.cpu(0), nudged)):
        ex = bind_resnet(mx, plain, c, FACTORY_CPU_BATCH, shape, (a, auxs))
        ex.forward_backward()
        st = {'output': ex.outputs[0].handle.detach().float().cpu()}
        st.update(('grad ' + n, g.handle.detach().float().cpu())
                  for n, g in ex.grad_dict.items())
        st.update(('aux ' + n, a.handle.detach().float().cpu())
                  for n, a in ex.aux_dict.items())
        states[key] = st
        del ex
    ref = states['cpu']
    forward = {k: float((states['gpu'][k] - v).abs().max()) /
               max(1e-30, float(v.abs().max()))
               for k, v in ref.items() if not k.startswith('grad ')}
    grads = {k: rel_err(torch, states['gpu'][k], v)
             for k, v in ref.items() if k.startswith('grad ')}
    own = {k: rel_err(torch, states['cpu_nudged'][k], v)
           for k, v in ref.items() if k.startswith('grad ')}

    def med(d):
        return sorted(d.values())[len(d) // 2]
    grad_bound = dict(
        median=FACTORY_CHAOS_FACTOR * med(own) + FACTORY_CHAOS_SLACK,
        max=FACTORY_CHAOS_FACTOR * max(own.values()) + FACTORY_CHAOS_SLACK)
    ok = finite and max(forward.values()) <= FACTORY_CPU_TOL and \
        med(grads) <= grad_bound['median'] and \
        max(grads.values()) <= grad_bound['max'] and \
        all(bool(torch.isfinite(v).all()) for v in states['gpu'].values())
    return dict(network=network, shape=list(shape), batch=batch,
                step_ms=step_ms, finite=finite,
                cpu_forward_max_err=max(forward.values()),
                cpu_grad_rel=dict(median=med(grads),
                                  max=max(grads.values()),
                                  worst=max(grads, key=grads.get)),
                cpu_own_spread=dict(median=med(own), max=max(own.values()),
                                    worst=max(own, key=own.get)),
                cpu_grad_bound=grad_bound, ok=ok)


def factories_gate(run):
    """Phase 16's checks on a run's numbers: a list of what failed."""
    bad = []
    for name, r in run['bf16'].items():
        want = r['pairs_from_graph']
        if not want or r['pairs_routed'] != want:
            bad.append('%s: the executor routes %d pairs, the graph has %d'
                       % (name, r['pairs_routed'], want))
        if r['stem_split']:
            bad.append('%s: a stem split took a conv' % name)
        if r['step_launches'] != [want] * FACTORY_STEPS:
            bad.append('%s: launches a step %s, expected %d'
                       % (name, r['step_launches'], want))
        if not all(math.isfinite(v) for v in r['losses']):
            bad.append('%s: losses %s' % (name, r['losses']))
        if len(r['kernel_checks']) != r['distinct_shapes'] or \
                not r['kernel_checks']:
            bad.append('%s: %d kernel checks for %d shapes'
                       % (name, len(r['kernel_checks']),
                          r['distinct_shapes']))
        for row in r['kernel_checks']:
            if not row['ok']:
                bad.append('%s: the kernel disagrees with its plain version '
                           'at %s' % (name, row))
        c = r['conditioned']
        if c['launches_route'] != want or c['launches_unfused'] != 0:
            bad.append('%s: route on / off launched %d / %d times'
                       % (name, c['launches_route'], c['launches_unfused']))
        if not c['loss_err'] <= RESNET_LOSS_ATOL:
            bad.append('%s: route on / off loss differs by %.3g (bound %.3g)'
                       % (name, c['loss_err'], RESNET_LOSS_ATOL))
        for key, err in dict(c['aux_rel'], output=c['out_rel']).items():
            bound = RESNET_OUT_REL if key == 'output' else RESNET_AUX_REL
            if not err <= bound:
                bad.append('%s: route on / off %s differs by %.3g (bound '
                           '%.3g)' % (name, key, err, bound))
    if run['bf16']['resnext50']['grouped_convs'] != 16:
        bad.append('resnext50: %d grouped convs'
                   % run['bf16']['resnext50']['grouped_convs'])
    for name, r in run['f32'].items():
        if not r['ok']:
            bad.append('%s (float32): %s' % (name, r))
    return bad


def factories_phase(torch, mx, cuda_conv, ctx=None):
    """Phase 16: Inception-v3 at 3x299x299 and ResNeXt-50 32x4d at 224 in
    bf16 through Module at batch FACTORY_BATCH, FACTORY_STEPS steps each
    on the pair route (launches a step counted against the graph's pairs),
    the kernel at every distinct routed shape, the route against route-off
    on conditioned and He-normal weights; LeNet, MLP, AlexNet, VGG-16 and
    Inception-BN one float32 step each and a batch of 2 against cpu(0).
    Gated by factories_gate."""
    ctx = ctx or mx.gpu(0)
    torch.cuda.empty_cache()
    bf16 = {}
    # the main path of each network: the count set to 0 just before, read
    # just after, in factory_bf16_run
    for name, network, shape in FACTORY_BF16:
        bf16[name] = factory_bf16_run(torch, mx, cuda_conv, name, network,
                                      shape, ctx)
        r = bf16[name]
        print('factories: %s bf16 batch %d: %.1f ms a step (%.1f images/s), '
              '%s launches a step (%d pairs in the graph, %d distinct '
              'shapes), route on / off output %.3g (conditioned), %.3g '
              '(He-normal); peak %.2f GB'
              % (name, FACTORY_BATCH, r['step_ms_median'],
                 r['images_per_s'], r['step_launches'], r['pairs_from_graph'],
                 r['distinct_shapes'], r['conditioned']['out_rel'],
                 r['he_normal']['out_rel'], r['peak_bytes'] / 1e9))
        torch.cuda.empty_cache()
    f32 = {}
    for name, network, shape, batch in FACTORY_F32:
        f32[name] = factory_f32_run(torch, mx, name, network, shape, batch,
                                    ctx)
        torch.cuda.empty_cache()
    run = dict(bf16=bf16, f32=f32)
    print('factories ' + json.dumps(run))
    bad = factories_gate(run)
    if bad:
        fail('factories: ' + '; '.join(bad))
    print('factories: float32 steps %s ms; gpu vs cpu forward %s, '
          'gradients (median, largest) %s against cpu\'s own spread %s'
          % ({k: round(v['step_ms'], 1) for k, v in f32.items()},
             {k: '%.2g' % v['cpu_forward_max_err'] for k, v in f32.items()},
             {k: '%.2g, %.2g' % (v['cpu_grad_rel']['median'],
                                 v['cpu_grad_rel']['max'])
              for k, v in f32.items()},
             {k: '%.2g, %.2g' % (v['cpu_own_spread']['median'],
                                 v['cpu_own_spread']['max'])
              for k, v in f32.items()}))
    return run


# ---------------------------------------------------------------------------
# Phase 17: the last 50 op names of the registry
# ---------------------------------------------------------------------------

CONTRIB_EXAMPLE = True      # the case table's example sizes (False: small)


def contrib_phase(torch, cuda_conv, cuda_ops, device='cuda'):
    """Phase 17: every name of ops/extra.py, ops/spatial.py and
    ops/contrib_ops.py (aliases included) and the table's variants on the
    card against cpu(0), forward and gradient, at the sizes of the
    examples that use them (tools/op_consistency.py's contrib cases);
    integer, mask, id, order and selection results equal, floats within
    their class; no hand-written kernel launched."""
    from mxnet_tpu_torch.tools import op_consistency as oc
    reset_hand_written(cuda_conv, cuda_ops)
    t0 = time.perf_counter()
    bad, host_ms = oc.run_contrib(torch, device, 'cpu',
                                  example=CONTRIB_EXAMPLE, seed=SEED)
    run = dict(names=len(oc.CONTRIB_NAMES),
               variants=sorted(oc.CONTRIB_VARIANTS),
               example_sizes=CONTRIB_EXAMPLE,
               s=time.perf_counter() - t0, host_ms_a_call=host_ms,
               mismatches=bad,
               kernel_launches=hand_written_launches(cuda_conv, cuda_ops))
    print('contrib ' + json.dumps(run))
    for name, ms in sorted(host_ms.items(), key=lambda kv: -kv[1])[:12]:
        print('contrib: %-36s %9.3f host ms a call on the card' % (name, ms))
    if bad:
        fail('contrib: %d cases disagree between the card and cpu(0): %s'
             % (len(bad), bad))
    if any(run['kernel_launches'].values()):
        fail('contrib: hand-written kernels launched: %s'
             % run['kernel_launches'])
    print('contrib: %d names and %d variants agree on the card and cpu(0) '
          'in %.1f s' % (run['names'], len(run['variants']), run['s']))
    return run


# ---------------------------------------------------------------------------
# Phase 18: the train_imagenet input path (ImageRecordIter -> Module.fit)
# ---------------------------------------------------------------------------

RECORD_IMAGES = 768         # 3 batches of RESNET_BATCH an epoch
RECORD_SIDES = (256, 500)
RECORD_QUALITY = 95
RECORD_THREADS = 8          # preprocess_threads of the train iterator
RECORD_GATE_THREADS = 2     # gate (d): the same epoch on fewer workers
RECORD_EPOCHS = 2
RECORD_VAL_RESIZE = 256
RECORD_PSNR_DB = 30.0       # gate (b): a decoded image against its pixels
RECORD_DECODE_TIMED = 64    # records decoded one by one for the decode ms


def synthetic_image(torch, rng, label, classes, sides, device):
    """A smooth seeded image (uint8 H x W x 3, OpenCV's BGR order) with an
    ellipse whose colour is its class's, made on `device`."""
    h, w = (int(v) for v in rng.integers(sides[0], sides[1] + 1, 2))
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    freq = rng.uniform(0.005, 0.03, (3, 2))
    phase = rng.uniform(0, 2 * math.pi, 3)
    chans = [128 + 60 * torch.sin(xx * float(freq[c, 0]) +
                                  yy * float(freq[c, 1]) + float(phase[c]))
             for c in range(3)]
    img = torch.stack(chans, dim=2)
    colour = torch.tensor([(label * 37) % 200 + 30, (label * 91) % 200 + 30,
                           (label * 53) % 200 + 30], dtype=torch.float32,
                          device=device)
    cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
    rx, ry = rng.uniform(0.15, 0.3) * w, rng.uniform(0.15, 0.3) * h
    d = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
    alpha = torch.sigmoid((1.0 - d) * 6.0)[:, :, None]
    img = img * (1 - alpha) + colour * alpha
    return img.round().clamp(0, 255).to(torch.uint8)


def write_record_images(torch, mx, prefix, n, classes, ctx, keep=0):
    """n seeded images packed by recordio.pack_img (nvJPEG on the card,
    JPEG quality RECORD_QUALITY) into prefix.rec / prefix.idx with labels
    i % classes; returns (seconds, the first `keep` images' pixels)."""
    rng = np.random.default_rng(SEED + 180)
    rec = mx.recordio.MXIndexedRecordIO(prefix + '.idx', prefix + '.rec',
                                        'w')
    kept = []
    t0 = time.perf_counter()
    for i in range(n):
        label = i % classes
        img = synthetic_image(torch, rng, label, classes, RECORD_SIDES,
                              ctx.torch_device)
        if i < keep:
            kept.append(img)
        header = mx.recordio.IRHeader(0, float(label), i, 0)
        rec.write_idx(i, mx.recordio.pack_img(header, img,
                                              quality=RECORD_QUALITY))
    rec.close()
    return time.perf_counter() - t0, kept


def record_iter(mx, prefix, ctx, threads=RECORD_THREADS, train=True):
    """examples/image_classification/common/data.py's iterators: the train
    one shuffled with random crops and mirrors, the val one resized to
    RECORD_VAL_RESIZE and centre-cropped."""
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    if train:
        return mx.io.ImageRecordIter(
            path_imgrec=prefix + '.rec', data_shape=shape,
            batch_size=RESNET_BATCH, shuffle=True, rand_crop=True,
            rand_mirror=True, preprocess_threads=threads, ctx=ctx)
    return mx.io.ImageRecordIter(
        path_imgrec=prefix + '.rec', data_shape=shape,
        batch_size=RESNET_BATCH, resize=RECORD_VAL_RESIZE,
        preprocess_threads=threads, ctx=ctx)


def psnr_db(torch, got, ref):
    mse = float(((got.double() - ref.double()) ** 2).mean())
    return math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def decode_checks(torch, mx, prefix, kept, ctx):
    """Gate (b): every kept image decoded on the card (BGR) against the
    pixels that were encoded, by PSNR; beside it the host decoder's
    (cv2) difference from nvJPEG's where cv2 imports; and the decode ms
    an image of nvJPEG alone, one thread, RECORD_DECODE_TIMED records."""
    from mxnet_tpu_torch.image import image as img_mod
    rec = mx.recordio.MXIndexedRecordIO(prefix + '.idx', prefix + '.rec',
                                        'r')
    bufs = [mx.recordio.unpack(rec.read_idx(i))[1]
            for i in range(max(len(kept), RECORD_DECODE_TIMED))]
    psnrs, host = [], None
    try:
        import cv2
    except ImportError:
        cv2 = None
    diffs = []
    for buf, src in zip(bufs, kept):
        dec = img_mod.decode_tensor(buf, ctx.torch_device, to_rgb=False)
        psnrs.append(psnr_db(torch, dec, src))
        if cv2 is not None:
            ref = cv2.imdecode(np.frombuffer(buf, np.uint8), 1)
            d = np.abs(dec.cpu().numpy().astype(np.int32) - ref)
            diffs.append((int(d.max()), float(d.mean())))
    if diffs:
        host = dict(decoder='cv2 %s' % cv2.__version__,
                    max_abs_diff=max(m for m, _ in diffs),
                    mean_abs_diff=float(np.mean([a for _, a in diffs])))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for buf in bufs[:RECORD_DECODE_TIMED]:
        img_mod.decode_tensor(buf, ctx.torch_device)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / RECORD_DECODE_TIMED
    return dict(images=len(psnrs), min_psnr_db=min(psnrs),
                mean_psnr_db=float(np.mean(psnrs)), host_decoder=host,
                nvjpeg_decode_ms_an_image=decode_ms,
                mean_jpeg_bytes=float(np.mean([len(b) for b in bufs])))


def augment_check(torch, mx, prefix, ctx):
    """Gate (c): one decoded image through the train chain (random crop
    and mirror) and through one that resizes first (RECORD_VAL_RESIZE),
    on the card and on cpu(0), from the same pixels and the same seeded
    draws: the crop and flip equal, the resize within 1 level."""
    from mxnet_tpu_torch.image import image as img_mod
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    rec = mx.recordio.MXIndexedRecordIO(prefix + '.idx', prefix + '.rec',
                                        'r')
    buf = mx.recordio.unpack(rec.read_idx(0))[1]
    dev = img_mod.decode_tensor(buf, ctx.torch_device)
    host = dev.cpu()
    out = {}
    for name, kw in (('crop_mirror', dict(rand_crop=True, rand_mirror=True)),
                     ('resize_crop_mirror', dict(resize=RECORD_VAL_RESIZE,
                                                 rand_crop=True,
                                                 rand_mirror=True))):
        augs = img_mod.CreateAugmenter(shape, **kw)
        results = []
        for img in (dev, host):
            with img_mod._seeded_aug_rng(SEED + 181):
                for aug in augs:
                    img = aug(img)[0]
            results.append(img)
        diff = float((results[0].cpu() - results[1]).abs().max())
        out[name] = dict(max_abs_diff=diff, shape=list(results[1].shape))
    return out


def record_epoch(torch, it):
    """One epoch of an iterator: (images, seconds, the batches' data and
    labels as device tensors)."""
    it.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = []
    for batch in it:
        batches.append((batch.data[0].handle, batch.label[0].handle))
    torch.cuda.synchronize()
    return (sum(d.shape[0] for d, _ in batches), time.perf_counter() - t0,
            batches)


def record_step_check(torch, mx, mod, prefix, ctx):
    """Gate (a): the parameters after one step on the first batch of an
    ImageRecordIter bit-equal to those after the same batch (its numbers
    copied to the host) fed through NDArrayIter, from one state, under
    deterministic cuDNN."""
    it = record_iter(mx, prefix, ctx)
    batch = it.next()
    it.close()
    x, y = batch.data[0].asnumpy(), batch.label[0].asnumpy()
    snap = module_snapshot(mod)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mod.forward_backward(batch)
        mod.update()
        fed = module_state(mod)
        module_restore(mod, snap)
        nd_batch = mx.io.NDArrayIter(x, y, batch_size=x.shape[0]).next()
        mod.forward_backward(nd_batch)
        mod.update()
        ref = module_state(mod)
        module_restore(mod, snap)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    unequal = sorted(k for k in ref if not torch.equal(fed[k], ref[k]))
    return dict(compared=len(ref), unequal=unequal[:10],
                equal=not unequal)


def record_gate(run):
    """Phase 18's gates; the list of what failed."""
    bad = []
    want = route_pairs(RESNET_PAIRS, run['stem_split'])
    for i, n in enumerate(run['train_launches']):
        if n != want:
            bad.append('fit step %d launched the kernel %d times, expected '
                       '%d' % (i, n, want))
    if run['score_launches'] != 0:
        bad.append('score launched the kernel %d times'
                   % run['score_launches'])
    if not run['score_finite']:
        bad.append('score not finite: %s' % run['score'])
    if not run['step_check']['equal']:
        bad.append('(a) the ImageRecordIter step differs from the '
                   'NDArrayIter step in %s' % run['step_check']['unequal'])
    if run['decode']['min_psnr_db'] < RECORD_PSNR_DB:
        bad.append('(b) a decoded image at %.2f dB < %.1f dB'
                   % (run['decode']['min_psnr_db'], RECORD_PSNR_DB))
    aug = run['augment']
    if aug['crop_mirror']['max_abs_diff'] != 0:
        bad.append('(c) the crop and flip differ on the card by %g'
                   % aug['crop_mirror']['max_abs_diff'])
    if aug['resize_crop_mirror']['max_abs_diff'] > 1:
        bad.append('(c) the resize differs on the card by %g levels'
                   % aug['resize_crop_mirror']['max_abs_diff'])
    if not run['workers_equal']:
        bad.append('(d) the epoch on %d workers differs from %d workers'
                   % (RECORD_GATE_THREADS, RECORD_THREADS))
    for r in run['kernel_checks']:
        if not r['ok']:
            bad.append('(e) the kernel at %s %s: %s' % (r['x'], r['w'], r))
    if not run['finite']:
        bad.append('a parameter or state is not finite after fit')
    return bad


def record_phase(torch, mx, cuda_conv, root, module=None, ctx=None,
                 keep=None):
    """Phase 18: RECORD_IMAGES seeded JPEGs written on the card by
    pack_img, ImageRecordIter (8 decode workers on their own streams)
    feeding Module.fit on the bf16 ResNet-50 of phase 10, then score on
    the val iterator; gated by record_gate. With `keep` (a directory) the
    .rec and .idx are moved there at the end, for phases 37 and 38."""
    import shutil
    from mxnet_tpu_torch import executor
    phase_t0 = time.perf_counter()
    ctx = ctx or mx.gpu(0)
    torch.cuda.empty_cache()
    work = root / 'build' / 'phase18'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    prefix = str(work / 'train')
    try:
        write_s, kept = write_record_images(
            torch, mx, prefix, RECORD_IMAGES, RESNET['num_classes'], ctx,
            keep=RESNET_BATCH)
        decode = decode_checks(torch, mx, prefix, kept, ctx)
        del kept
        augment = augment_check(torch, mx, prefix, ctx)

        # the iterator alone, then gate (d): the same epoch on fewer
        # workers (the shuffle from `random`, the draws from stream_seed)
        mx.random.seed(SEED)
        random.seed(SEED)
        it8 = record_iter(mx, prefix, ctx)
        images, iter_s, first = record_epoch(torch, it8)
        it8.close()
        random.seed(SEED)
        it2 = record_iter(mx, prefix, ctx, threads=RECORD_GATE_THREADS)
        _, _, second = record_epoch(torch, it2)
        it2.close()
        workers_equal = len(first) == len(second) and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(first, second))
        del first, second

        # the main path: fit fed by ImageRecordIter, the count set to 0
        # just before it and read just after
        symbol, init = module_symbol_params(mx)
        mod = mx.mod.Module(symbol, context=ctx)
        random.seed(SEED + 1)
        train = mx.io.prefetch_to_device(record_iter(mx, prefix, ctx),
                                         size=MODULE_PREFETCH, device=ctx)
        from mxnet_tpu_torch import profiler
        profiler.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cuda_conv.CONV_BN_STATS_LAUNCHES = 0
        times, launches, _, stalls, train_metric = module_fit(
            mx, cuda_conv, mod, train, init, RECORD_EPOCHS)
        torch.cuda.synchronize()
        fit_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
        fit_s = time.perf_counter() - t0
        peak_bytes = torch.cuda.max_memory_allocated()
        inputs = profiler.input_stats()
        stall = train.stall_ms_per_batch()
        train.close()
        train.data_iter.close()
        step_ms = median(step_intervals(times))

        ex = mod._exec_group.executor
        tensors = [ex.arg_dict[n].handle
                   for n in mod._fused_updater.param_names] + \
            [a.handle for a in ex.aux_dict.values()]
        finite = all(bool(torch.isfinite(t).all()) for t in tensors)

        # score on the val iterator launches no kernel
        val = record_iter(mx, prefix, ctx, train=False)
        cuda_conv.CONV_BN_STATS_LAUNCHES = 0
        score = [(n, float(v)) for n, v in mod.score(val, ['acc', 'ce'])]
        torch.cuda.synchronize()
        score_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
        val.close()

        step_check = record_step_check(torch, mx, mod, prefix, ctx)

        # one fit step's profile, its batch from the iterator
        it = record_iter(mx, prefix, ctx)
        batch = it.next()
        it.close()

        def one_step():
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(mx.metric.create('acc'), batch.label)
        profile = resnet_profile(torch, one_step, step_ms)

        # gate (e): the kernel against its plain version at every pair
        # shape of the step
        shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
        shapes = pair_shapes(symbol, RESNET_BATCH, shape, executor,
                             pairs=dict(ex.pairs))
        del mod, ex, batch, train
        torch.cuda.empty_cache()
        kernel_checks = resnet_kernel_checks(torch, cuda_conv, executor,
                                             shapes, ctx.torch_device)
        if keep is not None:
            shutil.rmtree(keep, ignore_errors=True)
            keep.mkdir(parents=True)
            for ext in ('.rec', '.idx'):
                shutil.move(prefix + ext, str(keep / ('train' + ext)))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    nd_fit = module['step_ms_median'] if module else None
    run = dict(
        config=dict(images=RECORD_IMAGES, sides=list(RECORD_SIDES),
                    quality=RECORD_QUALITY, classes=RESNET['num_classes'],
                    batch=RESNET_BATCH, epochs=RECORD_EPOCHS,
                    preprocess_threads=RECORD_THREADS, network=RESNET),
        stem_split=stem_split_on(), write_s=write_s,
        write_images_per_s=RECORD_IMAGES / write_s, decode=decode,
        augment=augment, iterator_images_per_s=images / iter_s,
        workers_equal=workers_equal, fit_s=fit_s,
        train_launches=launches, fit_launches=fit_launches,
        step_ms=step_intervals(times), step_ms_median=step_ms,
        images_per_s=RESNET_BATCH / (step_ms / 1e3),
        epoch_images_per_s=epoch_images_per_s(times, RECORD_IMAGES),
        ndarrayiter_fit_step_ms=nd_fit,
        ndarrayiter_fit_images_per_s=(RESNET_BATCH / (nd_fit / 1e3)
                                      if nd_fit else None),
        stall_ms_per_batch=stall, stall_ms=stalls,
        input_stats=inputs,
        decode_augment_ms_a_sample=(inputs['decode_ms'] /
                                    max(inputs['decoded_samples'], 1)),
        train_metric=train_metric, score=score,
        score_finite=all(math.isfinite(v) for _, v in score),
        score_launches=score_launches, peak_bytes=peak_bytes,
        finite=finite, step_check=step_check,
        device_busy_share=profile['device_busy_share'], profile=profile,
        kernel_checks=kernel_checks, s=time.perf_counter() - phase_t0)
    print('record ' + json.dumps(run))
    bad = record_gate(run)
    if bad:
        fail('record: ' + '; '.join(bad))
    print('record: ImageRecordIter -> fit %.1f ms a step (%.0f images/s; '
          'a whole epoch %s images/s; NDArrayIter fit %s); the iterator '
          'alone %.0f images/s; nvJPEG '
          '%.3f ms an image; decode + augment %.3f host ms a sample; '
          'stall %.2f ms a batch; device busy %.1f %%; peak %.2f GB; %s '
          'kernel launches a step; lowest PSNR %.2f dB; the phase %.1f s'
          % (step_ms, run['images_per_s'],
             ['%.0f' % v for v in run['epoch_images_per_s']],
             '%.1f ms' % nd_fit if nd_fit else 'not run',
             run['iterator_images_per_s'],
             decode['nvjpeg_decode_ms_an_image'],
             run['decode_augment_ms_a_sample'], run['stall_ms_per_batch'],
             100 * run['device_busy_share'], peak_bytes / 1e9,
             sorted(set(launches)), decode['min_psnr_db'], run['s']))
    return run


def epoch_images_per_s(times, per_epoch):
    """Images a second of each epoch after the first, from the last batch
    end of the epoch before to its own (its reset, the pipeline's refill
    and its steps), from module_fit's batch-end times."""
    last = {}
    for epoch, t in times:
        last[epoch] = t
    return [per_epoch / (last[e] - last[e - 1])
            for e in sorted(last) if e - 1 in last]


# ---------------------------------------------------------------------------
# Phase 19: VGG16-SSD300 through ImageDetIter and Module.fit
# ---------------------------------------------------------------------------

SSD_IMAGES = 256            # 8 batches of SSD_BATCH an epoch
SSD_SIDES = (300, 500)
SSD_CLASSES = 20
SSD_BATCH = 32
SSD_SHAPE = (3, 300, 300)
SSD_EPOCHS = 2
# examples/ssd/train_ssd.py's SGD, with each gradient element clipped to
# 1: from a random start (no pretrained VGG) the loc loss's gradient,
# which MakeLoss does not divide by the valid count in either package,
# blows the weights up within a few steps (the JAX package's too)
SSD_OPT = dict(learning_rate=0.002, momentum=0.9, wd=5e-4,
               clip_gradient=1.0)
SSD_AUG = dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True)
SSD_THREADS = 8
SSD_NMS = dict(nms_thresh=0.45, nms_topk=400)
SSD_TOL = 1e-5              # MultiBoxTarget / Detection, card against cpu(0)
SSD_CPU_BATCH = 2           # the train step on the card against cpu(0)
SSD_CHAOS_NUDGE = 2.0 ** -22
SSD_CHAOS_FACTOR, SSD_CHAOS_SLACK = 2.0, 0.005
SSD_TIMED = 3               # timed detection forwards, after one warm-up


def write_det_images(torch, mx, prefix, n, ctx):
    """n seeded detection images (sides SSD_SIDES, 1-6 boxes of
    SSD_CLASSES classes drawn as coloured rectangles on a smooth field,
    JPEG by pack_img), labels packed as tools/im2rec.py packs them:
    [2, 5, cls, x1, y1, x2, y2, ...] in normalised corners."""
    rng = np.random.default_rng(SEED + 190)
    rec = mx.recordio.MXIndexedRecordIO(prefix + '.idx', prefix + '.rec',
                                        'w')
    for i in range(n):
        img = synthetic_image(torch, rng, i % SSD_CLASSES, SSD_CLASSES,
                              SSD_SIDES, ctx.torch_device).float()
        h, w = img.shape[:2]
        label = [2, 5]
        for _ in range(int(rng.integers(1, 7))):
            cls = int(rng.integers(0, SSD_CLASSES))
            bw, bh = rng.uniform(0.1, 0.5, 2)
            x1, y1 = rng.uniform(0, 1 - bw), rng.uniform(0, 1 - bh)
            colour = torch.tensor([(cls * 37) % 200 + 30,
                                   (cls * 91) % 200 + 30,
                                   (cls * 53) % 200 + 30],
                                  dtype=torch.float32, device=img.device)
            img[int(y1 * h):int((y1 + bh) * h),
                int(x1 * w):int((x1 + bw) * w)] = colour
            label += [cls, x1, y1, x1 + bw, y1 + bh]
        header = mx.recordio.IRHeader(0, np.array(label, np.float32), i, 0)
        rec.write_idx(i, mx.recordio.pack_img(
            header, img.to(torch.uint8), quality=RECORD_QUALITY))
    rec.close()


def ssd_loss_metric(mx):
    """An EvalMetric of the loc loss of a batch (the sum of loc_loss over
    the positive anchors' count, the reference's SmoothL1 of
    MultiBoxMetric) and the class cross-entropy over the non-ignored
    anchors."""
    class Metric(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__(['loc_loss', 'cls_ce'])

        def reset(self):
            self.num_inst = 0
            self.sum_metric = 0.0
            self.loc, self.ce, self.n = 0.0, 0.0, 0
            self._pending_device = None

        def update(self, labels, preds):
            cls_prob, loc_loss, cls_label = (p.handle for p in preds)
            pos = (cls_label > 0).sum().clamp(min=1)
            valid = cls_label >= 0
            lab = cls_label.clamp(min=0).long()
            p = cls_prob.gather(1, lab[:, None]).squeeze(1)
            ce = -(p.clamp(min=1e-12).log() * valid).sum() / \
                valid.sum().clamp(min=1)
            self.loc += float(loc_loss.sum() / pos)
            self.ce += float(ce)
            self.n += 1

        def get(self):
            if not self.n:
                return (['loc_loss', 'cls_ce'], [math.nan, math.nan])
            return (['loc_loss', 'cls_ce'],
                    [self.loc / self.n, self.ce / self.n])
    return Metric()


def ssd_internals(mx, symbol):
    """The head's cls_preds, loc_preds and anchors as one symbol."""
    internals = symbol.get_internals()
    return mx.sym.Group([internals['multibox_cls_pred_output'],
                         internals['multibox_loc_pred_output'],
                         internals['multibox_anchors_output']])


def ssd_head_outputs(mx, symbol, args, data, ctx):
    """(cls_preds, loc_preds, anchors) of the trained head on `data`."""
    heads = ssd_internals(mx, symbol)
    ex = heads.simple_bind(ctx, grad_req='null', data=tuple(data.shape))
    ex.copy_params_from(args, {}, allow_extra_params=True)
    ex.arg_dict['data'][:] = data
    return [o.handle for o in ex.forward(is_train=False)]


def ssd_op_checks(torch, mx, cls_preds, loc_preds, anchors, label):
    """MultiBoxTarget (the train symbol's attrs) and MultiBoxDetection
    (the detection symbol's) on the card against cpu(0) on the same
    inputs: targets, masks, ids and order equal, floats within
    SSD_TOL."""
    from mxnet_tpu_torch.ops import contrib_ops as co
    anchors2 = anchors.reshape(-1, 4)
    target_args = (0.5, -1.0, 3.0, 0.5, 0, (0.1, 0.1, 0.2, 0.2))
    got = co.multibox_target(anchors2, label, cls_preds, *target_args)
    ref = co.multibox_target(anchors2.cpu(), label.cpu(), cls_preds.cpu(),
                             *target_args)
    cls_prob = torch.softmax(cls_preds, dim=1)
    det_args = (0.01, True, (0.1, 0.1, 0.2, 0.2), SSD_NMS['nms_thresh'],
                False, SSD_NMS['nms_topk'])
    det = co.multibox_detection(cls_prob, loc_preds, anchors2, *det_args)
    det_ref = co.multibox_detection(cls_prob.cpu(), loc_preds.cpu(),
                                    anchors2.cpu(), *det_args)
    out = dict(
        loc_target_max_abs_err=float((got[0].cpu() - ref[0]).abs().max()),
        loc_mask_equal=bool(torch.equal(got[1].cpu(), ref[1])),
        cls_target_equal=bool(torch.equal(got[2].cpu(), ref[2])),
        positives=int((ref[2] > 0).sum()),
        ids_equal=bool(torch.equal(det[..., 0].cpu(), det_ref[..., 0])),
        kept=int((det_ref[..., 0] >= 0).sum()),
        detection_max_abs_err=float((det.cpu() - det_ref).abs().max()))
    out['ok'] = (out['loc_mask_equal'] and out['cls_target_equal'] and
                 out['ids_equal'] and
                 out['loc_target_max_abs_err'] <= SSD_TOL and
                 out['detection_max_abs_err'] <= SSD_TOL)
    return out


def ssd_cpu_check(torch, mx, symbol, args, data, label, ctx):
    """One train step at batch SSD_CPU_BATCH on the card against cpu(0),
    float32, from the trained weights: cls_label equal, and the
    gradients' median relative error within SSD_CHAOS_FACTOR times
    cpu(0)'s own under a SSD_CHAOS_NUDGE nudge of the input, plus
    SSD_CHAOS_SLACK (VGG's ReLU masks flip under rounding)."""
    shapes = dict(data=tuple(data.shape), label=tuple(label.shape))
    req = {n: 'null' if n in ('data', 'label') else 'write'
           for n in symbol.list_arguments()}

    host_label = label.asnumpy()

    def step(c, x):
        ex = symbol.simple_bind(c, grad_req=req, **shapes)
        ex.copy_params_from({k: v.as_in_context(c) for k, v in args.items()},
                            {}, allow_extra_params=True)
        ex.arg_dict['data'][:] = x
        ex.arg_dict['label'][:] = host_label
        ex.forward_backward()
        return ([o.asnumpy() for o in ex.outputs],
                {n: g.asnumpy() for n, g in ex.grad_dict.items()})
    host = data.asnumpy()
    g_outs, g_grads = step(ctx, host)
    c_outs, c_grads = step(mx.cpu(), host)
    _, n_grads = step(mx.cpu(), host * np.float32(1 + SSD_CHAOS_NUDGE))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    own = float(np.median([rel(n_grads[k], g) for k, g in c_grads.items()]))
    port = float(np.median([rel(g_grads[k], g) for k, g in c_grads.items()]))
    finite = all(np.isfinite(g).all() for g in g_grads.values())
    return dict(batch=int(data.shape[0]), grad_median_rel=port,
                cpu_own_spread=own,
                bound=SSD_CHAOS_FACTOR * own + SSD_CHAOS_SLACK,
                cls_label_equal=bool(np.array_equal(g_outs[2], c_outs[2])),
                cls_prob_max_abs_err=float(np.abs(g_outs[0] - c_outs[0])
                                           .max()),
                finite=finite,
                ok=finite and bool(np.array_equal(g_outs[2], c_outs[2])) and
                port <= SSD_CHAOS_FACTOR * own + SSD_CHAOS_SLACK)


def ssd_detect(torch, mx, args, ctx):
    """The detection symbol on the trained weights: the forward's median
    host ms over SSD_TIMED runs and the NMS host ms inside one of them
    (nms_keep timed around its call)."""
    from mxnet_tpu_torch.ops import contrib_ops as co
    det = mx.models.ssd.get_symbol(num_classes=SSD_CLASSES, **SSD_NMS)
    ex = det.simple_bind(ctx, grad_req='null',
                         data=(SSD_BATCH,) + SSD_SHAPE)
    ex.copy_params_from(args, {}, allow_extra_params=True)
    rng = np.random.default_rng(SEED + 191)
    ex.arg_dict['data'][:] = rng.standard_normal(
        (SSD_BATCH,) + SSD_SHAPE).astype(np.float32)
    ex.forward(is_train=False)
    torch.cuda.synchronize()
    times = []
    for _ in range(SSD_TIMED):
        t0 = time.perf_counter()
        out = ex.forward(is_train=False)[0].handle
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    nms_ms = []
    keep = co.nms_keep

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = keep(*a, **k)
        torch.cuda.synchronize()
        nms_ms.append((time.perf_counter() - t) * 1e3)
        return r
    co.nms_keep = timed
    try:
        out = ex.forward(is_train=False)[0].handle
        torch.cuda.synchronize()
    finally:
        co.nms_keep = keep
    return dict(forward_ms=times, forward_ms_median=median(times),
                nms_ms=sum(nms_ms), rows=list(out.shape),
                kept=int((out[..., 0] >= 0).sum()),
                finite=bool(torch.isfinite(out).all()))


def ssd_gate(run):
    bad = []
    if any(run['kernel_launches'].values()):
        bad.append('hand-written kernels launched: %s'
                   % run['kernel_launches'])
    if not all(math.isfinite(v) for v in run['loc_loss_by_epoch'] +
               run['cls_ce_by_epoch']):
        bad.append('a loss is not finite: %s %s' % (
            run['loc_loss_by_epoch'], run['cls_ce_by_epoch']))
    if not run['ops']['ok']:
        bad.append('MultiBoxTarget / Detection on the card differ from '
                   'cpu(0): %s' % run['ops'])
    if not run['cpu']['ok']:
        bad.append('the train step on the card against cpu(0): %s'
                   % run['cpu'])
    if not run['detect']['finite']:
        bad.append('the detections are not finite')
    if run['anchors'] != run['expected_anchors']:
        bad.append('%d anchors, expected %d' % (run['anchors'],
                                                run['expected_anchors']))
    return bad


def ssd_phase(torch, mx, cuda_conv, cuda_ops, root, ctx=None):
    """Phase 19: VGG16-SSD300 (models.ssd.get_symbol_train, 20 classes,
    float32) trained by Module.fit from ImageDetIter (random crop, pad and
    mirror, the mean subtracted) on SSD_IMAGES seeded JPEGs written on
    the card, then the detection symbol on the trained weights; gated by
    ssd_gate."""
    import shutil
    phase_t0 = time.perf_counter()
    ctx = ctx or mx.gpu(0)
    torch.cuda.empty_cache()
    work = root / 'build' / 'phase19'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    prefix = str(work / 'det')
    try:
        t0 = time.perf_counter()
        write_det_images(torch, mx, prefix, SSD_IMAGES, ctx)
        write_s = time.perf_counter() - t0
        random.seed(SEED + 2)
        mx.random.seed(SEED)
        det_iter = mx.image.ImageDetIter(
            batch_size=SSD_BATCH, data_shape=SSD_SHAPE,
            path_imgrec=prefix + '.rec', shuffle=True,
            preprocess_threads=SSD_THREADS, ctx=ctx, **SSD_AUG)
        symbol = mx.models.ssd.get_symbol_train(num_classes=SSD_CLASSES)
        _, outs, _ = symbol.infer_shape(
            data=(1,) + SSD_SHAPE, label=(1, det_iter.max_objects, 5))
        anchors = outs[0][2]
        mod = mx.mod.Module(symbol, data_names=('data',),
                            label_names=('label',), context=ctx)
        train = mx.io.prefetch_to_device(det_iter, size=MODULE_PREFETCH,
                                         device=ctx)
        metric = ssd_loss_metric(mx)
        times, epoch_losses = [], []

        def record(param):
            times.append((param.epoch, time.perf_counter()))

        def epoch_end(epoch, *args):
            epoch_losses.append(dict(metric.get_name_value()))
        reset_hand_written(cuda_conv, cuda_ops)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mod.fit(train, eval_metric=metric, optimizer='sgd',
                optimizer_params=SSD_OPT, initializer=mx.init.Xavier(),
                batch_end_callback=[record], epoch_end_callback=epoch_end,
                num_epoch=SSD_EPOCHS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = hand_written_launches(cuda_conv, cuda_ops)
        peak_bytes = torch.cuda.max_memory_allocated()
        stall = train.stall_ms_per_batch()
        train.close()
        step_ms = median(step_intervals(times))
        args, _ = mod.get_params()

        # one step's profile and MultiBoxTarget's share, on a batch of
        # the iterator
        det_iter.reset()
        batch = det_iter.next()
        det_iter.close()

        def one_step():
            mod.forward_backward(batch)
            mod.update()
        profile = resnet_profile(torch, one_step, step_ms)
        step_launches = sum(c['launches']
                            for c in profile['classes'].values())
        cls_preds, loc_preds, anc = ssd_head_outputs(
            mx, symbol, args, batch.data[0], ctx)
        label = batch.label[0].handle
        from mxnet_tpu_torch.ops import contrib_ops as co
        from mxnet_tpu_torch.tools import bench_conv_bn as bench
        mbt_ms = bench.cuda_ms(lambda: co.multibox_target(
            anc.reshape(-1, 4), label, cls_preds, 0.5, -1.0, 3.0, 0.5, 0,
            (0.1, 0.1, 0.2, 0.2)), 5)
        ops = ssd_op_checks(torch, mx, cls_preds, loc_preds, anc, label)
        detect = ssd_detect(torch, mx, args, ctx)
        cpu = ssd_cpu_check(torch, mx, symbol, args,
                            batch.data[0][:SSD_CPU_BATCH],
                            batch.label[0][:SSD_CPU_BATCH], ctx)
        del mod, batch, train
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    run = dict(
        config=dict(images=SSD_IMAGES, sides=list(SSD_SIDES),
                    classes=SSD_CLASSES, batch=SSD_BATCH,
                    data_shape=list(SSD_SHAPE), epochs=SSD_EPOCHS,
                    optimizer='sgd', **SSD_OPT, threads=SSD_THREADS,
                    augment=SSD_AUG, **SSD_NMS),
        anchors=anchors, expected_anchors=8096, write_s=write_s,
        fit_s=fit_s, step_ms=step_intervals(times), step_ms_median=step_ms,
        images_per_s=SSD_BATCH / (step_ms / 1e3),
        epoch_images_per_s=epoch_images_per_s(times, SSD_IMAGES),
        stall_ms_per_batch=stall,
        multibox_target_device_ms=mbt_ms,
        loc_loss_by_epoch=[e['loc_loss'] for e in epoch_losses],
        cls_ce_by_epoch=[e['cls_ce'] for e in epoch_losses],
        kernel_launches=launches, launches_a_step=step_launches,
        device_busy_share=profile['device_busy_share'],
        peak_bytes=peak_bytes, ops=ops, detect=detect, cpu=cpu,
        profile=profile, s=time.perf_counter() - phase_t0)
    print('ssd ' + json.dumps(run))
    bad = ssd_gate(run)
    if bad:
        fail('ssd: ' + '; '.join(bad))
    print('ssd: fit %.1f ms a step (%.1f images/s, %d anchors), '
          'MultiBoxTarget %.3f ms of device time, %d kernel launches a '
          'step, device busy %.1f %%, peak %.2f GB; detection forward %.1f '
          'ms with NMS %.1f ms; loc loss by epoch %s; the phase %.1f s'
          % (step_ms, run['images_per_s'], anchors, mbt_ms, step_launches,
             100 * run['device_busy_share'], peak_bytes / 1e9,
             detect['forward_ms_median'], detect['nms_ms'],
             run['loc_loss_by_epoch'], run['s']))
    return run


# ---------------------------------------------------------------------------
# Phase 20: the serving fleet (ModelRegistry, ContinuousEngine, HttpFront)
# ---------------------------------------------------------------------------

# the ptb-lstm tenant: phase 14's widths (examples/rnn's bucketing LM)
FLEET_PTB = dict(vocab=PTB['vocab'], embed=PTB['embed'],
                 hidden=PTB['hidden'], layers=PTB['layers'])
FLEET_PTB_WEIGHT_STD = 0.1


def fleet_cell(mx, vocab, embed, hidden, layers):
    """The PTB LSTM LM's per-timestep cell as a scorer: a step's input is
    (token, next token), as float32 ids; Embedding, `layers` mx.rnn.
    LSTMCells stepped once (states l<i>_h, l<i>_c in and out),
    FullyConnected to the vocabulary, log_softmax, and the next token's
    log-probability picked: outputs [score (slots,), l0_h, l0_c, ...].
    The package `mx` builds it (the port, or the JAX package in the
    tests)."""
    data = mx.sym.Variable('data')
    tok, nxt = mx.sym.SliceChannel(data, num_outputs=2, axis=1,
                                   squeeze_axis=True)
    x = mx.sym.Embedding(tok, input_dim=vocab, output_dim=embed,
                         name='embed')
    states = []
    for i in range(layers):
        cell = mx.rnn.LSTMCell(hidden, prefix='lstm_l%d_' % i)
        x, (h, c) = cell(x, [mx.sym.Variable('l%d_h' % i),
                             mx.sym.Variable('l%d_c' % i)])
        states += [h, c]
    logp = mx.sym.log_softmax(mx.sym.FullyConnected(
        x, num_hidden=vocab, name='pred'))
    return mx.sym.Group([mx.sym.pick(logp, nxt, axis=-1)] + states)


def fleet_cell_states(hidden, layers):
    """(state_shapes, state_outputs) of fleet_cell."""
    names = ['l%d_%s' % (i, k) for i in range(layers) for k in 'hc']
    return ({n: (hidden,) for n in names},
            {n: 1 + j for j, n in enumerate(names)})


def fleet_cell_params(mx, cell, hidden, layers, seed):
    """Seeded float32 weights of fleet_cell, normal * FLEET_PTB_WEIGHT_STD,
    biases 0, as numpy arrays by name."""
    shapes, _ = fleet_cell_states(hidden, layers)
    known = dict({n: (1,) + s for n, s in shapes.items()}, data=(1, 2))
    arg_shapes, _, _ = cell.infer_shape(**known)
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in zip(cell.list_arguments(), arg_shapes):
        if name in known:
            continue
        out[name] = np.zeros(shape, np.float32) if name.endswith('_bias') \
            else (rng.standard_normal(shape) *
                  FLEET_PTB_WEIGHT_STD).astype(np.float32)
    return out


def fleet_unrolled(mx, vocab, embed, hidden, layers, steps):
    """fleet_cell's weights over a whole sequence: data (1, steps, 2),
    the LSTMCells' unroll(steps) from zero states, the scores (steps,)."""
    data = mx.sym.Variable('data')
    tok, nxt = mx.sym.SliceChannel(data, num_outputs=2, axis=2,
                                   squeeze_axis=True)
    x = mx.sym.Embedding(tok, input_dim=vocab, output_dim=embed,
                         name='embed')
    stack = mx.rnn.SequentialRNNCell()
    for i in range(layers):
        stack.add(mx.rnn.LSTMCell(hidden, prefix='lstm_l%d_' % i))
    outputs, _ = stack.unroll(steps, x, layout='NTC', merge_outputs=True)
    logp = mx.sym.log_softmax(mx.sym.FullyConnected(
        mx.sym.Reshape(outputs, shape=(-1, hidden)), num_hidden=vocab,
        name='pred'))
    return mx.sym.pick(logp, mx.sym.Reshape(nxt, shape=(-1,)), axis=-1)


class FleetScorer(object):
    """The gpt2-medium tenant, an engine-like object the registry takes
    by source=: infer(tokens, targets) -> [log p(targets) (1, T) float32]
    through a TransformerLM (its attention on the flash kernel when its
    config says use_flash). The logits stay where the model is; requests
    are serialized on one stream."""

    def __init__(self, torch, model, counter=None, lock=None):
        self._torch = torch
        self._model = model
        # counter() reads a launch count: each call's delta joins per_call
        self._counter = counter
        self.per_call = []
        self._device = model.embed.device
        # scorers that share a lock share one count exactly (phase 24)
        self._lock = lock or threading.Lock()
        self._closed = False
        self._stream = None
        if self._device.type == 'cuda':
            self._stream = torch.cuda.Stream(self._device)
            self._stream.wait_stream(torch.cuda.current_stream(
                self._device))

    def infer(self, tokens, targets):
        torch = self._torch
        if self._closed:
            from mxnet_tpu_torch.base import MXNetError
            raise MXNetError('FleetScorer is closed')
        tok = torch.as_tensor(np.asarray(tokens).reshape(1, -1)).long()
        tgt = torch.as_tensor(np.asarray(targets).reshape(1, -1)).long()
        stream = contextlib.nullcontext() if self._stream is None else \
            torch.cuda.stream(self._stream)
        with self._lock, stream, torch.inference_mode():
            before = self._counter() if self._counter else 0
            logits = self._model(tok.to(self._device))
            if self._counter:
                self.per_call.append(self._counter() - before)
            logp = torch.log_softmax(logits.float(), dim=-1).gather(
                -1, tgt.to(self._device)[..., None])[..., 0]
            return [logp.cpu().numpy()]

    @property
    def closed(self):
        return self._closed

    def close(self):
        self._closed = True
        return self

    def resident_bytes(self):
        return sum(p.numel() * p.element_size()
                   for p in self._model.parameters())


FLEET_SLOTS = PTB['batch']  # the ptb-lstm engine's slots: PTB's batch
FLEET_SEQS = 256            # ptb-lstm sequences through the front
FLEET_MAX_LEN = max(PTB['buckets'])
FLEET_TRAFFIC_S = 20.0      # the mixed traffic's window
FLEET_BURST_S = 3.0         # the burst at FLEET_BURST_MULT x the clients
FLEET_BURST_MULT = 4
# client threads by class: 1-image requests to resnet50, 4-image requests
# alternating between resnet50-int8 and resnet50-paged, the PTB
# sequences, 1024-token scoring requests
FLEET_CLIENTS = (('resnet50', 8), ('alternate', 4), ('ptb-lstm', 2),
                 ('gpt2-medium', 2))
FLEET_INFLIGHT = 48         # the front's in-flight admission bound
FLEET_IMAGES = 32           # distinct 1-image requests
FLEET_QUADS = 8             # distinct 4-image requests
FLEET_SCORES = 4            # distinct scoring requests
FLEET_DIGITS = 3            # decimals of the images in the JSON bodies
FLEET_LADDER = (1, 4, 16, 32)
FLEET_SOLO = 16             # ptb-lstm sequences also run alone
FLEET_MIN_CYCLES = 3        # evict / re-warm cycles of each ResNet tenant
FLEET_EVICT_FREED = 0.9     # share of an evicted tenant's bytes the
                            # allocator must give back
FLEET_UNROLL_TOL = 1e-5     # the engine against cell.unroll(60), relative
# the card's engine against cpu(0)'s, relative to the largest score:
# within FLEET_CPU_FACTOR times cpu(0)'s own move under a
# FLEET_CPU_NUDGE nudge of the embedding, plus FLEET_CPU_SLACK
FLEET_CPU_NUDGE = 2.0 ** -22
FLEET_CPU_FACTOR, FLEET_CPU_SLACK = 2.0, 1e-6
FLEET_PROFILE_S = 3.0       # the torch.profiler window inside the traffic
# SLO priorities: the registry evicts the lowest first, so with one
# ResNet tenant resident at a time ptb-lstm (2) is never the victim of a
# ResNet load, and resnet50 (1) goes only when no int8 tenant is resident
FLEET_PRIORITY = {'resnet50': 1, 'resnet50-int8': 0, 'resnet50-paged': 0,
                  'ptb-lstm': 2, 'gpt2-medium': 1}
FLEET_RESNETS = ('resnet50', 'resnet50-int8', 'resnet50-paged')


def fleet_sequences(n, seed):
    """n PTB-like sentences (ptb_sentences' corpus, 1 to FLEET_MAX_LEN
    words) as ptb-lstm requests: step i is (word i, word i + 1), the
    last word's next token 0 (the invalid label); float32 (T, 2)."""
    out = []
    for words in ptb_sentences(n, FLEET_PTB['vocab'], FLEET_MAX_LEN, seed):
        ids = [int(w[1:]) for w in words] + [0]
        out.append(np.stack([ids[:-1], ids[1:]], axis=1).astype(np.float32))
    return out


def fleet_ptb_engine(mx, params, ctx, **kw):
    """A ContinuousEngine over fleet_cell at FLEET_PTB's widths."""
    from mxnet_tpu_torch.serving_fleet import ContinuousEngine
    cell = fleet_cell(mx, **FLEET_PTB)
    shapes, outs = fleet_cell_states(FLEET_PTB['hidden'],
                                     FLEET_PTB['layers'])
    kw.setdefault('slots', FLEET_SLOTS)
    return ContinuousEngine(
        cell, arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                          for k, v in params.items()},
        data_shape=(2,), state_shapes=shapes, state_outputs=outs, ctx=ctx,
        **kw)


def fleet_same(a, b):
    """Two lists of per-sequence answers equal bit for bit."""
    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))
        for x, y in zip(a, b))


def busy_union_ms(events):
    """The device-busy time of profiler kernel events: the union of their
    intervals (engines' streams overlap), in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def cuda_kernel_events(prof):
    return [e for e in prof.events()
            if str(getattr(e, 'device_type', '')).endswith('CUDA')]


def fleet_ladder(torch, mx, params, ctx, seqs):
    """The PTB sequences through engines of FLEET_SLOTS slots: each K of
    FLEET_LADDER (stage_ahead 1), K = 16 serialized (stage_ahead 0), the
    convoy baseline, and a K = 16 run handed over mid-traffic by
    export_state / admit_state to a fresh engine; answers, seq/s and
    ticks. One K = 16 run under torch.profiler: kernel launches and the
    host and device ms of a tick."""
    from torch.profiler import ProfilerActivity, profile
    tokens = sum(len(x) for x in seqs)
    runs, answers = {}, {}

    def run(name, **kw):
        eng = fleet_ptb_engine(mx, params, ctx, **kw)
        try:
            t0 = time.perf_counter()
            answers[name] = eng.infer_many(seqs)
            wall = time.perf_counter() - t0
            st = eng.stats()
        finally:
            eng.close()
        runs[name] = dict(seqs_per_s=len(seqs) / wall,
                          tokens_per_s=tokens / wall, wall_s=wall,
                          ticks=st['ticks'], chunks=st['chunks'],
                          utilization=st['utilization'],
                          lone_fast_path=st['lone_fast_path'],
                          lone_fast_path_width=st['lone_fast_path_width'],
                          exact_fill_admits=st['exact_fill_admits'],
                          boundary_wait_ms=st['boundary_wait_ms'],
                          compiles_after_warmup=st['compiles_after_warmup'])

    for k in FLEET_LADDER:
        run('k%d' % k, tick_chunk=k)
    run('k16_serialized', tick_chunk=16, stage_ahead=0)
    run('convoy', tick_chunk=1, convoy=True)

    # the hand-over: export after a few chunks, admit into a fresh engine
    old = fleet_ptb_engine(mx, params, ctx, tick_chunk=16)
    got = {}
    t = threading.Thread(target=lambda: got.update(a=old.infer_many(seqs)))
    t.start()
    deadline = time.perf_counter() + 60
    while old.stats()['chunks'] < 4 and time.perf_counter() < deadline:
        time.sleep(0.001)
    exported = old.export_state()
    new = fleet_ptb_engine(mx, params, ctx, tick_chunk=16)
    migrated = new.admit_state(exported)
    t.join(timeout=300)
    new.close()
    old.close()
    if t.is_alive():
        fail('fleet: the handed-over PTB requests did not finish')
    answers['swap'] = got.get('a')

    # one K = 16 run under the profiler
    eng = fleet_ptb_engine(mx, params, ctx, tick_chunk=16)
    window = seqs[:FLEET_SLOTS]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.infer_many(window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = eng.stats()
    eng.close()
    kernels = cuda_kernel_events(prof)
    ticks = max(st['ticks'], 1)
    profile_row = dict(ticks=st['ticks'], chunks=st['chunks'],
                       launches=len(kernels),
                       launches_per_tick=len(kernels) / ticks,
                       host_ms_per_tick=wall * 1e3 / ticks,
                       device_ms_per_tick=busy_union_ms(kernels) / ticks)
    return runs, answers, dict(migrated=migrated,
                               dropped=exported['dropped']), profile_row


def fleet_unroll_check(torch, mx, params, ctx, seq):
    """(e): one FLEET_MAX_LEN-step sequence through an engine on ctx,
    against the same weights unrolled by the cells' unroll() and run
    once on ctx, and against cpu(0)'s engine, within cpu(0)'s own move
    under a nudge of the embedding."""
    steps = len(seq)
    sym = fleet_unrolled(mx, steps=steps, **FLEET_PTB)
    ex = sym.simple_bind(ctx, grad_req='null', data=(1, steps, 2))
    ex.copy_params_from({k: mx.nd.array(v, ctx=mx.cpu())
                         for k, v in params.items()})
    unrolled = ex.forward(is_train=False, data=seq[None])[0].asnumpy()

    def engine_scores(c, p):
        with fleet_ptb_engine(mx, p, c, tick_chunk=1) as eng:
            return eng.infer(seq)[0]

    card = engine_scores(ctx, params)
    cpu = engine_scores(mx.cpu(), params)
    nudged = dict(params, embed_weight=params['embed_weight'] *
                  np.float32(1.0 + FLEET_CPU_NUDGE))
    cpu_nudged = engine_scores(mx.cpu(), nudged)
    scale = float(np.abs(cpu).max())
    own = float(np.abs(cpu_nudged - cpu).max()) / scale
    return dict(steps=steps,
                unroll_rel_err=float(np.abs(card - unrolled).max() /
                                     np.abs(unrolled).max()),
                unroll_tol=FLEET_UNROLL_TOL,
                cpu_err=float(np.abs(card - cpu).max()) / scale,
                cpu_own=own,
                cpu_bound=FLEET_CPU_FACTOR * own + FLEET_CPU_SLACK)


def fleet_client(address, work, window, out, once=False):
    """One HTTP client: once `window['go']` is set, POST each (tenant,
    key, body) of `work` in turn on one keep-alive connection, once
    through `work` (`once`), or else until `window['stop_at']`
    (perf_counter); one record a reply in `out`."""
    import http.client
    window['go'].wait(timeout=600)
    conn = http.client.HTTPConnection(*address, timeout=300)
    i = 0
    try:
        while (i < len(work)) if once else \
                (time.perf_counter() < window['stop_at']):
            tenant, key, body = work[i % len(work)]
            i += 1
            t0 = time.perf_counter()
            try:
                conn.request('POST', '/v1/models/%s:predict' % tenant, body,
                             {'Content-Type': 'application/json'})
                r = conn.getresponse()
                data = r.read()
            except (OSError, http.client.HTTPException) as e:
                out.append(dict(tenant=tenant, key=key, code=None,
                                error=repr(e)))
                conn.close()
                conn = http.client.HTTPConnection(*address, timeout=300)
                continue
            rec = dict(tenant=tenant, key=key, code=r.status,
                       ms=(time.perf_counter() - t0) * 1e3,
                       retry_after=r.getheader('Retry-After'))
            if r.status == 200:
                rec['out'] = json.loads(data)['outputs'][0]
            elif r.status == 429:
                rec['overloaded'] = 'backlog_rows' in json.loads(data)
            out.append(rec)
    finally:
        conn.close()


def fleet_drive(address, work_by_client, seconds):
    """Client threads, one per (work list, once) pair, released together
    once all have started, the timed ones for `seconds`: (threads, their
    records, the perf_counter of the release)."""
    records = []
    window = dict(go=threading.Event(), stop_at=None)
    threads = [threading.Thread(target=fleet_client,
                                args=(address, work, window, records, once))
               for work, once in work_by_client]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    window['stop_at'] = t0 + seconds
    window['go'].set()
    return threads, records, t0


def fleet_codes(records):
    codes = {}
    for r in records:
        codes[str(r['code'])] = codes.get(str(r['code']), 0) + 1
    return codes


def fleet_tenant_rows(records, seconds):
    """Per tenant: requests, answers/s, p50 / p99 client latency of the
    answered requests, 429s."""
    rows = {}
    for tenant in sorted({r['tenant'] for r in records}):
        mine = [r for r in records if r['tenant'] == tenant]
        ok = [r['ms'] for r in mine if r['code'] == 200]
        rows[tenant] = dict(
            requests=len(mine), answered=len(ok),
            answers_per_s=len(ok) / seconds,
            p50_ms=float(np.percentile(ok, 50)) if ok else None,
            p99_ms=float(np.percentile(ok, 99)) if ok else None,
            rejected_429=sum(1 for r in mine if r['code'] == 429))
    return rows


def fleet_gate(run):
    """Phase 20's checks on a run's numbers: a list of what failed, empty
    when it passed."""
    bad = []
    for part in ('http', 'burst'):
        codes = run[part]['codes']
        other = {c: n for c, n in codes.items() if c not in ('200', '429')}
        if other:
            bad.append('%s: replies other than 200 and 429 (5xx or none): '
                       '%s' % (part, other))
    if run['http']['retry_after_missing']:
        bad.append('%d 429 replies carried no Retry-After'
                   % run['http']['retry_after_missing'])
    if not (run['http']['healthz_ok'] and run['http']['statsz_ok']):
        bad.append('/healthz or /statsz did not parse')
    if run['burst']['overloaded'] < 1:
        bad.append('the burst showed no Overloaded shed')
    silent = sorted(t for t in FLEET_PRIORITY
                    if not run['tenants'].get(t, {}).get('answered'))
    if silent:
        bad.append('tenants answered nothing in the traffic: %s' % silent)
    a = run['answers']
    if not a['resnet_max_rel_err'] <= a['resnet_tol'] or \
            not a['resnet_answers']:
        bad.append('ResNet answers %.4g of the largest output from the '
                   'serial forward (tol %g, %d answers)'
                   % (a['resnet_max_rel_err'], a['resnet_tol'],
                      a['resnet_answers']))
    if not (a['gpt2_bit_equal'] and a['gpt2_answers']):
        bad.append('gpt2-medium answers not bit-equal to the scorer called '
                   'directly (%d answers)' % a['gpt2_answers'])
    if not (a['ptb_bit_equal'] and a['ptb_answers']):
        bad.append('ptb-lstm answers not bit-equal to the same sequences '
                   'run alone (%d answers)' % a['ptb_answers'])
    r = run['registry']
    few = {t: n for t, n in r['cycles'].items() if n < FLEET_MIN_CYCLES}
    if few or set(r['cycles']) != set(FLEET_RESNETS):
        bad.append('evict / re-warm cycles %s, want %d of each ResNet '
                   'tenant' % (r['cycles'], FLEET_MIN_CYCLES))
    if r['compiles_after_warmup']:
        bad.append('%d rung builds after warm-up'
                   % r['compiles_after_warmup'])
    if r['peak_resident_bytes'] > r['budget_bytes']:
        bad.append('peak resident bytes %d over the budget %d'
                   % (r['peak_resident_bytes'], r['budget_bytes']))
    if not r['evict_freed_share'] >= FLEET_EVICT_FREED:
        bad.append('the allocator gave back %.3f of an evicted tenant\'s '
                   'bytes (want >= %g)' % (r['evict_freed_share'],
                                           FLEET_EVICT_FREED))
    p = run['ptb']
    for key, what in (('co_resident_vs_solo', 'co-resident against solo'),
                      ('k4_vs_k1', 'K=4 against K=1'),
                      ('k16_vs_k1', 'K=16 against K=1'),
                      ('staged_vs_serialized', 'stage_ahead=1 against 0'),
                      ('swap_vs_unswapped',
                       'export_state / admit_state against unswapped')):
        if not p[key]:
            bad.append('ptb-lstm not bit-equal: %s' % what)
    if not p['unroll_rel_err'] <= p['unroll_tol']:
        bad.append('ptb-lstm %.3g from its cell.unroll (tol %g)'
                   % (p['unroll_rel_err'], p['unroll_tol']))
    if not p['cpu_err'] <= p['cpu_bound']:
        bad.append('ptb-lstm on the card %.3g from cpu(0) (bound %.3g)'
                   % (p['cpu_err'], p['cpu_bound']))
    f = run['flash']
    if not f['kernel_ok']:
        bad.append('the flash kernel disagrees with its plain version at '
                   'the scorer\'s shape')
    if not f['per_request'] or \
            any(n != f['layers'] for n in f['per_request']):
        bad.append('flash forward launches per scorer request %s, want %d'
                   % (sorted(set(f['per_request'])), f['layers']))
    if tuple(f['bwd_launches']) != (0, 0) or f['conv_launches']:
        bad.append('the phase launched backward (%s) or conv (%d) kernels'
                   % (f['bwd_launches'], f['conv_launches']))
    return bad


def fleet_phase(torch, mx, cuda_conv, cuda_ops, tfm, root, ctx=None):
    """Phase 20: one ModelRegistry on ctx holding the bf16 ResNet-50
    checkpoint three ways (resnet50; resnet50-int8, quantize='int8';
    resnet50-paged, page_dtype='int8'), the PTB LSTM cell in a
    ContinuousEngine (ptb-lstm) and a pinned GPT-2-medium scorer on the
    flash kernel (gpt2-medium), under a byte budget that holds one ResNet
    tenant at a time; an HttpFront on 127.0.0.1 takes 16 client threads
    for FLEET_TRAFFIC_S, then a burst at FLEET_BURST_MULT x the clients.
    Gated by fleet_gate."""
    import gc
    import shutil
    from mxnet_tpu_torch import exec_cache, quantization
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving_fleet import SLO, HttpFront, ModelRegistry
    ctx = ctx or mx.gpu(0)
    device = ctx.torch_device
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ckpt_dir = root / 'build' / 'phase20'
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    prefix = str(ckpt_dir / 'resnet50')
    t_phase = time.perf_counter()
    try:
        # -- the tenants' weights, the requests and their references ----
        symbol, shape = serve_checkpoint(torch, mx, prefix, ctx)
        rng = np.random.default_rng(SEED + 400)
        images = np.round(rng.standard_normal(
            (FLEET_IMAGES + 4 * FLEET_QUADS,) + shape), FLEET_DIGITS)
        img_bodies = [json.dumps({'instances': images[i:i + 1].tolist()})
                      .encode() for i in range(FLEET_IMAGES)]
        quad_bodies = [json.dumps({'instances': images[
            FLEET_IMAGES + 4 * q:FLEET_IMAGES + 4 * q + 4].tolist()})
            .encode() for q in range(FLEET_QUADS)]
        images = images.astype(np.float32)
        serial = Predictor.from_checkpoint(
            prefix, 0, {'data': (SERVE_BATCH,) + shape}, ctx=ctx)
        fp_ref = serial_outputs(serial, images)
        # the int8 codes' weights, dequantized as the int8 engine does
        sex = serial._executor
        weights = {n: a._data for n, a in sex.arg_dict.items()
                   if n != 'data'}
        cfg = quantization.QuantConfig.resolve('int8')
        quantized, passthrough = quantization.quantize_weights(weights, cfg)
        deq = {n: quantization.dequantize_weight(q, sc, cfg, dtype=dt)
               for n, (q, sc, dt) in quantized.items()}
        deq.update({n: weights[n] for n in passthrough})
        q_serial = Predictor(symbol=symbol, arg_params=deq,
                             aux_params={n: a._data for n, a in
                                         sex.aux_dict.items()},
                             input_shapes={'data': (SERVE_BATCH,) + shape},
                             ctx=ctx)
        q_ref = serial_outputs(q_serial, images)
        del serial, q_serial, sex, weights, quantized, deq
        ref_scale = float(np.abs(fp_ref).max())

        lm_cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
        lm_params = tfm.params_from_jax(seeded_tree(lm_cfg, SEED + 401),
                                        dtype=torch.bfloat16, device=device)
        scorer = FleetScorer(torch, tfm.TransformerLM(lm_cfg, lm_params)
                             .eval(), counter=lambda: (
                                 cuda_ops.FLASH_FWD_LAUNCHES))
        del lm_params
        srng = np.random.default_rng(SEED + 402)
        scores_in = [srng.integers(0, lm_cfg['vocab'], SEQ + 1)
                     for _ in range(FLEET_SCORES)]
        score_bodies = [json.dumps({'inputs': {
            'tokens': t[:-1].tolist(), 'targets': t[1:].tolist()}})
            .encode() for t in scores_in]
        score_ref = [scorer.infer(t[:-1], t[1:])[0] for t in scores_in]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in scores_in:
            scorer.infer(t[:-1], t[1:])
        torch.cuda.synchronize()
        gpt2_ms = (time.perf_counter() - t0) * 1e3 / FLEET_SCORES

        cell = fleet_cell(mx, **FLEET_PTB)
        ptb_params = fleet_cell_params(mx, cell, FLEET_PTB['hidden'],
                                       FLEET_PTB['layers'], SEED + 403)
        seqs = fleet_sequences(FLEET_SEQS, SEED + 404)
        seq_bodies = [json.dumps({'instances': x.tolist()}).encode()
                      for x in seqs]
        print('fleet: checkpoint, %d images, %d sequences (%d tokens) and '
              'the references in %.1f s' % (
                  len(images), len(seqs), sum(len(x) for x in seqs),
                  time.perf_counter() - t_phase))

        # -- (d) and (e): the PTB cell's engines, before the traffic ----
        ladder, ptb_answers, swap, tick_profile = fleet_ladder(
            torch, mx, ptb_params, ctx, seqs)
        solo_idx = list(range(0, FLEET_SEQS, FLEET_SEQS // FLEET_SOLO))
        with fleet_ptb_engine(mx, ptb_params, ctx, tick_chunk=1) as eng:
            solo = [eng.infer(seqs[i]) for i in solo_idx]
        seq60 = np.concatenate(fleet_sequences(64, SEED + 405))[
            :FLEET_MAX_LEN]
        unroll = fleet_unroll_check(torch, mx, ptb_params, ctx, seq60)
        k1 = ptb_answers['k1']

        def ptb_loader(tick_chunk=None):
            return fleet_ptb_engine(mx, ptb_params, ctx,
                                    tick_chunk=tick_chunk,
                                    slo=SLO(deadline_ms=200.0))

        def register(reg, est=None):
            est = est or {}
            reg.register('resnet50', prefix=prefix, epoch=0,
                         input_shapes={'data': (1,) + shape},
                         slo=SLO(deadline_ms=50.0,
                                 priority=FLEET_PRIORITY['resnet50']),
                         max_batch=SERVE_BATCH,
                         est_bytes=est.get('resnet50'))
            q_est = est.get('resnet50-int8')
            reg.register('resnet50-int8', prefix=prefix, epoch=0,
                         input_shapes={'data': (1,) + shape},
                         quantize='int8', slo=SLO(
                             deadline_ms=150.0,
                             priority=FLEET_PRIORITY['resnet50-int8']),
                         max_batch=8, est_bytes=None if q_est is None else
                         int(math.ceil(q_est / cfg.est_ratio())))
            reg.register('resnet50-paged', prefix=prefix, epoch=0,
                         input_shapes={'data': (1,) + shape},
                         page_dtype='int8', slo=SLO(
                             deadline_ms=150.0,
                             priority=FLEET_PRIORITY['resnet50-paged']),
                         max_batch=8, est_bytes=est.get('resnet50-paged'))
            reg.register('ptb-lstm', loader=ptb_loader, tick_chunk='auto',
                         slo=SLO(deadline_ms=200.0,
                                 priority=FLEET_PRIORITY['ptb-lstm']),
                         est_bytes=est.get('ptb-lstm'))

        # -- warm-up: every program built, every tenant's bytes measured -
        t0 = time.perf_counter()
        with ModelRegistry(ctx=ctx) as warm:
            register(warm)
            warm.infer('resnet50', images[:1])
            warm.infer('resnet50-int8', images[:4])
            warm.infer('resnet50-paged', images[:4])
            warm.infer('ptb-lstm', seqs[0])
            nbytes = {m: v['bytes']
                      for m, v in warm.stats()['models'].items()}
        nbytes['gpt2-medium'] = scorer.resident_bytes()
        budget = (nbytes['gpt2-medium'] + nbytes['resnet50'] +
                  nbytes['ptb-lstm'] + nbytes['resnet50-int8'] // 2)
        print('fleet: warm-up %.1f s; bytes %s; budget %d'
              % (time.perf_counter() - t0, nbytes, budget))

        # -- the registry under the budget -------------------------------
        reg = ModelRegistry(budget_bytes=budget, ctx=ctx)
        reg.register('gpt2-medium', source=scorer,
                     slo=SLO(priority=FLEET_PRIORITY['gpt2-medium']))
        register(reg, nbytes)
        evictions, loads, page_in_ms = {}, {}, []
        count_lock = threading.Lock()
        evict_one, load_locked, page_in = (reg._evict_one, reg._load_locked,
                                           reg._page_in)

        def counting_evict(ent):
            resident = ent.engine is not None
            evict_one(ent)
            if resident:
                with count_lock:
                    evictions[ent.name] = evictions.get(ent.name, 0) + 1

        def counting_load(ent):
            # a load, unless a concurrent one made the entry resident
            fresh = ent.engine is None or ent.engine.closed
            eng = load_locked(ent)
            if fresh:
                with count_lock:
                    loads[ent.name] = loads.get(ent.name, 0) + 1
            return eng

        def timed_page_in(ent):
            t1 = time.perf_counter()
            pred = page_in(ent)
            if pred is not None:
                page_in_ms.append((time.perf_counter() - t1) * 1e3)
            return pred

        reg._evict_one, reg._load_locked, reg._page_in = (
            counting_evict, counting_load, timed_page_in)
        for name in ('gpt2-medium', 'ptb-lstm', 'resnet50'):
            reg.engine(name)
        front = HttpFront(reg, host='127.0.0.1', port=0,
                          max_inflight=FLEET_INFLIGHT).start()
        address = front.address

        def work_lists(mult):
            lists = []
            for cls, n in FLEET_CLIENTS:
                for c in range(n * mult):
                    if cls == 'resnet50':
                        work = [('resnet50', (c + j) % FLEET_IMAGES,
                                 img_bodies[(c + j) % FLEET_IMAGES])
                                for j in range(FLEET_IMAGES)]
                        lists.append((work, False))
                    elif cls == 'alternate':
                        # half the clients start on each tenant
                        work = [(FLEET_RESNETS[1 + (c + j) % 2],
                                 (c + j) % FLEET_QUADS,
                                 quad_bodies[(c + j) % FLEET_QUADS])
                                for j in range(2 * FLEET_QUADS)]
                        lists.append((work, False))
                    elif cls == 'ptb-lstm':
                        # the traffic sends the sentences once; the burst
                        # cycles through its share of them
                        lists.append(([('ptb-lstm', i, seq_bodies[i])
                                       for i in range(c, FLEET_SEQS,
                                                      n * mult)],
                                      mult == 1))
                    else:
                        work = [('gpt2-medium', (c + g) % FLEET_SCORES,
                                 score_bodies[(c + g) % FLEET_SCORES])
                                for g in range(FLEET_SCORES)]
                        lists.append((work, False))
            return lists

        # -- the traffic ---------------------------------------------------
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        misses0 = exec_cache.stats()['misses']
        cuda_conv.CONV_BN_STATS_LAUNCHES = 0
        reset_counts(cuda_ops)
        scorer.per_call.clear()
        threads, records, t_start = fleet_drive(address, work_lists(1),
                                                FLEET_TRAFFIC_S)
        time.sleep(1.0)
        health = json.loads(urllib_get(address, '/healthz'))
        statsz = json.loads(urllib_get(address, '/statsz'))
        time.sleep(2.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_p = time.perf_counter()
            time.sleep(FLEET_PROFILE_S)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t_p
        busy_ms = busy_union_ms(cuda_kernel_events(prof))
        del prof
        for t in threads:
            t.join(timeout=FLEET_TRAFFIC_S + 600)
        traffic_s = time.perf_counter() - t_start
        if any(t.is_alive() for t in threads):
            fail('fleet: clients did not finish')
        ptb_stats = reg.engine('ptb-lstm').stats()
        st1 = reg.stats()
        health_after = json.loads(urllib_get(address, '/healthz'))

        # -- the burst ----------------------------------------------------
        # resnet50 resident with a measured service time, as after its
        # own traffic, when the burst's clients arrive together (served
        # by the engine itself: the registry's admission would shed on
        # the traffic's estimate)
        r50 = reg.engine('resnet50')
        for i in range(4):
            r50.infer(images[i:i + 1])
        svc_before_burst = r50.service_estimate()
        del r50
        burst_threads, burst, _ = fleet_drive(
            address, work_lists(FLEET_BURST_MULT), FLEET_BURST_S)
        for t in burst_threads:
            t.join(timeout=FLEET_BURST_S + 600)
        if any(t.is_alive() for t in burst_threads):
            fail('fleet: burst clients did not finish')
        st2 = reg.stats()
        ev_snap, ld_snap = dict(evictions), dict(loads)
        statsz_after = json.loads(urllib_get(address, '/statsz'))
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        misses = exec_cache.stats()['misses'] - misses0
        flash_launches = cuda_ops.FLASH_FWD_LAUNCHES
        launches = read_counts(cuda_ops)
        conv_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
        per_call = list(scorer.per_call)
        front.close()

        # -- (b) the allocator after an eviction --------------------------
        reg.engine('resnet50')
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        r50_bytes = reg.stats()['models']['resnet50']['bytes']
        reg.evict('resnet50')
        gc.collect()
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated()
        final = reg.stats()
        reg.close()

        # -- (f) the flash kernel at the scorer's shape --------------------
        flash_case = kernel_case(torch, cuda_ops, 'fleet_scorer',
                                 (1, GPT2_MEDIUM['heads'], SEQ,
                                  GPT2_MEDIUM['dim'] // GPT2_MEDIUM['heads']),
                                 SEQ, torch.bfloat16, True, iters=20)
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # -- (a) the answers against their references ------------------------
    errs = []
    for r in records + burst:
        if r['code'] != 200 or r['tenant'] not in FLEET_RESNETS:
            continue
        got = np.asarray(r['out'], np.float32)
        if r['tenant'] == 'resnet50':
            rows = [r['key']]
        else:
            rows = list(range(FLEET_IMAGES + 4 * r['key'],
                              FLEET_IMAGES + 4 * r['key'] + 4))
        e_fp = float(np.abs(got - fp_ref[rows]).max()) / ref_scale
        e_q = float(np.abs(got - q_ref[rows]).max()) / ref_scale
        errs.append(dict(resnet50=e_fp, **{'resnet50-int8': e_q,
                                           'resnet50-paged': min(e_fp, e_q)}
                         )[r['tenant']])
    gpt2_recs = [r for r in records + burst
                 if r['tenant'] == 'gpt2-medium' and r['code'] == 200]
    gpt2_equal = all(np.array_equal(np.asarray(r['out'], np.float32),
                                    score_ref[r['key']]) for r in gpt2_recs)
    ptb_ok = [r for r in records + burst
              if r['tenant'] == 'ptb-lstm' and r['code'] == 200]
    ptb_equal = all(np.array_equal(np.asarray(r['out'], np.float32),
                                   k1[r['key']][0]) for r in ptb_ok)
    retry_missing = sum(1 for r in records + burst
                        if r['code'] == 429 and not r['retry_after'])
    # 429s whose body is an Overloaded shed's (the registry's or an
    # engine's), not the admission gate's
    overloaded = sum(1 for r in burst if r.get('overloaded'))
    reloads = {t: n - 1 for t, n in ld_snap.items()}
    cycles = {t: min(ev_snap.get(t, 0), reloads.get(t, 0))
              for t in FLEET_RESNETS}
    run = dict(
        http=dict(codes=fleet_codes(records), retry_after_missing=retry_missing,
                  healthz_ok=health.get('status') == 'ok' and
                  health_after.get('status') == 'ok',
                  statsz_ok='models' in statsz and 'fleet' in statsz and
                  'http' in statsz_after),
        burst=dict(codes=fleet_codes(burst), overloaded=overloaded,
                   resnet50_service_estimate=svc_before_burst,
                   shed_requests=st2['shed_requests'] - st1['shed_requests'],
                   tenants=fleet_tenant_rows(burst, FLEET_BURST_S)),
        answers=dict(resnet_max_rel_err=max(errs) if errs else float('inf'),
                     resnet_tol=SERVE_SERIAL_REL_TOL,
                     resnet_answers=len(errs), gpt2_bit_equal=gpt2_equal,
                     gpt2_answers=len(gpt2_recs), ptb_bit_equal=ptb_equal,
                     ptb_answers=len(ptb_ok)),
        registry=dict(cycles=cycles, evictions=ev_snap, reloads=reloads,
                      loads=final['loads'], total_evictions=final['evictions'],
                      page_ins=final['page_ins'],
                      page_drops=final['page_drops'],
                      page_in_ms_mean=float(np.mean(page_in_ms))
                      if page_in_ms else None, page_ins_timed=len(page_in_ms),
                      resident_bytes=st1['resident_bytes'],
                      peak_resident_bytes=final['peak_resident_bytes'],
                      budget_bytes=budget, bytes=nbytes,
                      compiles_after_warmup=misses,
                      evict_freed_bytes=freed, evicted_bytes=r50_bytes,
                      evict_freed_share=freed / max(r50_bytes, 1)),
        ptb=dict(co_resident_vs_solo=fleet_same(
                     [k1[i] for i in solo_idx], solo),
                 k4_vs_k1=fleet_same(ptb_answers['k4'], k1),
                 k16_vs_k1=fleet_same(ptb_answers['k16'], k1),
                 staged_vs_serialized=fleet_same(
                     ptb_answers['k16'], ptb_answers['k16_serialized']),
                 swap_vs_unswapped=fleet_same(ptb_answers['swap'],
                                              ptb_answers['k16']),
                 swap=swap, ladder=ladder,
                 convoy_ratio=dict(
                     seqs_per_s=ladder['k1']['seqs_per_s'] /
                     ladder['convoy']['seqs_per_s'],
                     ticks=ladder['convoy']['ticks'] / ladder['k1']['ticks']),
                 engine=dict((k, ptb_stats[k]) for k in (
                     'ticks', 'chunks', 'tick_chunk', 'auto_k_decisions',
                     'boundary_wait_ms', 'lone_fast_path',
                     'lone_fast_path_width', 'exact_fill_admits',
                     'lone_fast_path_hits', 'utilization', 'staged_chunks',
                     'tick_ms_ema')),
                 http_seqs_per_s=len(ptb_ok) / traffic_s,
                 http_tokens_per_s=sum(len(seqs[r['key']])
                                       for r in ptb_ok) / traffic_s,
                 tick_profile=tick_profile, **unroll),
        flash=dict(kernel_ok=bool(flash_case.get('ok')) and
                   flash_case['same_bits_twice'], per_request=per_call,
                   layers=GPT2_MEDIUM['layers'], launches=flash_launches,
                   bwd_launches=launches[1:], conv_launches=conv_launches,
                   case=flash_case),
        tenants=fleet_tenant_rows(records, traffic_s),
        gpt2=dict(ms_per_request=gpt2_ms,
                  tokens_per_s=SEQ / (gpt2_ms / 1e3),
                  flash_launches_per_request=sorted(set(per_call))),
        device=dict(busy_share=busy_ms / (prof_wall * 1e3),
                    profile_window_ms=prof_wall * 1e3, busy_ms=busy_ms,
                    peak_bytes=peak_bytes),
        traffic_s=traffic_s, phase_s=time.perf_counter() - t_phase)
    print('fleet ' + json.dumps(run, default=str))
    bad = fleet_gate(run)
    if bad:
        fail('fleet: ' + '; '.join(bad))
    for tenant, row in sorted(run['tenants'].items()):
        print('fleet tenant %s: %d requests, p50 %s ms, p99 %s ms, %.1f '
              'answers/s, %d 429s' % (tenant, row['requests'], row['p50_ms'],
                                      row['p99_ms'], row['answers_per_s'],
                                      row['rejected_429']))
    g = run['registry']
    print('fleet registry: %d loads, %d evictions, cycles %s, %d page-ins '
          '(mean %s ms), %d page drops, resident %d, peak %d of budget %d, '
          '%d rung builds after warm-up, evict freed %.3f of %d bytes'
          % (g['loads'], g['total_evictions'], g['cycles'], g['page_ins'],
             g['page_in_ms_mean'], g['page_drops'], g['resident_bytes'],
             g['peak_resident_bytes'], g['budget_bytes'],
             g['compiles_after_warmup'], g['evict_freed_share'],
             g['evicted_bytes']))
    p = run['ptb']
    print('fleet ptb-lstm: %.1f seqs/s, %.0f tokens/s through the front; '
          'engine %s; %.1f launches a tick, host %.3f ms and device %.3f ms '
          'a tick' % (p['http_seqs_per_s'], p['http_tokens_per_s'],
                      p['engine'], p['tick_profile']['launches_per_tick'],
                      p['tick_profile']['host_ms_per_tick'],
                      p['tick_profile']['device_ms_per_tick']))
    print('fleet ptb-lstm ladder (slots %d): %s; continuous / convoy: %.2fx '
          'seqs/s, %.2fx fewer ticks' % (
              FLEET_SLOTS, {k: round(v['seqs_per_s'], 1)
                            for k, v in p['ladder'].items()},
              p['convoy_ratio']['seqs_per_s'], p['convoy_ratio']['ticks']))
    print('fleet gpt2-medium: %.2f ms a request, %.0f tokens/s, %s flash '
          'launches a request; device busy %.3f of the traffic, peak %.2f GB'
          % (run['gpt2']['ms_per_request'], run['gpt2']['tokens_per_s'],
             run['gpt2']['flash_launches_per_request'],
             run['device']['busy_share'], peak_bytes / 1e9))
    return run


def urllib_get(address, path):
    import urllib.request
    return urllib.request.urlopen('http://%s:%d%s' % (tuple(address) +
                                                     (path,)),
                                  timeout=60).read()


# ---------------------------------------------------------------------------
# Phases 21 and 22: the bf16 ResNet-50 trained across two worker processes
# on the card, through the parameter server (21) and through the
# coordinator's allreduce with an elastic restart, the ring and serving of
# the checkpoints (22)
# ---------------------------------------------------------------------------

DIST_PS_BATCH = 64           # each worker's images a step, phase 21
DIST_PS_STEPS = 7            # 1 warm-up + 6 timed steps
DIST_PS_PROFILED = 2         # then steps under torch.profiler
DIST_COORD_BATCH = 32        # each rank's images a step, phase 22
DIST_COORD_STEPS = 10
DIST_KILL_AT = 7             # rank 1 SIGKILLs itself after this step
# one key of each end of the net and one in between: the probes whose
# pushed gradients and weights before and after the first step the
# workers dump
DIST_PROBES = ('conv0_weight', 'stage3_unit1_conv2_weight', 'fc1_weight')
DIST_OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                multi_precision=True)
# a fit step's host walk is about 135 ms and the first step loads the
# kernel library and cuDNN: heartbeats every 0.5 s and a death only after
# 10 s of silence leave a wide margin against a false death
DIST_ENV = {'MXNET_TPU_DIST_HEARTBEAT_S': '0.5',
            'MXNET_TPU_DIST_DEAD_AFTER_S': '10',
            'MXNET_TPU_BARRIER_TIMEOUT_S': '180',
            'MXNET_TPU_DIST_INIT_TIMEOUT_S': '180'}
DIST_STALE_ENV = ('DMLC_PS_ROOT_URI', 'DMLC_PS_ROOT_PORT', 'DMLC_ROLE',
                  'DMLC_NUM_WORKER', 'DMLC_NUM_SERVER', 'DMLC_WORKER_ID',
                  'MXNET_TPU_DIST_PORT', 'MXNET_TPU_DIST_TOPOLOGY',
                  'MXNET_TPU_DIST_WIRE_DTYPE', 'MXNET_TPU_FAULT_KILL_AT_STEP',
                  'MXNET_TPU_FAULT_KILL_RANK', 'MXNET_TPU_WORKER_RANKS',
                  'MXNET_TPU_WORKER_RANK')
DIST_LAUNCH_TIMEOUT_S = 420
DIST_SERVE_BATCH = 8


def dist_images(n, seed):
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    return module_data(RESNET['num_classes'], n, shape, seed)


def dist_worker(kind, out_dir, tag):
    """One worker of phase 21 (kind 'ps') or 22 ('coord'), run by the
    port's launcher: Module.fit trains the bf16 ResNet-50 with a
    'dist_sync' store on gpu(0), its conv launches counted per step; the
    probe keys' first-step gradients and weights are dumped. Phase 22's
    workers keep a CheckpointManager and exit PREEMPTED_EXIT when a
    peer's death preempts them."""
    import pickle
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _build, cuda_conv, dist, elastic, profiler
    from mxnet_tpu_torch import _hostarray as ha
    # the CUDA context and the kernel library before the runtime's
    # heartbeats start
    torch.zeros(1, device='cuda')
    _build.library()
    rank = int(os.environ['DMLC_WORKER_ID'])
    ctx = mx.gpu(0)
    out_dir = Path(out_dir)
    rt = None
    if kind == 'ps':
        batch, steps = DIST_PS_BATCH, DIST_PS_STEPS + DIST_PS_PROFILED
        x, y = dist_images(batch * steps, SEED + 2100 + rank)
    else:
        rt = dist.initialize()
        shard = tag == 'shard'
        batch, steps = DIST_COORD_BATCH, DIST_COORD_STEPS
        x, y = dist_images(batch * steps,
                           SEED + 2200 + (rank if shard else 0))
    kv = mx.kv.create('dist_sync')
    dump = {'probe_keys': list(DIST_PROBES)}

    # the probes: the first round's pushed gradients, weights before and
    # after it, the cross-process sum (phase 22) and the optimizer shipped
    orig_ppa, orig_sum = kv.push_pull_all, kv._cross_host_sum
    orig_set = kv.set_optimizer
    state = {'keys': None}

    def push_pull_all(keys, grads, outs):
        first = 'grad' not in dump
        if first:
            idx = {k: i for i, k in enumerate(keys)}
            state['keys'] = list(keys)
            dump['grad'] = {k: ha.host(grads[idx[k]]) for k in DIST_PROBES}
            dump['before'] = {k: ha.host(outs[idx[k]]).clone()
                              for k in DIST_PROBES}
            dump['push_bytes'] = sum(g._data.numel() * g._data.element_size()
                                     for g in grads)
            dump['pull_bytes'] = sum(o._data.numel() * o._data.element_size()
                                     for o in outs)
        orig_ppa(keys, grads, outs)
        if first:
            dump['after'] = {k: ha.host(outs[idx[k]]) for k in DIST_PROBES}

    def cross_host_sum(merged):
        out = orig_sum(merged)
        if 'summed' not in dump and state['keys'] is not None:
            idx = {k: i for i, k in enumerate(state['keys'])}
            dump['summed'] = {k: ha.host(out[idx[k]]) for k in DIST_PROBES}
        return out

    def set_optimizer(optimizer):
        sym_ref, optimizer.sym = optimizer.sym, None
        try:
            dump['optimizer'] = pickle.dumps(optimizer)
        finally:
            optimizer.sym = sym_ref
        orig_set(optimizer)
    kv.push_pull_all = push_pull_all
    kv._cross_host_sum = cross_host_sum
    kv.set_optimizer = set_optimizer

    symbol, init = module_symbol_params(mx)
    mod = mx.mod.Module(symbol, context=ctx)
    np.random.seed(SEED)
    mx.random.seed(SEED)
    train = mx.io.NDArrayIter(x, y, batch_size=batch)
    mgr = None
    if kind == 'coord':
        mgr = elastic.CheckpointManager(str(out_dir / ('ck_' + tag)),
                                        every_n_steps=2, incremental=2)
    times, launches = [], []
    count = [0]
    prof = {}

    def record(param):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        launches.append(cuda_conv.CONV_BN_STATS_LAUNCHES - count[0])
        count[0] = cuda_conv.CONV_BN_STATS_LAUNCHES
        if kind == 'ps' and DIST_PS_PROFILED and \
                param.nbatch == DIST_PS_STEPS - 1:
            from torch.profiler import ProfilerActivity, profile
            prof['p'] = profile(activities=[ProfilerActivity.CUDA])
            prof['p'].start()
            prof['t0'] = time.perf_counter()
        if kind == 'ps' and param.nbatch == steps - 1 and 'p' in prof:
            prof['wall_ms'] = (time.perf_counter() - prof['t0']) * 1e3
            prof['p'].stop()

    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        mod.fit(train, kvstore=kv, optimizer='sgd',
                optimizer_params=dict(DIST_OPT), initializer=init,
                eval_metric='acc', num_epoch=1, batch_end_callback=record,
                checkpoint=mgr)
    except elastic.Preempted as e:
        print('PREEMPTED step=%d dead_ranks=%s ckpt=%s heartbeat_deaths=%d'
              % (e.step, sorted(e.dead_ranks), e.checkpoint_dir,
                 profiler.dist_stats()['dist_dead_hosts_detected']))
        sys.stdout.flush()
        mgr.close()
        os._exit(dist.PREEMPTED_EXIT)
    fit_s = time.perf_counter() - t0
    if mgr is not None:
        if mgr.last_resume is not None:
            print('RESUMED step=%d world=%d' % (mgr.last_resume.step,
                                                rt.world))
        mgr.wait()
        if mgr._last_save_step != mgr.step:
            # the last cadence save was skipped behind a write in flight
            mgr.save(epoch=1, sync=True)
        mgr.close()
    if prof.get('p') is not None:
        kernels = [e for e in prof['p'].key_averages()
                   if str(getattr(e, 'device_type', '')).endswith('CUDA')]
        dump['profile'] = dict(
            device_ms=sum(device_us(e) for e in kernels) / 1e3,
            wall_ms=prof['wall_ms'], steps=DIST_PS_PROFILED)
    args, auxs = mod.get_params()
    dump.update(
        rank=rank, world=int(os.environ['DMLC_NUM_WORKER']), tag=tag,
        params={n: ha.host(v) for n, v in args.items()},
        aux={n: ha.host(v) for n, v in auxs.items()},
        step_times=times, launches=launches, fit_s=fit_s,
        resumed_step=None if mgr is None or mgr.last_resume is None
        else mgr.last_resume.step,
        dist_stats=profiler.dist_stats(), ckpt_stats=profiler.ckpt_stats(),
        delta_stats=profiler.delta_stats())
    torch.save(dump, str(out_dir / ('%s_r%d.pt' % (tag, rank))))
    kv.barrier()
    if kind == 'ps':
        if rank == 0:
            kv.stop_servers()
            report = Path(os.environ['MXNET_TPU_PS_REPORT'])
            deadline = time.monotonic() + 30
            while not report.exists() and time.monotonic() < deadline:
                time.sleep(0.1)
        kv.close()
    else:
        dist.shutdown()
    print('DIST_WORKER_OK tag=%s rank=%d steps=%d' % (tag, rank,
                                                     len(times)))


class Background:
    """A command run in the background while the script goes on: its
    output goes to temporary files and its wall clock stops when it
    exits. wait() gives (the completed process, wall seconds), or stops
    it and raises subprocess.TimeoutExpired after `timeout` seconds from
    its start; one not waited for is stopped when the script exits."""

    running = []

    def __init__(self, cmd, timeout, **popen):
        import tempfile
        self.cmd, self.timeout = cmd, timeout
        self.out, self.err = (tempfile.TemporaryFile('w+') for _ in 'oe')
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=self.out, stderr=self.err,
                                     text=True, **popen)
        self.wall, self.result = None, None
        self._lock, self._after = threading.Lock(), []
        self.watch = threading.Thread(target=self._watch, daemon=True)
        self.watch.start()
        Background.running.append(self)

    def _watch(self):
        self.proc.wait()
        with self._lock:
            self.wall = time.perf_counter() - self.t0
            after, self._after = self._after, []
        for fn in after:
            fn()

    def after(self, fn):
        """Call fn once the command has exited: from the thread that
        watches it (wait() returns after fn has), or now if it has."""
        with self._lock:
            if self.wall is None:
                self._after.append(fn)
                return
        fn()

    def wait(self):
        if self.result is None:
            self.watch.join(max(1.0, self.t0 + self.timeout -
                                time.perf_counter()))
            if self.wall is None:
                self.stop()
                raise subprocess.TimeoutExpired(self.cmd, self.timeout)
            Background.running.remove(self)
            for f in (self.out, self.err):
                f.seek(0)
            self.result = (subprocess.CompletedProcess(
                self.cmd, self.proc.returncode, self.out.read(),
                self.err.read()), self.wall)
            self.out.close()
            self.err.close()
        return self.result

    def stop(self):
        """SIGTERM (the launcher passes it to its workers), then SIGKILL
        after 30 s."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        if self in Background.running:
            Background.running.remove(self)

    @classmethod
    def stop_all(cls):
        for job in list(cls.running):
            job.stop()


class Launch(Background):
    """One run of the port's launcher: the launches of phases 21, 22 and
    31 run at once. wait() also keeps the launcher's output under
    chiprun_out/."""

    def __init__(self, root, tag, cmd, env):
        self.root, self.tag = root, tag
        super().__init__(cmd, DIST_LAUNCH_TIMEOUT_S, cwd=str(root), env=env)

    def wait(self):
        first = self.result is None
        res, wall = super().wait()
        if first:
            log = self.root / 'chiprun_out' / ('dist_%s.log' % self.tag)
            log.parent.mkdir(exist_ok=True)
            log.write_text(
                '$ %s\nrc %d, %.1f s\n--- stdout\n%s\n--- stderr\n%s\n'
                % (' '.join(self.cmd), res.returncode, wall, res.stdout,
                   res.stderr))
            print('dist %s: launcher rc %d in %.1f s (log %s)'
                  % (self.tag, res.returncode, wall,
                     log.relative_to(self.root)))
        return res, wall


def start_launch(root, out_dir, tag, kind, n, servers, env=None,
                 elastic=False, ranks_per_worker=1):
    """Start `n` dist_worker processes (and `servers` parameter servers)
    through `python -m mxnet_tpu_torch.tools.launch`, each worker
    `ranks_per_worker` ranks; returns the Launch."""
    e = {k: v for k, v in os.environ.items() if k not in DIST_STALE_ENV}
    e.update(DIST_ENV)
    e.update(env or {})
    cmd = [sys.executable, '-m', 'mxnet_tpu_torch.tools.launch', '-n',
           str(n), '-s', str(servers), '--launcher', 'local']
    if ranks_per_worker > 1:
        cmd += ['--ranks-per-worker', str(ranks_per_worker)]
    if elastic:
        cmd += ['--elastic', '--elastic-shrink', '--max-restarts', '2',
                '--elastic-grace', '60']
    cmd += [sys.executable, str(root / 'chip_smoke.py'), '--dist-worker',
            kind, '--dist-out', str(out_dir), '--dist-tag', tag]
    return Launch(root, tag, cmd, e)


def fresh_dir(root, phase):
    """build/phase<N>, emptied."""
    out = root / 'build' / ('phase%d' % phase)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    return out


def dist_load(torch, out_dir, tag, rank):
    path = Path(out_dir) / ('%s_r%d.pt' % (tag, rank))
    if not path.exists():
        fail('dist %s: rank %d wrote no result (%s)' % (tag, rank, path))
    return torch.load(str(path), weights_only=False)


def tensors_equal(torch, a, b):
    """Names whose tensors differ in any bit (or are missing) between two
    {name: host tensor or numpy array} dicts."""
    from mxnet_tpu_torch import _hostarray as ha
    bad = sorted(set(a) ^ set(b))
    for n in sorted(set(a) & set(b)):
        x, y = ha.host(a[n]), ha.host(b[n])
        if ha.dtype_name(x) != ha.dtype_name(y) or \
                tuple(x.shape) != tuple(y.shape) or \
                ha.raw_bytes(x).tobytes() != ha.raw_bytes(y).tobytes():
            bad.append(n)
    return bad


def step_ms_median(times, skip_first=1, upto=None):
    t = times[:upto] if upto else times
    iv = [(b - a) * 1e3 for a, b in zip(t, t[1:])][skip_first - 1:]
    return median(iv) if iv else float('nan')


def ps_start(root):
    """Phase 21's launch, started: (its directory, the Launch)."""
    out = fresh_dir(root, 21)
    return out, start_launch(
        root, out, 'ps', 'ps', 2, 1,
        env={'MXNET_TPU_PS_REPORT': str(out / 'server.json')})


def ps_phase(torch, mx, root, started=None):
    """Phase 21: `tools.launch -n 2 -s 1`: two workers on gpu(0) and one
    CPU parameter server; Module.fit(kvstore='dist_sync') with the
    momentum SGD of phase 10, 64 images a step each on its own half of a
    seeded set. Gated: 32 conv launches a worker step, the ranks' weights
    bit-equal, the server's update of the probe keys equal bit for bit to
    the port's optimizer on cpu(0) over the summed pushes, and a server
    that never initialized CUDA."""
    import pickle
    import shutil
    from mxnet_tpu_torch import optimizer as opt_mod
    if started is None:
        torch.cuda.empty_cache()
        started = ps_start(root)
    out, launch = started
    report_path = out / 'server.json'
    res, wall = launch.wait()
    if res.returncode != 0:
        fail('phase 21: the launcher exited %d:\n%s\n%s'
             % (res.returncode, res.stdout[-3000:], res.stderr[-3000:]))
    w = [dist_load(torch, out, 'ps', r) for r in (0, 1)]
    if not report_path.exists():
        fail('phase 21: the server wrote no report')
    report = json.loads(report_path.read_text())
    steps = DIST_PS_STEPS + DIST_PS_PROFILED
    bad = []
    for r in (0, 1):
        if w[r]['launches'] != [RESNET_PAIRS - 1] * steps:
            bad.append('rank %d conv launches a step %s, want %d each'
                       % (r, w[r]['launches'], RESNET_PAIRS - 1))
    differ = tensors_equal(torch, w[0]['params'], w[1]['params'])
    if differ:
        bad.append('the ranks\' weights differ in %d tensors (%s)'
                   % (len(differ), differ[:4]))
    # the server's arithmetic: the port's optimizer on cpu(0), from the
    # weights before the first round and the sum of the two pushes
    server_check = {}
    optimizer = pickle.loads(w[0]['optimizer'])
    updater = opt_mod.get_updater(optimizer)
    cpu = mx.cpu(0)
    from mxnet_tpu_torch import _hostarray as ha
    for k in DIST_PROBES:
        g = ha.host(w[0]['grad'][k]) + ha.host(w[1]['grad'][k])
        wt = mx.nd.NDArray(ha.to_tensor(ha.copy(w[0]['before'][k])), cpu)
        with cpu:
            updater(k, mx.nd.NDArray(ha.to_tensor(g), cpu), wt)
        got = [tensors_equal(torch, {k: wt._data}, {k: w[r]['after'][k]})
               for r in (0, 1)]
        server_check[k] = dict(equal=not any(got), dtype=ha.dtype_name(g),
                               shape=list(g.shape))
        if any(got):
            bad.append('the server\'s update of %s differs from the '
                       'optimizer on cpu(0)' % k)
    if report['cuda_initialized']:
        bad.append('the server process initialized CUDA')
    prof = [wr.get('profile') for wr in w]
    busy = [p['device_ms'] / p['wall_ms'] for p in prof if p]
    # the frame MAC the workers and the server ran: the same interpreter
    # and environment choose it (MXNET_TPU_PS_MAC, else Poly1305 where
    # the cryptography package imports, else HMAC-SHA256)
    from mxnet_tpu_torch import kvstore_server
    mac = 'poly1305' if kvstore_server._mac_alg() == \
        kvstore_server._ALG_POLY else 'hmac-sha256'
    run = dict(
        config=dict(RESNET, batch_per_worker=DIST_PS_BATCH, workers=2,
                    servers=1, steps=steps, optimizer='sgd', **DIST_OPT),
        frame_mac=mac, launcher_s=wall,
        step_ms=[step_ms_median(wr['step_times'], upto=DIST_PS_STEPS)
                 for wr in w],
        wire_bytes_per_step=[wr['push_bytes'] + wr['pull_bytes']
                             for wr in w],
        server=report,
        server_update_ms_per_round=report['update_ms'] / steps,
        device_busy_share_per_rank=busy,
        device_busy_share=sum(busy),
        launches=[wr['launches'] for wr in w],
        server_check=server_check, fit_s=[wr['fit_s'] for wr in w])
    print('dist_ps ' + json.dumps(run))
    if bad:
        fail('phase 21: ' + '; '.join(bad))
    print('dist_ps: 2 workers x %d images, step %.1f / %.1f ms (median, '
          'ranks 0 / 1), %.1f MB on the wire a worker step, server update '
          '%.1f ms a round, device busy %.1f %% (both ranks over %d '
          'profiled steps); ranks bit-equal, server arithmetic bit-equal on '
          '%s, server CUDA initialized: %s; frame MAC %s'
          % (DIST_PS_BATCH, run['step_ms'][0], run['step_ms'][1],
             run['wire_bytes_per_step'][0] / 1e6,
             run['server_update_ms_per_round'],
             100 * run['device_busy_share'], DIST_PS_PROFILED,
             list(DIST_PROBES), report['cuda_initialized'], mac))
    run['path_launches'] = sum(sum(wr['launches']) for wr in w)
    shutil.rmtree(out, ignore_errors=True)
    return run


def coord_start(root):
    """Phase 22's three launches, started together: (their directory,
    {arm: Launch})."""
    out = fresh_dir(root, 22)
    return out, dict(
        straight=start_launch(root, out, 'straight', 'coord', 1, 0),
        elastic=start_launch(
            root, out, 'elastic', 'coord', 2, 0, elastic=True,
            env={'MXNET_TPU_FAULT_KILL_AT_STEP': str(DIST_KILL_AT),
                 'MXNET_TPU_FAULT_KILL_RANK': '1'}),
        shard=start_launch(root, out, 'shard', 'coord', 2, 0,
                           env={'MXNET_TPU_DIST_TOPOLOGY': 'ring'}))


def coord_phase(torch, mx, root, started=None):
    """Phase 22: `tools.launch -s 0`, the coordinator's allreduce, each
    rank 32 images a step with a CheckpointManager(every_n_steps=2,
    incremental=2). Arms: straight (world 1, 10 steps); elastic (world 2
    on the same batches, rank 1 SIGKILLed after step 7, rank 0 preempted
    by the heartbeats, a relaunch at world 1 that resumes and ends
    bit-equal to the straight arm); shard (world 2 on the ring, each rank
    its own half: the ranks bit-equal, the allreduced probe gradients the
    bit-exact sum of the ranks'). Then the straight arm's checkpoints
    served on the card: the exported last commit against the final
    parameters, and a delta applied to an engine against an engine loaded
    in full."""
    import shutil
    from mxnet_tpu_torch import _hostarray as ha
    from mxnet_tpu_torch import delta as delta_mod
    from mxnet_tpu_torch import dist, elastic, serving
    if started is None:
        torch.cuda.empty_cache()
        started = coord_start(root)
    out, launches = started
    bad = []
    arms = {}

    res, wall = launches['straight'].wait()
    if res.returncode != 0:
        fail('phase 22 straight arm: rc %d\n%s\n%s'
             % (res.returncode, res.stdout[-3000:], res.stderr[-3000:]))
    straight = dist_load(torch, out, 'straight', 0)
    arms['straight'] = dict(wall_s=wall, fit_s=straight['fit_s'],
                            step_ms=step_ms_median(straight['step_times']),
                            launches=straight['launches'],
                            ckpt_stats=straight['ckpt_stats'],
                            delta_stats=straight['delta_stats'])

    res, wall = launches['elastic'].wait()
    if res.returncode != 0:
        fail('phase 22 elastic arm: rc %d\n%s\n%s'
             % (res.returncode, res.stdout[-3000:], res.stderr[-3000:]))
    preempt = [ln for ln in res.stdout.splitlines()
               if ln.startswith('PREEMPTED')]
    resumed = [ln for ln in res.stdout.splitlines()
               if ln.startswith('RESUMED step=')]
    if not preempt or 'dead_ranks=[1]' not in preempt[0] or \
            'heartbeat_deaths=0' in preempt[0]:
        bad.append('elastic: rank 0 was not preempted by the heartbeats '
                   '(%s)' % preempt)
    if not resumed:
        bad.append('elastic: the relaunch did not resume')
    if 'elastic restart 1/' not in res.stderr or \
            'preempted' not in res.stderr:
        bad.append('elastic: the launcher did not relaunch after exit %d'
                   % dist.PREEMPTED_EXIT)
    elastic_r0 = dist_load(torch, out, 'elastic', 0)
    differ = tensors_equal(torch, straight['params'], elastic_r0['params'])
    differ_aux = tensors_equal(torch, straight['aux'], elastic_r0['aux'])
    if differ or differ_aux:
        bad.append('elastic: the resumed run differs from the straight one '
                   'in %d weights and %d aux states (%s)'
                   % (len(differ), len(differ_aux), (differ + differ_aux)[:4]))
    arms['elastic'] = dict(wall_s=wall, preempted=preempt, resumed=resumed,
                           resumed_step=elastic_r0['resumed_step'],
                           relaunch_launches=elastic_r0['launches'],
                           equal_to_straight=not (differ or differ_aux))

    res, wall = launches['shard'].wait()
    if res.returncode != 0:
        fail('phase 22 shard arm: rc %d\n%s\n%s'
             % (res.returncode, res.stdout[-3000:], res.stderr[-3000:]))
    s = [dist_load(torch, out, 'shard', r) for r in (0, 1)]
    differ = tensors_equal(torch, s[0]['params'], s[1]['params'])
    if differ:
        bad.append('shard: the ranks differ in %d weights (%s)'
                   % (len(differ), differ[:4]))
    want = {k: ha.host(s[0]['grad'][k]) + ha.host(s[1]['grad'][k])
            for k in DIST_PROBES}
    probe_bad = tensors_equal(torch, want, s[0]['summed'])
    if probe_bad:
        bad.append('shard: the ring\'s sum of %s is not the ranks\' sum'
                   % probe_bad)
    for r in (0, 1):
        if s[r]['launches'] != [RESNET_PAIRS - 1] * DIST_COORD_STEPS:
            bad.append('shard: rank %d conv launches %s'
                       % (r, s[r]['launches']))
    arms['shard'] = dict(
        wall_s=wall, step_ms=[step_ms_median(x['step_times']) for x in s],
        ring_bytes=[x['dist_stats']['dist_ring_bytes'] for x in s],
        rounds=[x['dist_stats']['dist_allreduce_rounds'] for x in s],
        probe_sum_equal=not probe_bad)
    if straight['launches'] != [RESNET_PAIRS - 1] * DIST_COORD_STEPS:
        bad.append('straight: conv launches %s' % straight['launches'])

    # serving the straight arm's checkpoints on the card
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ck = out / 'ck_straight'
        commits = sorted(
            [(s_, 'full') for s_ in elastic.list_checkpoints(str(ck))] +
            [(s_, 'delta') for s_ in elastic.list_deltas(str(ck))])
        last_step, last_kind = commits[-1]
        last_dir = ck / ((elastic._STEP_DIR if last_kind == 'full'
                          else elastic._DELTA_DIR) % last_step)
        symbol, _ = module_symbol_params(mx)
        shape = (DIST_SERVE_BATCH,) + tuple(
            int(v) for v in RESNET['image_shape'].split(','))
        x, _ = dist_images(DIST_SERVE_BATCH, SEED + 2300)
        prefix = str(out / 'served')
        serving.export_serving_checkpoint(str(last_dir), symbol, prefix, 0)
        gpu = mx.gpu(0)
        exported = mx.predictor.Predictor.from_checkpoint(
            prefix, 0, {'data': shape}, ctx=gpu).predict(x)
        final = mx.predictor.Predictor(
            symbol=symbol, input_shapes={'data': shape}, ctx=gpu,
            arg_params={n: mx.nd.NDArray(ha.to_tensor(v), mx.cpu())
                        for n, v in straight['params'].items()},
            aux_params={n: mx.nd.NDArray(ha.to_tensor(v), mx.cpu())
                        for n, v in straight['aux'].items()}).predict(x)
        export_equal = bool(np.array_equal(exported, final))
        if last_step != DIST_COORD_STEPS or not export_equal:
            bad.append('serving: the export of %s (step %d) does not answer '
                       'as the final parameters' % (last_dir.name, last_step))
        # the last delta in the serving key space, applied to an engine
        # serving the commit before it
        prev_step, prev_kind = commits[-2]
        prev_dir = ck / ((elastic._STEP_DIR if prev_kind == 'full'
                          else elastic._DELTA_DIR) % prev_step)
        base = serving.serving_state(str(prev_dir))
        new = serving.serving_state(str(last_dir))
        base_fp = delta_mod.fingerprint(base)
        entries, meta, _ = delta_mod.make_delta(
            base, new, seq=1, base_fp=base_fp,
            config=delta_mod.DeltaConfig(dense='raw'))
        serving.export_serving_checkpoint(str(prev_dir), symbol,
                                          prefix + '_prev', 0)
        eng_a = mx.predictor.Predictor.from_checkpoint(
            prefix + '_prev', 0, {'data': shape}, ctx=gpu).serve(
                max_batch=DIST_SERVE_BATCH)
        eng_b = mx.predictor.Predictor.from_checkpoint(
            prefix, 0, {'data': shape}, ctx=gpu).serve(
                max_batch=DIST_SERVE_BATCH)
        try:
            before = eng_a.infer(x)
            new_fp = eng_a.apply_delta(dict(entries), meta,
                                       expect_fp=base_fp)
            after = eng_a.infer(x)
            full = eng_b.infer(x)
        finally:
            eng_a.close()
            eng_b.close()
        delta_equal = bool(np.array_equal(np.asarray(after),
                                          np.asarray(full)))
        changed = not np.array_equal(np.asarray(before), np.asarray(after))
        if not delta_equal or not changed:
            bad.append('serving: the engine with the delta applied answers '
                       'otherwise than the engine loaded in full (equal %s, '
                       'changed %s)' % (delta_equal, changed))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    run = dict(
        config=dict(RESNET, batch_per_rank=DIST_COORD_BATCH,
                    steps=DIST_COORD_STEPS, kill_at=DIST_KILL_AT,
                    optimizer='sgd', **DIST_OPT, env=DIST_ENV),
        arms=arms,
        serving=dict(last_commit=last_dir.name, previous=prev_dir.name,
                     export_equal=export_equal, delta_equal=delta_equal,
                     delta_bytes=meta['bytes'],
                     delta_full_bytes=meta['full_bytes'], new_fp=new_fp,
                     commits=['%s-%08d' % (('step' if k == 'full'
                                            else 'delta'), s_)
                              for s_, k in commits]))
    print('dist_coord ' + json.dumps(run))
    if bad:
        fail('phase 22: ' + '; '.join(bad))
    print('dist_coord: straight %.1f s (%.1f ms a step), elastic %.1f s '
          '(%s; %s), shard on the ring %.1f s (%.1f / %.1f ms a step); '
          'resumed bit-equal, ring sum bit-exact, export and delta serve '
          'bit-equal (%s <- %s, %d of %d bytes)'
          % (arms['straight']['wall_s'], arms['straight']['step_ms'],
             arms['elastic']['wall_s'], preempt[0], resumed[0],
             arms['shard']['wall_s'], arms['shard']['step_ms'][0],
             arms['shard']['step_ms'][1], last_dir.name, prev_dir.name,
             meta['bytes'], meta['full_bytes']))
    run['path_launches'] = sum(straight['launches']) + \
        sum(elastic_r0['launches']) + sum(sum(x['launches']) for x in s)
    shutil.rmtree(out, ignore_errors=True)
    return run


# ---------------------------------------------------------------------------
# phase 23: the train -> serve loop
# ---------------------------------------------------------------------------

LOOP_MODEL = 'resnet50'
LOOP_BATCH = 64             # the trainer's images a step (phase 10: 256)
LOOP_BATCHES = 8            # batches an epoch of the seeded set
LOOP_MAX_EPOCHS = 40        # the drill's bound, in epochs
LOOP_EVERY = 2              # CheckpointManager(every_n_steps=)
LOOP_FRAC = 0.5             # CheckpointPusher(frac=)
LOOP_PACE_S = 0.05          # the trainer's pause a step: canary time
LOOP_CLIENTS = 2
LOOP_ALONE_STEPS = 5        # trainer steps with the fleet down, timed
LOOP_OPT = dict(learning_rate=0.01, momentum=0.9, wd=1e-4,
                multi_precision=True)
LOOP_KNOBS = {'MXNET_TPU_FLEET_HEARTBEAT_S': '0.25',
              'MXNET_TPU_FLEET_DEAD_AFTER_S': '1.5',
              'MXNET_TPU_FLEET_CANARY_MIN_SAMPLES': '6',
              'MXNET_TPU_FLEET_CANARY_PROMOTE_SAMPLES': '12'}
LOOP_DEGRADE = '@v1:100'    # MXNET_TPU_FAULT_CANARY_DEGRADE_MS: v1 only
LOOP_SETTLE_S = 120.0       # bound of each wait: a verdict, a respawn
LOOP_CHECK_IMAGES = 4       # 1-image requests held against the Predictor


class _LoopDone(Exception):
    """The drill saw every event it waits for: stop the trainer."""


def percentile(vals, q):
    return float(np.percentile(vals, q)) if vals else None


# one closed-loop client, in a process of its own (its JSON encoding of
# each 1.1 MB body then holds no interpreter lock of the trainer's and the
# router's process): post_with_backoff the body until the stop file
# appears, one JSON line a request (wall-clock start, status or error, ms)
LOOP_CLIENT = r'''
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
from mxnet_tpu_torch.fleet_supervisor import post_with_backoff
url, body_path, stop_path, out_path = sys.argv[2:6]
with open(body_path) as f:
    body = json.load(f)
with open(out_path, 'w') as out:
    while not os.path.exists(stop_path):
        t0 = time.time()
        rec = {'t0': t0}
        try:
            rec['code'] = post_with_backoff(url, body, deadline_s=60)[0]
        except Exception as e:
            rec['error'] = repr(e)
        rec['ms'] = (time.time() - t0) * 1e3
        out.write(json.dumps(rec) + '\n')
        out.flush()
'''


def loop_clients(root, out, url, body):
    """LOOP_CLIENTS client processes posting `body` to `url`; returns
    stop(), which ends them and gives their records."""
    body_path, stop_path = out / 'client_body.json', out / 'client_stop'
    body_path.write_text(json.dumps(body))
    procs = [subprocess.Popen([sys.executable, '-c', LOOP_CLIENT,
                               str(root), url, str(body_path),
                               str(stop_path), str(out / ('client%d' % i))])
             for i in range(LOOP_CLIENTS)]

    def stop():
        stop_path.touch()
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
        records = []
        for i in range(LOOP_CLIENTS):
            path = out / ('client%d' % i)
            if path.exists():
                records += [json.loads(line) for line in
                            path.read_text().splitlines() if line]
        return records, [p.returncode for p in procs]
    return stop


def loop_gate(run):
    """Phase 23's checks on a run's numbers: a list of what failed, empty
    when it passed."""
    bad = []
    want = RESNET_PAIRS - 1
    steps = run['launches_per_step']
    if not steps or any(n != want for n in steps):
        bad.append('trainer conv launches a step %s, want %d each'
                   % (sorted(set(steps)), want))
    first = run['verdicts'][0] if run['verdicts'] else None
    if first is None or first['kind'] != 'rolled_back' or \
            not first['candidate'].endswith('@v1'):
        bad.append('the trainer did not see the first candidate rolled '
                   'back (verdicts %s)' % run['verdicts'][:3])
    if not run['killed']:
        bad.append('no replica was SIGKILLed while a push was judged')
    if run['respawn_s'] is None or run['restarts'] < 1:
        bad.append('the SIGKILLed replica did not respawn (restarts %d)'
                   % run['restarts'])
    if not run['reconciled']:
        bad.append('a replica does not serve the promoted arm: %s'
                   % run['replica_codes'])
    if run['promotions'] < 1:
        bad.append('no candidate was promoted')
    if run['delta_pushes'] < 1 or run['full_pushes'] < 1:
        bad.append('%d delta and %d full pushes, want one of each at least'
                   % (run['delta_pushes'], run['full_pushes']))
    if run['lost'] or run['non_200']:
        bad.append('%d requests lost, %d answered otherwise than 200: %s'
                   % (len(run['lost']), run['non_200'], run['lost'][:3]))
    if run['client_ok'] < 1 or any(run['client_rcs']):
        bad.append('no client request was answered, or a client exited '
                   'with an error (%s)' % run['client_rcs'])
    if not run['models_match']:
        bad.append('the fleet serves %s, the last promoted is %s'
                   % (run['fleet_model'], run['last_promoted']))
    if not run['final_rel_err'] <= SERVE_SERIAL_REL_TOL:
        bad.append('the router answers %.4g of the largest output from a '
                   'direct Predictor over the last promoted export, over '
                   '%.4g' % (run['final_rel_err'], SERVE_SERIAL_REL_TOL))
    if run['push_fallbacks']:
        bad.append('%d delta pushes were refused (chain or parity) with no '
                   'fault injected' % run['push_fallbacks'])
    return bad


def train_serve_phase(torch, mx, cuda_conv, root, ctx=None):
    """Phase 23: a FleetSupervisor of two replica processes on the card
    serves phase 11's bf16 ResNet-50 checkpoint; in this process
    Module.fit trains the same network from it at LOOP_BATCH, a
    CheckpointManager(every_n_steps=LOOP_EVERY) committing and a
    CheckpointPusher(frac=LOOP_FRAC, delta=True) pushing each commit into
    the fleet, while LOOP_CLIENTS closed-loop client processes post
    through the router. The first candidate is degraded (LOOP_DEGRADE)
    and rolls back; one replica is SIGKILLed while a later push is
    judged; the drill ends once a candidate was promoted and one went
    out as a delta. Gated by loop_gate."""
    import shutil
    import signal
    from mxnet_tpu_torch import elastic, profiler
    from mxnet_tpu_torch.fleet_supervisor import (CheckpointPusher,
                                                  FleetSupervisor,
                                                  _http_json,
                                                  post_with_backoff)
    from mxnet_tpu_torch.predictor import Predictor
    ctx = ctx or mx.gpu(0)
    out = root / 'build' / 'phase23'
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torch.cuda.empty_cache()
    prior = {k: os.environ.get(k) for k in LOOP_KNOBS}
    os.environ.update(LOOP_KNOBS)
    profiler.clear()
    prefix0 = str(out / 'initial')
    symbol, shape = serve_checkpoint(torch, mx, prefix0, ctx)
    _s, args0, auxs0 = mx.model.load_checkpoint(prefix0, 0, ctx=mx.cpu())
    x, y = module_data(RESNET['num_classes'], LOOP_BATCH * LOOP_BATCHES,
                       shape, SEED + 600)
    # the bodies carry float64 values of FLEET_DIGITS decimals (short
    # JSON: a float32's repr is twice as long and twice the decode); the
    # references take the same values as float32, as the replicas do
    rng = np.random.default_rng(SEED + 601)
    images = np.round(rng.standard_normal(
        (1 + LOOP_CHECK_IMAGES, 1) + shape), FLEET_DIGITS)
    sup = pusher = mgr = stop_clients = None
    records, client_rcs = [], []
    state = dict(killed=False, restarts_at_kill=0, t_kill=None,
                 respawn_s=None)
    pushes, verdict_t = {}, {}
    launches, step_ms, marks = [], [], {}
    try:
        t0 = time.perf_counter()
        sup = FleetSupervisor(
            models=[{'name': LOOP_MODEL, 'prefix': prefix0, 'epoch': 0,
                     'input_shapes': {'data': [1] + list(shape)},
                     'max_batch': 4, 'max_wait_us': 0,
                     'deadline_ms': 10000}],
            replicas=2, ctx=ctx,
            env={'MXNET_TPU_FAULT_CANARY_DEGRADE_MS': LOOP_DEGRADE})
        sup.start()
        sup.wait_healthy()
        boot_s = time.perf_counter() - t0
        host, port = sup.router.address
        url = 'http://%s:%d/v1/models/%s:predict' % (host, port,
                                                     LOOP_MODEL)
        push = sup.push

        # wall clocks: the clients' records come from other processes
        def timed_push(*a, **kw):
            cand = push(*a, **kw)
            pushes[cand] = dict(t=time.time(), delta='delta' in kw)
            return cand
        sup.push = timed_push
        sup.on_push_verdict(lambda v: verdict_t.setdefault(
            v.candidate, time.time()))
        stop_clients = loop_clients(root, out, url,
                                    {'instances': images[0].tolist()})

        pusher = CheckpointPusher(sup, LOOP_MODEL, symbol=symbol,
                                  frac=LOOP_FRAC, delta=True,
                                  max_consecutive_rollbacks=0,
                                  push_dir=str(out / 'push'))
        mgr = pusher.attach(elastic.CheckpointManager(
            str(out / 'ck'), every_n_steps=LOOP_EVERY))

        def watch_respawn():
            while time.perf_counter() - state['t_kill'] < LOOP_SETTLE_S:
                live = sup.replicas()
                if sup.stats()['restarts'] > state['restarts_at_kill'] \
                        and len(live) >= 2 and \
                        all(sup._probe(r) for r in live):
                    state['respawn_s'] = time.perf_counter() - \
                        state['t_kill']
                    return
                time.sleep(0.05)

        def on_batch(param):
            torch.cuda.synchronize()
            now = time.perf_counter()
            if 'end' in marks:
                step_ms.append((now - marks['end']) * 1e3)
            launches.append(cuda_conv.CONV_BN_STATS_LAUNCHES -
                            marks.get('count', 0))
            time.sleep(LOOP_PACE_S)
            verds = pusher.verdicts()
            rolled = any(v.kind == 'rolled_back' for v in verds)
            promoted = any(v.kind == 'promoted' for v in verds)
            reps = sup.replicas()
            if rolled and not state['killed'] and \
                    sup.push_active(LOOP_MODEL) and reps:
                state['restarts_at_kill'] = sup.stats()['restarts']
                reps[0].proc.send_signal(signal.SIGKILL)
                state['t_kill'] = time.perf_counter()
                state['killed'] = True
                threading.Thread(target=watch_respawn, daemon=True).start()
            if rolled and promoted and state['killed'] and \
                    profiler.delta_stats()['delta_pushes'] >= 1:
                mgr.request_stop(_LoopDone())
            marks['count'] = cuda_conv.CONV_BN_STATS_LAUNCHES
            marks['end'] = time.perf_counter()

        mod = mx.mod.Module(symbol, context=ctx)
        train = mx.io.NDArrayIter(x, y, batch_size=LOOP_BATCH)
        marks['count'] = cuda_conv.CONV_BN_STATS_LAUNCHES
        t_fit = time.perf_counter()
        try:
            mod.fit(train, optimizer='sgd', optimizer_params=dict(LOOP_OPT),
                    arg_params=args0, aux_params=auxs0, eval_metric='acc',
                    num_epoch=LOOP_MAX_EPOCHS, checkpoint=mgr,
                    batch_end_callback=on_batch)
            fail('phase 23: no promote and delta push in %d epochs '
                 '(verdicts %r)' % (LOOP_MAX_EPOCHS, pusher.verdicts()))
        except _LoopDone:
            pass
        fit_s = time.perf_counter() - t_fit
        # the clients keep the last candidate's canary judged
        t_wait = time.perf_counter()
        while sup.push_active(LOOP_MODEL) and \
                time.perf_counter() - t_wait < LOOP_SETTLE_S:
            time.sleep(0.05)
        while state['killed'] and state['respawn_s'] is None and \
                time.perf_counter() - state['t_kill'] < LOOP_SETTLE_S:
            time.sleep(0.05)
        records, client_rcs = stop_clients()
        stop_clients = None
        verds = pusher.verdicts()
        promoted = [v for v in verds if v.kind == 'promoted']
        last = promoted[-1] if promoted else None
        fleet_model = sup.stats()['models'][LOOP_MODEL]
        # every replica, the respawned one too, serves the promoted arm,
        # and the router answers as a Predictor over its export
        replica_codes, final_rel = {}, float('inf')
        if last is not None:
            for rep in sup.replicas():
                st_, _h, _b = _http_json(
                    'POST', rep.host, rep.port,
                    '/v1/models/%s:predict' % last.candidate,
                    {'instances': images[1].tolist()}, timeout=60)
                replica_codes[rep.index] = st_
            ref = Predictor.from_checkpoint(
                os.path.join(pusher.push_dir, 'push-%08d' % last.step), 0,
                {'data': (1,) + shape}, ctx=ctx)
            errs = []
            for img in images[1:]:
                status, ans = post_with_backoff(
                    url, {'instances': img.tolist()}, deadline_s=60)
                want = ref.predict(img.astype(np.float32))
                got = np.asarray(ans['outputs'][0], np.float32) \
                    if status == 200 else np.full_like(want, np.inf)
                errs.append(float(np.abs(got - want).max() /
                                  np.abs(want).max()))
            final_rel = max(errs)
            del ref
        fs_stats = profiler.fleet_supervisor_stats()
        lp = profiler.loop_stats()
        ds = profiler.delta_stats()
        ck = profiler.ckpt_stats()
        sup_stats = sup.stats()
    finally:
        if stop_clients is not None:
            stop_clients()
        if pusher is not None:
            pusher.close()
        if mgr is not None:
            mgr.close()
        if sup is not None:
            sup.stop()
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # the same trainer with the fleet down
    batch = next(iter(mx.io.NDArrayIter(x[:LOOP_BATCH], y[:LOOP_BATCH],
                                        batch_size=LOOP_BATCH)))
    alone = []
    for i in range(LOOP_ALONE_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        if i:
            alone.append((time.perf_counter() - t0) * 1e3)
    del mod
    during = [r['ms'] for r in records
              if any(p['t'] <= r['t0'] <= verdict_t.get(c, float('inf'))
                     for c, p in pushes.items())]
    lost = [r for r in records if 'error' in r]
    run = dict(
        config=dict(RESNET, batch=LOOP_BATCH, every_n_steps=LOOP_EVERY,
                    frac=LOOP_FRAC, replicas=2, clients=LOOP_CLIENTS,
                    degrade=LOOP_DEGRADE, knobs=LOOP_KNOBS,
                    optimizer='sgd', **LOOP_OPT),
        replica_boot_s=boot_s, fit_s=fit_s,
        launches_per_step=launches,
        trainer_step_ms_fleet_up=median(step_ms) if step_ms else None,
        trainer_step_ms_alone=median(alone), steps=len(launches),
        verdicts=[dict(kind=v.kind, candidate=v.candidate, step=v.step)
                  for v in verds],
        push_to_verdict_s={c: verdict_t[c] - p['t'] for c, p in
                           sorted(pushes.items()) if c in verdict_t},
        pushed_as={c: 'delta' if p['delta'] else 'full'
                   for c, p in sorted(pushes.items())},
        delta_pushes=ds['delta_pushes'],
        full_pushes=lp['loop_pushes'] - ds['delta_pushes'],
        delta_bytes=ds['delta_bytes'], delta_full_bytes=ds['delta_full_bytes'],
        push_fallbacks=ds['delta_push_fallbacks'],
        router_ms_during_push=dict(p50=percentile(during, 50),
                                   p99=percentile(during, 99),
                                   n=len(during)),
        router_ms_all=dict(p50=percentile([r['ms'] for r in records], 50),
                           p99=percentile([r['ms'] for r in records], 99)),
        killed=state['killed'], respawn_s=state['respawn_s'],
        restarts=sup_stats['restarts'],
        reconciled=bool(replica_codes) and
        all(c == 200 for c in replica_codes.values()),
        replica_codes=replica_codes,
        promotions=len(promoted),
        client_ok=sum(1 for r in records if r.get('code') == 200),
        client_rcs=client_rcs,
        non_200=sum(1 for r in records if r.get('code') not in (None, 200)),
        lost=[r['error'] for r in lost],
        fleet_model=fleet_model,
        last_promoted=last.candidate if last is not None else None,
        models_match=last is not None and fleet_model == last.candidate,
        final_rel_err=final_rel, final_tol=SERVE_SERIAL_REL_TOL,
        commits_skipped=ck['ckpt_skipped'],
        fleet_supervisor_stats=fs_stats, loop_stats=lp)
    print('train_serve ' + json.dumps(run))
    bad = loop_gate(run)
    if bad:
        fail('phase 23: ' + '; '.join(bad))
    print('train_serve: replicas booted in %.1f s; %d trainer steps at %d '
          'images, %.1f ms a step with the fleet up, %.1f ms alone, %d conv '
          'launches each; %d pushes (%d delta, %d full; delta %.1f of %.1f '
          'MB), push -> verdict %s s; router p50 / p99 %.1f / %.1f ms during '
          'the pushes; SIGKILL -> healthy respawn %.1f s; %d requests, 0 '
          'lost; answers %.3g of the largest output from the last promoted '
          'export (%s); %d commits skipped by the writer'
          % (boot_s, run['steps'], LOOP_BATCH,
             run['trainer_step_ms_fleet_up'] or 0.0,
             run['trainer_step_ms_alone'], RESNET_PAIRS - 1,
             lp['loop_pushes'], run['delta_pushes'], run['full_pushes'],
             run['delta_bytes'] / 1e6, run['delta_full_bytes'] / 1e6,
             {c: round(s_, 2) for c, s_ in
              run['push_to_verdict_s'].items()},
             run['router_ms_during_push']['p50'] or 0.0,
             run['router_ms_during_push']['p99'] or 0.0,
             run['respawn_s'], run['client_ok'], final_rel,
             run['last_promoted'], run['commits_skipped']))
    run['path_launches'] = sum(launches)
    shutil.rmtree(out, ignore_errors=True)
    return run


# ---------------------------------------------------------------------------
# phase 24: the GPT-2-medium scorer behind the router
# ---------------------------------------------------------------------------

ROUTER_REQUESTS = 8         # distinct scoring requests, each sent twice
ROUTER_CLIENTS = 2
ROUTER_DEADLINE_MS = 30000  # the scorer's SLO: the router's retry budget
ROUTER_CLOSE_REQUESTS = 12  # each client's requests around the close


def router_gate(run):
    """Phase 24's checks on a run's numbers: a list of what failed, empty
    when it passed."""
    bad = []
    if run['answers'] != run['sent'] or run['unequal']:
        bad.append('%d of %d answers through the router, %d not bit-equal '
                   'to the scorer called directly'
                   % (run['answers'], run['sent'], len(run['unequal'])))
    want = GPT2_MEDIUM['layers']
    calls = run['launches_per_call']
    if not calls or any(n != want for n in calls):
        bad.append('flash launches a request %s, want %d each'
                   % (sorted(set(calls)), want))
    if run['shadow_requests'] < 1 or run['shadow_divergences']:
        bad.append('shadow: %d requests, %d divergences'
                   % (run['shadow_requests'], run['shadow_divergences']))
    if run['close_hung']:
        bad.append('%d requests hung across the replica close'
                   % run['close_hung'])
    if run['in_flight_at_close'] < 1:
        bad.append('no request was in flight when the replica closed')
    if run['close_untyped']:
        bad.append('requests around the replica close ended otherwise '
                   'than 200 or a typed error: %s' % run['close_untyped'][:3])
    if not run['close_max_s'] <= ROUTER_DEADLINE_MS / 1e3 + 5:
        bad.append('a request around the close took %.1f s, over the '
                   'deadline' % run['close_max_s'])
    if run['after_close_unequal'] or not run['after_close_ok']:
        bad.append('the survivor answered %d requests after the close, %d '
                   'not bit-equal' % (run['after_close_ok'],
                                      run['after_close_unequal']))
    for kernel, n in sorted(run['other_launches'].items()):
        if n:
            bad.append('the scorer launched the %s kernel %d times'
                       % (kernel, n))
    return bad


def scorer_router_phase(torch, mx, cuda_conv, cuda_ops, tfm, ctx=None):
    """Phase 24: two in-process ReplicaServers on gpu(0), each serving a
    FleetScorer over one GPT-2-medium TransformerLM on the flash kernel
    (registered by loader=), behind one FleetRouter; a shadow arm with
    the same weights takes a tee of the traffic; then one replica closes
    while ROUTER_CLIENTS clients send. Gated by router_gate."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.fleet_supervisor import (FleetRouter, ReplicaServer,
                                                  _http_json)
    ctx = ctx or mx.gpu(0)
    device = ctx.torch_device
    torch.cuda.empty_cache()
    profiler.clear()
    cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
    params = tfm.params_from_jax(seeded_tree(cfg, SEED + 700),
                                 dtype=torch.bfloat16, device=device)
    model = tfm.TransformerLM(cfg, params).eval()
    del params
    lock = threading.Lock()         # one scorer call at a time: exact counts
    scorers = []

    def loader():
        s_ = FleetScorer(torch, model, counter=lambda:
                         cuda_ops.FLASH_FWD_LAUNCHES, lock=lock)
        scorers.append(s_)
        return s_
    direct = FleetScorer(torch, model)
    rng = np.random.default_rng(SEED + 701)
    seqs = [rng.integers(0, cfg['vocab'], SEQ + 1)
            for _ in range(ROUTER_REQUESTS)]
    bodies = [{'inputs': {'tokens': t[:-1].tolist(),
                          'targets': t[1:].tolist()}} for t in seqs]
    refs = [direct.infer(t[:-1], t[1:])[0] for t in seqs]
    spec = {'name': 'scorer', 'loader': loader}
    reps = [ReplicaServer(models=[spec], index=i, ctx=ctx).start()
            for i in range(2)]
    for r in reps:
        r.warm_all()
    router = FleetRouter(deadlines={'scorer': ROUTER_DEADLINE_MS}).start()
    for i, r in enumerate(reps):
        router.add_backend('r%d' % i, *r.address)
    host, port = router.address
    before = hand_written_launches(cuda_conv, cuda_ops)
    unequal, answers, sent = [], 0, 0
    t0 = time.perf_counter()
    try:
        # the shadow arm: the same weights, a tee of the logged traffic
        for r in reps:
            r.load_model('scorer@shadow', {'name': 'scorer@shadow',
                                           'loader': loader})
        router.start_canary('scorer', 'scorer@shadow', mode='shadow')
        results = [[] for _ in range(ROUTER_CLIENTS)]

        def client(i):
            for j in range(i, 2 * ROUTER_REQUESTS, ROUTER_CLIENTS):
                k = j % ROUTER_REQUESTS
                st_, _h, b = _http_json('POST', host, port,
                                        '/v1/models/scorer:predict',
                                        bodies[k], timeout=120)
                results[i].append((k, st_, b))
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(ROUTER_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        for res in results:
            for k, st_, b in res:
                sent += 1
                if st_ == 200:
                    answers += 1
                    got = np.asarray(b['outputs'][0], np.float32)
                    if not np.array_equal(got, refs[k]):
                        unequal.append(k)
        traffic_s = time.perf_counter() - t0
        drained = router.shadow_drain(timeout=300)
        report = router.canary_report('scorer')
        replay = router.replay('scorer', arm='scorer@shadow')
        # one replica closes while the clients send
        close_recs = []

        def close_client(i):
            for j in range(ROUTER_CLOSE_REQUESTS):
                k = (i + j) % ROUTER_REQUESTS
                t1 = time.perf_counter()
                try:
                    st_, _h, b = _http_json(
                        'POST', host, port, '/v1/models/scorer:predict',
                        bodies[k], timeout=ROUTER_DEADLINE_MS / 1e3 + 30)
                    rec = dict(k=k, code=st_, body=b)
                except Exception as e:
                    rec = dict(k=k, error=repr(e))
                rec.update(t0=t1, t1=time.perf_counter())
                rec['s'] = rec['t1'] - t1
                close_recs.append(rec)
        threads = [threading.Thread(target=close_client, args=(i,))
                   for i in range(ROUTER_CLIENTS)]
        for t in threads:
            t.start()
        t1 = time.perf_counter()
        while len(close_recs) < ROUTER_CLIENTS and \
                time.perf_counter() - t1 < 120:
            time.sleep(0.001)
        t_close = time.perf_counter()
        reps[1].close()
        router.remove_backend('r1')
        for t in threads:
            t.join(timeout=ROUTER_DEADLINE_MS / 1e3 + 120)
        hung = sum(1 for t in threads if t.is_alive())
        untyped = [r for r in close_recs
                   if r.get('code') != 200 and
                   not (r.get('code') in (502, 503) and
                        'error' in (r.get('body') or {}))]
        after_ok = after_unequal = 0
        for k in range(ROUTER_REQUESTS):
            st_, _h, b = _http_json('POST', host, port,
                                    '/v1/models/scorer:predict', bodies[k],
                                    timeout=120)
            if st_ == 200:
                after_ok += 1
                if not np.array_equal(np.asarray(b['outputs'][0],
                                                 np.float32), refs[k]):
                    after_unequal += 1
        close_equal = all(np.array_equal(np.asarray(
            r['body']['outputs'][0], np.float32), refs[r['k']])
            for r in close_recs if r.get('code') == 200)
        after = hand_written_launches(cuda_conv, cuda_ops)
        fs_stats = profiler.fleet_supervisor_stats()
    finally:
        router.close()
        for r in reps:
            r.close()
    per_call = [n for s_ in scorers for n in s_.per_call]
    other = {k: after[k] - before[k] for k in after if k != 'flash_fwd'}
    run = dict(
        config=dict(GPT2_MEDIUM, seq=SEQ, dtype='bfloat16', replicas=2,
                    clients=ROUTER_CLIENTS, deadline_ms=ROUTER_DEADLINE_MS),
        sent=sent, answers=answers, unequal=unequal,
        traffic_s=traffic_s, launches_per_call=per_call,
        flash_launches=after['flash_fwd'] - before['flash_fwd'],
        shadow_drained=drained,
        shadow_requests=report['shadow_requests'],
        shadow_divergences=report['shadow_divergences'],
        replay=replay,
        close_requests=len(close_recs), close_hung=hung,
        in_flight_at_close=sum(1 for r in close_recs
                               if r['t0'] <= t_close <= r['t1']),
        close_untyped=[dict(code=r.get('code'), error=r.get('error'))
                       for r in untyped],
        close_codes=sorted(str(r.get('code')) for r in close_recs),
        close_max_s=max([r['s'] for r in close_recs] or [0.0]),
        close_answers_equal=close_equal,
        after_close_ok=after_ok, after_close_unequal=after_unequal,
        other_launches=other, fleet_supervisor_stats=fs_stats)
    if not close_equal:
        run['after_close_unequal'] += 1
    print('router ' + json.dumps(run))
    bad = router_gate(run)
    if bad:
        fail('phase 24: ' + '; '.join(bad))
    print('router: %d scoring requests of %d tokens through 2 replicas, '
          'bit-equal to the scorer, %d flash launches each; shadow %d '
          'requests, 0 divergences; replica closed with %d requests in '
          'flight (%d around it: %s), longest %.2f s, survivor bit-equal'
          % (answers, SEQ, GPT2_MEDIUM['layers'], run['shadow_requests'],
             run['in_flight_at_close'], len(close_recs),
             ','.join(run['close_codes']), run['close_max_s']))
    run['path_launches'] = run['flash_launches']
    return run


# ---------------------------------------------------------------------------
# phase 25: the deployment artifact and the C predict API
# ---------------------------------------------------------------------------

ART_BATCH = 8
ART_BUCKETS = (1, 8, 32)
ART_RUNNER = r'''
import sys
import torch
prog = torch.export.load(sys.argv[1]).module()
x = torch.load(sys.argv[2]).to('cuda:0')
with torch.no_grad():
    out = prog(x)
torch.cuda.synchronize()
assert not any(m.startswith('mxnet_tpu') for m in sys.modules), \
    sorted(m for m in sys.modules if m.startswith('mxnet_tpu'))
torch.save([o.cpu() for o in out], sys.argv[3])
'''
# examples/c_predict/predict.c passes dev_type 1 (the CPU); compiled with
# -DMXTPredCreate=mxt_example_create_on_card it calls this shim instead
# (compiled on its own, without the define), which passes dev_type 2
ART_CARD_SHIM = r'''
#include <stdint.h>
extern int MXTPredCreate(const char*, const void*, int, int, int, uint32_t,
                         const char**, const uint32_t*, const uint32_t*,
                         void**);
int mxt_example_create_on_card(const char* json, const void* params,
                               int size, int dev_type, int dev_id,
                               uint32_t n, const char** keys,
                               const uint32_t* indptr,
                               const uint32_t* shapes, void** out) {
  (void)dev_type;
  return MXTPredCreate(json, params, size, 2, dev_id, n, keys, indptr,
                       shapes, out);
}
'''


def artifact_gate(run):
    """Phase 25's checks on a run's numbers: a list of what failed, empty
    when it passed."""
    bad = []
    want = ['input data float32 %d,%s' % (ART_BATCH, RESNET['image_shape']),
            'output 0 float32 %d,%d' % (ART_BATCH, RESNET['num_classes'])]
    if run['manifest'] != want:
        bad.append('manifest %s, want %s' % (run['manifest'], want))
    if run['runner_rc'] != 0:
        bad.append('the torch-only runner exited %d: %s'
                   % (run['runner_rc'], run['runner_err']))
    elif not run['pt2_rel_err'] <= SERVE_SERIAL_REL_TOL:
        bad.append('the .pt2 answers %.4g of the largest output from '
                   'Predictor.forward, over %.4g'
                   % (run['pt2_rel_err'], SERVE_SERIAL_REL_TOL))
    if sorted(run['rungs']) != sorted(ART_BUCKETS):
        bad.append('export_compiled gave rungs %s' % run['rungs'])
    if run['second_hits'] != len(ART_BUCKETS) or run['second_misses']:
        bad.append('the second export_compiled: %d hits, %d misses'
                   % (run['second_hits'], run['second_misses']))
    for dev in ('cpu', 'card'):
        c = run['c_predict'][dev]
        if c['rc'] != 0 or c['predicted'] != c['want']:
            bad.append('predict.c on the %s: exit %s, class %s, the '
                       'Predictor\'s %s (%s)' % (dev, c['rc'], c['predicted'],
                                                 c['want'], c['err']))
    for kernel, n in sorted(run['launches'].items()):
        if n:
            bad.append('the phase launched the %s kernel %d times'
                       % (kernel, n))
    return bad


def predicted_class(text):
    for line in text.splitlines():
        if line.startswith('predicted='):
            return int(line.split()[0].split('=', 1)[1])
    return None


def artifact_phase(torch, mx, cuda_conv, cuda_ops, root, ctx=None):
    """Phase 25: export_artifact writes phase 11's bf16 ResNet-50 as .pt2
    and .manifest; a python3 -I that imports torch alone runs it on
    cuda:0 against Predictor.forward; export_compiled(batch_buckets=
    ART_BUCKETS) twice, the second all cache hits; the C predict API
    built with the host compiler, and examples/c_predict/predict.c
    linked against it classifying a seeded image on the CPU (dev_type 1,
    as written) and on the card (dev_type 2, through ART_CARD_SHIM), each
    as the Predictor on that device. Gated by artifact_gate."""
    import shutil
    from mxnet_tpu_torch import _build, exec_cache
    from mxnet_tpu_torch.predictor import Predictor
    ctx = ctx or mx.gpu(0)
    out = root / 'build' / 'phase25'
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torch.cuda.empty_cache()
    before = hand_written_launches(cuda_conv, cuda_ops)
    prefix = str(out / 'resnet50')
    symbol, shape = serve_checkpoint(torch, mx, prefix, ctx)
    pred = Predictor.from_checkpoint(prefix, 0,
                                     {'data': (ART_BATCH,) + shape}, ctx=ctx)
    t0 = time.perf_counter()
    manifest = pred.export_artifact(str(out / 'artifact'))
    export_s = time.perf_counter() - t0
    x = np.random.default_rng(SEED + 800).standard_normal(
        (ART_BATCH,) + shape, dtype=np.float32)
    torch.save(torch.from_numpy(x), str(out / 'in.pt'))
    # the torch-only runner and the two C programs run in processes of
    # their own while this one exports the rungs
    runner = Background([sys.executable, '-I', '-c', ART_RUNNER,
                         str(out / 'artifact.pt2'), str(out / 'in.pt'),
                         str(out / 'out.pt')], 600, cwd=str(out))
    t0 = time.perf_counter()
    lib = _build.c_predict_library()
    c_build_s = time.perf_counter() - t0
    libdir = str(lib.parent)
    img = x[:1]
    img.tofile(str(out / 'input.f32'))
    (out / 'card_shim.c').write_text(ART_CARD_SHIM)
    shim = str(out / 'card_shim.o')
    cc = subprocess.run(['gcc', '-O2', '-c', str(out / 'card_shim.c'),
                         '-o', shim], capture_output=True, text=True,
                        timeout=300)
    if cc.returncode != 0:
        fail('phase 25: the shim failed to compile:\n%s%s'
             % (cc.stdout, cc.stderr))
    c_jobs = {}
    for dev, extra in (('cpu', []),
                       ('card', ['-DMXTPredCreate=mxt_example_create_on_card',
                                 shim])):
        exe = str(out / ('predict_' + dev))
        cc = subprocess.run(['gcc', '-O2', *extra,
                             str(root / 'examples' / 'c_predict' /
                                 'predict.c'), '-o', exe, '-L' + libdir,
                             '-lmxt_predict', '-Wl,-rpath,' + libdir],
                            capture_output=True, text=True, timeout=300)
        if cc.returncode != 0:
            fail('phase 25: predict.c failed to compile:\n%s%s'
                 % (cc.stdout, cc.stderr))
        env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
        c_jobs[dev] = Background([exe, prefix + '-symbol.json',
                                  prefix + '-0000.params',
                                  str(out / 'input.f32')] +
                                 [str(d) for d in (1,) + shape], 600,
                                 env=env, cwd=str(out))
    want = pred.forward(data=x)[0].asnumpy()
    # the rungs, twice
    t0 = time.perf_counter()
    s0 = exec_cache.stats()
    rungs = pred.export_compiled(batch_buckets=ART_BUCKETS)
    first_s = time.perf_counter() - t0
    s1 = exec_cache.stats()
    t0 = time.perf_counter()
    again = pred.export_compiled(batch_buckets=ART_BUCKETS)
    second_s = time.perf_counter() - t0
    s2 = exec_cache.stats()
    same = all(again[b]['program'] is rungs[b]['program'] for b in rungs)
    c_runs = {}
    for dev, ctx_dev in (('cpu', mx.cpu()), ('card', ctx)):
        one = Predictor.from_checkpoint(prefix, 0, {'data': (1,) + shape},
                                        ctx=ctx_dev)
        c_want = int(np.argmax(one.predict(img)[0]))
        del one
        run_, c_s = c_jobs[dev].wait()
        c_runs[dev] = dict(rc=run_.returncode,
                           predicted=predicted_class(run_.stdout),
                           want=c_want, s=c_s,
                           out=run_.stdout.strip()[-300:],
                           err=run_.stderr.strip()[-1500:])
    proc, runner_s = runner.wait()
    pt2_rel = float('inf')
    bit_equal = False
    if proc.returncode == 0:
        got = torch.load(str(out / 'out.pt'))[0].float().numpy()
        pt2_rel = float(np.abs(got - want).max() / np.abs(want).max())
        bit_equal = bool(np.array_equal(got, want))
    after = hand_written_launches(cuda_conv, cuda_ops)
    run = dict(
        config=dict(RESNET, batch=ART_BATCH, buckets=ART_BUCKETS),
        manifest=manifest, export_s=export_s,
        pt2_bytes=os.path.getsize(str(out / 'artifact.pt2')),
        runner_rc=proc.returncode, runner_err=proc.stderr[-1500:],
        runner_s=runner_s, pt2_rel_err=pt2_rel, pt2_bit_equal=bit_equal,
        pt2_tol=SERVE_SERIAL_REL_TOL,
        rungs=sorted(rungs), first_export_s=first_s,
        first_misses=s1['misses'] - s0['misses'],
        first_hits=s1['hits'] - s0['hits'],
        second_export_s=second_s, second_hits=s2['hits'] - s1['hits'],
        second_misses=s2['misses'] - s1['misses'], second_same=same,
        c_build_s=c_build_s, c_library=str(lib),
        c_predict=c_runs,
        launches={k: after[k] - before[k] for k in after})
    print('artifact ' + json.dumps(run))
    bad = artifact_gate(run)
    if bad:
        fail('phase 25: ' + '; '.join(bad))
    print('artifact: .pt2 of %.1f MB exported in %.1f s, run by torch alone '
          'in %.1f s, %s Predictor.forward (%.3g of the largest output); '
          'export_compiled %s: %.1f s, then %d hits in %.3f s; the C '
          'library built in %.1f s; predict.c classifies as the Predictor '
          'on the CPU (%d) and the card (%d)'
          % (run['pt2_bytes'] / 1e6, export_s, runner_s,
             'bit-equal to' if bit_equal else 'within tolerance of',
             pt2_rel, list(ART_BUCKETS), first_s, run['second_hits'],
             second_s, c_build_s, c_runs['cpu']['predicted'],
             c_runs['card']['predicted']))
    shutil.rmtree(out, ignore_errors=True)
    return run


# -- phases 26-27: the mesh, the collectives and ring attention -------------

MESH_ONE = {'data': 1, 'sp': 1, 'model': 1}
# phase 26's updated parameters against phase 5's one-device step on the
# same bf16 weights and tokens. The mesh path runs the same kernels on the
# same inputs (attention on one device: no ring over an sp axis of one
# rank) and the same products; what may differ is float32 rounding where
# the loss is scaled (a block's mean times its share of the tokens, here
# 1.0), and a float32 difference in a gradient can move a bf16 update
# across one rounding. So each parameter is held within one bf16 step of
# the one-device value (bf16 keeps 8 significant bits: a step is at most
# 2^-7 of the value), and the share that differs at all is printed. Most
# bf16 updates round away below half a step, so this bound cannot tell a
# step that skipped its update: the float32 steps below are gated on the
# update itself.
MESH_W_RTOL = 2.0 ** -7
# The float32 steps of phases 26 and 27 (FP32_LAYERS layers at full
# width) are gated on their updates: per leaf, |(w_new - w_old) - (w_ref
# - w_old)| <= MESH_UPDATE_RTOL * max|w_ref - w_old| + eps |w_old|, with
# w_ref the one-device step's. eps |w_old| is one float32 rounding of the
# weight (each step rounds w - lr g once, at most half a unit in the last
# place). The sharded step sums the same float32 gradient in another
# order (the products split over 'model', the ring's lse merge, the loss
# as block means over data x sp), a relative error of order 1e-6 of the
# leaf's largest element; a hop's dK / dV dropped or the update skipped
# moves some leaf by order one of its largest update. 1e-3 sits between
# (the CPU rehearsal in tests/test_torch_ring_attention.py,
# test_update_gate_fails_planted_faults, reads both).
MESH_UPDATE_RTOL = 1e-3
MESH_RING = {'data': 1, 'sp': 2, 'model': 2}
MESH_RANKS = 4
MESH_RING_STEPS = 1          # timed steps a rank, after one warm-up
MESH_J_SP = 4                # __graft_entry__ dryrun phase (j), at sp = 4


def lm_batch(torch, vocab, device):
    """Phase 3's first request, (tokens, targets) of BATCH x SEQ."""
    tok = np.random.default_rng(SEED + 1).integers(0, vocab,
                                                   (BATCH, SEQ + 1))
    tok = torch.from_numpy(tok).to(device)
    return tok[:, :-1], tok[:, 1:]


def leaves_within(torch, got, ref, rtol, atol):
    """Leaf by leaf, |got - ref| <= atol + rtol |ref|: (all within, the
    largest error, the largest error over its bound, the share of the
    elements that differ at all, every leaf bit-equal)."""
    worst = worst_ratio = 0.0
    differ = total = 0
    for g, r in zip(got, ref):
        g, r = g.detach().float(), r.detach().float()
        err = (g - r).abs()
        worst = max(worst, float(err.max()))
        worst_ratio = max(worst_ratio, float(
            (err / (atol + rtol * r.abs()).clamp(min=1e-30)).max()))
        differ += int((err > 0).sum())
        total += err.numel()
    return dict(ok=worst_ratio <= 1.0, max_abs_err=worst,
                max_err_over_bound=worst_ratio,
                share_differ=differ / max(total, 1), bit_equal=differ == 0,
                rtol=rtol, atol=atol)


def updates_within(torch, new, old, ref, rtol, roundings=1):
    """Leaf by leaf, the update new - old against the reference update
    ref - old: |(new - old) - (ref - old)| <= rtol max|ref - old| +
    roundings eps |old| (eps of old's dtype: one rounding of the weight,
    once a step where `roundings` steps may each round it apart).
    Returns (all within, the largest error over its bound, the largest
    error as a share of its leaf's largest reference update, the
    smallest such largest update, rtol)."""
    worst = worst_rel = 0.0
    smallest = math.inf
    for n, o, r in zip(new, old, ref):
        eps = torch.finfo(o.dtype).eps
        n, o, r = (t.detach().float() for t in (n, o, r))
        want = r - o
        err = ((n - o) - want).abs()
        top = float(want.abs().max())
        bound = rtol * top + roundings * eps * o.abs()
        worst = max(worst, float((err / bound.clamp(min=1e-30)).max()))
        worst_rel = max(worst_rel, float(err.max()) / max(top, 1e-30))
        smallest = min(smallest, top)
    return dict(ok=worst <= 1.0, max_err_over_bound=worst,
                max_err_of_leaf_update=worst_rel,
                smallest_leaf_update=smallest, rtol=rtol)


def fp32_mesh_step(torch, cuda_ops, tfm, mesh, tokens, targets,
                   reference):
    """One float32 step at GPT-2-medium widths and FP32_LAYERS layers
    through `mesh` (every rank of it takes part): its flash launches and
    loss; with `reference`, also the one-device step from the same
    weights on this rank, and the gathered parameters (leaves_within,
    F32_TOL) and updates (updates_within, MESH_UPDATE_RTOL) held against
    it."""
    cfg = tfm.lm_config(use_flash=True,
                        **dict(GPT2_MEDIUM, layers=FP32_LAYERS))
    tree = seeded_tree(cfg, SEED + 3)
    old = tfm.params_from_jax(tree, dtype=torch.float32, device=mesh.device)
    counts = read_counts(cuda_ops)
    loss, new = tfm.make_train_step(cfg, mesh, lr=LR)(
        tfm.place_params(old, cfg, mesh), tokens, targets)
    row = dict(fp32_launches=[a - b for a, b in zip(read_counts(cuda_ops),
                                                     counts)],
               fp32_loss=float(loss))
    new = tfm.tree_leaves(tfm.gather_params(new, cfg, mesh))
    if reference:
        model = tfm.TransformerLM(cfg, tfm.params_from_jax(
            tree, dtype=torch.float32, device=mesh.device))
        row['fp32_one_device_loss'] = float(tfm.make_train_step(
            cfg, lr=LR)(model, tokens, targets))
        ref = list(model.parameters())
        row['fp32_params'] = leaves_within(torch, new, ref, F32_TOL['rtol'],
                                           F32_TOL['atol'])
        row['fp32_updates'] = updates_within(
            torch, new, tfm.tree_leaves(old), ref, MESH_UPDATE_RTOL)
    return row


def mesh_step_phase(torch, cuda_ops, tfm, pmesh, profiler, root, batch,
                    train=None):
    """Phase 26: the GPT-2-medium bf16 train step through the mesh path at
    world 1 over NCCL, held against the one-device step."""
    cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
    tokens, targets = batch
    out = root / 'build' / 'phase26'
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    pmesh.init_process_group(device='cuda:0', rank=0, world_size=1,
                             init_method='file://%s' % (out / 'rendezvous'))
    try:
        mesh = pmesh.make_mesh(MESH_ONE)
        tree = seeded_tree(cfg, SEED + 26)
        params = tfm.params_from_jax(tree, dtype=torch.bfloat16,
                                     device='cuda')
        del tree
        local = tfm.place_params(params, cfg, mesh)   # copies
        # the one-device step (phase 5's) from the same weights, in place
        model = tfm.TransformerLM(cfg, params)
        one_loss = float(tfm.make_train_step(cfg, lr=LR)(model, tokens,
                                                          targets))
        ref = [p.detach() for p in model.parameters()]
        del model, params

        step = tfm.make_train_step(cfg, mesh, lr=LR)
        stats = profiler.mesh_stats()
        reset_counts(cuda_ops)
        loss, local = step(local, tokens, targets)
        torch.cuda.synchronize()
        first = read_counts(cuda_ops)
        check = leaves_within(torch, tfm.tree_leaves(
            tfm.gather_params(local, cfg, mesh)), ref, MESH_W_RTOL, 0.0)
        del ref

        reset_counts(cuda_ops)
        times, per_step = [], []
        for _ in range(TRAIN_STEPS):
            counts = read_counts(cuda_ops)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, local = step(local, tokens, targets)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            per_step.append([a - b for a, b in zip(read_counts(cuda_ops),
                                                    counts)])
        launches = read_counts(cuda_ops)
        staged = profiler.mesh_stats()['mesh_staged_bytes'] - \
            stats['mesh_staged_bytes']
        dev_ms, top, _ = profile_device(
            torch, lambda: step(local, tokens, targets),
            'mesh step profile, one step', 8)
        backend = mesh.backend
        del local, step
        torch.cuda.empty_cache()
        fp32 = fp32_mesh_step(torch, cuda_ops, tfm, mesh, tokens, targets,
                              True)
        torch.cuda.empty_cache()
    finally:
        pmesh.destroy_process_group()
    step_ms = sorted(times)[len(times) // 2] * 1e3
    run = dict(config='gpt2-medium widths, %d layers, bf16, mesh %s'
               % (cfg['layers'], MESH_ONE), backend=backend,
               loss=float(loss), one_device_loss=one_loss,
               loss_atol=LM_NLL_ATOL, params=check, first_launches=first,
               launches=launches, launches_per_step=per_step,
               step_ms=[t * 1e3 for t in times], step_ms_median=step_ms,
               one_device_step_ms_median=None if train is None else
               train['step_ms_median'], staged_bytes=staged,
               profiled_device_ms=dev_ms,
               device_busy_share=dev_ms / step_ms, profile_top=top, **fp32)
    print('mesh step ' + json.dumps(run))
    want = [cfg['layers']] * 3
    if backend != 'nccl':
        fail('phase 26: world 1 on one card took %s, not NCCL' % backend)
    if list(first) != want or per_step != [want] * TRAIN_STEPS:
        fail('phase 26: launches (fwd, dK/dV, dQ) %s then %s, expected %s '
             'a step' % (first, per_step, want))
    if abs(run['loss'] - one_loss) > LM_NLL_ATOL:
        fail('phase 26: mesh loss %.5f vs one-device %.5f (tol %g)'
             % (run['loss'], one_loss, LM_NLL_ATOL))
    if not check['ok']:
        fail('phase 26: updated parameters off the one-device step: %s'
             % check)
    if fp32['fp32_launches'] != [FP32_LAYERS] * 3:
        fail('phase 26: float32 launches %s' % fp32['fp32_launches'])
    if not fp32['fp32_updates']['ok']:
        fail('phase 26: float32 updates off the one-device step: %s'
             % fp32['fp32_updates'])
    if staged:
        fail('phase 26: an NCCL group staged %d bytes' % staged)
    print('mesh step: %.1f ms a step (phase 5: %s ms), 24/24/24 launches, '
          'loss %.5f vs %.5f, parameters %s; float32 updates within %.3g '
          'of their leaf\'s largest (%.3g of the bound)' % (
              step_ms, run['one_device_step_ms_median'], run['loss'],
              one_loss, 'bit-equal' if check['bit_equal'] else
              'within one bf16 step (%.3g %% differ)'
              % (100 * check['share_differ']),
              fp32['fp32_updates']['max_err_of_leaf_update'],
              fp32['fp32_updates']['max_err_over_bound']))
    return run


def hop_check(torch, out, lse, ref_out, ref_lse, grads, ref_grads):
    """One bf16 hop's forward (FWD_TOL, LSE_TOL) and dq, dk, dv (BWD_TOL)
    against their plain versions."""
    ltol = LSE_TOL['bfloat16']
    err = (lse - ref_lse).abs()
    return dict(
        out=grad_mismatch(torch, out, ref_out, FWD_TOL['bfloat16']),
        lse_max_abs_err=float(err.max()),
        lse_ok=bool((err <= ltol['atol'] + ltol['rtol']
                     * ref_lse.abs()).all()),
        **{name: grad_mismatch(torch, got, ref, BWD_TOL['bfloat16'])
           for name, got, ref in zip(('dq', 'dk', 'dv'), grads,
                                     ref_grads)})


def mesh_rank(rank, out_dir):
    """Phase 27, one rank of MESH_RANKS sharing the card over gloo."""
    import torch
    from mxnet_tpu_torch import _build, cuda_ops, profiler
    from mxnet_tpu_torch.parallel import mesh as pmesh
    from mxnet_tpu_torch.parallel import transformer as tfm
    from mxnet_tpu_torch.parallel.ring_attention import (_rotate,
                                                        ring_forward)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()                # built by the parent
    mesh = pmesh.make_mesh(MESH_RING)
    sp = mesh.axis_index('sp')
    dev = mesh.device
    row = dict(rank=rank, coordinate=mesh.coordinate, device=str(dev),
               backend=mesh.backend, staged=mesh.staged)
    cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
    tokens, targets = lm_batch(torch, cfg['vocab'], dev)
    tree = seeded_tree(cfg, SEED + 26)     # phase 26's weights
    local = tfm.place_params(tfm.params_from_jax(
        tree, dtype=torch.bfloat16, device=dev), cfg, mesh)
    step = tfm.make_train_step(cfg, mesh, lr=LR)
    loss, local = step(local, tokens, targets)
    torch.cuda.synchronize()
    row['loss'] = float(loss)

    # the main path: MESH_RING_STEPS steps, counted and timed
    stats = profiler.mesh_stats()
    reset_counts(cuda_ops)
    times, per_step = [], []
    for _ in range(MESH_RING_STEPS):
        counts = read_counts(cuda_ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, local = step(local, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append([a - b for a, b in zip(read_counts(cuda_ops),
                                                counts)])
    row['launches'] = read_counts(cuda_ops)
    after = profiler.mesh_stats()
    row.update(launches_per_step=per_step, step_ms=[t * 1e3 for t in times],
               **{k + '_per_step': (after['mesh_' + k] - stats['mesh_' + k])
                  / MESH_RING_STEPS for k in ('collectives', 'payload_bytes',
                                              'staged_bytes', 'ring_hops')})
    events = device_events(torch, lambda: step(local, tokens, targets))
    row['profiled_device_ms'] = sum(device_us(e) for e in events) / 1e3
    del local, step
    if rank == 0:                   # the one-device loss, same weights
        with torch.inference_mode():
            model = tfm.TransformerLM(cfg, tfm.params_from_jax(
                tree, dtype=torch.bfloat16, device=dev))
            row['one_device_loss'] = float(model.loss(tokens, targets))
        del model
    del tree
    torch.cuda.empty_cache()

    # float32 at full width, FP32_LAYERS layers: one step's parameters
    # and updates
    row.update(fp32_mesh_step(torch, cuda_ops, tfm, mesh, tokens, targets,
                              rank == 0))
    torch.cuda.empty_cache()

    # the hops' kernels against their plain versions, with the ring's
    # merged lse and D: hop 0 is this rank's own block, the diagonal
    # (causal); on sp-rank 1 hop 1 holds sp-rank 0's block, the past
    # (unmasked), as on the main path
    heads = GPT2_MEDIUM['heads'] // MESH_RING['model']
    dh = GPT2_MEDIUM['dim'] // GPT2_MEDIUM['heads']
    shape = (BATCH, heads, SEQ // MESH_RING['sp'], dh)
    scale = 1.0 / math.sqrt(dh)
    gen = torch.Generator(device=dev).manual_seed(SEED + 27 + rank)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    out, lse = ring_forward(q, k, v, mesh, 'sp', True, scale, True)
    kout, klse = cuda_ops._flash_fwd_cuda(q, k, v, True, scale)
    ref_out, ref_lse = cuda_ops.flash_attention_online_reference(
        q, k, v, True, scale, block_k=FWD_BLOCK_K)
    dd = cuda_ops.attention_bwd_delta(out, do).contiguous()
    args = (q, k, v, do, lse, dd, True, scale)
    dk, dv = cuda_ops.flash_attention_bwd_dkdv_cuda(*args)
    dq = cuda_ops.flash_attention_bwd_dq_cuda(*args)
    ref_dk, ref_dv = cuda_ops.flash_attention_bwd_dkdv_reference(*args)
    ref_dq = cuda_ops.flash_attention_bwd_dq_reference(*args)
    row['hop'] = hop_check(torch, kout, klse, ref_out, ref_lse,
                           (dq, dk, dv), (ref_dq, ref_dk, ref_dv))
    row['hop'].update(shape=list(shape), hops_merged=sp + 1,
                      merged_lse_minus_hop_lse_max=float(
                          (lse - klse).abs().max()))
    kb, vb = (t.contiguous() for t in _rotate(mesh, 'sp', k, v))
    if sp:
        pout, plse = cuda_ops._flash_fwd_cuda(q, kb, vb, False, scale)
        ref_out, ref_lse = cuda_ops.flash_attention_online_reference(
            q, kb, vb, False, scale, block_k=FWD_BLOCK_K)
        args = (q, kb, vb, do, lse, dd, False, scale)
        dk, dv = cuda_ops.flash_attention_bwd_dkdv_cuda(*args)
        dq = cuda_ops.flash_attention_bwd_dq_cuda(*args)
        ref_dk, ref_dv = cuda_ops.flash_attention_bwd_dkdv_reference(*args)
        ref_dq = cuda_ops.flash_attention_bwd_dq_reference(*args)
        row['past_hop'] = hop_check(torch, pout, plse, ref_out, ref_lse,
                                    (dq, dk, dv), (ref_dq, ref_dk, ref_dv))

    # attention(impl='ring') against impl='full' at dryrun phase (j)'s
    # shape, float32, over an sp axis of all four ranks
    mesh4 = pmesh.make_mesh({'sp': MESH_J_SP})
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    qkv = [torch.randn((2, 2, 16 * MESH_J_SP, 8), generator=gen, device=dev)
           for _ in range(3)]
    with pmesh.use_mesh(mesh4):
        full = tfm.attention(*qkv, causal=True, impl='full')
        row['ring_vs_full'] = {}
        for use_flash in (False, True):
            ring = tfm.attention(*qkv, causal=True, impl='ring',
                                 use_flash=use_flash)
            err = (ring - full).abs()
            row['ring_vs_full']['flash' if use_flash else 'plain'] = dict(
                max_abs_err=float(err.max()), ok=bool(
                    (err <= F32_TOL['atol'] + F32_TOL['rtol'] *
                     full.abs()).all()))
    with open(os.path.join(out_dir, 'rank%d.json' % rank), 'w') as f:
        json.dump(row, f)


def ring_gate(rows):
    """What is wrong with phase 27's ranks' rows (empty when nothing)."""
    bad = []
    layers = GPT2_MEDIUM['layers']
    fwd = [0] * MESH_RING_STEPS
    for row in rows:
        r, sp = row['rank'], row['coordinate']['sp']
        want = [layers * (sp + 1)] * 3
        if row['launches_per_step'] != [want] * MESH_RING_STEPS:
            bad.append('rank %d (sp %d): launches %s, expected %s a step'
                       % (r, sp, row['launches_per_step'], want))
        for i, counts in enumerate(row['launches_per_step']):
            fwd[i] += counts[0]
        if row['fp32_launches'] != [FP32_LAYERS * (sp + 1)] * 3:
            bad.append('rank %d: float32 launches %s' % (r,
                                                         row['fp32_launches']))
        if row['backend'] != 'gloo' or not row['staged'] or \
                not row['staged_bytes_per_step'] > 0:
            bad.append('rank %d: backend %s, staged %s, %s bytes' % (
                r, row['backend'], row['staged'],
                row['staged_bytes_per_step']))
        if row['loss'] != rows[0]['loss']:
            bad.append('rank %d: loss %r, rank 0 %r' % (r, row['loss'],
                                                         rows[0]['loss']))
        hops = [('diagonal', row['hop'])]
        if sp:              # sp-rank 1's past block runs unmasked
            if 'past_hop' not in row:
                bad.append('rank %d (sp %d): the past hop\'s kernels '
                           'were not checked' % (r, sp))
            else:
                hops.append(('past', row['past_hop']))
        for kind, hop in hops:
            for name in ('out', 'dq', 'dk', 'dv'):
                if not hop[name]['ok']:
                    bad.append('rank %d: the %s hop\'s %s kernel off its '
                               'plain version: %s' % (r, kind, name,
                                                      hop[name]))
            if not hop['lse_ok']:
                bad.append('rank %d: %s hop lse off by %.3g' % (
                    r, kind, hop['lse_max_abs_err']))
        for kind, check in row['ring_vs_full'].items():
            if not check['ok']:
                bad.append('rank %d: %s ring vs full attention %.3g'
                           % (r, kind, check['max_abs_err']))
    want_fwd = layers * sum(c['sp'] + 1 for c in
                            (row['coordinate'] for row in rows))
    if fwd != [want_fwd] * MESH_RING_STEPS:
        bad.append('forward launches over the ranks %s a step, expected %d'
                   % (fwd, want_fwd))
    r0 = rows[0]
    if abs(r0['loss'] - r0['one_device_loss']) > LM_NLL_ATOL:
        bad.append('bf16 loss %.5f vs one-device %.5f (tol %g)' % (
            r0['loss'], r0['one_device_loss'], LM_NLL_ATOL))
    if not r0['fp32_params']['ok']:
        bad.append('float32 parameters off the one-device step: %s'
                   % r0['fp32_params'])
    if not r0['fp32_updates']['ok']:
        bad.append('float32 updates off the one-device step: %s'
                   % r0['fp32_updates'])
    return bad


def ring_phase(torch, pmesh, root, smi):
    """Phase 27: MESH_RANKS processes share the card over gloo and train
    the LM at MESH_RING; their rows are gated by ring_gate."""
    out = root / 'build' / 'phase27'
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        pmesh.spawn(mesh_rank, MESH_RANKS, out / 'rendezvous',
                    args=(str(out),))
    except Exception as e:          # a rank's own traceback is above
        fail('phase 27: a rank failed: %s' % e)
    wall_s = time.perf_counter() - t0
    rows = []
    for r in range(MESH_RANKS):
        with open(out / ('rank%d.json' % r)) as f:
            rows.append(json.load(f))
    shutil.rmtree(out, ignore_errors=True)
    step_ms = [sorted(row['step_ms'])[len(row['step_ms']) // 2]
               for row in rows]
    # the busy share: every rank's device time in one profiled step, taken
    # after its timed steps, summed over the slowest rank's median step
    device_ms = [row['profiled_device_ms'] for row in rows]
    busy = sum(device_ms) / max(step_ms)
    run = dict(config='gpt2-medium widths, %d layers, bf16, mesh %s, %d '
               'ranks on one card over gloo' % (GPT2_MEDIUM['layers'],
                                                MESH_RING, MESH_RANKS),
               card=smi, wall_s=wall_s, step_ms_by_rank=step_ms,
               profiled_device_ms_by_rank=device_ms,
               launches=[sum(row['launches'][i] for row in rows)
                         for i in range(3)],
               staged_bytes_per_step_by_rank=[
                   row['staged_bytes_per_step'] for row in rows],
               device_busy_share=busy, ranks=rows)
    print('ring ' + json.dumps(run))
    bad = ring_gate(rows)
    if bad:
        fail('phase 27: ' + '; '.join(bad))
    print('ring: %d ranks on one card (%s): step ms by rank %s, host-staged '
          'MB a step by rank %s, device ms of a profiled step by rank %s, '
          'the card busy %.1f %% of a step (their sum over the slowest '
          'rank\'s median step), float32 parameters within F32_TOL (max '
          '%.3g) and updates within %.3g of their leaf\'s largest (%.3g of '
          'the bound), bf16 loss %.5f vs %.5f; phase took %.1f s' % (
              MESH_RANKS, smi, ['%.1f' % ms for ms in step_ms],
              ['%.1f' % (row['staged_bytes_per_step'] / 1e6) for row in rows],
              ['%.1f' % ms for ms in device_ms], 100 * busy,
              rows[0]['fp32_params']['max_abs_err'],
              rows[0]['fp32_updates']['max_err_of_leaf_update'],
              rows[0]['fp32_updates']['max_err_over_bound'], rows[0]['loss'], rows[0]['one_device_loss'], wall_s))
    return run


# -- phases 28 and 29: a Module over several contexts, ZeRO-1 -----------------

DP_STEPS = 3                 # steps with ZeRO 0, then 3 with ZeRO 1
DP_FIT_BULK = 2              # fit(bulk=2) over 2 batches: one dispatch
DP_OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
              multi_precision=True)
DP_RANKS = 2
DP_SEED = SEED + 2800
# phase 29's ZeRO-1 optimizer state a rank against phase 28's replicated
# one: half of it and the padding of each bucket to the data size
DP_STATE_SHARE = 0.55
# phase 29's first step against phase 28's world-1 step, from the same
# seeded weights on the same global batch: the ranks sum each BatchNorm's
# float32 statistics over the two halves of the batch, which rounds them
# otherwise than the one device's sum over all of it; a bf16 activation
# can then move by one bf16 step (2^-8 of it), and the network carries
# that to its output. The loss (the batch's mean NLL, about ln 1000) is
# held within DP_LOSS_ATOL, each output probability within DP_OUT_ATOL.
DP_LOSS_ATOL = 0.02
DP_OUT_ATOL = 0.02
DP_CUT_BATCH = 8             # the float32 cut ResNet's global batch


def dp_resnet(mx, batch, seed=DP_SEED):
    """Phase 10's bf16 ResNet-50 symbol and seeded He-normal values, the
    data and label left out."""
    symbol = mx.models.resnet.get_symbol(**RESNET)
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    args, auxs = resnet_params(symbol, dict(data=(batch,) + shape),
                               RESNET['num_classes'], seed)
    return symbol, shape, ({k: v for k, v in args.items()
                            if k not in NO_GRAD}, auxs)


def dp_batches(mx, shape, n, seed, batch=RESNET_BATCH):
    """n seeded global batches of `batch` images on the host, batch i
    drawn from seed + i (so that a prefix of them is the same batches):
    the numpy arrays (x, y) and the DataBatches."""
    xy = [module_data(RESNET['num_classes'], batch, shape, seed + i)
          for i in range(n)]
    return xy, [mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                                label=[mx.nd.array(y, ctx=mx.cpu())])
                for x, y in xy]


def dp_module(mx, symbol, ctxs, batch, shape, params, zero, opt=None):
    mod = mx.mod.Module(symbol, context=ctxs)
    mod.bind(data_shapes=[mx.io.DataDesc('data', (batch,) + shape)],
             label_shapes=[mx.io.DataDesc('softmax_label', (batch,))])
    cpu = mx.cpu()
    mod.init_params(initializer=None,
                    arg_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in params[0].items()},
                    aux_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in params[1].items()})
    mod.init_optimizer(optimizer='sgd',
                       optimizer_params=dict(opt or DP_OPT), zero=zero)
    return mod


def dp_nll(torch, out, label):
    """The batch's mean NLL of the (gathered) softmax output."""
    p = out.handle.float()
    lab = label.handle.long().to(p.device)
    return float(-torch.log(p.gather(1, lab[:, None]).clamp(min=1e-30))
                 .mean())


def dp_steps(torch, mx, cuda_conv, mod, batches):
    """forward_backward + update over `batches`: each step's ms, conv
    launches, loss and (for the first) its gathered output."""
    rows = []
    for i, b in enumerate(batches):
        before = cuda_conv.CONV_BN_STATS_LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(b)
        mod.update()
        torch.cuda.synchronize()
        row = dict(ms=(time.perf_counter() - t0) * 1e3,
                   launches=cuda_conv.CONV_BN_STATS_LAUNCHES - before)
        out = mod.get_outputs()[0]
        row['loss'] = dp_nll(torch, out, b.label[0])
        if i == 0:
            row['output'] = out.handle.float().cpu()
        rows.append(row)
    return rows


def dp_state(mod):
    """Weights and moving statistics by name, host copies."""
    args, auxs = mod.get_params()
    state = {'arg ' + k: v.handle.cpu() for k, v in args.items()}
    state.update(('aux ' + k, v.handle.cpu()) for k, v in auxs.items())
    return state


def dp_digest(torch, tensors):
    """One sha256 over the bytes of every tensor, by sorted name."""
    import hashlib
    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        h.update(name.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dp_mesh_phase(torch, mx, cuda_conv, pmesh, profiler, root, smi):
    """Phase 28: the bf16 ResNet-50 through Module(context=[gpu(0)]) as
    the one rank of a data mesh over NCCL: 3 steps with ZeRO 0, its
    states carried into ZeRO 1 for 3 more, then fit(bulk=2) on
    io.prefetch_to_device(mesh=); held against the one-device Module on
    the same batches (no process group)."""
    out = root / 'build' / 'phase28'
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    symbol, shape, params = dp_resnet(mx, RESNET_BATCH)
    xy, batches = dp_batches(mx, shape, 2 * DP_STEPS + DP_FIT_BULK,
                             DP_SEED + 1)
    fit_x = np.concatenate([x for x, _ in xy[2 * DP_STEPS:]])
    fit_y = np.concatenate([y for _, y in xy[2 * DP_STEPS:]])
    del xy
    try:
        # the one-device Module: six steps and the same fit
        ref = dp_module(mx, symbol, [mx.gpu(0)], RESNET_BATCH, shape,
                        params, 0)
        assert ref._exec_group.mesh is None
        ref_rows = dp_steps(torch, mx, cuda_conv, ref,
                            batches[:2 * DP_STEPS])
        ref.fit(mx.io.NDArrayIter(fit_x, fit_y, batch_size=RESNET_BATCH),
                num_epoch=1, bulk=DP_FIT_BULK, eval_metric='acc')
        ref_state = dp_state(ref)
        del ref
        torch.cuda.empty_cache()

        pmesh.init_process_group(device='cuda:0', rank=0, world_size=1,
                                 init_method='file://%s' % (out / 'rdv'))
        try:
            mod = dp_module(mx, symbol, [mx.gpu(0)], RESNET_BATCH, shape,
                            params, 0)
            eg = mod._exec_group
            mesh = eg.mesh
            backend = None if mesh is None else mesh.backend
            profiler.clear()
            stats = profiler.mesh_stats()
            # the main path: the count set to 0 just before, read after
            cuda_conv.CONV_BN_STATS_LAUNCHES = 0
            z0 = dp_steps(torch, mx, cuda_conv, mod, batches[:DP_STEPS])
            z0_bytes = mod._fused_updater.state_bytes_per_device()
            blob = mod._fused_updater.get_states()
            mod.init_optimizer(optimizer='sgd',
                               optimizer_params=dict(DP_OPT), zero=1,
                               force_init=True)
            mod._fused_updater.set_states(blob)
            z1 = dp_steps(torch, mx, cuda_conv, mod,
                          batches[DP_STEPS:2 * DP_STEPS])
            z1_bytes = mod._fused_updater.state_bytes_per_device()
            staged = mx.io.prefetch_to_device(
                mx.io.NDArrayIter(fit_x, fit_y, batch_size=RESNET_BATCH),
                mesh=mesh)
            before = cuda_conv.CONV_BN_STATS_LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.fit(staged, num_epoch=1, bulk=DP_FIT_BULK,
                    eval_metric='acc')
            torch.cuda.synchronize()
            fit_ms = (time.perf_counter() - t0) * 1e3
            fit_launches = cuda_conv.CONV_BN_STATS_LAUNCHES - before
            launches = cuda_conv.CONV_BN_STATS_LAUNCHES
            after = profiler.mesh_stats()
            comm = profiler.comm_stats()
            state = dp_state(mod)
            del mod, eg, staged
        finally:
            pmesh.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(out, ignore_errors=True)
    names = sorted(ref_state)
    check = leaves_within(torch, [state[k] for k in names],
                          [ref_state[k] for k in names], MESH_W_RTOL, 0.0)
    per_step = [r['launches'] for r in z0 + z1]
    want = route_pairs(RESNET_PAIRS, stem_split_on())
    run = dict(
        config='bf16 ResNet-50, batch %d, Module(context=[gpu(0)]) as '
               'the one rank of a data mesh' % RESNET_BATCH,
        card=smi, backend=backend, launches=launches,
        launches_per_step=per_step, fit_launches=fit_launches,
        step_ms_z0=[r['ms'] for r in z0], step_ms_z1=[r['ms'] for r in z1],
        one_device_step_ms=[r['ms'] for r in ref_rows],
        fit_ms=fit_ms, loss=[r['loss'] for r in z0 + z1],
        one_device_loss=[r['loss'] for r in ref_rows],
        state_bytes_z0=z0_bytes, state_bytes_z1=z1_bytes,
        staged_bytes=after['mesh_staged_bytes'] - stats['mesh_staged_bytes'],
        collectives=after['mesh_collectives'] - stats['mesh_collectives'],
        comm=comm, params=check)
    print('dp mesh ' + json.dumps(run))
    if backend != 'nccl':
        fail('phase 28: world 1 on one card took %s, not NCCL' % backend)
    if per_step != [want] * (2 * DP_STEPS) or \
            fit_launches != want * DP_FIT_BULK:
        fail('phase 28: conv launches %s a step and %d in fit, expected %d '
             'a step' % (per_step, fit_launches, want))
    if run['staged_bytes']:
        fail('phase 28: an NCCL group staged %d bytes' % run['staged_bytes'])
    if not check['ok']:
        fail('phase 28: parameters or moving statistics off the one-device '
             'Module\'s: %s' % check)
    run['reference'] = dict(output=z0[0]['output'], loss=z0[0]['loss'])
    print('dp mesh: world 1 over NCCL, %d conv launches a step, step ms '
          'ZeRO 0 %s, ZeRO 1 %s (one device %s), fit(bulk=%d) %.1f ms, '
          'optimizer state %.1f MB (ZeRO 0) / %.1f MB (ZeRO 1) a rank, '
          'parameters and moving statistics %s' % (
              want, ['%.1f' % r['ms'] for r in z0],
              ['%.1f' % r['ms'] for r in z1],
              ['%.1f' % r['ms'] for r in ref_rows], DP_FIT_BULK, fit_ms,
              z0_bytes / 1e6, z1_bytes / 1e6,
              'bit-equal' if check['bit_equal'] else
              'within one bf16 step (%.3g %% differ)'
              % (100 * check['share_differ'])))
    return run


def dp_cut_step(torch, mx, ctxs, plant=None):
    """One float32 step of the cut ResNet at DP_CUT_BATCH: the weights
    before and after, by name; `plant` replaces BatchNorm's statistic
    sum (ops.nn._sync_sum)."""
    from mxnet_tpu_torch.ops import nn as ops_nn
    symbol = mx.models.resnet.resnet(dtype='float32', **CUT_RESNET)
    shape = CUT_RESNET['image_shape']
    args, auxs = resnet_params(symbol, dict(data=(DP_CUT_BATCH,) + shape),
                               CUT_RESNET['num_classes'], DP_SEED + 5)
    batch = mx.io.DataBatch(data=[mx.nd.array(args['data'], ctx=mx.cpu())],
                            label=[mx.nd.array(args['softmax_label'],
                                               ctx=mx.cpu())])
    params = ({k: v for k, v in args.items() if k not in NO_GRAD}, auxs)
    mod = dp_module(mx, symbol, ctxs, DP_CUT_BATCH, shape, params, 0,
                    opt=dict(learning_rate=0.1, momentum=0.9, wd=1e-4))
    old = {k: v.handle.clone() for k, v in mod.get_params()[0].items()}
    sync_sum = ops_nn._sync_sum
    if plant is not None:
        ops_nn._sync_sum = plant
    try:
        mod.forward_backward(batch)
        mod.update()
    finally:
        ops_nn._sync_sum = sync_sum
    new = {k: v.handle.clone() for k, v in mod.get_params()[0].items()}
    return old, new


def dp_worker(out_dir):
    """One rank of phase 29, run by the port's launcher with
    MXNET_TPU_DIST_JAX=1: the dist runtime and one torch.distributed
    group over the two workers (gloo: they share the card), then
    Module(context=[gpu(0), gpu(1)]) trains the bf16 ResNet-50 at global
    batch 256 with ZeRO 1, interleave on; its row, digests, checkpoint
    and (rank 0) the gathered optimizer states go to out_dir."""
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _build, cuda_conv, dist, elastic, profiler
    from mxnet_tpu_torch import executor as executor_mod
    torch.zeros(1, device='cuda')
    _build.library()
    rt = dist.initialize()
    rank = rt.rank
    out_dir = Path(out_dir)
    symbol, shape, params = dp_resnet(mx, RESNET_BATCH)
    _, batches = dp_batches(mx, shape, DP_STEPS, DP_SEED + 1)
    mod = dp_module(mx, symbol, [mx.gpu(0), mx.gpu(1)], RESNET_BATCH, shape,
                    params, 1)
    eg = mod._exec_group
    mesh = eg.mesh
    ex = eg.executor
    row = dict(rank=rank, data=mesh.shape['data'], backend=mesh.backend,
               staged=mesh.staged, device=str(mesh.device),
               local_batch=eg.local_batch,
               host_span=dist.host_span_active())
    profiler.clear()
    stats = profiler.mesh_stats()
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    steps = dp_steps(torch, mx, cuda_conv, mod, batches)
    row['launches'] = cuda_conv.CONV_BN_STATS_LAUNCHES
    after = profiler.mesh_stats()
    row.update(launches_per_step=[s['launches'] for s in steps],
               step_ms=[s['ms'] for s in steps],
               loss=[s['loss'] for s in steps], comm=profiler.comm_stats(),
               **{k + '_per_step': (after['mesh_' + k] - stats['mesh_' + k])
                  / DP_STEPS for k in ('collectives', 'payload_bytes',
                                       'staged_bytes')})
    row['state_bytes'] = mod._fused_updater.state_bytes_per_device()
    state = dp_state(mod)
    row['param_digest'] = dp_digest(torch, {k: v for k, v in state.items()
                                           if k.startswith('arg ')})
    row['aux_digest'] = dp_digest(torch, {k: v for k, v in state.items()
                                         if k.startswith('aux ')})
    if rank == 0:
        torch.save(steps[0]['output'], str(out_dir / 'output0.pt'))
    # the elastic ZeRO checkpoint: each rank its blocks; and the states
    # gathered over the mesh, for the world-1 restore
    mgr = elastic.CheckpointManager(str(out_dir / 'ckpt'), async_=False)
    mgr.attach(mod)
    mgr._step = DP_STEPS
    mgr.save(sync=True)
    blob = mod._fused_updater.get_states()
    if rank == 0:
        (out_dir / 'states.pkl').write_bytes(blob)
    del blob, state
    # the busy share: one profiled step's device time
    b = batches[0]
    events = device_events(torch, lambda: (mod.forward_backward(b),
                                           mod.update()))
    row['profiled_device_ms'] = sum(device_us(e) for e in events) / 1e3
    shapes = pair_shapes(symbol, eg.local_batch, shape, executor_mod,
                         pairs=dict(ex.pairs))
    del mod, eg, ex
    torch.cuda.empty_cache()
    # the kernel at this rank's shapes against its plain version
    checks = resnet_kernel_checks(torch, cuda_conv, executor_mod, shapes,
                                  mesh.device)
    row['kernel_checks'] = [dict(x=r['x'], w=r['w'], stride=r['stride'],
                                 pairs=r['pairs'],
                                 max_abs_err=r['y']['max_abs_err'],
                                 ok=r['ok']) for r in checks]
    # the float32 cut ResNet's step against the one-device step, and with
    # per-rank statistics planted
    old, new = dp_cut_step(torch, mx, [mx.gpu(0), mx.gpu(1)])
    _, planted = dp_cut_step(torch, mx, [mx.gpu(0), mx.gpu(1)],
                             plant=lambda x, m: x * m.axis_size('data'))
    if rank == 0:
        _, ref = dp_cut_step(torch, mx, [mx.gpu(0)])
        names = sorted(ref)
        row['cut_updates'] = updates_within(
            torch, [new[k] for k in names], [old[k] for k in names],
            [ref[k] for k in names], MESH_UPDATE_RTOL)
        row['cut_planted_updates'] = updates_within(
            torch, [planted[k] for k in names], [old[k] for k in names],
            [ref[k] for k in names], MESH_UPDATE_RTOL)
    with open(out_dir / ('rank%d.json' % rank), 'w') as f:
        json.dump(row, f)
    dist.shutdown()


def dp_gate(rows, world1):
    """What is wrong with phase 29's ranks' rows (empty when nothing)."""
    bad = []
    want = route_pairs(RESNET_PAIRS, stem_split_on())
    for row in rows:
        r = row['rank']
        if (row['data'], row['backend'], row['staged'],
                row['local_batch'], row['host_span']) != \
                (DP_RANKS, 'gloo', True, RESNET_BATCH // DP_RANKS, False):
            bad.append('rank %d: data %s, backend %s, staged %s, local '
                       'batch %s, host span %s' % (
                           r, row['data'], row['backend'], row['staged'],
                           row['local_batch'], row['host_span']))
        if row['launches_per_step'] != [want] * DP_STEPS:
            bad.append('rank %d: conv launches %s, expected %d a step'
                       % (r, row['launches_per_step'], want))
        for c in row['kernel_checks']:
            if not c['ok']:
                bad.append('rank %d: the kernel off its plain version at '
                           '%s %s' % (r, c['x'], c['w']))
        limit = DP_STATE_SHARE * world1['state_bytes_z0']
        if row['state_bytes'] > limit:
            bad.append('rank %d: optimizer state %d bytes > %.0f'
                       % (r, row['state_bytes'], limit))
        if row['comm']['zero_wire_all_reduce'] <= 0 or \
                row['comm']['bytes_reduce_scattered'] <= 0:
            bad.append('rank %d: no ZeRO bucket on the wire: %s'
                       % (r, row['comm']))
        for key in ('param_digest', 'aux_digest', 'loss'):
            if row[key] != rows[0][key]:
                bad.append('rank %d: %s differs from rank 0\'s' % (r, key))
    r0 = rows[0]
    if abs(r0['loss'][0] - world1['reference']['loss']) > DP_LOSS_ATOL:
        bad.append('first-step loss %.5f vs world 1 %.5f (tol %g)' % (
            r0['loss'][0], world1['reference']['loss'], DP_LOSS_ATOL))
    if r0['output_max_abs_err'] > DP_OUT_ATOL:
        bad.append('first-step outputs %.4g from world 1\'s (tol %g)' % (
            r0['output_max_abs_err'], DP_OUT_ATOL))
    if not r0['cut_updates']['ok']:
        bad.append('float32 cut ResNet updates off the one-device step: %s'
                   % r0['cut_updates'])
    if r0['cut_planted_updates']['ok']:
        bad.append('the planted per-rank statistics passed the update '
                   'gate: %s' % r0['cut_planted_updates'])
    if not r0['restore']['ok']:
        bad.append('the ZeRO checkpoint restored at world 1 differs: %s'
                   % r0['restore'])
    return bad


def dp_restore_check(torch, mx, out):
    """The ranks' ZeRO checkpoint restored into a world-1 Module (2 -> 1):
    its momenta and masters against the ones the ranks gathered."""
    import pickle
    from mxnet_tpu_torch import elastic
    symbol, shape, params = dp_resnet(mx, RESNET_BATCH)
    mod = dp_module(mx, symbol, [mx.gpu(0)], RESNET_BATCH, shape, params, 1)
    info = elastic.resume(elastic.CheckpointManager(str(out / 'ckpt')), mod)
    got = pickle.loads(mod._fused_updater.get_states())
    want = pickle.loads((out / 'states.pkl').read_bytes())
    del mod
    torch.cuda.empty_cache()
    differ = []
    for part in (0, 2):
        if sorted(got[part]) != sorted(want[part]):
            differ.append('names of part %d' % part)
            continue
        for k, v in want[part].items():
            if v is None and got[part][k] is None:
                continue
            if not np.array_equal(np.asarray(got[part][k]), np.asarray(v)):
                differ.append(k)
    return dict(ok=info is not None and info.step == DP_STEPS and
                not differ, step=None if info is None else info.step,
                differ=differ[:8], momenta=len(want[0]),
                masters=sum(v is not None for v in want[2].values()))


def dp_start(root):
    """Phase 29's launch, started: (its directory, the Launch)."""
    out = fresh_dir(root, 29)
    return out, start_launch(root, out, 'dp', 'dp', DP_RANKS, 0,
                             env={'MXNET_TPU_DIST_JAX': '1',
                                  'MXNET_TPU_INTERLEAVE_REDUCE': '1'})


def dp_ranks_phase(torch, mx, root, smi, world1, started=None):
    """Phase 29: DP_RANKS workers of the port's launcher share the card
    (MXNET_TPU_DIST_JAX=1, gloo) and train the bf16 ResNet-50 as one data
    mesh with ZeRO 1; gated by dp_gate against phase 28's world-1 step."""
    if started is None:
        torch.cuda.empty_cache()
        started = dp_start(root)
    out, launch = started
    try:
        res, wall = launch.wait()
        if res.returncode != 0:
            fail('phase 29: the launcher exited %d (its log is named above)'
                 % res.returncode)
        rows = []
        for r in range(DP_RANKS):
            with open(out / ('rank%d.json' % r)) as f:
                rows.append(json.load(f))
        got = torch.load(str(out / 'output0.pt'))
        rows[0]['output_max_abs_err'] = float(
            (got - world1['reference']['output']).abs().max())
        rows[0]['restore'] = dp_restore_check(torch, mx, out)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    step_ms = [median(row['step_ms']) for row in rows]
    device_ms = [row['profiled_device_ms'] for row in rows]
    busy = sum(device_ms) / max(step_ms)
    run = dict(config='bf16 ResNet-50, global batch %d, Module(context='
               '[gpu(0), gpu(1)]), ZeRO 1, %d ranks on one card over gloo'
               % (RESNET_BATCH, DP_RANKS), card=smi, wall_s=wall,
               step_ms_by_rank=step_ms, profiled_device_ms_by_rank=device_ms,
               device_busy_share=busy,
               launches=sum(row['launches'] for row in rows),
               state_bytes_by_rank=[row['state_bytes'] for row in rows],
               world1_state_bytes_z0=world1['state_bytes_z0'],
               ranks=rows)
    print('dp ranks ' + json.dumps(run))
    bad = dp_gate(rows, world1)
    if bad:
        fail('phase 29: ' + '; '.join(bad))
    r0 = rows[0]
    print('dp ranks: %d ranks on one card (%s): step ms by rank %s, '
          'collectives %s and host-staged MB %s a step by rank, optimizer '
          'state %.1f MB a rank (world 1, ZeRO 0: %.1f MB), the card busy '
          '%.1f %% of a step; first-step loss %.5f vs %.5f, outputs within '
          '%.3g; float32 cut ResNet updates within %.3g of their leaf\'s '
          'largest, the planted per-rank statistics %.3g of the bound; the '
          'checkpoint restored at world 1 (%d momenta, %d masters); phase '
          'took %.1f s' % (
              DP_RANKS, smi, ['%.1f' % ms for ms in step_ms],
              [row['collectives_per_step'] for row in rows],
              ['%.1f' % (row['staged_bytes_per_step'] / 1e6) for row in rows],
              r0['state_bytes'] / 1e6, world1['state_bytes_z0'] / 1e6,
              100 * busy, r0['loss'][0], world1['reference']['loss'],
              r0['output_max_abs_err'],
              r0['cut_updates']['max_err_of_leaf_update'],
              r0['cut_planted_updates']['max_err_over_bound'],
              r0['restore']['momenta'], r0['restore']['masters'], wall))
    return run


# ---------------------------------------------------------------------------
# Phase 30: the fused Gluon step trains the bf16 ResNet-50 v1
# ---------------------------------------------------------------------------

GF_BATCH = 256
GF_SIDE = 224
GF_CLASSES = 1000
GF_OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
              multi_precision=True)
GF_SEED = SEED + 3000
GF_STEPS = 3                 # single fused steps, then bulk(GF_BULK)
GF_BULK = 2
# gluon.model_zoo.vision.resnet50_v1's conv -> BatchNorm pairs the route
# takes, counted from the code (gf_pairs): the stem, the 16 bottlenecks'
# 3x3 convs and the 4 projections; each bottleneck's two 1x1 convs carry
# a bias (BottleneckV1, vision.py) and stay on cuDNN
GF_PAIRS = 21
# the fused step's first loss (mean over the batch, about ln 1000)
# against the unfused step's (autograd.record + Trainer.step, phase 13's
# path, cuDNN convs and BatchNorm's one-pass sums of the rounded bf16 y)
# on the same weights and batch: the two round the statistics otherwise,
# and bf16 carries that through 50 layers
GF_LOSS_ATOL = 0.02
# the float32 cut net: ResNetV1 with one bottleneck a stage at 64^2
GF_CUT = dict(layers=[1, 1, 1, 1], channels=[16, 64, 128, 256, 512],
              classes=10)
GF_CUT_BATCH = 8
GF_CUT_SIDE = 64


def gf_pairs(gluon, net):
    """The conv -> BatchNorm pairs of `net` the fused step's route takes
    (gluon/fused.py: adjacent children of a HybridSequential, a 2-D conv
    with no bias, no activation, groups 1 and dilation 1, then a
    BatchNorm on axis 1 without use_global_stats)."""
    nn = gluon.nn
    count = 0
    stack = [net]
    while stack:
        b = stack.pop()
        kids = list(b._children)
        stack.extend(kids)
        if type(b) is not nn.HybridSequential:
            continue
        for c, n in zip(kids, kids[1:]):
            kw = getattr(c, '_kwargs', {})
            if type(c) is nn.Conv2D and type(n) is nn.BatchNorm and \
                    kw['no_bias'] and c.act is None and \
                    len(kw['kernel']) == 2 and kw['num_group'] == 1 and \
                    all(d == 1 for d in kw['dilate']) and \
                    n._kwargs['axis'] in (1, -3) and \
                    not n._kwargs['use_global_stats']:
                count += 1
    return count


def gf_net(torch, mx, ctx, state=None):
    """resnet50_v1 (1000 classes) on ctx in bf16, its shapes completed by
    one float32 forward; Xavier from GF_SEED, or `state`."""
    mx.random.seed(GF_SEED)
    net = mx.gluon.model_zoo.vision.resnet50_v1(classes=GF_CLASSES)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(mx.nd.zeros((1, 3, GF_SIDE, GF_SIDE), ctx=ctx))
    net.cast('bfloat16')
    if state is not None:
        gluon_set_state(net, state)
    return net


def gf_batches(torch, mx, ctx, n):
    """n seeded batches of GF_BATCH bf16 images and labels on ctx."""
    dev = ctx.torch_device
    gen = torch.Generator(device=dev).manual_seed(GF_SEED + 1)
    out = []
    for _ in range(n):
        x = torch.randn((GF_BATCH, 3, GF_SIDE, GF_SIDE), generator=gen,
                        device=dev).to(torch.bfloat16)
        y = torch.randint(0, GF_CLASSES, (GF_BATCH,), generator=gen,
                          device=dev).float()
        out.append((mx.nd.NDArray(x, ctx), mx.nd.NDArray(y, ctx)))
    return out


def gf_cut_step(torch, mx, ctx, route, plant=False):
    """One fused float32 step of the cut ResNet v1 (GF_CUT) on ctx: the
    weights before and after, by name. `route` puts its float32 pairs on
    the conv kernel (float32 FMA); `plant` hands each pair's BatchNorm
    the statistics of an earlier pair of its width (or its own, one
    channel off)."""
    from mxnet_tpu_torch import executor as ex_mod
    from mxnet_tpu_torch.gluon import fused
    from mxnet_tpu_torch.gluon.model_zoo import vision
    gluon = mx.gluon
    mx.random.seed(GF_SEED + 7)
    net = vision.ResNetV1(vision.BottleneckV1, GF_CUT['layers'],
                          GF_CUT['channels'], classes=GF_CUT['classes'])
    net.initialize(mx.init.Xavier(), ctx=ctx)
    dev = ctx.torch_device
    gen = torch.Generator(device=dev).manual_seed(GF_SEED + 8)
    x = torch.randn((GF_CUT_BATCH, 3, GF_CUT_SIDE, GF_CUT_SIDE),
                    generator=gen, device=dev)
    y = torch.randint(0, GF_CUT['classes'], (GF_CUT_BATCH,), generator=gen,
                      device=dev).float()
    x, y = mx.nd.NDArray(x, ctx), mx.nd.NDArray(y, ctx)
    net(x)
    tr = gluon.Trainer(net.collect_params(), 'sgd',
                       dict(learning_rate=0.1, momentum=0.9, wd=1e-4))
    fs = gluon.fuse_step(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    old = {k: v.clone() for k, v in gluon_param_state(net).items()}
    dtypes, pair_conv = fused._PairRoute.dtypes, ex_mod.pair_conv
    seen = {}

    def planted(xt, w, stride, pad):
        yt, (s1, s2) = pair_conv(xt, w, stride, pad)
        prev = seen.get(s1.shape[0])
        seen[s1.shape[0]] = (s1, s2)
        if prev is None:
            return yt, (s1.roll(1), s2.roll(1))
        return yt, prev

    if route:
        fused._PairRoute.dtypes = (torch.bfloat16, torch.float32)
    if plant:
        ex_mod.pair_conv = planted
    try:
        fs(x, y)
    finally:
        fused._PairRoute.dtypes, ex_mod.pair_conv = dtypes, pair_conv
    new = gluon_param_state(net)
    return old, new, fs.routed_pairs


def gf_gate(run):
    """Phase 30's checks on a run's numbers: a list of what failed."""
    bad = []
    if run['pairs_in_code'] != GF_PAIRS:
        bad.append('resnet50_v1 has %d routable pairs in the code, not %d'
                   % (run['pairs_in_code'], GF_PAIRS))
    want = [GF_PAIRS] * GF_STEPS
    if run['launches_per_step'] != want or \
            run['routed_per_step'] != want:
        bad.append('conv launches %s (routed %s) a step, expected %d'
                   % (run['launches_per_step'], run['routed_per_step'],
                      GF_PAIRS))
    if run['bulk_launches'] != GF_PAIRS * GF_BULK:
        bad.append('bulk(%d) launched the kernel %d times, expected %d'
                   % (GF_BULK, run['bulk_launches'], GF_PAIRS * GF_BULK))
    for c in run['kernel_checks']:
        if not c['ok']:
            bad.append('the kernel off its plain version at %s %s'
                       % (c['x'], c['w']))
    if sum(c['pairs'] for c in run['kernel_checks']) != GF_PAIRS:
        bad.append('the shapes checked cover %d pairs, not %d' % (
            sum(c['pairs'] for c in run['kernel_checks']), GF_PAIRS))
    if not all(math.isfinite(v) for v in run['losses']):
        bad.append('losses %s' % run['losses'])
    if abs(run['losses'][0] - run['unfused_loss']) > GF_LOSS_ATOL:
        bad.append('first fused loss %.5f vs the unfused step\'s %.5f '
                   '(tol %g)' % (run['losses'][0], run['unfused_loss'],
                                 GF_LOSS_ATOL))
    if not run['bulk_equal']:
        bad.append('bulk(%d) differs from %d single steps in %s'
                   % (GF_BULK, GF_BULK, run['bulk_differ']))
    if not run['step_ahead_equal']:
        bad.append('step_ahead 0 and 1 gave different losses or weights')
    if run['cut_routed'] <= 0 or not run['cut_updates']['ok']:
        bad.append('float32 cut net: %d pairs routed, updates %s'
                   % (run['cut_routed'], run['cut_updates']))
    if run['cut_planted_updates']['ok']:
        bad.append('statistics from the wrong pair passed the update gate: '
                   '%s' % run['cut_planted_updates'])
    return bad


def gluon_fused_phase(torch, mx, cuda_conv, smi, ctx=None):
    """Phase 30: gluon.fuse_step trains model_zoo resnet50_v1 in bf16 at
    batch 256 (SGD, momentum 0.9, wd 1e-4, float32 masters): GF_STEPS
    single fused steps (step_ahead 1), then on a second net from the same
    weights bulk(GF_BULK) and one more step with step_ahead 0; the
    unfused step (autograd.record + Trainer.step) from the same weights
    on the first batch; the kernel at every routed shape against its
    plain version; a float32 cut net's step with its pairs on the kernel
    against it with them off, and with the statistics planted from the
    wrong pair. Gated by gf_gate."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import executor as executor_mod
    gluon = mx.gluon
    ctx = ctx or mx.gpu(0)
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    try:
        net = gf_net(torch, mx, ctx)
        pairs_in_code = gf_pairs(gluon, net)
        state = {k: v.clone() for k, v in gluon_param_state(net).items()}
        batches = gf_batches(torch, mx, ctx, GF_STEPS)

        # the unfused step, phase 13's path, on the first batch
        ref = gf_net(torch, mx, ctx, state)
        tr = gluon.Trainer(ref.collect_params(), 'sgd', dict(GF_OPT))
        with autograd.record():
            loss = loss_fn(ref(batches[0][0]), batches[0][1])
        loss.backward()
        tr.step(GF_BATCH)
        unfused_loss = float(loss.mean().asscalar())
        del ref, tr, loss
        torch.cuda.empty_cache()

        # the main path: GF_STEPS fused steps, the count set to 0 before
        tr = gluon.Trainer(net.collect_params(), 'sgd', dict(GF_OPT))
        fs = gluon.fuse_step(net, loss_fn, tr)
        cuda_conv.CONV_BN_STATS_LAUNCHES = 0
        rows, losses, routed, shapes = [], [], [], {}
        for i, (x, y) in enumerate(batches):
            before = cuda_conv.CONV_BN_STATS_LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = fs(x, y)
            torch.cuda.synchronize()
            rows.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                             launches=cuda_conv.CONV_BN_STATS_LAUNCHES -
                             before))
            losses.append(loss.handle.float().mean().item())
            routed.append(fs.routed_pairs)
            shapes = fs.routed_shapes
            if i == GF_BULK - 1:
                after_bulk = {k: v.clone()
                              for k, v in gluon_param_state(net).items()}
        main_launches = cuda_conv.CONV_BN_STATS_LAUNCHES
        final = gluon_param_state(net)
        stats = mx.profiler.gluon_fused_stats()
        del fs, tr, net
        torch.cuda.empty_cache()

        # bulk(2) and a step_ahead-0 step on a second net, same weights
        net = gf_net(torch, mx, ctx, state)
        tr = gluon.Trainer(net.collect_params(), 'sgd', dict(GF_OPT))
        fs = gluon.fuse_step(net, loss_fn, tr, step_ahead=0)
        xs = mx.nd.NDArray(torch.stack([b[0].handle
                                        for b in batches[:GF_BULK]]), ctx)
        ys = mx.nd.NDArray(torch.stack([b[1].handle
                                        for b in batches[:GF_BULK]]), ctx)
        before = cuda_conv.CONV_BN_STATS_LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs.bulk(xs, ys)
        torch.cuda.synchronize()
        bulk_ms = (time.perf_counter() - t0) * 1e3
        bulk_launches = cuda_conv.CONV_BN_STATS_LAUNCHES - before
        got = gluon_param_state(net)
        bulk_differ = sorted(k for k in after_bulk
                             if not torch.equal(got[k], after_bulk[k]))
        loss3 = fs(*batches[GF_BULK]).handle.float().mean().item()
        got = gluon_param_state(net)
        ahead_equal = loss3 == losses[GF_BULK] and all(
            torch.equal(got[k], final[k]) for k in final)
        del fs, tr, net, xs, ys, got, final, after_bulk, state, batches
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # the kernel at every routed shape against its plain version
    checks = resnet_kernel_checks(
        torch, cuda_conv, executor_mod,
        {k: ['pair'] * n for k, n in shapes.items()}, ctx.torch_device)
    # the float32 cut net: the route against no route, and planted
    old, ref_new, _ = gf_cut_step(torch, mx, ctx, route=False)
    _, new, cut_routed = gf_cut_step(torch, mx, ctx, route=True)
    _, planted, _ = gf_cut_step(torch, mx, ctx, route=True, plant=True)
    # the moving statistics are no update; the bias of a 1x1 conv that
    # feeds a BatchNorm has a zero gradient, its update rounding noise
    names = sorted(k for k in old if 'running' not in k and
                   not ('conv' in k and k.endswith('bias')))
    cut = updates_within(torch, [new[k] for k in names],
                         [old[k] for k in names],
                         [ref_new[k] for k in names], MESH_UPDATE_RTOL)
    cut_planted = updates_within(torch, [planted[k] for k in names],
                                 [old[k] for k in names],
                                 [ref_new[k] for k in names],
                                 MESH_UPDATE_RTOL)
    step_ms = median([r['ms'] for r in rows[1:]])
    run = dict(
        config='gluon.model_zoo.vision.resnet50_v1, bf16, batch %d, %dx%d, '
               'gluon.fuse_step, SGD momentum 0.9 wd 1e-4 multi_precision'
               % (GF_BATCH, GF_SIDE, GF_SIDE),
        card=smi, pairs_in_code=pairs_in_code,
        launches=main_launches,
        launches_per_step=[r['launches'] for r in rows],
        routed_per_step=routed, step_ms=[r['ms'] for r in rows],
        step_ms_median=step_ms, images_per_s=GF_BATCH / (step_ms / 1e3),
        bulk_ms=bulk_ms, bulk_images_per_s=GF_BULK * GF_BATCH /
        (bulk_ms / 1e3), bulk_launches=bulk_launches,
        losses=losses, unfused_loss=unfused_loss,
        bulk_equal=not bulk_differ, bulk_differ=bulk_differ[:8],
        step_ahead_equal=ahead_equal, gluon_fused_stats=stats,
        kernel_checks=[dict(x=r['x'], w=r['w'], stride=r['stride'],
                            pairs=r['pairs'],
                            max_abs_err=r['y']['max_abs_err'],
                            s1_rel_err=r['s1']['rel_err'],
                            s2_rel_err=r['s2']['rel_err'], ms=r['ms'],
                            library_ms=r['library_ms'],
                            bound_ms=r['bound_ms'], ok=r['ok'])
                       for r in checks],
        cut_routed=cut_routed, cut_updates=cut,
        cut_planted_updates=cut_planted)
    print('gluon fused ' + json.dumps(run))
    bad = gf_gate(run)
    if bad:
        fail('phase 30: ' + '; '.join(bad))
    print('gluon fused: resnet50_v1 bf16 batch %d on %s: %.1f ms a step '
          '(%.1f images/s), bulk(%d) %.1f ms, %d conv launches a step; '
          'first loss %.5f vs unfused %.5f; bulk and step_ahead 0 bit-equal '
          'to single steps; float32 cut net updates within %.3g of their '
          'leaf\'s largest (%d pairs routed), the planted statistics %.3g '
          'of the bound' % (
              GF_BATCH, smi, step_ms, run['images_per_s'], GF_BULK, bulk_ms,
              GF_PAIRS, losses[0], unfused_loss,
              cut['max_err_of_leaf_update'], cut_routed,
              cut_planted['max_err_over_bound']))
    return run


# ---------------------------------------------------------------------------
# Phase 31: the sparse tier at a recommender's size
# ---------------------------------------------------------------------------

# matrix factorization at MovieLens-20M's counts (GroupLens: 138,493
# users, 27,278 movies), rank 64, float32, both tables sparse_grad
MF = dict(users=138493, items=27278, rank=64)
MF_BATCH = 4096              # (user, item) pairs a step
MF_STEPS = 5
MF_ZIPF = 1.1                # the ids' popularity skew
MF_OPT = dict(learning_rate=0.05, momentum=0.9)
MF_SEED = SEED + 3100
MF_RANKS = 2
MF_SHARE = (0.45, 0.55)      # a rank's table bytes over world 1's
MF_HOT_ROWS = 8192
MF_SERVE_BATCH = 1024        # the engine's max_batch
MF_REQUESTS = 16             # requests of MF_REQUEST_ROWS pairs
MF_REQUEST_ROWS = 512


def mf_ids(rng, vocab, n):
    """n ids of a table of `vocab` rows, Zipf(MF_ZIPF)-skewed over a
    seeded permutation of the rows."""
    p = 1.0 / np.arange(1, vocab + 1) ** MF_ZIPF
    cdf = np.cumsum(p / p.sum())
    ranks = np.minimum(np.searchsorted(cdf, rng.random(n)), vocab - 1)
    perm = np.random.default_rng(MF_SEED).permutation(vocab)
    return perm[ranks].astype(np.float32)


def mf_batches(n, seed):
    """n host batches (user ids, item ids, scores) of MF_BATCH pairs."""
    rng = np.random.default_rng(seed)
    return [(mf_ids(rng, MF['users'], MF_BATCH),
             mf_ids(rng, MF['items'], MF_BATCH),
             rng.standard_normal(MF_BATCH).astype(np.float32))
            for _ in range(n)]


def mf_symbol(mx, sparse=True, head=True):
    """user . item, through LinearRegressionOutput when `head`."""
    s = mx.sym
    u = s.Embedding(s.Variable('user'), input_dim=MF['users'],
                    output_dim=MF['rank'], sparse_grad=sparse,
                    name='user_embed')
    v = s.Embedding(s.Variable('item'), input_dim=MF['items'],
                    output_dim=MF['rank'], sparse_grad=sparse,
                    name='item_embed')
    pred = s.sum(u * v, axis=1)
    return s.LinearRegressionOutput(pred, s.Variable('score'), name='lro') \
        if head else pred


def mf_params():
    rng = np.random.default_rng(MF_SEED + 1)
    return {'user_embed_weight': (rng.standard_normal(
                (MF['users'], MF['rank'])) * 0.1).astype(np.float32),
            'item_embed_weight': (rng.standard_normal(
                (MF['items'], MF['rank'])) * 0.1).astype(np.float32)}


def mf_module(mx, ctxs, params, sparse=True, opt=None):
    mod = mx.mod.Module(mf_symbol(mx, sparse), data_names=['user', 'item'],
                        label_names=['score'], context=ctxs)
    mod.bind(data_shapes=[mx.io.DataDesc('user', (MF_BATCH,)),
                          mx.io.DataDesc('item', (MF_BATCH,))],
             label_shapes=[mx.io.DataDesc('score', (MF_BATCH,))])
    mod.init_params(initializer=None, arg_params={
        k: mx.nd.array(v, ctx=mx.cpu()) for k, v in params.items()})
    mod.init_optimizer(optimizer='sgd',
                       optimizer_params=dict(opt or MF_OPT))
    return mod


def mf_batch(mx, b):
    return mx.io.DataBatch(data=[mx.nd.array(b[0], ctx=mx.cpu()),
                                 mx.nd.array(b[1], ctx=mx.cpu())],
                           label=[mx.nd.array(b[2], ctx=mx.cpu())])


def mf_train(torch, mx, mod, batches):
    """forward_backward + update over `batches`; each step's ms."""
    ms = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(mf_batch(mx, b))
        mod.update()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def mf_tables(mod):
    """The full tables, host copies, by name."""
    args, _ = mod.get_params()
    return {k: v.handle.cpu() for k, v in args.items()}


def mf_worker(out_dir):
    """One rank of phase 31, run by the port's launcher with
    MXNET_TPU_DIST_JAX=1 (gloo: the ranks share the card):
    Module(context=[gpu(0), gpu(1)]) trains the factorization one step
    on the global batch, its tables striped over the data mesh; its row,
    the full tables (rank 0) and an elastic checkpoint go to out_dir."""
    import torch
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, elastic
    torch.zeros(1, device='cuda')
    rt = dist.initialize()
    rank = rt.rank
    out_dir = Path(out_dir)
    mod = mf_module(mx, [mx.gpu(0), mx.gpu(1)], mf_params())
    eg = mod._exec_group
    ex = eg.executor
    row = dict(rank=rank, data=eg.mesh.shape['data'],
               backend=eg.mesh.backend, local_batch=eg.local_batch,
               striped=sorted(eg.sparse_tables))
    row['table_bytes'] = sum(
        ex.arg_dict[n]._data.numel() * ex.arg_dict[n]._data.element_size()
        for n in eg.sparse_tables)
    row['step_ms'] = mf_train(torch, mx, mod, mf_batches(1, MF_SEED + 2))
    tables = mf_tables(mod)
    if rank == 0:
        torch.save(tables, str(out_dir / 'tables.pt'))
    mgr = elastic.CheckpointManager(str(out_dir / 'ckpt'), async_=False)
    mgr.attach(mod)
    mgr._step = 1
    mgr.save(sync=True)
    with open(out_dir / ('rank%d.json' % rank), 'w') as f:
        json.dump(row, f)
    dist.shutdown()


def mf_serve_check(torch, mx, params, ctx):
    """The predict symbol served by InferenceEngine with hot_rows (both
    tables in pinned host memory, a (MF_HOT_ROWS, rank) buffer each on
    the card) against the full-table engine on the same requests."""
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving import InferenceEngine
    rng = np.random.default_rng(MF_SEED + 9)
    reqs = [(mf_ids(rng, MF['users'], MF_REQUEST_ROWS),
             mf_ids(rng, MF['items'], MF_REQUEST_ROWS))
            for _ in range(MF_REQUESTS)]
    outs, stats = {}, {}
    for hot in (None, MF_HOT_ROWS):
        pred = Predictor(symbol=mf_symbol(mx, head=False),
                         arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                     for k, v in params.items()},
                         input_shapes={'user': (1,), 'item': (1,)},
                         ctx=ctx)
        eng = InferenceEngine(pred, max_batch=MF_SERVE_BATCH,
                              quantize=False, hot_rows=hot)
        try:
            outs[hot] = [eng.predict(u, i) for u, i in reqs]
            st = eng.stats()
            stats[hot] = dict(resident_bytes=eng.resident_bytes(),
                              hot_rows=st.get('hot_rows'))
            if hot:
                stats[hot]['pinned'] = all(
                    t.host.is_pinned() for t in eng._hotrows.values())
        finally:
            eng.close()
    equal = all(np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(outs[None], outs[MF_HOT_ROWS]))
    hr = stats[MF_HOT_ROWS]['hot_rows']
    return dict(equal=equal, pinned=stats[MF_HOT_ROWS]['pinned'],
                device_table_bytes=sum(v['resident_bytes']
                                       for v in hr.values()),
                full_table_bytes=sum(v['table_bytes'] for v in hr.values()),
                hits=sum(v['hits'] for v in hr.values()),
                misses=sum(v['misses'] for v in hr.values()),
                evictions=sum(v['evictions'] for v in hr.values()),
                prefetch_hits=sum(v['prefetch_hits'] for v in hr.values()),
                engine_resident_bytes=stats[MF_HOT_ROWS]['resident_bytes'],
                full_engine_resident_bytes=stats[None]['resident_bytes'])


def mf_gate(run):
    """Phase 31's checks on a run's numbers: a list of what failed."""
    bad = []
    if run['untouched_changed']:
        bad.append('rows no batch touched changed: %s'
                   % run['untouched_changed'])
    if not run['touched_changed']:
        bad.append('the steps changed no touched row')
    if run['plain_sgd_differ']:
        bad.append('the plain-SGD sparse step differs from the dense one in '
                   '%s' % run['plain_sgd_differ'])
    e = run['embed_stats']
    if not 0 < e['embed_touched_bytes'] < e['embed_dense_equiv_bytes'] or \
            e['embed_touched_bytes'] != run['touched_bytes_expected'] or \
            e['embed_steps'] != MF_STEPS:
        bad.append('embed counters %s (touched bytes expected %d)'
                   % (e, run['touched_bytes_expected']))
    if not run['same_bits_twice']:
        bad.append('two runs of the sparse steps differ')
    ranks = run['ranks']
    for r in ranks:
        if (r['data'], r['backend'], r['striped']) != \
                (MF_RANKS, 'gloo', ['item_embed_weight',
                                    'user_embed_weight']):
            bad.append('rank %d: data %s, backend %s, striped %s'
                       % (r['rank'], r['data'], r['backend'], r['striped']))
        share = r['table_bytes'] / run['world1_table_bytes']
        if not MF_SHARE[0] <= share <= MF_SHARE[1]:
            bad.append('rank %d holds %.3f of the tables\' bytes'
                       % (r['rank'], share))
    if not run['rank_updates']['ok']:
        bad.append('the 2-rank step\'s updates off world 1\'s: %s'
                   % run['rank_updates'])
    if not run['restore']['ok']:
        bad.append('the ranks\' checkpoint restored at world 1 differs: %s'
                   % run['restore'])
    s = run['serve']
    if not s['equal'] or not s['pinned'] or s['hits'] <= 0 or \
            s['device_table_bytes'] != 2 * MF_HOT_ROWS * MF['rank'] * 4:
        bad.append('hot-row serving: %s' % s)
    return bad


def sparse_start(root):
    """Phase 31's launch, started: (its directory, the Launch)."""
    out = fresh_dir(root, 31)
    return out, start_launch(root, out, 'sparse', 'sparse', MF_RANKS, 0,
                             env={'MXNET_TPU_DIST_JAX': '1'})


def sparse_phase(torch, mx, root, smi, ctx=None, started=None):
    """Phase 31: the factorization at MovieLens-20M's counts through
    Module on gpu(0): MF_STEPS rows-only steps (SGD, momentum 0.9) on
    Zipf-skewed batches, twice; a plain-SGD step against the dense one;
    then MF_RANKS workers of the launcher share the card as a data mesh
    with the tables striped, against the world-1 step; their elastic
    checkpoint restored at world 1; last the predict symbol served with
    hot_rows against the full-table engine. Gated by mf_gate."""
    from mxnet_tpu_torch import elastic, profiler
    ctx = ctx or mx.gpu(0)
    out = root / 'build' / 'phase31'
    torch.cuda.empty_cache()
    params = mf_params()
    batches = mf_batches(MF_STEPS, MF_SEED + 2)
    try:
        # the rows-only steps, twice from the same weights
        runs = []
        for _ in range(2):
            profiler.clear()
            mod = mf_module(mx, [ctx], params)
            step_ms = mf_train(torch, mx, mod, batches)
            fu = mod._fused_updater
            runs.append((mf_tables(mod), {k: v.cpu() for k, v in
                                          fu.states.items()},
                         profiler.embed_stats(), step_ms,
                         fu.state_bytes_per_device()))
            ents = mod._exec_group.executor._sparse_embed_entries()
            world1_bytes = sum(
                mod._exec_group.executor.arg_dict[e['weight']]._data.numel()
                * 4 for e in ents)
            rungs = [e['rung'] for e in ents]
            del mod, fu
        tables, moms, embed, step_ms, state_bytes = runs[0]
        same_bits = all(torch.equal(tables[k], runs[1][0][k])
                        for k in tables) and all(
            torch.equal(moms[k], runs[1][1][k]) for k in moms)
        untouched_changed, touched_changed = [], False
        for name, col, vocab in (('user_embed_weight', 0, MF['users']),
                                 ('item_embed_weight', 1, MF['items'])):
            seen = np.zeros(vocab, bool)
            for b in batches:
                seen[b[col].astype(np.int64)] = True
            idle = torch.from_numpy(~seen)
            start = torch.from_numpy(params[name])
            if not torch.equal(tables[name][idle], start[idle]) or \
                    bool(moms[name][idle].abs().max() > 0):
                untouched_changed.append(name)
            touched_changed |= not torch.equal(tables[name][~idle],
                                               start[~idle])
        expected = MF_STEPS * sum(2 * r * MF['rank'] * 4 * 2 for r in rungs)

        # plain SGD: the sparse step against the dense one, bit for bit
        plain = {}
        for sparse in (True, False):
            mod = mf_module(mx, [ctx], params, sparse=sparse,
                            opt=dict(learning_rate=0.05))
            mf_train(torch, mx, mod, batches[:1])
            plain[sparse] = mf_tables(mod)
            del mod
        plain_differ = sorted(k for k in plain[True]
                              if not torch.equal(plain[True][k],
                                                 plain[False][k]))

        # world 1's step on the ranks' global batch, and the ranks
        mod = mf_module(mx, [ctx], params)
        mf_train(torch, mx, mod, mf_batches(1, MF_SEED + 2))
        world1 = mf_tables(mod)
        del mod
        if started is None:
            torch.cuda.empty_cache()
            started = sparse_start(root)
        out, launch = started
        res, wall = launch.wait()
        if res.returncode != 0:
            fail('phase 31: the launcher exited %d (its log is named above)'
                 % res.returncode)
        ranks = []
        for r in range(MF_RANKS):
            with open(out / ('rank%d.json' % r)) as f:
                ranks.append(json.load(f))
        got = torch.load(str(out / 'tables.pt'))
        names = sorted(world1)
        start = [torch.from_numpy(params[k]) for k in names]
        rank_updates = updates_within(torch, [got[k] for k in names], start,
                                      [world1[k] for k in names],
                                      MESH_UPDATE_RTOL)
        # the ranks' checkpoint restored into a world-1 Module
        mod = mf_module(mx, [ctx], params)
        info = elastic.resume(elastic.CheckpointManager(str(out / 'ckpt')),
                              mod)
        restored = mf_tables(mod)
        del mod
        differ = sorted(k for k in got if not torch.equal(got[k],
                                                          restored[k]))
        restore = dict(ok=info is not None and info.step == 1 and
                       not differ, differ=differ,
                       step=None if info is None else info.step)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    serve = mf_serve_check(torch, mx, {k: v.numpy()
                                       for k, v in tables.items()}, ctx)
    med = median(step_ms[1:])
    run = dict(
        config='matrix factorization, MovieLens-20M counts (%d users, %d '
               'items), rank %d, float32, batch %d, Zipf %.2f ids, SGD '
               'momentum 0.9, sparse_grad tables through Module'
               % (MF['users'], MF['items'], MF['rank'], MF_BATCH, MF_ZIPF),
        card=smi, step_ms=step_ms, step_ms_median=med,
        pairs_per_s=MF_BATCH / (med / 1e3), rungs=rungs,
        optimizer_state_bytes=state_bytes,
        untouched_changed=untouched_changed,
        touched_changed=touched_changed, plain_sgd_differ=plain_differ,
        embed_stats=embed, touched_bytes_expected=expected,
        same_bits_twice=same_bits, world1_table_bytes=world1_bytes,
        ranks=ranks, rank_wall_s=wall, rank_updates=rank_updates,
        restore=restore, serve=serve)
    print('sparse ' + json.dumps(run))
    bad = mf_gate(run)
    if bad:
        fail('phase 31: ' + '; '.join(bad))
    print('sparse: factorization at MovieLens-20M counts on %s: %.2f ms a '
          'step (%.0f pairs/s), rungs %s, touched %.3f of the dense '
          'update\'s bytes; untouched rows and their momenta unchanged, '
          'plain SGD bit-equal to dense, two runs bit-equal; %d ranks hold '
          '%s of the table bytes, updates within %.3g of world 1\'s, the '
          'checkpoint restored at world 1 bit for bit; hot-row serving '
          'bit-equal, %d hits %d misses, %.2f MB of tables on the card '
          'against %.2f MB' % (
              smi, med, run['pairs_per_s'], rungs,
              embed['embed_touched_frac'], MF_RANKS,
              ['%.3f' % (r['table_bytes'] / world1_bytes) for r in ranks],
              rank_updates['max_err_of_leaf_update'], serve['hits'],
              serve['misses'], serve['device_table_bytes'] / 1e6,
              serve['full_table_bytes'] / 1e6))
    return run


# ---------------------------------------------------------------------------
# Phases 32-34: pipeline and expert parallelism
# ---------------------------------------------------------------------------

PIPE_RANKS = 2               # {'data': 1, 'pipe': 2}: two processes, one card
PIPE_MICRO = 4               # microbatches of BATCH // PIPE_MICRO = 2 rows
PIPE_STEPS = 2
PIPE_MOMENTUM = 0.9
PIPE_SEED = SEED + 3200
# The flash kernels' launches a rank and step: each stage runs its
# GPT2_MEDIUM['layers'] / PIPE_RANKS blocks once a microbatch forward and
# once backward, and nothing on the bubble ticks (parallel/pipeline.py).
PIPE_STAGE_LAUNCHES = GPT2_MEDIUM['layers'] // PIPE_RANKS * PIPE_MICRO
# Phase 32's bf16 updates after PIPE_STEPS steps against the one-device
# steps of the same untied function (updates_within, PIPE_STEPS roundings
# of the weight). Each microbatch's weight gradient is rounded to bf16
# (2^-9 of itself) before the drain sums the four in float32, where the
# whole-batch backward rounds once, and the 2-row and 8-row products
# round their bf16 activations apart: a few 2^-9 of a leaf's update a
# step, and with momentum 0.9 the second update carries the first's;
# 2^-6 of the leaf's largest update covers that. Each step may also
# round a weight one bf16 step apart, hence the roundings term (2^-6 of
# |w| at two steps), larger than most bf16 updates here; the elements
# near zero still carry the rtol term alone, so microbatch 1 dropped
# from the bf16 run must fail this gate against the clean run. The
# float32 run (FP32_LAYERS layers at full width, the same engine) is
# gated at MESH_UPDATE_RTOL, as phases 26-27's are, and each fault of
# PIPE_PLANTS planted into it must fail that gate against the clean run.
PIPE_UPDATE_RTOL = 2.0 ** -6

# faults planted into phase 32's float32 run, each on microbatch 1 or on
# the 'pipe' sums: its gradient zeroed into the stages and the stem, its
# gradient counted twice (both with the forward unchanged bit for bit),
# the stem and head gradients not summed over 'pipe'
PIPE_PLANTS = ('drop', 'double', 'unsummed')
# the flash kernels at the shapes phase 32's microbatches give them
PIPE_KERNEL_SHAPE = (BATCH // PIPE_MICRO, GPT2_MEDIUM['heads'], SEQ,
                     GPT2_MEDIUM['dim'] // GPT2_MEDIUM['heads'])
PIPE_KERNEL_CHECKS = [(way, dtype) for way in ('forward', 'backward')
                      for dtype in ('bfloat16', 'float32')]

PG = dict(feat=768, units=1024, body=8, classes=16, batch=256, steps=3)
PG_PIPE = (2, 4)             # stages, microbatches: {'data': 2, 'pipe': 2}
PG_RANKS = 4
PG_OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
PG_SEED = SEED + 3300
PG_TOL = dict(atol=3e-6, rtol=1e-4)      # the dryrun's (__graft_entry__.py)

# google/switch-base-8's published config (d_model, d_ff, num_experts);
# capacity factor 1.25 as in Fedus et al.'s training runs
SWITCH = dict(d_model=768, d_ff=3072, experts=8, capacity_factor=1.25)
MOE_TOKENS = 4096            # a step's tokens: C = ceil(1.25 * 4096 / 8)
MOE_CLASSES = 16
MOE_STEPS = 2
MOE_OPT = dict(learning_rate=0.05, momentum=0.9)
MOE_SEED = SEED + 3400
MOE_TOL = dict(atol=3e-6, rtol=1e-4)     # tests/test_pipeline_train.py's


def pipe_staged_bytes(cfg):
    """The bytes a phase-32 rank stages through host memory a step, from
    the code: each of the PIPE_MICRO activations and cotangents goes out
    on one rank and in on the other (a (2, SEQ, dim) bf16 tensor each
    way, once each end), the stem's and head's gradients are summed over
    'pipe' (embed, ln_f, head_w in bf16: out and back), and the loss (a
    float32 scalar) is broadcast from the last stage (out and back)."""
    act = (BATCH // PIPE_MICRO) * SEQ * cfg['dim'] * 2
    hops = 2 * PIPE_MICRO * act
    edges = 2 * 2 * (2 * cfg['vocab'] * cfg['dim'] + cfg['dim'])
    return hops + edges + 2 * 4


def pipe_lm_init(torch, tfm, mesh, cfg, dtype, seed):
    """This rank's leaves of the LM of `cfg` in PIPE_RANKS stages from
    `seed`'s weights in `dtype`: (stage leaves with their stage dim of 1,
    stem leaves, head leaves)."""
    params = tfm.params_from_jax(seeded_tree(cfg, seed), dtype=dtype,
                                 device=mesh.device)
    stages, stem, head = tfm.pipe_lm_leaves(params, PIPE_RANKS)
    return ([w[None].clone() for w in stages[mesh.axis_index('pipe')]],
            stem, head)


@contextlib.contextmanager
def pipe_unsummed(collectives):
    """The 'unsummed' plant: sums over 'pipe' return this rank's own
    value (the engine's stem and head gradient sums)."""
    real = collectives._all_reduce

    def local(x, mesh, axis):
        return x if axis == 'pipe' else real(x, mesh, axis)

    collectives._all_reduce = local
    try:
        yield
    finally:
        collectives._all_reduce = real


def pipe_planted_fns(torch, fns, plant, rows=BATCH // PIPE_MICRO):
    """(stem_fn, stage_fn, head_fn) with `plant` ('drop' or 'double', on
    microbatch 1's rows of the head's input, microbatches of `rows`
    rows) planted in the head."""
    stem_fn, stage_fn, head_fn = fns
    lo, hi = rows, 2 * rows

    def planted(ws, acts, label, rng):
        part = acts[lo:hi]
        part = part.detach() if plant == 'drop' else \
            part * 2 - part.detach()
        return head_fn(ws, torch.cat([acts[:lo], part, acts[hi:]]), label,
                       rng)

    return stem_fn, stage_fn, planted


def pipe_lm_run(torch, pp, tfm, cuda_ops, profiler, mesh, cfg, init,
                tokens, targets, plant=None):
    """PIPE_STEPS steps of the LM of `cfg` in PIPE_RANKS stages
    (parallel/pipeline.make_pipe_step_fn over transformer.pipe_lm_fns)
    from this rank's leaves `init` (pipe_lm_init), counted and timed,
    with a fault of PIPE_PLANTS planted when `plant`: (this rank's row,
    its final leaves [stage..., stem..., head...], a function running one
    more step). The row's pipe counters are what the engine recorded."""
    from mxnet_tpu_torch.parallel import collectives
    stage_ws, stem, head = ([w.clone() for w in ws] for ws in init)
    hyper = dict(momentum=PIPE_MOMENTUM, rescale=1.0, clip=None,
                 nesterov=False)
    fns = tfm.pipe_lm_fns(cfg, PIPE_RANKS)
    if plant in ('drop', 'double'):
        fns = pipe_planted_fns(torch, fns, plant)
    step = pp.make_pipe_step_fn(mesh, PIPE_RANKS, PIPE_MICRO, *fns, hyper)
    opt = pp.init_pipe_opt_state(mesh, None, PIPE_RANKS, stage_ws, stem,
                                 head)
    n = len(stage_ws) + len(stem) + len(head)
    lrs, wds = [LR] * n, [0.0] * n
    profiler.clear()
    stats = profiler.mesh_stats()
    rng, losses, times, per_step = 0, [], [], []
    with pipe_unsummed(collectives) if plant == 'unsummed' else \
            contextlib.nullcontext():
        for _ in range(PIPE_STEPS):
            counts = read_counts(cuda_ops)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            leaves, stage_ws, stem, head, opt, rng = step(
                stage_ws, stem, head, opt, rng, tokens, targets, lrs, wds)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            per_step.append([a - b for a, b in zip(read_counts(cuda_ops),
                                                    counts)])
            losses.append(float(leaves[0].reshape(-1)[0]))
    after = profiler.mesh_stats()
    pipe = profiler.pipe_stats()
    row = dict(launches_per_step=per_step, step_ms=times, loss=losses,
               pipe=pipe, param_bytes=pipe['pipe_param_bytes_per_device'],
               edge_digest=dp_digest(torch, {str(i): w for i, w in
                                             enumerate(stem + head)}),
               **{k + '_per_step': (after['mesh_' + k] - stats['mesh_' + k])
                  / PIPE_STEPS for k in ('collectives', 'payload_bytes',
                                         'staged_bytes')})
    final = [w[0] for w in stage_ws] + stem + head

    def one_more():
        step(stage_ws, stem, head, opt, rng, tokens, targets, lrs, wds)

    return row, final, one_more


def pipe_leaves(init):
    """pipe_lm_init's leaves as pipe_lm_run's final ones are listed."""
    return [w[0] for w in init[0]] + list(init[1]) + list(init[2])


def pipe_save(torch, path, final, n_stage, rank):
    """A rank's final leaves for the main process: its stage's, and rank
    0's stem and head."""
    torch.save({'stage': [w.cpu() for w in final[:n_stage]],
                'edge': [w.cpu() for w in final[n_stage:]] if rank == 0
                else []}, str(path))


def pipe_kernel_checks(torch, cuda_ops):
    """The flash kernels at PIPE_KERNEL_SHAPE against their plain
    versions (phase 2's and 4's checks and tolerances, which fail the
    run on a disagreement): one row per PIPE_KERNEL_CHECKS entry."""
    out = []
    for way, dtype_name in PIPE_KERNEL_CHECKS:
        dtype = getattr(torch, dtype_name)
        name = 'pipe_micro_%s_%s' % (way, dtype_name)
        if way == 'forward':
            r = kernel_case(torch, cuda_ops, name, PIPE_KERNEL_SHAPE, SEQ,
                            dtype, True, 2)
            err = r['max_abs_err']
        else:
            r = bwd_case(torch, cuda_ops, name, PIPE_KERNEL_SHAPE, SEQ,
                         dtype, True, False, 2)
            err = max(e['max_abs_err'] for e in r['errors'].values())
        out.append(dict(way=way, dtype=dtype_name, q=r['q'],
                        max_abs_err=err, tol=r['tol'],
                        same_bits_twice=r['same_bits_twice']))
    return out


def pipe_worker(out_dir):
    """One rank of phase 32 and the data-mesh part of phase 34, run by the
    port's launcher with MXNET_TPU_DIST_JAX=1 (gloo: the two share the
    card). Phase 32: the bf16 GPT-2-medium LM in two pipeline stages,
    PIPE_STEPS steps of BATCH x SEQ in PIPE_MICRO microbatches, counted,
    timed, saved and profiled, then again with microbatch 1 dropped
    (its updates held against the clean run's); the float32 LM at
    FP32_LAYERS layers, clean and with each of PIPE_PLANTS; the flash
    kernels at the microbatches' shape against their plain versions.
    Phase 34: gluon.nn.MoE at Switch-Base-8's widths through fuse_step
    over a data mesh of the two ranks, each computing 4 experts, then one
    make_moe_train_step over an 'expert' axis of 2."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _build, cuda_ops, dist, profiler
    from mxnet_tpu_torch.parallel import collectives
    from mxnet_tpu_torch.parallel import mesh as pmesh
    from mxnet_tpu_torch.parallel import moe as pmoe
    from mxnet_tpu_torch.parallel import pipeline as pp
    from mxnet_tpu_torch.parallel import transformer as tfm
    torch.zeros(1, device='cuda')
    _build.library()
    rt = dist.initialize()
    rank = rt.rank
    out_dir = Path(out_dir)
    mesh = pp.make_pipe_mesh(PIPE_RANKS, PIPE_RANKS)
    dev = mesh.device
    cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
    tokens, targets = lm_batch(torch, cfg['vocab'], dev)
    init = pipe_lm_init(torch, tfm, mesh, cfg, torch.bfloat16, PIPE_SEED)
    reset_counts(cuda_ops)
    row, final, one_more = pipe_lm_run(
        torch, pp, tfm, cuda_ops, profiler, mesh, cfg, init, tokens,
        targets)
    row.update(rank=rank, stage=mesh.axis_index('pipe'),
               backend=mesh.backend, staged=mesh.staged, device=str(dev),
               launches=list(read_counts(cuda_ops)))
    pipe_save(torch, out_dir / ('pipe_r%d.pt' % rank), final,
              len(init[0]), rank)
    # the busy share: one more step under torch.profiler (not saved)
    events = device_events(torch, one_more)
    row['profiled_device_ms'] = sum(device_us(e) for e in events) / 1e3
    row['peak_bytes'] = torch.cuda.max_memory_allocated()
    del one_more, events
    # microbatch 1 dropped from the bf16 run (pipe_gate: the bf16 update
    # gate must fail it)
    _, planted, _ = pipe_lm_run(torch, pp, tfm, cuda_ops, profiler, mesh,
                                cfg, init, tokens, targets, plant='drop')
    row['bf16_planted_drop'] = updates_within(
        torch, planted, pipe_leaves(init), final, PIPE_UPDATE_RTOL,
        roundings=PIPE_STEPS)
    del init, final, planted
    torch.cuda.empty_cache()
    # float32 at full width, FP32_LAYERS layers, clean and planted
    cfg32 = tfm.lm_config(use_flash=True,
                          **dict(GPT2_MEDIUM, layers=FP32_LAYERS))
    init = pipe_lm_init(torch, tfm, mesh, cfg32, torch.float32,
                        PIPE_SEED + 1)
    f32, final, _ = pipe_lm_run(torch, pp, tfm, cuda_ops, profiler, mesh,
                                cfg32, init, tokens, targets)
    row['fp32'] = {k: f32[k] for k in ('launches_per_step', 'loss',
                                       'step_ms', 'edge_digest')}
    pipe_save(torch, out_dir / ('pipe32_r%d.pt' % rank), final,
              len(init[0]), rank)
    row['fp32']['planted'] = {}
    for plant in PIPE_PLANTS:
        _, planted, _ = pipe_lm_run(torch, pp, tfm, cuda_ops, profiler,
                                    mesh, cfg32, init, tokens, targets,
                                    plant=plant)
        row['fp32']['planted'][plant] = updates_within(
            torch, planted, pipe_leaves(init), final, MESH_UPDATE_RTOL)
        del planted
    del init, final
    torch.cuda.empty_cache()
    row['kernel_checks'] = pipe_kernel_checks(torch, cuda_ops)
    torch.cuda.empty_cache()

    # phase 34 over a data mesh of the two ranks
    profiler.clear()
    profiler.profiler_set_state('run')
    try:
        net, moe_losses, moe_ms = moe_train(torch, mx,
                                            [mx.cpu(0), mx.cpu(1)])
    finally:
        profiler.profiler_set_state('stop')
    row['moe'] = moe_counters(profiler, net)
    row['moe'].update(step_ms=moe_ms, loss=moe_losses)
    with pmesh.data_mesh_scope(pmesh.world_data_mesh()):
        row['moe']['experts'] = list(collectives.expert_range(
            SWITCH['experts']))
    if rank == 0:
        torch.save(moe_values(net), str(out_dir / 'moe.pt'))
    del net
    torch.cuda.empty_cache()
    emesh = pmesh.make_mesh({'expert': PIPE_RANKS})
    D, H, E = SWITCH['d_model'], SWITCH['d_ff'], SWITCH['experts']
    tok = MOE_TOKENS // PIPE_RANKS
    cap = pmoe.capacity_for(tok, E, SWITCH['capacity_factor'])
    full = pmoe.init_moe_params(D, H, E, torch.Generator().manual_seed(
        MOE_SEED + 1), device=dev)
    eparams = pmoe.place_moe_params(full, emesh)
    del full
    gen = np.random.default_rng(MOE_SEED + 2)
    x = torch.from_numpy(gen.standard_normal((MOE_TOKENS, D),
                                             dtype=np.float32)).to(dev)
    estep = pmoe.make_moe_train_step(emesh, D, H, E, cap)
    t0 = time.perf_counter()
    eloss, eparams = estep(eparams, x, torch.tanh(x) * 0.5)
    torch.cuda.synchronize()
    row['moe']['expert_step'] = dict(
        loss=float(eloss), ms=(time.perf_counter() - t0) * 1e3,
        capacity=cap, local_experts=int(eparams['w1'].shape[0]),
        finite=all(bool(torch.isfinite(v).all())
                   for v in eparams.values()))
    with open(out_dir / ('rank%d.json' % rank), 'w') as f:
        json.dump(row, f)
    dist.shutdown()


def pipe_start(root):
    """Phase 32's launch (phase 34's ranks too), started: (its directory,
    the Launch)."""
    out = fresh_dir(root, 32)
    return out, start_launch(root, out, 'pipe', 'pipe', PIPE_RANKS, 0,
                             env={'MXNET_TPU_DIST_JAX': '1'})


def pipe_reference(torch, tfm, cfg, dtype, seed, dev, tokens, targets,
                   tied=True):
    """The one-device references of phase 32 from `seed`'s weights: the
    tied TransformerLM's loss (when `tied`), then PIPE_STEPS steps of the
    same untied function as the pipeline's (pipe_lm_fns with one stage,
    the whole batch, plain autograd, sgd_update_math): (tied loss,
    losses, initial leaves, final leaves), leaves in the pipeline's order
    [stage 0, stage 1, embed, ln_f, head_w]."""
    from mxnet_tpu_torch.optimizer import sgd_update_math
    params = tfm.params_from_jax(seeded_tree(cfg, seed), dtype=dtype,
                                 device=dev)
    tied_loss = None
    if tied:
        model = tfm.TransformerLM(cfg, params)
        with torch.no_grad():
            tied_loss = float(model.loss(tokens, targets))
        del model
    stages, stem, head = tfm.pipe_lm_leaves(params, PIPE_RANKS)
    old = [w for st in stages for w in st] + stem + head
    del params, stages
    stem_fn, stage_fn, head_fn = tfm.pipe_lm_fns(cfg, 1)
    ws = [w.clone() for w in old]
    moms = [torch.zeros_like(w) for w in ws]
    n = len(ws) - 3
    losses = []
    for _ in range(PIPE_STEPS):
        leaves = [w.detach().requires_grad_() for w in ws]
        x = stage_fn(leaves[:n], stem_fn(leaves[n:n + 1], tokens, 0), 0)
        (loss,), total = head_fn(leaves[n + 1:], x, targets, 0)
        grads = torch.autograd.grad(total, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            new = [sgd_update_math(w, g, m, LR, 0.0, momentum=PIPE_MOMENTUM)
                   for w, g, m in zip(leaves, grads, moms)]
        ws = [w.detach() for w, _ in new]
        moms = [m for _, m in new]
        del leaves, grads, x, total, new
    return tied_loss, losses, old, ws


def pipe_gate(rows, cfg, ref):
    """What is wrong with phase 32's ranks (empty when nothing)."""
    bad = []
    want = [PIPE_STAGE_LAUNCHES] * 3
    staged = pipe_staged_bytes(cfg)
    for row in rows:
        r = row['rank']
        if (row['backend'], row['staged']) != ('gloo', True):
            bad.append('rank %d: backend %s, staged %s'
                       % (r, row['backend'], row['staged']))
        if row['launches_per_step'] != [want] * PIPE_STEPS:
            bad.append('rank %d: launches (fwd, dK/dV, dQ) %s, expected %s '
                       'a step' % (r, row['launches_per_step'], want))
        if row['staged_bytes_per_step'] != staged:
            bad.append('rank %d: %s bytes staged a step, the code counts %d'
                       % (r, row['staged_bytes_per_step'], staged))
        if abs(row['pipe']['pipe_bubble_frac'] - 0.2) > 1e-12 or \
                row['pipe']['pipe_steps'] != PIPE_STEPS:
            bad.append('rank %d: pipe_stats %s' % (r, row['pipe']))
        if not row['param_bytes'] < ref['world1_param_bytes']:
            bad.append('rank %d: %d parameter bytes, world 1 %d'
                       % (r, row['param_bytes'], ref['world1_param_bytes']))
        if row['loss'] != rows[0]['loss']:
            bad.append('rank %d: losses %s, rank 0 %s'
                       % (r, row['loss'], rows[0]['loss']))
        if row['edge_digest'] != rows[0]['edge_digest']:
            bad.append('rank %d: stem and head leaves differ from rank 0\'s'
                       % r)
        f32 = [[FP32_LAYERS // PIPE_RANKS * PIPE_MICRO] * 3] * PIPE_STEPS
        if row['fp32']['launches_per_step'] != f32:
            bad.append('rank %d: float32 launches %s, expected %s'
                       % (r, row['fp32']['launches_per_step'], f32))
        checked = [(c['way'], c['dtype']) for c in row['kernel_checks']
                   if c['q'] == list(PIPE_KERNEL_SHAPE)]
        if checked != PIPE_KERNEL_CHECKS:
            bad.append('rank %d: the flash kernels were checked at %s, not '
                       'at %s for each of %s' % (
                           r, [(c['way'], c['dtype'], c['q'])
                               for c in row['kernel_checks']],
                           list(PIPE_KERNEL_SHAPE), PIPE_KERNEL_CHECKS))
    if all(row.get('bf16_planted_drop', {}).get('ok', True)
           for row in rows):
        bad.append('the bf16 gate passed microbatch 1 dropped: %s'
                   % [row.get('bf16_planted_drop') for row in rows])
    for plant in PIPE_PLANTS:
        caught = [not row['fp32']['planted'][plant]['ok'] for row in rows
                  if plant in row['fp32'].get('planted', {})]
        if len(caught) != len(rows) or not any(caught):
            bad.append('the float32 gate passed the planted fault %r: %s'
                       % (plant, [row['fp32'].get('planted', {}).get(plant)
                                  for row in rows]))
    if abs(rows[0]['loss'][0] - ref['tied_loss']) > LM_NLL_ATOL:
        bad.append('first loss %.5f vs the tied one-device LM\'s %.5f (tol '
                   '%g)' % (rows[0]['loss'][0], ref['tied_loss'],
                            LM_NLL_ATOL))
    for i, (a, b) in enumerate(zip(rows[0]['loss'], ref['losses'])):
        if abs(a - b) > LM_NLL_ATOL:
            bad.append('step %d loss %.5f vs the one-device step\'s %.5f'
                       % (i, a, b))
    if not ref['params']['ok']:
        bad.append('bf16 updates off the one-device steps: %s'
                   % ref['params'])
    if not ref['fp32_updates']['ok']:
        bad.append('float32 updates off the one-device steps: %s'
                   % ref['fp32_updates'])
    return bad


def pipe_phase(torch, cuda_ops, tfm, root, smi, started=None,
               device='cuda'):
    """Phase 32: PIPE_RANKS launcher workers share the card on a {'data':
    1, 'pipe': 2} mesh and train the bf16 GPT-2-medium LM, blocks 0-11 on
    stage 0 and 12-23 on stage 1, on the flash kernels; gated by
    pipe_gate against the one-device references (pipe_reference)."""
    if started is None:
        torch.cuda.empty_cache()
        started = pipe_start(root)
    out, launch = started
    res, wall = launch.wait()
    if res.returncode != 0:
        fail('phase 32: the launcher exited %d (its log is named above)'
             % res.returncode)
    rows = []
    for r in range(PIPE_RANKS):
        with open(out / ('rank%d.json' % r)) as f:
            rows.append(json.load(f))
    cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
    tokens, targets = lm_batch(torch, cfg['vocab'], device)
    torch.cuda.empty_cache()

    def final(name):
        saved = [torch.load(str(out / ('%s_r%d.pt' % (name, r))))
                 for r in range(PIPE_RANKS)]
        return [w.to(device) for sv in saved for w in sv['stage']] + \
            [w.to(device) for w in saved[0]['edge']]

    tied, ref_losses, old, ref_ws = pipe_reference(
        torch, tfm, cfg, torch.bfloat16, PIPE_SEED, torch.device(device),
        tokens, targets)
    params = updates_within(torch, final('pipe'), old, ref_ws,
                            PIPE_UPDATE_RTOL, roundings=PIPE_STEPS)
    world1_param_bytes = sum(w.numel() * w.element_size() for w in old)
    del old, ref_ws
    torch.cuda.empty_cache()
    cfg32 = tfm.lm_config(use_flash=True,
                          **dict(GPT2_MEDIUM, layers=FP32_LAYERS))
    _, losses32, old, ref_ws = pipe_reference(
        torch, tfm, cfg32, torch.float32, PIPE_SEED + 1,
        torch.device(device), tokens, targets, tied=False)
    fp32_updates = updates_within(torch, final('pipe32'), old, ref_ws,
                                  MESH_UPDATE_RTOL)
    del old, ref_ws
    torch.cuda.empty_cache()
    ref = dict(tied_loss=tied, losses=ref_losses, params=params,
               fp32_losses=losses32, fp32_updates=fp32_updates,
               world1_param_bytes=world1_param_bytes)
    # a worker's first step carries its process's warm-up (its first
    # backward on the card, cuBLAS's handles, the gloo pairs' first use):
    # the steps after it are the step time
    step_ms = [median(row['step_ms'][1:]) for row in rows]
    device_ms = [row['profiled_device_ms'] for row in rows]
    busy = sum(device_ms) / max(step_ms)
    run = dict(config='bf16 gpt2-medium widths, %d layers in %d stages of '
               '%d blocks, batch %d x %d in %d microbatches, %d ranks on one '
               'card over gloo' % (cfg['layers'], PIPE_RANKS,
                                   cfg['layers'] // PIPE_RANKS, BATCH, SEQ,
                                   PIPE_MICRO, PIPE_RANKS),
               card=smi, wall_s=wall, step_ms_by_rank=step_ms,
               first_step_ms_by_rank=[row['step_ms'][0] for row in rows],
               profiled_device_ms_by_rank=device_ms,
               device_busy_share=busy,
               launches=[sum(row['launches'][i] for row in rows)
                         for i in range(3)],
               staged_bytes_per_step_by_rank=[row['staged_bytes_per_step']
                                              for row in rows],
               staged_bytes_counted=pipe_staged_bytes(cfg),
               planted_fp32_over_bound={
                   plant: [row['fp32']['planted'][plant]['max_err_over_bound']
                           for row in rows] for plant in PIPE_PLANTS},
               planted_bf16_drop_over_bound=[
                   row['bf16_planted_drop']['max_err_over_bound']
                   for row in rows],
               reference=ref, ranks=rows)
    print('pipe ' + json.dumps(run))
    bad = pipe_gate(rows, cfg, ref)
    if bad:
        fail('phase 32: ' + '; '.join(bad))
    print('pipe: %d ranks on one card (%s): step ms by rank %s (the first, '
          'warm-up included, %s), %d flash '
          'forward / dK-dV / dQ launches a rank and step, %d bytes staged a '
          'rank and step (counted from the code), the card busy %.1f %% of a '
          'step; losses %s against the one-device %s (tied first %.5f); '
          'bf16 parameters %s; float32 updates within %.3g of their leaf\'s '
          'largest (%.3g of the bound); planted faults at %s of the float32 '
          'bound by rank, a dropped microbatch at %s of the bf16 one; the '
          'flash kernels at %s checked in bf16 and float32; bubble %.2f, '
          '%.1f MB of parameters a rank against %.1f (the engine\'s '
          'record); phase took %.1f s' % (
              PIPE_RANKS, smi, ['%.1f' % ms for ms in step_ms],
              ['%.1f' % row['step_ms'][0] for row in rows],
              PIPE_STAGE_LAUNCHES, rows[0]['staged_bytes_per_step'],
              100 * busy, ['%.5f' % l for l in rows[0]['loss']],
              ['%.5f' % l for l in ref_losses], tied,
              'updates within %.3g of the bound' %
              params['max_err_over_bound'],
              fp32_updates['max_err_of_leaf_update'],
              fp32_updates['max_err_over_bound'],
              {k: ['%.3g' % v for v in vs] for k, vs in
               run['planted_fp32_over_bound'].items()},
              ['%.3g' % v for v in run['planted_bf16_drop_over_bound']],
              list(PIPE_KERNEL_SHAPE),
              rows[0]['pipe']['pipe_bubble_frac'],
              max(row['param_bytes'] for row in rows) / 1e6,
              world1_param_bytes / 1e6, wall))
    return run


def pg_seeded(mx, net, seed):
    """A phase-33 net's parameters from numpy draws: weights uniform in
    +-0.05, biases zero."""
    rng = np.random.default_rng(seed)
    for _, p in sorted(net.collect_params().items()):
        v = np.zeros(p.shape, np.float32) if p.name.endswith('bias') else \
            ((rng.random(p.shape, dtype=np.float32) - 0.5) * 0.1)
        p.set_data(mx.nd.array(v))


def pg_net(mx, ctx):
    """A stem Dense, PG['body'] identical Dense(units, 'tanh') and a head
    Dense, float32, seeded."""
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(PG['units'], activation='relu',
                         in_units=PG['feat']))
        for _ in range(PG['body']):
            net.add(nn.Dense(PG['units'], activation='tanh',
                             in_units=PG['units']))
        net.add(nn.Dense(PG['classes'], in_units=PG['units']))
    net.initialize(ctx=ctx)
    pg_seeded(mx, net, PG_SEED)
    return net


def pg_batches():
    rng = np.random.default_rng(PG_SEED + 1)
    return [(rng.standard_normal((PG['batch'], PG['feat']),
                                 dtype=np.float32),
             rng.integers(0, PG['classes'], PG['batch']).astype(np.float32))
            for _ in range(PG['steps'])]


def pg_values(torch, net):
    return [p.list_data()[0]._data.detach().float().cpu().clone()
            for _, p in sorted(net.collect_params().items())]


def pg_train(torch, mx, ctx, pipeline=None, zero=None):
    """PG['steps'] fuse_step steps of pg_net over `ctx`: (net, step, step
    ms)."""
    net = pg_net(mx, ctx)
    tr = mx.gluon.Trainer(net.collect_params(), 'sgd', dict(PG_OPT))
    fs = mx.gluon.fuse_step(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            tr, pipeline=pipeline, zero=zero)
    times = []
    for x, y in pg_batches():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs(mx.nd.array(x), mx.nd.array(y))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if pipeline is not None:
        fs.sync_params()
    return net, fs, times


def pg_symbol(mx):
    S = mx.sym
    h = S.Activation(S.FullyConnected(S.Variable('data'), name='stem',
                                      num_hidden=PG['units']),
                     act_type='relu')
    for i in range(PG['body']):
        h = S.Activation(S.FullyConnected(h, name='body%d' % i,
                                          num_hidden=PG['units']),
                         act_type='tanh')
    h = S.FullyConnected(h, name='out', num_hidden=PG['classes'])
    return S.SoftmaxOutput(h, name='softmax')


def pg_fit(torch, mx, ctxs, pipeline=None):
    """Module.fit of pg_symbol over pg_batches, one epoch: the parameters
    by name, host copies."""
    sym = pg_symbol(mx)
    shapes, _, _ = sym.infer_shape(data=(PG['batch'], PG['feat']))
    rng = np.random.default_rng(PG_SEED + 2)
    args = {n: mx.nd.array(np.zeros(s, np.float32) if n.endswith('bias')
                           else (rng.random(s, dtype=np.float32) - 0.5)
                           * 0.1)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ('data', 'softmax_label')}
    bs = pg_batches()
    it = mx.io.NDArrayIter(np.concatenate([x for x, _ in bs]),
                           np.concatenate([y for _, y in bs]),
                           batch_size=PG['batch'])
    mod = mx.mod.Module(sym, context=ctxs)
    mod.fit(it, num_epoch=1, optimizer='sgd', optimizer_params=dict(PG_OPT),
            arg_params=args, initializer=None, pipeline=pipeline)
    ap, _ = mod.get_params()
    return {k: v._data.detach().float().cpu().clone()
            for k, v in sorted(ap.items())}


def pg_step_key(fs):
    """A pipelined fused step's computation fingerprint (the stages' op
    trace with the stem, head and loss) and step signatures."""
    d = fs._dispatch
    return repr((d.fingerprint, sorted(map(repr, d.fns))))


def pipe4_worker(out_dir):
    """One rank of phase 33 (four launcher workers share the card on a
    {'data': 2, 'pipe': 2} mesh): fuse_step(pipeline=(2, 4)) on pg_net
    with and without ZeRO-1, a re-created ZeRO trainer, and
    Module.fit(pipeline=(2, 4)) on pg_symbol over [gpu(0), ..., gpu(3)].
    The Gluon trainers get cpu(0..3) contexts: a net initialized over
    gpu(i) would allocate on cuda:i, which one card lacks; the steps run
    on each rank's mesh device. Rank 0 also runs the one-device steps on
    gpu(0) and holds the ranks' results against them."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, exec_cache
    torch.zeros(1, device='cuda')
    rt = dist.initialize()
    rank = rt.rank
    out_dir = Path(out_dir)
    ctxs = [mx.cpu(i) for i in range(PG_RANKS)]
    row = dict(rank=rank)
    vals = {}
    for arm, zero in (('z0', 0), ('z1', 1)):
        net, fs, times = pg_train(torch, mx, ctxs, pipeline=PG_PIPE,
                                  zero=zero)
        vals[arm] = pg_values(torch, net)
        row[arm] = dict(step_ms=times, device=str(fs._device),
                        mesh=dict(fs._mesh.shape),
                        accounting=list(fs._pipe_state_accounting()))
    key = pg_step_key(fs)
    n_cached = exec_cache.size()
    net, fs, _ = pg_train(torch, mx, ctxs, pipeline=PG_PIPE, zero=1)
    row['recreate'] = dict(same_key=pg_step_key(fs) == key,
                           cache_entries=exec_cache.size() - n_cached,
                           same_bits=all(torch.equal(a, b) for a, b in zip(
                               vals['z1'], pg_values(torch, net))))
    got_fit = pg_fit(torch, mx, [mx.gpu(i) for i in range(PG_RANKS)],
                     pipeline=PG_PIPE)
    if rank == 0:
        ref_net, _, ref_times = pg_train(torch, mx, [mx.gpu(0)])
        ref = pg_values(torch, ref_net)
        row['one_device_step_ms'] = ref_times
        for arm in ('z0', 'z1'):
            row[arm]['parity'] = leaves_within(torch, vals[arm], ref,
                                               PG_TOL['rtol'],
                                               PG_TOL['atol'])
        ref_fit = pg_fit(torch, mx, [mx.gpu(0)])
        row['fit_parity'] = leaves_within(
            torch, [got_fit[k] for k in sorted(ref_fit)],
            [ref_fit[k] for k in sorted(ref_fit)], PG_TOL['rtol'],
            PG_TOL['atol'])
    row['peak_bytes'] = torch.cuda.max_memory_allocated()
    with open(out_dir / ('rank%d.json' % rank), 'w') as f:
        json.dump(row, f)
    dist.shutdown()


def pipe4_start(root):
    """Phase 33's launch, started: (its directory, the Launch)."""
    out = fresh_dir(root, 33)
    return out, start_launch(root, out, 'pipe4', 'pipe4', PG_RANKS, 0,
                             env={'MXNET_TPU_DIST_JAX': '1'})


def pipe4_gate(rows):
    """What is wrong with phase 33's ranks (empty when nothing)."""
    bad = []
    for row in rows:
        r = row['rank']
        for arm in ('z0', 'z1'):
            if row[arm]['mesh'] != {'data': 2, 'pipe': 2} or \
                    not row[arm]['device'].startswith('cuda'):
                bad.append('rank %d %s: mesh %s on %s' % (
                    r, arm, row[arm]['mesh'], row[arm]['device']))
        z0, z1 = row['z0']['accounting'], row['z1']['accounting']
        if z1[0] != z0[0] or not z1[1] <= z0[1] // 2 + 4096:
            bad.append('rank %d: ZeRO-1 state %d bytes against the '
                       'replicated %d (parameters %d, %d)'
                       % (r, z1[1], z0[1], z1[0], z0[0]))
        rc = row['recreate']
        if not rc['same_key'] or rc['cache_entries'] or \
                not rc['same_bits']:
            bad.append('rank %d: the re-created ZeRO trainer %s' % (r, rc))
    r0 = rows[0]
    for name, check in (('gluon', r0['z0']['parity']),
                        ('gluon ZeRO-1', r0['z1']['parity']),
                        ('Module.fit', r0['fit_parity'])):
        if not check['ok']:
            bad.append('%s off the one-device step: %s' % (name, check))
    return bad


def pipe4_phase(torch, root, smi, started=None):
    """Phase 33: PG_RANKS launcher workers train pg_net through
    fuse_step(pipeline=) and pg_symbol through Module.fit(pipeline=) at
    dp x pipe = 2 x 2; gated by pipe4_gate."""
    if started is None:
        torch.cuda.empty_cache()
        started = pipe4_start(root)
    out, launch = started
    try:
        res, wall = launch.wait()
        if res.returncode != 0:
            fail('phase 33: the launcher exited %d (its log is named above)'
                 % res.returncode)
        rows = []
        for r in range(PG_RANKS):
            with open(out / ('rank%d.json' % r)) as f:
                rows.append(json.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    run = dict(config='float32 Dense stem, %d x Dense(%d, tanh), head; batch '
               '%d; pipeline=%s over %d ranks on one card over gloo'
               % (PG['body'], PG['units'], PG['batch'], PG_PIPE, PG_RANKS),
               card=smi, wall_s=wall, ranks=rows)
    print('pipe4 ' + json.dumps(run))
    bad = pipe4_gate(rows)
    if bad:
        fail('phase 33: ' + '; '.join(bad))
    r0 = rows[0]
    print('pipe4: %d ranks (%s): step ms rank 0 %s (one device %s); the '
          'Gluon step within %.3g, %.3g (ZeRO-1) and Module.fit within %.3g '
          'of the one-device steps (of the bound); ZeRO-1 state %d bytes a '
          'rank against %d; a re-created trainer the same bits and step '
          'key; phase took %.1f s' % (
              PG_RANKS, smi, ['%.1f' % t for t in r0['z0']['step_ms']],
              ['%.1f' % t for t in r0['one_device_step_ms']],
              r0['z0']['parity']['max_err_over_bound'],
              r0['z1']['parity']['max_err_over_bound'],
              r0['fit_parity']['max_err_over_bound'],
              r0['z1']['accounting'][1], r0['z0']['accounting'][1], wall))
    return run


def moe_net(mx, ctx):
    """Dense(d_model, relu), MoE(d_model, d_ff, 8 experts, capacity factor
    1.25), Dense(MOE_CLASSES), float32; weights normal * 0.02 from numpy,
    biases zero."""
    nn = mx.gluon.nn
    D = SWITCH['d_model']
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(D, activation='relu', in_units=D))
        net.add(nn.MoE(D, SWITCH['d_ff'], num_experts=SWITCH['experts'],
                       capacity_factor=SWITCH['capacity_factor']))
        net.add(nn.Dense(MOE_CLASSES, in_units=D))
    net.initialize(ctx=ctx)
    rng = np.random.default_rng(MOE_SEED)
    for _, p in sorted(net.collect_params().items()):
        if p.grad_req == 'null':
            continue
        v = np.zeros(p.shape, np.float32) if p.name.endswith('bias') else \
            rng.standard_normal(p.shape, dtype=np.float32) * np.float32(0.02)
        p.set_data(mx.nd.array(v))
    return net


def moe_train(torch, mx, ctx):
    """MOE_STEPS fuse_step steps of moe_net on MOE_TOKENS-token batches:
    (net, losses, step ms)."""
    net = moe_net(mx, ctx)
    tr = mx.gluon.Trainer(net.collect_params(), 'sgd', dict(MOE_OPT))
    fs = mx.gluon.fuse_step(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    rng = np.random.default_rng(MOE_SEED + 3)
    losses, times = [], []
    for _ in range(MOE_STEPS):
        x = rng.standard_normal((MOE_TOKENS, SWITCH['d_model']),
                                dtype=np.float32)
        y = rng.integers(0, MOE_CLASSES, MOE_TOKENS).astype(np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fs(mx.nd.array(x), mx.nd.array(y))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.asnumpy().mean()))
    return net, losses, times


def moe_values(net):
    return [p.list_data()[0]._data.detach().float().cpu().clone()
            for _, p in sorted(net.collect_params().items())]


def moe_counters(profiler, net):
    """The profiler's MoE counters and the blocks' cumulative counts."""
    st = profiler.moe_stats()
    out = {k: st[k] for k in ('moe_routed_tokens', 'moe_dropped_tokens',
                              'moe_dispatches', 'moe_drop_frac')}
    out['per_expert'] = st['moe_experts']
    for _, p in net.collect_params().items():
        kind = getattr(p, '_moe_counter', None)
        if kind:
            out['block_' + kind] = float(p.list_data()[0]._data.sum())
    return out


def moe_gate(world1, rows, parity, same_bits):
    """What is wrong with phase 34 (empty when nothing)."""
    bad = []
    fed = MOE_TOKENS * MOE_STEPS
    for name, c in [('world 1', world1)] + [('rank %d' % r['rank'], r['moe'])
                                           for r in rows]:
        if c['moe_routed_tokens'] + c['moe_dropped_tokens'] != fed or \
                c['moe_dispatches'] != MOE_STEPS:
            bad.append('%s: %d routed + %d dropped in %d dispatches, %d fed'
                       % (name, c['moe_routed_tokens'],
                          c['moe_dropped_tokens'], c['moe_dispatches'], fed))
        per = c['per_expert'].values()
        if sum(e['routed'] for e in per) != c['moe_routed_tokens'] or \
                sum(e['dropped'] for e in per) != c['moe_dropped_tokens']:
            bad.append('%s: the per-expert table %s does not sum to the '
                       'totals' % (name, c['per_expert']))
        if c['block_routed'] != c['moe_routed_tokens'] or \
                c['block_dropped'] != c['moe_dropped_tokens']:
            bad.append('%s: the blocks count %s / %s, the profiler %d / %d'
                       % (name, c['block_routed'], c['block_dropped'],
                          c['moe_routed_tokens'], c['moe_dropped_tokens']))
    for r in rows:
        lo, hi = r['moe']['experts']
        if hi - lo != SWITCH['experts'] // PIPE_RANKS:
            bad.append('rank %d computes experts %d-%d' % (r['rank'], lo, hi))
        es = r['moe']['expert_step']
        if not (es['finite'] and math.isfinite(es['loss'])) or \
                es['local_experts'] != SWITCH['experts'] // PIPE_RANKS:
            bad.append('rank %d: make_moe_train_step %s' % (r['rank'], es))
        if (r['moe']['moe_routed_tokens'], r['moe']['moe_dropped_tokens']) \
                != (world1['moe_routed_tokens'],
                    world1['moe_dropped_tokens']):
            bad.append('rank %d: routed / dropped %d / %d, world 1 %d / %d'
                       % (r['rank'], r['moe']['moe_routed_tokens'],
                          r['moe']['moe_dropped_tokens'],
                          world1['moe_routed_tokens'],
                          world1['moe_dropped_tokens']))
    if not parity['ok']:
        bad.append('the two ranks\' parameters off world 1\'s: %s' % parity)
    if not same_bits:
        bad.append('two world-1 runs differ')
    return bad


def moe_phase(torch, mx, root, smi, out=None):
    """Phase 34: gluon.nn.MoE at Switch-Base-8's widths through fuse_step:
    at world 1 on gpu(0), twice (the same bits), under the profiler; its
    parameters held against phase 32's two ranks' data-mesh run (each
    computing 4 experts) and their make_moe_train_step; gated by
    moe_gate."""
    from mxnet_tpu_torch import profiler
    out = out or root / 'build' / 'phase32'
    try:
        rows = []
        for r in range(PIPE_RANKS):
            with open(out / ('rank%d.json' % r)) as f:
                rows.append(json.load(f))
        ranks_vals = torch.load(str(out / 'moe.pt'))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    runs = []
    for _ in range(2):
        profiler.clear()
        profiler.profiler_set_state('run')
        try:
            net, losses, times = moe_train(torch, mx, [mx.gpu(0)])
        finally:
            profiler.profiler_set_state('stop')
        runs.append((moe_values(net), moe_counters(profiler, net), losses,
                     times))
        del net
    vals, world1, losses, times = runs[0]
    same = all(torch.equal(a, b) for a, b in zip(vals, runs[1][0]))
    parity = leaves_within(torch, ranks_vals, vals, MOE_TOL['rtol'],
                           MOE_TOL['atol'])
    world1.update(loss=losses, step_ms=times)
    run = dict(config='Dense(%d, relu), MoE(%d, %d, %d experts, capacity '
               'factor %g), Dense(%d), float32, %d tokens a step'
               % (SWITCH['d_model'], SWITCH['d_model'], SWITCH['d_ff'],
                  SWITCH['experts'], SWITCH['capacity_factor'], MOE_CLASSES,
                  MOE_TOKENS), card=smi, world1=world1,
               capacity=int(math.ceil(SWITCH['capacity_factor'] * MOE_TOKENS
                                      / SWITCH['experts'])),
               parity=parity, same_bits_twice=same,
               ranks=[r['moe'] for r in rows])
    print('moe ' + json.dumps(run))
    bad = moe_gate(world1, rows, parity, same)
    if bad:
        fail('phase 34: ' + '; '.join(bad))
    print('moe: Switch-Base-8 widths (%s): world 1 %s ms a step, %d routed '
          'and %d dropped of %d tokens; two ranks %s ms a step, each 4 '
          'experts, within %.3g of world 1 (of the bound); two runs '
          'bit-equal; make_moe_train_step over 2 ranks %.1f ms' % (
              smi, ['%.1f' % t for t in times], world1['moe_routed_tokens'],
              world1['moe_dropped_tokens'], MOE_TOKENS * MOE_STEPS,
              ['%.1f' % t for t in rows[0]['moe']['step_ms']],
              parity['max_err_over_bound'],
              rows[0]['moe']['expert_step']['ms']))
    return run


# ---------------------------------------------------------------------------
# Phase 35: hybrid workers. `tools.launch -n 2 -s 1 --ranks-per-worker 2`:
# two workers of two ranks each share the card over gloo, each worker's
# ranks a data mesh of their own, the workers synced through one CPU
# parameter server (the JAX package's dryrun phase (f)); the reductions
# over the batch on each worker's data mesh
# ---------------------------------------------------------------------------

HYBRID_WORKERS = 2
HYBRID_RANKS = 2             # a worker's ranks: four processes on the card
HYBRID_BATCH = 64            # a rank's images a step: 128 a worker, 256 all
HYBRID_STEPS = 3             # 1 warm-up + 2 timed, then one profiled step
HYBRID_SEED = SEED + 3500
HYBRID_PROBE_ROUNDS = 3
# the graphs of the reductions over the batch (tests/_torch_parallel_ranks.py
# BR_CASES), a parameter before each (fc1, or w1 for the ties) and one after
# (w2), at the CPU tests' tolerance (tests/test_torch_module_dp.py STEP)
HYBRID_BR_CASES = ('sum', 'sum_axis', 'mean', 'prod', 'nansum', 'nanprod',
                   'max', 'max_axis', 'min', 'min_axis', 'norm', 'norm_ord1',
                   'softmax_cross_entropy', 'sort', 'argsort', 'topk',
                   'max_ties', 'min_ties', 'chain', 'center')
HYBRID_BR_SHAPE = (16, 12)   # the global batch, the features
HYBRID_BR_HIDDEN = 6
HYBRID_BR_TOL = dict(rtol=1e-4, atol=1e-5)
# a bf16 ResNet-50 step whose loss reduces over axis 0,
# MakeLoss(mean(softmax_cross_entropy(fc1))), over a worker's data mesh
# against one device on the same global batch; the loss within phase 29's
# DP_LOSS_ATOL (the ranks sum BatchNorm's statistics in another order)
HYBRID_SCE_BATCH = 32


def hybrid_reducer_net(mx, case):
    """The reduction case's graph; whether its data gradient is kept."""
    S = mx.sym
    data = S.Variable('data')
    ties = case.endswith('_ties')
    feat = HYBRID_BR_SHAPE[1]
    if ties:
        h = S.broadcast_mul(data, S.Variable('w1', shape=(1, feat)))
        width = feat
    else:
        h = S.tanh(S.FullyConnected(data, name='fc1',
                                    num_hidden=HYBRID_BR_HIDDEN))
        width = HYBRID_BR_HIDDEN
    vec = (1, width)
    if case in ('sum', 'sum_axis', 'mean', 'nansum', 'max', 'max_axis',
                'min', 'min_axis'):
        r = getattr(S, case)(h, axis=0, keepdims=True)
    elif case in ('prod', 'nanprod'):
        r = getattr(S, case)(h * 0.3 + 1.0, axis=0, keepdims=True)
    elif case in ('norm', 'norm_ord1'):
        r = S.norm(h, ord=1 if case == 'norm_ord1' else 2)
        vec = (1,)
    elif case == 'softmax_cross_entropy':
        r = S.softmax_cross_entropy(h, S.Variable('softmax_label'))
        vec = (1,)
    elif case in ('sort', 'argsort'):
        r = getattr(S, case)(h, axis=0)
    elif case == 'topk':
        r = S.topk(h, axis=0, k=3, ret_typ='value')
    elif ties:
        r = getattr(S, case[:3])(h, axis=0, keepdims=True)
    elif case == 'chain':
        r = S.sum(S.max(h, axis=0, keepdims=True), axis=1, keepdims=True)
        vec = (1, 1)
    else:
        c = S.broadcast_sub(h, S.mean(h, axis=0, keepdims=True))
        r = S.sum(S.square(c), axis=0, keepdims=True)
    z = S.broadcast_mul(r, S.Variable('w2', shape=vec))
    return S.MakeLoss(z, name='loss'), ties


def hybrid_reducer_inputs():
    """The reductions' seeded data (tied rows 3, 5 and 12 at the maximum
    of every column, 1 and 9 at the minimum: they straddle the two
    ranks' halves) and labels."""
    rng = np.random.default_rng(HYBRID_SEED + 7)
    x = rng.random(HYBRID_BR_SHAPE, dtype=np.float32)
    ties = x.copy()
    ties[[3, 5, 12]] = 2.0
    ties[[1, 9]] = -1.0
    y = rng.integers(0, 5, HYBRID_BR_SHAPE[0]).astype(np.float32)
    return x, ties, y


def hybrid_reducer_step(mx, case, ctxs):
    """One SGD step of the case's Module over `ctxs`: the outputs, the
    parameters' gradients, the data's gradient for the ties and the
    updated parameters, as float64 numpy arrays by name."""
    net, ties = hybrid_reducer_net(mx, case)
    x, x_ties, y = hybrid_reducer_inputs()
    n = HYBRID_BR_SHAPE[0]
    shapes = {'data': HYBRID_BR_SHAPE}
    label = case == 'softmax_cross_entropy'
    if label:
        shapes['softmax_label'] = (n,)
    rng = np.random.default_rng(HYBRID_SEED + 9)
    args = {name: ((rng.random(s, dtype=np.float32) - 0.5) * 0.8 +
                   (1.0 if name == 'w1' else 0.0)).astype(np.float32)
            for name, s in zip(net.list_arguments(),
                               net.infer_shape(**shapes)[0])
            if name not in NO_GRAD}
    cpu = mx.cpu()
    mod = mx.mod.Module(net, context=ctxs)
    mod.bind(data_shapes=[mx.io.DataDesc('data', HYBRID_BR_SHAPE)],
             label_shapes=[mx.io.DataDesc('softmax_label', (n,))]
             if label else None, inputs_need_grad=ties)
    mod.init_params(initializer=None, arg_params={
        k: mx.nd.array(v, ctx=cpu) for k, v in args.items()})
    mod.init_optimizer(kvstore=None, optimizer='sgd',
                       optimizer_params={'learning_rate': 0.1})
    mod.forward_backward(mx.io.DataBatch(
        data=[mx.nd.array(x_ties if ties else x, ctx=cpu)],
        label=[mx.nd.array(y, ctx=cpu)] if label else None))
    res = {'out': mod.get_outputs()[0].asnumpy()}
    for k, g in zip(mod._param_names, mod._exec_group.grad_arrays):
        res['grad ' + k] = g.asnumpy()
    if ties:
        res['data grad'] = mod.get_input_grads()[0].asnumpy()
    mod.update()
    for k, v in mod.get_params()[0].items():
        res['param ' + k] = v.asnumpy()
    return {k: np.asarray(v, np.float64) for k, v in res.items()}


def hybrid_reducer_checks(mx):
    """Every reduction case over the worker's data mesh against one device
    on the global batch: a row a case (within HYBRID_BR_TOL, every shape
    the same)."""
    rows = {}
    ctxs = [mx.gpu(i) for i in range(HYBRID_RANKS)]
    for case in HYBRID_BR_CASES:
        got = hybrid_reducer_step(mx, case, ctxs)
        ref = hybrid_reducer_step(mx, case, [mx.gpu(0)])
        worst, differ = 0.0, []
        for k in sorted(set(got) | set(ref)):
            if k not in got or k not in ref or got[k].shape != ref[k].shape:
                differ.append(k)
                continue
            bound = HYBRID_BR_TOL['atol'] + HYBRID_BR_TOL['rtol'] * \
                np.abs(ref[k])
            worst = max(worst, float((np.abs(got[k] - ref[k]) / bound)
                                     .max()))
        rows[case] = dict(ok=not differ and worst <= 1.0,
                          max_err_over_bound=worst, differ=differ,
                          keys=len(ref))
    return rows


def hybrid_sce_symbol(mx):
    """The bf16 ResNet-50 with its loss reduced over axis 0:
    MakeLoss(mean(softmax_cross_entropy(fc1 in float32, label)))."""
    body = mx.models.resnet.get_symbol(**RESNET)
    fc = body.get_internals()['cast_out_output']
    sce = mx.sym.softmax_cross_entropy(fc, mx.sym.Variable('softmax_label'))
    return mx.sym.MakeLoss(mx.sym.mean(sce), name='sce_loss')


def hybrid_sce_step(torch, mx, cuda_conv, ctxs):
    """One step of hybrid_sce_symbol over `ctxs` at HYBRID_SCE_BATCH: the
    loss (a replicated output), the conv launches, and whether every
    gradient is finite."""
    symbol = hybrid_sce_symbol(mx)
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    n = HYBRID_SCE_BATCH
    args, auxs = resnet_params(symbol, dict(data=(n,) + shape,
                                            softmax_label=(n,)),
                               RESNET['num_classes'], HYBRID_SEED + 11)
    cpu = mx.cpu()
    mod = mx.mod.Module(symbol, context=ctxs, label_names=['softmax_label'])
    mod.bind(data_shapes=[mx.io.DataDesc('data', (n,) + shape)],
             label_shapes=[mx.io.DataDesc('softmax_label', (n,))])
    mod.init_params(initializer=None,
                    arg_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in args.items()
                                if k not in NO_GRAD},
                    aux_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in auxs.items()})
    mod.init_optimizer(kvstore=None, optimizer='sgd',
                       optimizer_params=dict(DIST_OPT))
    before = cuda_conv.CONV_BN_STATS_LAUNCHES
    mod.forward_backward(mx.io.DataBatch(
        data=[mx.nd.array(args['data'], ctx=cpu)],
        label=[mx.nd.array(args['softmax_label'], ctx=cpu)]))
    torch.cuda.synchronize()
    launches = cuda_conv.CONV_BN_STATS_LAUNCHES - before
    out = mod.get_outputs()[0]
    finite = all(bool(torch.isfinite(g.handle).all())
                 for g in mod._exec_group.grad_arrays if g is not None)
    mod.update()
    row = dict(loss=float(out.handle.float().reshape(-1)[0]),
               out_shape=list(out.shape), launches=launches,
               grads_finite=finite,
               replicated=mod._exec_group.executor.replicated_outputs())
    del mod
    torch.cuda.empty_cache()
    return row


def hybrid_worker(out_dir):
    """One rank of phase 35, run by the port's launcher with
    --ranks-per-worker: the probe key's sync-SGD arithmetic, then
    Module(context=[gpu(0), gpu(1)]) over the worker's own data mesh
    trains the bf16 ResNet-50 with kvstore 'dist_sync' (the worker's
    leader pushes the mesh-summed gradients and hands the pulled weights
    to the other rank); then the reductions over the batch on the
    worker's mesh, and a bf16 ResNet-50 step whose loss reduces over
    axis 0. Writes w<worker>_r<rank>.json and .pt, and exits through the
    interpreter."""
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _build, cuda_conv
    from mxnet_tpu_torch import _hostarray as ha
    from mxnet_tpu_torch import executor as executor_mod
    from mxnet_tpu_torch.parallel import collectives, worker_group
    torch.zeros(1, device='cuda')
    _build.library()
    kv = mx.kv.create('dist_sync')
    group = worker_group.current()
    worker, rank = kv.rank, group.rank
    out_dir = Path(out_dir)
    row = dict(worker=worker, rank=rank, workers=kv.num_workers,
               group_size=group.size,
               world=torch.distributed.get_world_size(),
               backend=torch.distributed.get_backend())
    cpu = mx.cpu()
    with cpu:
        kv.init('probe', mx.nd.zeros((2, 2)))
        kv.set_optimizer(mx.optimizer.create('test', rescale_grad=1.0))
        row['probe'] = []
        for _ in range(HYBRID_PROBE_ROUNDS):
            kv.push('probe', mx.nd.array(np.full((2, 2), float(worker + 1),
                                                 np.float32)))
            got = mx.nd.zeros((2, 2))
            kv.pull('probe', out=got)
            row['probe'].append(got.asnumpy().tolist())
            kv.barrier()
    wbatch = HYBRID_BATCH * HYBRID_RANKS
    symbol, shape, params = dp_resnet(mx, wbatch, HYBRID_SEED)
    mod = mx.mod.Module(symbol, context=[mx.gpu(i)
                                         for i in range(HYBRID_RANKS)])
    mod.bind(data_shapes=[mx.io.DataDesc('data', (wbatch,) + shape)],
             label_shapes=[mx.io.DataDesc('softmax_label', (wbatch,))])
    mod.init_params(initializer=None,
                    arg_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in params[0].items()},
                    aux_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in params[1].items()})
    eg = mod._exec_group
    ex = eg.executor
    # the first step's probes: this rank's own gradients before the
    # worker's sum, the pushed (summed) ones, the weights before and after
    dump = {}
    finish = collectives._ReducePass.finish

    def finish_probed(self, grads):
        if 'local' not in dump:
            dump['local'] = {}
            for i, p in enumerate(self.red.positions):
                name = ex._diff_names[p]
                if name in DIST_PROBES:
                    g = self.grads[i] if self.grads[i] is not None \
                        else grads[p]
                    dump['local'][name] = ha.host(g)
        return finish(self, grads)
    collectives._ReducePass.finish = finish_probed
    push_pull_all = kv.push_pull_all
    rounds = []

    def push_pull_probed(keys, grads, outs):
        first = not rounds
        rounds.append(len(keys))
        if first:
            idx = {k: i for i, k in enumerate(keys)}
            dump['grad'] = {k: ha.host(grads[idx[k]]) for k in DIST_PROBES}
            dump['before'] = {k: ha.host(outs[idx[k]]).clone()
                              for k in DIST_PROBES}
        push_pull_all(keys, grads, outs)
        if first:
            dump['after'] = {k: ha.host(outs[idx[k]]) for k in DIST_PROBES}
    kv.push_pull_all = push_pull_probed
    mod.init_optimizer(kvstore=kv, optimizer='sgd',
                       optimizer_params=dict(DIST_OPT))
    row.update(rescale_grad=mod._optimizer.rescale_grad, dp=eg.dp,
               local_batch=eg.local_batch)
    import pickle
    sym_ref, mod._optimizer.sym = mod._optimizer.sym, None
    try:
        dump['optimizer'] = pickle.dumps(mod._optimizer)
    finally:
        mod._optimizer.sym = sym_ref
    _, batches = dp_batches(mx, shape, HYBRID_STEPS + 1,
                            HYBRID_SEED + 100 * (worker + 1), wbatch)
    pushes = kv.pushes
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    steps = dp_steps(torch, mx, cuda_conv, mod, batches[:HYBRID_STEPS])
    row['launches'] = cuda_conv.CONV_BN_STATS_LAUNCHES
    row.update(launches_per_step=[s['launches'] for s in steps],
               step_ms=[s['ms'] for s in steps],
               loss=[s['loss'] for s in steps])
    b = batches[HYBRID_STEPS]
    events = device_events(torch, lambda: (mod.forward_backward(b),
                                           mod.update()))
    row['profiled_device_ms'] = sum(device_us(e) for e in events) / 1e3
    collectives._ReducePass.finish = finish
    row.update(pushes=kv.pushes - pushes, rounds=len(rounds),
               keys=rounds[0] if rounds else 0)
    state = dp_state(mod)
    row['param_digest'] = dp_digest(torch, {k: v for k, v in state.items()
                                           if k.startswith('arg ')})
    row['aux_digest'] = dp_digest(torch, {k: v for k, v in state.items()
                                         if k.startswith('aux ')})
    shapes = pair_shapes(symbol, eg.local_batch, shape, executor_mod,
                         pairs=dict(ex.pairs))
    device = eg.mesh.device
    del mod, eg, ex, state
    torch.cuda.empty_cache()
    if worker == 0 and rank == 0:
        # the kernel at a rank's shapes against its plain version
        checks = resnet_kernel_checks(torch, cuda_conv, executor_mod,
                                      shapes, device)
        row['kernel_checks'] = [dict(
            x=r['x'], w=r['w'], stride=r['stride'], pairs=r['pairs'],
            max_abs_err=r['y']['max_abs_err'], ms=r['ms'],
            bound_ms=r['bound_ms'], library_ms=r['library_ms'], ok=r['ok'])
            for r in checks]
    t0 = time.perf_counter()
    row['reducers'] = hybrid_reducer_checks(mx)
    row['reducers_s'] = time.perf_counter() - t0
    row['sce'] = hybrid_sce_step(torch, mx, cuda_conv,
                                 [mx.gpu(i) for i in range(HYBRID_RANKS)])
    if rank == 0:
        row['sce_one_device'] = hybrid_sce_step(torch, mx, cuda_conv,
                                                [mx.gpu(0)])
    with open(out_dir / ('w%d_r%d.json' % (worker, rank)), 'w') as f:
        json.dump(row, f)
    torch.save(dump, str(out_dir / ('w%d_r%d.pt' % (worker, rank))))
    kv.barrier()
    if worker == 0 and rank == 0:
        kv.stop_servers()
        report = Path(os.environ['MXNET_TPU_PS_REPORT'])
        deadline = time.monotonic() + 30
        while not report.exists() and time.monotonic() < deadline:
            time.sleep(0.1)
    kv.close()
    print('HYBRID_RANK_OK worker=%d rank=%d' % (worker, rank), flush=True)


def hybrid_start(root):
    """Phase 35's launch, started: (its directory, the Launch)."""
    out = fresh_dir(root, 35)
    return out, start_launch(
        root, out, 'hybrid', 'hybrid', HYBRID_WORKERS, 1,
        env={'MXNET_TPU_PS_REPORT': str(out / 'server.json')},
        ranks_per_worker=HYBRID_RANKS)


def hybrid_group_sums(torch, dumps):
    """Per worker and probe key, whether the gradient its leader pushed is
    the sum of its two ranks' own gradients (rounded once to their dtype,
    as the all-reduce rounds it)."""
    from mxnet_tpu_torch import _hostarray as ha
    out = {}
    for w in range(HYBRID_WORKERS):
        ranks = [dumps[(w, r)] for r in range(HYBRID_RANKS)]
        for k in DIST_PROBES:
            parts = [torch.as_tensor(ha.to_float32(d['local'][k]))
                     for d in ranks]
            pushed = ha.host(ranks[0]['grad'][k])
            want = ha.from_float32(sum(parts).numpy(), pushed)
            out['worker %d %s' % (w, k)] = not tensors_equal(
                torch, {k: want}, {k: pushed})
    return out


def hybrid_server_check(torch, mx, dumps):
    """The server's update of each probe key against the port's optimizer
    on cpu(0) over the two workers' pushes, from the weights before the
    first round, bit for bit, as phase 21 holds it."""
    import pickle
    from mxnet_tpu_torch import _hostarray as ha
    from mxnet_tpu_torch import optimizer as opt_mod
    leaders = [dumps[(w, 0)] for w in range(HYBRID_WORKERS)]
    updater = opt_mod.get_updater(pickle.loads(leaders[0]['optimizer']))
    cpu = mx.cpu(0)
    out = {}
    for k in DIST_PROBES:
        g = sum(ha.host(d['grad'][k]) for d in leaders)
        wt = mx.nd.NDArray(ha.to_tensor(ha.copy(leaders[0]['before'][k])),
                           cpu)
        with cpu:
            updater(k, mx.nd.NDArray(ha.to_tensor(g), cpu), wt)
        out[k] = not any(tensors_equal(torch, {k: wt._data},
                                       {k: dumps[(w, r)]['after'][k]})
                         for w in range(HYBRID_WORKERS)
                         for r in range(HYBRID_RANKS))
    return out


def hybrid_gate(rows, run):
    """What is wrong with phase 35's ranks' rows and the run's checks
    (empty when nothing)."""
    bad = []
    want = route_pairs(RESNET_PAIRS, stem_split_on())
    total = sum(range(1, HYBRID_WORKERS + 1))
    probe = [[[float((r + 1) * total)] * 2] * 2
             for r in range(HYBRID_PROBE_ROUNDS)]
    keys = rows[0]['keys']
    for row in rows:
        w, r = row['worker'], row['rank']
        who = 'worker %d rank %d' % (w, r)
        if (row['workers'], row['group_size'], row['world'], row['dp'],
                row['local_batch']) != (HYBRID_WORKERS, HYBRID_RANKS,
                                        HYBRID_RANKS, HYBRID_RANKS,
                                        HYBRID_BATCH):
            bad.append('%s: workers %s, group %s, world %s, data %s, local '
                       'batch %s' % (who, row['workers'], row['group_size'],
                                     row['world'], row['dp'],
                                     row['local_batch']))
        if row['probe'] != probe:
            bad.append('%s: probe pulls %s, expected %s' % (
                who, [p[0][0] for p in row['probe']],
                [p[0][0] for p in probe]))
        if row['launches_per_step'] != [want] * HYBRID_STEPS:
            bad.append('%s: conv launches %s, expected %d a step'
                       % (who, row['launches_per_step'], want))
        # the leader pushes every key once a round, the other rank never
        if row['rounds'] != HYBRID_STEPS + 1 or row['keys'] != keys or \
                row['pushes'] != (row['rounds'] * keys if r == 0 else 0):
            bad.append('%s: %d pushes over %d rounds of %d keys'
                       % (who, row['pushes'], row['rounds'], row['keys']))
        if abs(row['rescale_grad'] - 1.0 / (
                HYBRID_BATCH * HYBRID_RANKS * HYBRID_WORKERS)) > 1e-12:
            bad.append('%s: rescale_grad %g' % (who, row['rescale_grad']))
        if row['param_digest'] != rows[0]['param_digest']:
            bad.append('%s: weights differ from worker 0 rank 0\'s' % who)
        mate = next(x for x in rows if x['worker'] == w and x['rank'] == 0)
        for key in ('aux_digest', 'loss'):
            if row[key] != mate[key]:
                bad.append('%s: %s differs from its worker\'s rank 0'
                           % (who, key))
        for case, c in row['reducers'].items():
            if not c['ok']:
                bad.append('%s: %s over the data mesh off the one-device '
                           'step (%.3g of the bound, differ %s)'
                           % (who, case, c['max_err_over_bound'],
                              c['differ']))
        if sorted(row['reducers']) != sorted(HYBRID_BR_CASES):
            bad.append('%s: reduction cases %s' % (who,
                                                   sorted(row['reducers'])))
        sce = row['sce']
        if sce['launches'] != want or not sce['grads_finite'] or \
                sce['replicated'] != [True] or \
                math.prod(sce['out_shape']) != 1:
            bad.append('%s: the softmax_cross_entropy step: %s' % (who, sce))
        if r == 0:
            ref = row['sce_one_device']
            if abs(sce['loss'] - ref['loss']) > DP_LOSS_ATOL:
                bad.append('%s: the softmax_cross_entropy loss %.5f vs one '
                           'device %.5f (tol %g)' % (who, sce['loss'],
                                                     ref['loss'],
                                                     DP_LOSS_ATOL))
        for c in row.get('kernel_checks', ()):
            if not c['ok']:
                bad.append('%s: the kernel off its plain version at %s %s'
                           % (who, c['x'], c['w']))
    if not any(row.get('kernel_checks') for row in rows):
        bad.append('no rank checked the kernel at its shapes')
    for name, ok in sorted(run['group_sums'].items()):
        if not ok:
            bad.append('%s: the pushed gradient is not its ranks\' sum'
                       % name)
    for name, ok in sorted(run['server_check'].items()):
        if not ok:
            bad.append('the server\'s update of %s differs from the '
                       'optimizer on cpu(0)' % name)
    if run['server_cuda_initialized'] is not False:
        bad.append('the server initialized CUDA (or wrote no report)')
    if run['ranks_exited_ok'] != HYBRID_WORKERS * HYBRID_RANKS:
        bad.append('%d of %d ranks finished' % (
            run['ranks_exited_ok'], HYBRID_WORKERS * HYBRID_RANKS))
    return bad


def hybrid_phase(torch, mx, root, smi, started=None):
    """Phase 35: hybrid workers (the module comment above); gated by
    hybrid_gate."""
    if started is None:
        torch.cuda.empty_cache()
        started = hybrid_start(root)
    out, launch = started
    try:
        res, wall = launch.wait()
        if res.returncode != 0:
            fail('phase 35: the launcher exited %d (its log is named above)'
                 % res.returncode)
        rows, dumps = [], {}
        for w in range(HYBRID_WORKERS):
            for r in range(HYBRID_RANKS):
                with open(out / ('w%d_r%d.json' % (w, r))) as f:
                    rows.append(json.load(f))
                dumps[(w, r)] = torch.load(
                    str(out / ('w%d_r%d.pt' % (w, r))), weights_only=False)
        report_path = out / 'server.json'
        report = json.loads(report_path.read_text()) \
            if report_path.exists() else {}
        group_sums = hybrid_group_sums(torch, dumps)
        server_check = hybrid_server_check(torch, mx, dumps)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    step_ms = [median(row['step_ms'][1:]) for row in rows]
    device_ms = [row['profiled_device_ms'] for row in rows]
    busy = sum(device_ms) / max(step_ms)
    checks = next(row['kernel_checks'] for row in rows
                  if row.get('kernel_checks'))
    run = dict(
        config='bf16 ResNet-50, %d workers x %d ranks sharing the card '
               'over gloo, %d images a rank step (%d a worker, %d in all), '
               'one CPU parameter server, dist_sync' % (
                   HYBRID_WORKERS, HYBRID_RANKS, HYBRID_BATCH,
                   HYBRID_BATCH * HYBRID_RANKS,
                   HYBRID_BATCH * HYBRID_RANKS * HYBRID_WORKERS),
        card=smi, wall_s=wall, step_ms_by_rank=step_ms,
        profiled_device_ms_by_rank=device_ms, device_busy_share=busy,
        launches=sum(row['launches'] for row in rows),
        kernel_pairs_ms=sum(c['ms'] * c['pairs'] for c in checks),
        kernel_pairs_bound_ms=sum(c['bound_ms'] * c['pairs']
                                  for c in checks),
        kernel_pairs_library_ms=sum(c['library_ms'] * c['pairs']
                                    for c in checks),
        group_sums=group_sums, server_check=server_check,
        server_cuda_initialized=report.get('cuda_initialized'),
        ranks_exited_ok=res.stdout.count('HYBRID_RANK_OK'),
        reducers_s=max(row['reducers_s'] for row in rows), ranks=rows)
    print('hybrid ' + json.dumps(run))
    bad = hybrid_gate(rows, run)
    if bad:
        fail('phase 35: ' + '; '.join(bad))
    r0 = rows[0]
    print('hybrid: %d workers x %d ranks on one card (%s): a rank\'s step '
          '%s ms by rank, the card busy %.1f %% of a step; %d conv launches '
          '(32 a rank step), %d pushes a leader over %d rounds of %d keys; '
          'the four ranks bit-equal; the server\'s update bit-equal on %s; '
          'the %d reductions within the CPU tests\' tolerance of one '
          'device on every rank; the softmax_cross_entropy step\'s loss '
          '%.5f vs one device %.5f; launch %.1f s' % (
              HYBRID_WORKERS, HYBRID_RANKS, smi,
              ['%.1f' % ms for ms in step_ms], 100 * busy, run['launches'],
              r0['pushes'], r0['rounds'], r0['keys'], list(DIST_PROBES),
              len(HYBRID_BR_CASES), r0['sce']['loss'],
              r0['sce_one_device']['loss'], wall))
    return run


# ---------------------------------------------------------------------------
# Phase 36: a Custom numpy loss head trains the bf16 ResNet-50 through
# Module; a legacy NumpyOp step; test_utils.check_consistency of a conv ->
# BatchNorm pair over cpu, gpu and bfloat16
# ---------------------------------------------------------------------------

CUSTOM_BATCH = 256
CUSTOM_STEPS = 2
CUSTOM_SEED = SEED + 3600
CUSTOM_OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                  multi_precision=True)
# the Custom head's steps against SoftmaxOutput(normalization='batch')'s
# (the same loss and gradient, the softmax and its gradient computed on
# the host in numpy instead of by torch on the card), from phase 16's
# conditioned values: both steps' losses within phase 9's
# RESNET_LOSS_ATOL, and after two steps the float32 weights and masters
# within phase 10's MODULE_STATE_REL in relative norm. The bf16 weights
# in bf16 steps and the momenta are reported, not gated: the two heads'
# float32 gradients differ in their last bits (numpy's softmax against
# torch's), a bf16 gradient then rounds one step apart here and there,
# and where a leaf's gradient nearly cancels, or a weight is near zero
# (its bf16 spacing finer than an update), that is a large share (on an
# H100 80GB HBM3: momenta up to 0.285 apart, a weight 2 steps) while the
# masters moved 3.2e-8 apart
# check_consistency's specs and tolerances: cpu float32, gpu float32 and
# gpu bfloat16 at the reference's low-precision tolerance (its
# check_consistency takes 1e-1 for float16; bfloat16 keeps 3 bits fewer),
# then cpu float32 against gpu float32 alone at the JAX test's 1e-3
CUSTOM_CONSISTENCY = dict(data=(16, 16, 14, 14), num_filter=32,
                          rtol=1e-1, atol=1e-1, f32_rtol=1e-3,
                          f32_atol=1e-3)


def custom_register(mx):
    """examples/numpy_ops/custom_softmax.py's loss head, registered as
    'chip_np_softmax_loss', and a legacy NumpyOp (x squared)."""
    op_mod = mx.operator

    class NumpySoftmaxLoss(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            z = np.asarray(in_data[0])
            z = z - z.max(axis=1, keepdims=True)
            e = np.exp(z)
            self.assign(out_data[0], req[0],
                        e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            p = np.asarray(out_data[0])
            labels = np.asarray(in_data[1]).astype(int)
            grad = p.copy()
            grad[np.arange(len(labels)), labels] -= 1.0
            self.assign(in_grad[0], req[0],
                        grad / len(labels) * CUSTOM_GRAD_SCALE[0])

    @op_mod.register('chip_np_softmax_loss')
    class NumpySoftmaxLossProp(op_mod.CustomOpProp):
        def __init__(self, **kwargs):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ['data', 'label']

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return NumpySoftmaxLoss()

    class Square(op_mod.NumpyOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = np.asarray(in_data[0]) ** 2

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = 2 * np.asarray(in_data[0]) * \
                np.asarray(out_grad[0])
    return Square


# the Custom head's backward is scaled by this (1: the example's); the
# phase runs the head once more with CUSTOM_PLANT_SCALE, which the state
# gate must fail
CUSTOM_GRAD_SCALE = [1.0]
CUSTOM_PLANT_SCALE = 1.5


def custom_symbols(mx):
    """(the SoftmaxOutput net, the Custom-head net): the bf16 ResNet-50,
    its head cast to float32."""
    ref = mx.models.resnet.get_symbol(**RESNET)
    fc = ref.get_internals()['cast_out_output']
    ref = mx.sym.SoftmaxOutput(fc, name='softmax', normalization='batch')
    custom = mx.sym.Custom(fc, mx.sym.Variable('softmax_label'),
                           op_type='chip_np_softmax_loss', name='softmax')
    return ref, custom


def custom_steps(torch, mx, cuda_conv, symbol, params, batches, ctx):
    """CUSTOM_STEPS Module steps of `symbol` on ctx from `params`: the
    first loss, the conv launches a step, the ms a step and the state
    after (module_state)."""
    cpu = mx.cpu()
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    mod = mx.mod.Module(symbol, context=ctx, label_names=['softmax_label'])
    mod.bind(data_shapes=[mx.io.DataDesc('data', (CUSTOM_BATCH,) + shape)],
             label_shapes=[mx.io.DataDesc('softmax_label', (CUSTOM_BATCH,))])
    mod.init_params(initializer=None,
                    arg_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in params[0].items()},
                    aux_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in params[1].items()})
    mod.init_optimizer(kvstore=None, optimizer='sgd',
                       optimizer_params=dict(CUSTOM_OPT))
    launches, ms, losses = [], [], []
    for b in batches:
        before = cuda_conv.CONV_BN_STATS_LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(b)
        mod.update()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(cuda_conv.CONV_BN_STATS_LAUNCHES - before)
        losses.append(dp_nll(torch, mod.get_outputs()[0], b.label[0]))
    state = module_state(mod)
    del mod
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=ms, losses=losses), state


def custom_compare(torch, got, ref):
    """The Custom head's state against SoftmaxOutput's: bf16 weights in
    bf16 steps, float32 weights and masters and the momenta in relative
    norm."""
    steps, rel, moms = {}, {}, {}
    for key, r in ref.items():
        kind, _, name = key.partition(' ')
        if kind == 'arg' and r.dtype == torch.bfloat16:
            steps[name] = bf16_steps(torch, got[key], r)
        elif kind == 'mom':
            moms[name] = rel_err(torch, got[key], r)
        elif kind in ('arg', 'master'):
            rel[key] = rel_err(torch, got[key], r)
    worst = max(rel, key=rel.get)
    return dict(weight_steps_max=max(steps.values()),
                weight_steps_worst=max(steps, key=steps.get),
                state_rel_max=rel[worst], state_rel_worst=worst,
                mom_rel_max=max(moms.values()),
                mom_rel_worst=max(moms, key=moms.get),
                bf16_weights=len(steps), float32_states=len(rel))


def custom_gate(run):
    """What is wrong with phase 36's run (empty when nothing)."""
    bad = []
    want = route_pairs(RESNET_PAIRS, stem_split_on())
    for head in ('custom', 'softmax'):
        if run[head]['launches'] != [want] * CUSTOM_STEPS:
            bad.append('the %s head\'s steps launched the kernel %s times, '
                       'expected %d a step' % (head, run[head]['launches'],
                                               want))
    for i, (a, b) in enumerate(zip(run['custom']['losses'],
                                   run['softmax']['losses'])):
        if not abs(a - b) <= RESNET_LOSS_ATOL:
            bad.append('step %d loss %.5f vs SoftmaxOutput\'s %.5f'
                       % (i, a, b))
    cmp_ = run['compare']
    if not cmp_['state_rel_max'] <= MODULE_STATE_REL:
        bad.append('%s differs by %.3g (bound %g)' % (
            cmp_['state_rel_worst'], cmp_['state_rel_max'],
            MODULE_STATE_REL))
    if run['planted']['state_rel_max'] <= MODULE_STATE_REL:
        bad.append('the Custom head\'s backward x%g passed the state gate '
                   '(%.3g)' % (run['planted']['scale'],
                               run['planted']['state_rel_max']))
    if not run['legacy']['ok']:
        bad.append('the NumpyOp step: %s' % run['legacy'])
    for key in ('consistency', 'consistency_f32'):
        if not run[key]['ok']:
            bad.append('check_consistency over %s: %s'
                       % (run[key]['specs'], run[key]['error']))
    if run['consistency']['launches'] < 1:
        bad.append('check_consistency\'s bf16 run did not reach the kernel')
    return bad


def custom_legacy_check(torch, mx, Square, ctx):
    """One train forward and backward of the NumpyOp x squared on ctx:
    the output x^2 and the gradient 2 x g, bit for bit."""
    rng = np.random.default_rng(CUSTOM_SEED + 1)
    x = rng.standard_normal(4096).astype(np.float32)
    g = rng.standard_normal(4096).astype(np.float32)
    net = Square().get_symbol(mx.sym.Variable('x'), name='square')
    ex = net.simple_bind(ctx, grad_req='write', x=x.shape)
    ex.forward(is_train=True, x=mx.nd.array(x, ctx=ctx))
    out = ex.outputs[0]
    ex.backward(out_grads=mx.nd.array(g, ctx=ctx))
    grad = ex.grad_dict['x']
    on_card = out.handle.device.type == ctx.torch_device.type
    ok = on_card and np.array_equal(out.asnumpy(), x ** 2) and \
        np.array_equal(grad.asnumpy(), 2 * x * g)
    return dict(ok=bool(ok), on_device=str(out.handle.device),
                elements=x.size)


def custom_consistency(torch, mx, cuda_conv, ctx, low=True):
    """test_utils.check_consistency of a conv -> BatchNorm pair weighted
    by an argument (under its head of ones the BatchNorm's output alone
    has gradients of exactly 0) over [cpu float32, ctx float32, ctx
    bfloat16] (`low`), else [cpu float32, ctx float32] at float32's
    tolerance; the conv launches."""
    c = CUSTOM_CONSISTENCY
    S = mx.sym
    x = S.Convolution(S.Variable('data'), num_filter=c['num_filter'],
                      kernel=(3, 3), pad=(1, 1), no_bias=True, name='conv')
    x = S.BatchNorm(x, name='bn', fix_gamma=False)
    net = x * S.Variable('head')
    specs = [dict(ctx=mx.cpu(), data=c['data']), dict(ctx=ctx, data=c['data'])]
    names = ['cpu float32', '%s float32' % ctx]
    if low:
        specs.append(dict(ctx=ctx, data=c['data'], type_dict={
            'data': 'bfloat16', 'conv_weight': 'bfloat16'}))
        names.append('%s bfloat16' % ctx)
    rtol, atol = (c['rtol'], c['atol']) if low else (c['f32_rtol'],
                                                     c['f32_atol'])
    np.random.seed(CUSTOM_SEED + 2)
    before = cuda_conv.CONV_BN_STATS_LAUNCHES
    try:
        mx.test_utils.check_consistency(net, specs, scale=0.5, rtol=rtol,
                                        atol=atol)
        err = None
    except AssertionError as e:
        err = str(e)
    return dict(ok=err is None, error=err, rtol=rtol, atol=atol,
                launches=cuda_conv.CONV_BN_STATS_LAUNCHES - before,
                specs=names)


def custom_phase(torch, mx, cuda_conv, smi, ctx=None):
    """Phase 36: the bf16 ResNet-50 through Module with the Custom numpy
    softmax-loss head against SoftmaxOutput(normalization='batch'), a
    NumpyOp step and check_consistency; gated by custom_gate."""
    ctx = ctx or mx.gpu(0)
    Square = custom_register(mx)
    ref_sym, custom_sym = custom_symbols(mx)
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    args, auxs = resnet_params(ref_sym, dict(data=(CUSTOM_BATCH,) + shape,
                                             softmax_label=(CUSTOM_BATCH,)),
                               RESNET['num_classes'], CUSTOM_SEED)
    # phase 16's conditioned values: the seeded He-normal net is chaotic
    # at initialisation, and a last-bit difference of the head's float32
    # gradient (numpy's softmax against torch's) that rounds one bf16
    # gradient apart grows through its backward beyond any bound
    params = (conditioned({k: v for k, v in args.items()
                           if k not in NO_GRAD}), auxs)
    _, batches = dp_batches(mx, shape, CUSTOM_STEPS, CUSTOM_SEED + 3,
                            CUSTOM_BATCH)
    torch.backends.cudnn.deterministic = True
    def fresh():
        # each run its own copy: a bound array on the host may share the
        # numpy array's memory, and the update writes it in place
        return tuple({k: v.copy() for k, v in part.items()}
                     for part in params)
    try:
        cuda_conv.CONV_BN_STATS_LAUNCHES = 0
        custom, got = custom_steps(torch, mx, cuda_conv, custom_sym,
                                   fresh(), batches, ctx)
        custom['path_launches'] = cuda_conv.CONV_BN_STATS_LAUNCHES
        softmax, ref = custom_steps(torch, mx, cuda_conv, ref_sym, fresh(),
                                    batches, ctx)
        # the gate's reading of a Custom head whose backward is off by
        # CUSTOM_PLANT_SCALE
        CUSTOM_GRAD_SCALE[0] = CUSTOM_PLANT_SCALE
        try:
            _, planted = custom_steps(torch, mx, cuda_conv, custom_sym,
                                      fresh(), batches, ctx)
        finally:
            CUSTOM_GRAD_SCALE[0] = 1.0
    finally:
        torch.backends.cudnn.deterministic = False
    compare = custom_compare(torch, got, ref)
    planted_compare = custom_compare(torch, planted, ref)
    del got, ref, planted
    run = dict(config='bf16 ResNet-50 at batch %d, %d Module steps, the '
               'Custom numpy softmax-loss head against SoftmaxOutput('
               'normalization=\'batch\')' % (CUSTOM_BATCH, CUSTOM_STEPS),
               card=smi, custom=custom, softmax=softmax, compare=compare,
               planted=dict(scale=CUSTOM_PLANT_SCALE,
                            state_rel_max=planted_compare['state_rel_max'],
                            state_rel_worst=planted_compare[
                                'state_rel_worst']),
               launches=custom['path_launches'],
               legacy=custom_legacy_check(torch, mx, Square, ctx),
               consistency=custom_consistency(torch, mx, cuda_conv, ctx),
               consistency_f32=custom_consistency(torch, mx, cuda_conv, ctx,
                                                  low=False))
    print('custom ' + json.dumps(run))
    bad = custom_gate(run)
    if bad:
        fail('phase 36: ' + '; '.join(bad))
    print('custom: the Custom head\'s steps %s ms (SoftmaxOutput\'s %s), %s '
          'conv launches a step; losses %s vs %s; after %d steps the float32 '
          'state within %.3g (%s), the bf16 weights %.3g bf16 steps apart '
          '(%s), the momenta %.3g (%s); its backward x%g planted %.3g apart; '
          'the NumpyOp step bit-exact on %s; '
          'check_consistency over %s within %g (%d conv launches) and over '
          '%s within %g' % (
              ['%.1f' % t for t in custom['ms']],
              ['%.1f' % t for t in softmax['ms']], custom['launches'],
              ['%.5f' % v for v in custom['losses']],
              ['%.5f' % v for v in softmax['losses']], CUSTOM_STEPS,
              compare['state_rel_max'], compare['state_rel_worst'],
              compare['weight_steps_max'], compare['weight_steps_worst'],
              compare['mom_rel_max'], compare['mom_rel_worst'],
              CUSTOM_PLANT_SCALE, run['planted']['state_rel_max'],
              run['legacy']['on_device'], run['consistency']['specs'],
              run['consistency']['rtol'], run['consistency']['launches'],
              run['consistency_f32']['specs'],
              run['consistency_f32']['rtol']))
    return run


# -- phase 37: the native runtime -------------------------------------------

ENGINE_PUSHES = 2000        # pushes of the seeded engine program
ENGINE_VARS = 32            # its variables
ENGINE_WORKERS = 8          # the native engine's workers
ENGINE_MOD = (1 << 61) - 1  # the program's values live mod this prime


def engine_program(eng, seed, pushes=ENGINE_PUSHES, nvars=ENGINE_VARS):
    """A seeded program of `pushes` ops over `nvars` variables on `eng`
    (an mx.engine Engine, or the JAX package's): each op reads up to four
    variables' values and folds them, with its index, into the values of
    the ones it writes; a wait_for_var now and then. Under the engine's
    rules (a variable's ops in push order, readers together, a writer
    alone) the final values are fixed by the program: returns them."""
    rng = random.Random(seed)
    handles = [eng.new_variable() for _ in range(nvars)]
    state = [v + 1 for v in range(nvars)]

    def op(i, reads, writes):
        def f():
            acc = i
            for r in reads:
                acc = (acc * 1000003 + state[r]) % ENGINE_MOD
            for w in writes:
                state[w] = (state[w] * 31 + acc + w) % ENGINE_MOD
        return f
    for i in range(pushes):
        picks = rng.sample(range(nvars), rng.randint(0, 4))
        n_write = rng.randint(0, len(picks))
        writes, reads = picks[:n_write], picks[n_write:]
        eng.push(op(i, reads, writes),
                 const_vars=[handles[r] for r in reads],
                 mutable_vars=[handles[w] for w in writes])
        if rng.random() < 0.01:
            eng.wait_for_var(handles[rng.randrange(nvars)])
    eng.wait_all()
    return list(state)


NATIVE_THREADS = 8          # preprocess_threads of the native iterator
NATIVE_EPOCHS = 2           # fit epochs over phase 18's 768 images
NATIVE_RESETS = 20          # resets mid-epoch, each then a full epoch
NATIVE_RECORDS = 8          # records of the RecordIO cross-reads


def engine_checks(mx):
    """mx.engine on the native ThreadedEngine: writes to one variable in
    push order, four readers between two writers see the first write,
    duplicate variables refused, and engine_program's state (two seeds)
    the same on the native engine as on NaiveEngine."""
    from mxnet_tpu_torch import _core, engine as engine_mod
    eng = engine_mod.Engine(num_workers=ENGINE_WORKERS)
    native = isinstance(eng._impl, engine_mod._NativeEngine)
    var = eng.new_variable()
    order = []
    for i in range(64):
        eng.push(lambda i=i: order.append(i), mutable_vars=(var,))
    eng.wait_all()
    box, seen = [0], []

    def write(v):
        def f():
            time.sleep(0.002)
            box[0] = v
        return f
    eng.push(write(1), mutable_vars=(var,))
    for _ in range(4):
        eng.push(lambda: seen.append(box[0]), const_vars=(var,))
    eng.push(write(2), mutable_vars=(var,))
    for _ in range(4):
        eng.push(lambda: seen.append(box[0]), const_vars=(var,))
    eng.wait_all()
    refused = 0
    for const, mut in (((), (var, var)), ((var,), (var,)), ((var, var), ())):
        try:
            eng.push(lambda: None, const_vars=const, mutable_vars=mut)
        except _core.NativeError:
            refused += 1
    programs = []
    for seed in (SEED, SEED + 1):
        t0 = time.perf_counter()
        got = engine_program(eng, seed)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = engine_program(engine_mod._PyEngine(), seed)  # NaiveEngine
        programs.append(dict(seed=seed, equal=got == want, native_s=native_s,
                             naive_s=time.perf_counter() - t0))
    eng.close()
    return dict(native=native, serial=order == list(range(64)),
                read_write=seen == [1] * 4 + [2] * 4,
                duplicates_refused=refused, programs=programs,
                pushes=ENGINE_PUSHES, variables=ENGINE_VARS)


def recordio_checks(mx, work):
    """The C writer's records read by recordio.MXRecordIO, and
    MXRecordIO's records read by the C reader, byte for byte."""
    import ctypes
    from mxnet_tpu_torch import _core
    lib = _core.lib()
    rng = np.random.default_rng(SEED + 370)
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(0, 5000, NATIVE_RECORDS)]
    c_path, py_path = str(work / 'c.rec'), str(work / 'py.rec')
    w = lib.MXTRecordWriterCreate(c_path.encode())
    for p in payloads:
        lib.MXTRecordWriterWrite(w, p, len(p))
    lib.MXTRecordWriterFree(w)
    r = mx.recordio.MXRecordIO(c_path, 'r')
    c_to_py = [r.read() for _ in payloads] + [r.read()]
    r.close()
    w = mx.recordio.MXRecordIO(py_path, 'w')
    for p in payloads:
        w.write(p)
    w.close()
    r = lib.MXTRecordReaderCreate(py_path.encode())
    data_p, size = ctypes.c_char_p(), ctypes.c_uint64()
    py_to_c = []
    while lib.MXTRecordReaderNext(r, ctypes.byref(data_p),
                                  ctypes.byref(size)) == 1:
        py_to_c.append(ctypes.string_at(data_p, size.value))
    lib.MXTRecordReaderFree(r)
    return dict(records=len(payloads),
                c_to_py=c_to_py == payloads + [None],
                py_to_c=py_to_c == payloads,
                same_bytes=open(c_path, 'rb').read() ==
                open(py_path, 'rb').read())


def native_iter(mx, prefix, ctx, train=True):
    """ImageRecordIter(use_native=True) over prefix.rec: shuffled with
    random crops and mirrors (seeded) for training, else in file order,
    centre-cropped."""
    shape = tuple(int(v) for v in RESNET['image_shape'].split(','))
    return mx.io.ImageRecordIter(
        path_imgrec=prefix + '.rec', data_shape=shape,
        batch_size=RESNET_BATCH, shuffle=train, rand_crop=train,
        rand_mirror=train, seed=SEED, preprocess_threads=NATIVE_THREADS,
        use_native=True, ctx=ctx)


def reset_check(torch, it, resets=NATIVE_RESETS):
    """`resets` times: reset, take a seeded number of batches (at least
    one, fewer than an epoch), reset, take a whole epoch; each such epoch
    against the first one's batches, bit for bit."""
    def epoch():
        return [(b.data[0].handle.clone(), b.label[0].handle.clone(), b.pad)
                for b in it]
    it.reset()
    first = epoch()
    rng = np.random.default_rng(SEED + 371)
    equal, taken = [], []
    t0 = time.perf_counter()
    for _ in range(resets):
        it.reset()
        k = int(rng.integers(1, max(2, len(first))))
        for _ in range(k):
            it.next()
        taken.append(k)
        it.reset()
        again = epoch()
        equal.append(len(again) == len(first) and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and
            a[2] == b[2] for a, b in zip(again, first)))
    return dict(resets=resets, batches=len(first), taken=taken,
                equal=equal, s=time.perf_counter() - t0)


def iter_images_per_s(it, sync):
    """Images a second over one epoch of `it` after its reset."""
    it.reset()
    sync()
    t0 = time.perf_counter()
    n = 0
    for b in it:
        n += b.data[0].shape[0] - (b.pad or 0)
    sync()
    return n / (time.perf_counter() - t0)


def native_fit(torch, mx, cuda_conv, prefix, ctx, counter):
    """Module.fit on phase 10's bf16 ResNet-50 fed by the native iterator:
    per batch, the conv launches (`counter`, set to 0 just before the fit
    and read after each batch) and the NLL of its output."""
    symbol, init = module_symbol_params(mx)
    mod = mx.mod.Module(symbol, context=ctx)
    it = native_iter(mx, prefix, ctx)
    launches, losses, last = [], [], [0]

    def record(param):
        b = param.locals['data_batch']
        losses.append(dp_nll(torch, mod.get_outputs()[0], b.label[0]))
        now = counter()
        launches.append(now - last[0])
        last[0] = now
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    cuda_conv.CONV_BN_STATS_PLAIN_CALLS = 0
    last[0] = counter()
    t0 = time.perf_counter()
    mod.fit(it, eval_metric='acc', optimizer='sgd',
            optimizer_params=module_optimizer_params(mx), initializer=init,
            batch_end_callback=record, num_epoch=NATIVE_EPOCHS)
    if ctx.device_type == 'gpu':
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    it.close()
    ex = mod._exec_group.executor
    finite = all(bool(torch.isfinite(a.handle).all())
                 for a in list(ex.arg_dict.values()) +
                 list(ex.aux_dict.values()))
    pairs = graph_pairs(symbol)
    del mod, ex
    return dict(launches=launches, losses=losses, fit_s=fit_s,
                finite=finite, batches_an_epoch=len(losses) // NATIVE_EPOCHS,
                want=route_pairs(pairs, stem_split_on()))


def native_gate(run):
    """Phase 37's checks on a run's numbers: what failed, empty when it
    passed."""
    bad = []
    eng = run['engine']
    if not eng['native']:
        bad.append('mx.engine.Engine() is not the native engine')
    for key, what in (('serial', 'writes out of push order'),
                      ('read_write', 'readers saw the wrong write')):
        if not eng[key]:
            bad.append('engine: ' + what)
    if eng['duplicates_refused'] != 3:
        bad.append('engine: %d of 3 duplicate-var pushes refused'
                   % eng['duplicates_refused'])
    for p in eng['programs']:
        if not p['equal']:
            bad.append('engine: the program of seed %d ends apart from '
                       'NaiveEngine\'s' % p['seed'])
    io_ = run['recordio']
    for key in ('c_to_py', 'py_to_c', 'same_bytes'):
        if not io_[key]:
            bad.append('recordio: %s failed' % key)
    if not run['image']['built']:
        if 'OpenCV' not in run['image']['refused']:
            bad.append('ImageRecordIter(use_native=True) without its '
                       'library did not raise naming OpenCV: %r'
                       % run['image']['refused'])
        return bad
    fit = run['fit']
    n = fit['batches_an_epoch']
    if n < 1 or fit['launches'] != [fit['want']] * (n * NATIVE_EPOCHS):
        bad.append('fit launched the kernel %s times a step, expected %d'
                   % (fit['launches'], fit['want']))
    losses = fit['losses']
    if not losses or not all(math.isfinite(v) for v in losses) or \
            not fit['finite']:
        bad.append('fit: a loss or a parameter is not finite: %s' % losses)
    elif not np.mean(losses[-n:]) < np.mean(losses[:n]):
        bad.append('fit: the loss did not fall: %s' % losses)
    r = run['resets']
    if len(r['equal']) != NATIVE_RESETS or not all(r['equal']):
        bad.append('after reset %s the epoch differs from the first'
                   % [i for i, e in enumerate(r['equal']) if not e])
    return bad


def native_phase(torch, mx, cuda_conv, root, prefix=None, build=None,
                 ctx=None, counter=None):
    """Phase 37: the native runtime (csrc/native/, built on the card's
    host): mx.engine's ordering and refusals and engine_program against
    NaiveEngine, RecordIO between the C writer / reader and
    recordio.MXRecordIO; then, where the image iterator's library builds
    (OpenCV 4), ImageRecordIter(use_native=True, 8 threads) over phase
    18's .rec alone against the nvJPEG iterator, NATIVE_RESETS resets
    mid-epoch, and Module.fit on the bf16 ResNet-50 fed by it, and where
    it does not, use_native=True raising and naming what is missing.
    `prefix` is phase 18's kept .rec (written here when None), `build`
    host_builds' results (built here when None); gated by native_gate."""
    from mxnet_tpu_torch import _core
    ctx = ctx or mx.gpu(0)
    counter = counter or (lambda: cuda_conv.CONV_BN_STATS_LAUNCHES)
    work = fresh_dir(root, 37)
    if build is None:
        build = {}
        host_builds(build)
    if isinstance(build['native'], Exception):
        fail('phase 37: the native runtime failed to build: %s'
             % build['native'])
    if prefix is None:
        prefix = str(work / 'train')
        write_record_images(torch, mx, prefix, RECORD_IMAGES,
                            RESNET['num_classes'], ctx)
    run = dict(library=str(build['native'][0]), build_s=build['native'][1],
               engine=engine_checks(mx), recordio=recordio_checks(mx, work),
               threads=NATIVE_THREADS)
    image = build['image']
    if isinstance(image, Exception):
        # no OpenCV: the iterator must refuse, naming it
        try:
            native_iter(mx, prefix, ctx).close()
            refused = None
        except _core.NativeError as e:
            refused = str(e)
        run['image'] = dict(built=False, error=str(image)[:600],
                            refused=(refused or '')[:600])
    else:
        run['image'] = dict(built=True, library=str(image[0]),
                            build_s=image[1])
        sync = torch.cuda.synchronize if ctx.device_type == 'gpu' else \
            (lambda: None)
        it = native_iter(mx, prefix, ctx)
        run['native_images_per_s'] = iter_images_per_s(it, sync)
        it.close()
        nvjpeg = record_iter(mx, prefix, ctx)
        random.seed(SEED)
        run['nvjpeg_images_per_s'] = iter_images_per_s(nvjpeg, sync)
        nvjpeg.close()
        it = native_iter(mx, prefix, mx.cpu(), train=False)
        run['resets'] = reset_check(torch, it)
        it.close()
        run['fit'] = native_fit(torch, mx, cuda_conv, prefix, ctx, counter)
    shutil.rmtree(work, ignore_errors=True)
    print('native ' + json.dumps(run))
    bad = native_gate(run)
    if bad:
        fail('phase 37: ' + '; '.join(bad))
    if run['image']['built']:
        fit = run['fit']
        what = ('the iterator alone %.0f images/s (%d threads) against '
                'nvJPEG\'s %.0f; %d resets, each epoch bit-equal; fit %s '
                'launches a step, loss %.3f -> %.3f'
                % (run['native_images_per_s'], NATIVE_THREADS,
                   run['nvjpeg_images_per_s'], NATIVE_RESETS,
                   sorted(set(fit['launches'])), fit['losses'][0],
                   fit['losses'][-1]))
    else:
        what = ('no native image iterator on this host: use_native=True '
                'raises (%s)' % run['image']['refused'][:200])
    print('native: engine and RecordIO built in %.1f s; engine program '
          '(%d pushes, %d vars) equal to NaiveEngine; RecordIO both ways; '
          '%s' % (run['build_s'], ENGINE_PUSHES, ENGINE_VARS, what))
    return run


# -- phase 38: the C training API ------------------------------------------

C_TRAIN_BATCH = 64
C_TRAIN_STEPS = 3
C_TRAIN_SEED = SEED + 380
# the program's optimizer: SGD with momentum on the summed loss, rescaled
# by 1 / batch inside it
C_TRAIN_LR, C_TRAIN_MOMENTUM = '0.1', '0.9'
# a kernel on the program's path found to give other bits on a second run
# of the same inputs: its name. None: none is known, so the two runs in
# the script's process must agree bit for bit, and the program and the
# replay with them. Named, the program and the replay are held to phase
# 36's bounds instead: each loss within RESNET_LOSS_ATOL, each weight
# array within MODULE_STATE_REL in relative norm
C_TRAIN_NONDETERMINISTIC = None
# the program: no Python in its source. Built twice, as an executable and
# (-DMXT_C_TRAIN_NO_MAIN) as a shared object whose mxt_c_train the
# script calls through ctypes in its own process, so both make the same
# calls, and writes its outputs, labels, batches and final weights under
# out_dir. argv: dev_type symbol.json params rec side batch steps out_dir
# source [a step at which the first weight's update is skipped: a planted
# fault]; source "native" takes the native iterator (shuffled, random
# crops and mirrors, seeded), a context such as "gpu(0)" the port's
# pipeline there in file order (nvJPEG on the card)
C_TRAIN_PROGRAM = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

extern const char* MXTTrainGetLastError(void);
extern int MXTSymbolCreateFromJSON(const char* json, void** out);
extern int MXTSymbolListArguments(void* sym, uint32_t* n,
                                  const char*** names);
extern void MXTSymbolFree(void* sym);
extern int MXTExecutorSimpleBind(void* sym, int dev_type, int dev_id,
                                 const char* grad_req, uint32_t n,
                                 const char** keys, const uint32_t* indptr,
                                 const uint32_t* shapes, void** out);
extern int MXTExecutorArgArray(void* ex, const char* name, void** out);
extern int MXTExecutorGradArray(void* ex, const char* name, void** out);
extern int MXTExecutorForward(void* ex, int is_train);
extern int MXTExecutorBackward(void* ex);
extern int MXTExecutorOutput(void* ex, uint32_t index, void** out);
extern void MXTExecutorFree(void* ex);
extern int MXTNDArrayLoad(const char* fname, void** list, uint32_t* n);
extern int MXTNDArrayLoadGet(void* list, uint32_t i, const char** key,
                             void** nd);
extern int MXTNDArrayCopyFromNDArray(void* dst, void* src);
extern int MXTNDArrayGetShape(void* nd, uint32_t* ndim,
                              const uint32_t** shape);
extern int MXTNDArraySyncCopyToCPU(void* nd, float* data, size_t size);
extern void MXTNDArrayFree(void* nd);
extern int MXTNDArrayWaitAll(void);
extern int MXTDataIterCreate(const char* name, uint32_t n,
                             const char** keys, const char** vals,
                             void** out);
extern int MXTDataIterNext(void* it, int* has_next);
extern int MXTDataIterGetData(void* it, void** out);
extern int MXTDataIterGetLabel(void* it, void** out);
extern void MXTDataIterFree(void* it);
extern int MXTUpdaterCreate(const char* name, uint32_t n, const char** keys,
                            const char** vals, void** out);
extern int MXTUpdaterStep(void* upd, int index, void* grad, void* weight);
extern void MXTUpdaterFree(void* upd);

#define CHECK(x)                                                        \
  do {                                                                  \
    if ((x) != 0) {                                                     \
      fprintf(stderr, "line %d: %s: %s\n", __LINE__, #x,                \
              MXTTrainGetLastError());                                  \
      return 1;                                                         \
    }                                                                   \
  } while (0)

static int write_array(FILE* f, void* nd) {
  uint32_t ndim;
  const uint32_t* shape;
  size_t n = 1;
  CHECK(MXTNDArrayGetShape(nd, &ndim, &shape));
  for (uint32_t i = 0; i < ndim; ++i) n *= shape[i];
  float* buf = (float*)malloc(n * sizeof(float));
  CHECK(MXTNDArraySyncCopyToCPU(nd, buf, n));
  fwrite(buf, sizeof(float), n, f);
  free(buf);
  return 0;
}

int mxt_c_train(int argc, char** argv) {
  if (argc < 10) {
    fprintf(stderr, "usage: %s dev_type symbol.json params rec side batch "
                    "steps out_dir source [skip_step]\n", argv[0]);
    return 2;
  }
  int dev_type = atoi(argv[1]), side = atoi(argv[5]);
  int batch = atoi(argv[6]), steps = atoi(argv[7]);
  int native = !strcmp(argv[9], "native");
  int skip_step = argc > 10 ? atoi(argv[10]) : -1;
  char path[4096];

  FILE* f = fopen(argv[2], "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* json = (char*)malloc(len + 1);
  if (fread(json, 1, len, f) != (size_t)len) return 1;
  json[len] = 0;
  fclose(f);
  void* sym;
  CHECK(MXTSymbolCreateFromJSON(json, &sym));
  free(json);
  uint32_t n_args;
  const char** listed;
  CHECK(MXTSymbolListArguments(sym, &n_args, &listed));
  char** names = (char**)malloc(n_args * sizeof(char*));
  for (uint32_t i = 0; i < n_args; ++i) names[i] = strdup(listed[i]);

  const char* keys[2] = {"data", "softmax_label"};
  uint32_t indptr[3] = {0, 4, 5};
  uint32_t shapes[5] = {(uint32_t)batch, 3, (uint32_t)side, (uint32_t)side,
                        (uint32_t)batch};
  void* ex;
  CHECK(MXTExecutorSimpleBind(sym, dev_type, 0, "write", 2, keys, indptr,
                              shapes, &ex));
  void* list;
  uint32_t n_saved;
  CHECK(MXTNDArrayLoad(argv[3], &list, &n_saved));
  for (uint32_t i = 0; i < n_saved; ++i) {
    const char* key;
    void *saved, *arg;
    CHECK(MXTNDArrayLoadGet(list, i, &key, &saved));
    CHECK(MXTExecutorArgArray(ex, key, &arg));
    CHECK(MXTNDArrayCopyFromNDArray(arg, saved));
    MXTNDArrayFree(arg);
    MXTNDArrayFree(saved);
  }
  MXTNDArrayFree(list);

  char rescale[64], shape_param[64], batch_param[32];
  snprintf(rescale, sizeof(rescale), "%.9g", 1.0 / batch);
  const char* okeys[3] = {"learning_rate", "momentum", "rescale_grad"};
  const char* ovals[3] = {"LR", "MOMENTUM", rescale};
  void* upd;
  CHECK(MXTUpdaterCreate("sgd", 3, okeys, ovals, &upd));

  snprintf(shape_param, sizeof(shape_param), "(3,%d,%d)", side, side);
  snprintf(batch_param, sizeof(batch_param), "%d", batch);
  const char* ikeys[8] = {"path_imgrec", "data_shape", "batch_size",
                          "shuffle", "rand_crop", "rand_mirror",
                          "use_native", native ? "seed" : "ctx"};
  const char* flag = native ? "1" : "0";
  const char* ivals[8] = {argv[4], shape_param, batch_param, flag, flag,
                          flag, flag, native ? "SEED" : argv[9]};
  void* it;
  CHECK(MXTDataIterCreate("ImageRecordIter", 8, ikeys, ivals, &it));
  void *data_arg, *label_arg;
  CHECK(MXTExecutorArgArray(ex, "data", &data_arg));
  CHECK(MXTExecutorArgArray(ex, "softmax_label", &label_arg));

  snprintf(path, sizeof(path), "%s/outputs.f32", argv[8]);
  FILE* outs = fopen(path, "wb");
  snprintf(path, sizeof(path), "%s/labels.f32", argv[8]);
  FILE* labels = fopen(path, "wb");
  snprintf(path, sizeof(path), "%s/data.f32", argv[8]);
  FILE* datas = fopen(path, "wb");
  if (!outs || !labels || !datas) return 1;
  for (int step = 0; step < steps; ++step) {
    int has_next;
    void *data, *label, *out;
    CHECK(MXTDataIterNext(it, &has_next));
    if (!has_next) {
      fprintf(stderr, "the iterator ended at step %d\n", step);
      return 1;
    }
    CHECK(MXTDataIterGetData(it, &data));
    CHECK(MXTDataIterGetLabel(it, &label));
    CHECK(MXTNDArrayCopyFromNDArray(data_arg, data));
    CHECK(MXTNDArrayCopyFromNDArray(label_arg, label));
    if (write_array(labels, label) || write_array(datas, data)) return 1;
    MXTNDArrayFree(data);
    MXTNDArrayFree(label);
    CHECK(MXTExecutorForward(ex, 1));
    CHECK(MXTExecutorBackward(ex));
    int index = 0, skipped = 0;
    for (uint32_t i = 0; i < n_args; ++i) {
      void *grad, *weight;
      if (!strcmp(names[i], "data") || !strcmp(names[i], "softmax_label"))
        continue;
      if (step == skip_step && !skipped && strstr(names[i], "_weight")) {
        skipped = 1;
        ++index;
        continue;
      }
      CHECK(MXTExecutorGradArray(ex, names[i], &grad));
      CHECK(MXTExecutorArgArray(ex, names[i], &weight));
      CHECK(MXTUpdaterStep(upd, index++, grad, weight));
      MXTNDArrayFree(grad);
      MXTNDArrayFree(weight);
    }
    CHECK(MXTExecutorOutput(ex, 0, &out));
    if (write_array(outs, out)) return 1;
    MXTNDArrayFree(out);
  }
  fclose(outs);
  fclose(labels);
  fclose(datas);
  CHECK(MXTNDArrayWaitAll());
  snprintf(path, sizeof(path), "%s/weights.f32", argv[8]);
  FILE* weights = fopen(path, "wb");
  if (!weights) return 1;
  for (uint32_t i = 0; i < n_args; ++i) {
    void* w;
    if (!strcmp(names[i], "data") || !strcmp(names[i], "softmax_label"))
      continue;
    CHECK(MXTExecutorArgArray(ex, names[i], &w));
    if (write_array(weights, w)) return 1;
    MXTNDArrayFree(w);
  }
  fclose(weights);
  MXTNDArrayFree(data_arg);
  MXTNDArrayFree(label_arg);
  MXTDataIterFree(it);
  MXTUpdaterFree(upd);
  MXTExecutorFree(ex);
  MXTSymbolFree(sym);
  for (uint32_t i = 0; i < n_args; ++i) free(names[i]);
  free(names);
  printf("C TRAIN OK steps=%d\n", steps);
  return 0;
}

#ifndef MXT_C_TRAIN_NO_MAIN
int main(int argc, char** argv) { return mxt_c_train(argc, argv); }
#endif
""".replace('"LR"', '"%s"' % C_TRAIN_LR).replace(
    '"MOMENTUM"', '"%s"' % C_TRAIN_MOMENTUM).replace('"SEED"', '"%d"' % SEED)


def host_builds(box):
    """The native runtime's two libraries, built (for a thread): box
    ['native'] and box['image'] become (path, seconds), or the exception
    the build raised (the image iterator's names an absent OpenCV)."""
    from mxnet_tpu_torch import _build
    for key, fn in (('native', _build.native_library),
                    ('image', _build.native_image_library)):
        t0 = time.perf_counter()
        try:
            box[key] = (fn(), time.perf_counter() - t0)
        except Exception as e:      # judged where the result is used
            box[key] = e


def native_rec(torch, mx, root, kept):
    """The prefix of phase 18's .rec (moved under build/native_rec when
    `kept`), else the same images written there now."""
    prefix = root / 'build' / 'native_rec' / 'train'
    if not kept:
        prefix.parent.mkdir(parents=True, exist_ok=True)
        write_record_images(torch, mx, str(prefix), RECORD_IMAGES,
                            RESNET['num_classes'], mx.gpu(0))
    return str(prefix)


def c_train_build(lib, out):
    """The program as an executable and as a shared object, both linked
    against the C API library `lib`; raises with the compiler's output."""
    src = out / 'c_train.c'
    src.write_text(C_TRAIN_PROGRAM)
    libdir = str(lib.parent)
    link = ['-L' + libdir, '-lmxt_predict', '-Wl,-rpath,' + libdir]
    exe, so = out / 'c_train', out / 'c_train.so'
    for cmd in (['gcc', '-O2', '-Wall', str(src), '-o', str(exe)] + link,
                ['gcc', '-O2', '-Wall', '-fPIC', '-shared',
                 '-DMXT_C_TRAIN_NO_MAIN', str(src), '-o', str(so)] + link):
        cc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if cc.returncode != 0:
            raise RuntimeError('the C program failed to build:\n$ %s\n%s%s'
                               % (' '.join(cmd), cc.stdout, cc.stderr))
    return exe, so


def c_train_inputs(mx, out, image_shape, batch, net=None):
    """The symbol JSON (models/resnet.py's bf16 ResNet-50 unless `net`)
    and its seeded He-normal parameters (nd.save, by name)."""
    symbol = net if net is not None else mx.models.resnet.get_symbol(**RESNET)
    (out / 'symbol.json').write_text(symbol.tojson())
    args, _ = resnet_params(symbol, {'data': (batch,) + image_shape,
                                     'softmax_label': (batch,)},
                            1000, C_TRAIN_SEED)
    mx.nd.save(str(out / 'params.nd'),
               {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in args.items()
                if k not in ('data', 'softmax_label')})
    return symbol


def c_train_argv(started, run_dir, skip=None):
    out, shape = started['out'], started['image_shape']
    argv = [str(started['dev_type']), str(out / 'symbol.json'),
            str(out / 'params.nd'), started['prefix'] + '.rec',
            str(shape[1]), str(started['batch']), str(started['steps']),
            str(run_dir), started['source']]
    return argv + ([str(skip)] if skip is not None else [])


def c_train_inprocess(so, argv):
    """mxt_c_train(argv) called through ctypes in this process: the
    program's own calls, on the interpreter already running here."""
    import ctypes
    prog = ctypes.CDLL(str(so))
    args = ['c_train'] + argv
    arr = (ctypes.c_char_p * len(args))(*[a.encode() for a in args])
    return prog.mxt_c_train(len(args), arr)


def c_train_read(run_dir, steps, batch, classes):
    """What a run wrote: the outputs of each step, (steps, batch,
    classes); its labels, (steps, batch); its batches, (steps, batch, ...);
    the final weights, flat float32 in the symbol's argument order."""
    def read(name):
        return np.fromfile(str(run_dir / name), np.float32)
    return dict(outputs=read('outputs.f32').reshape(steps, batch, classes),
                labels=read('labels.f32').reshape(steps, batch),
                data=read('data.f32').reshape(steps, batch, -1),
                weights=read('weights.f32'))


def c_train_replay(mx, started, recorded, counter):
    """The steps of a run made again in Python, past the C API: the
    symbol bound by simple_bind on the program's device with grad_req
    write, its parameters from params.nd, each recorded batch and label
    through Executor.forward_backward, and an SGD updater made here with
    the program's settings. A fault of the C API's bridge, which the
    program and the runs in this process share (an optimizer setting
    parsed wrongly, a gradient not written, an update that does nothing),
    sets the replay apart from the program. Returns its outputs and
    weights, laid out as c_train_read's, and its conv launches."""
    symbol, batch = started['symbol'], started['batch']
    ctx = mx.gpu(0) if started['dev_type'] == 2 else mx.cpu()
    ex = symbol.simple_bind(ctx, grad_req='write',
                            data=(batch,) + started['image_shape'],
                            softmax_label=(batch,))
    for key, value in mx.nd.load(str(started['out'] / 'params.nd'),
                                 ctx=mx.cpu()).items():
        value.copyto(ex.arg_dict[key])
    updater = mx.optimizer.get_updater(mx.optimizer.SGD(
        learning_rate=float(C_TRAIN_LR), momentum=float(C_TRAIN_MOMENTUM),
        rescale_grad=1.0 / batch))
    names = [n for n in symbol.list_arguments() if n not in NO_GRAD]
    outputs = []
    before = counter()
    for x, y in zip(recorded['data'], recorded['labels']):
        mx.nd.array(x.reshape(ex.arg_dict['data'].shape), ctx=ctx,
                    dtype=np.float32).copyto(ex.arg_dict['data'])
        mx.nd.array(y, ctx=ctx, dtype=np.float32).copyto(
            ex.arg_dict['softmax_label'])
        ex.forward_backward()
        for index, name in enumerate(names):
            updater(index, ex.grad_dict[name], ex.arg_dict[name])
        outputs.append(ex.outputs[0].asnumpy().astype(np.float32))
    launches = counter() - before
    weights = np.concatenate([
        ex.arg_dict[n].astype('float32').asnumpy().ravel() for n in names])
    return dict(outputs=np.stack(outputs), weights=weights,
                launches=launches)


def c_train_weights_rel(symbol, batch, image_shape, a, b):
    """The largest relative-norm difference of one weight array between
    two flat weight vectors, cut by the symbol's argument shapes."""
    shapes, _, _ = symbol.infer_shape(data=(batch,) + image_shape,
                                      softmax_label=(batch,))
    worst, at = 0.0, 0
    for name, shape in zip(symbol.list_arguments(), shapes):
        if name in NO_GRAD:
            continue
        n = int(np.prod(shape))
        x, y = a[at:at + n].astype(np.float64), b[at:at + n].astype(
            np.float64)
        at += n
        worst = max(worst, float(np.linalg.norm(x - y) /
                                 max(np.linalg.norm(y), 1e-30)))
    return worst


def c_train_losses(outs, labels):
    return [float(-np.log(np.maximum(
        o[np.arange(len(l)), l.astype(np.int64)], 1e-30)).mean())
        for o, l in zip(outs, labels)]


REC_TRAIN_IMAGES, REC_TRAIN_EDGE, REC_TRAIN_CLASSES = 160, 16, 10


def rec_train_start(torch, mx, out):
    """cpp-package/example/rec_train.cpp, as written, built against the
    port's C API library and started with its executor on the CPU
    (kCPU) over a .rec of colour-coded class images (the JAX test's, JPEG
    by nvJPEG here); its ImageRecordIter names no ctx, so the port's
    pipeline decodes on gpu(0) and MXTNDArrayCopyFromNDArray brings each
    batch to the host. The Background."""
    rng = np.random.default_rng(SEED + 381)
    prefix = str(out / 'colors')
    w = mx.recordio.MXIndexedRecordIO(prefix + '.idx', prefix + '.rec', 'w')
    centers = rng.integers(40, 215, (REC_TRAIN_CLASSES, 3))
    for i in range(REC_TRAIN_IMAGES):
        c = i % REC_TRAIN_CLASSES
        img = (centers[c][None, None, :] + rng.integers(
            -25, 25, (REC_TRAIN_EDGE, REC_TRAIN_EDGE, 3))).clip(0, 255)
        w.write_idx(i, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(c), i, 0),
            torch.from_numpy(img.astype(np.uint8)).cuda()))
    w.close()
    from mxnet_tpu_torch import _build
    lib = _build.c_predict_library()
    exe = str(out / 'rec_train')
    cc = subprocess.run(
        ['g++', '-O2', '-std=c++14', '-I' + str(Path(__file__).resolve()
                                                 .parent / 'cpp-package' /
                                                 'include'),
         str(Path(__file__).resolve().parent / 'cpp-package' / 'example' /
             'rec_train.cpp'), '-o', exe, '-L' + str(lib.parent),
         '-lmxt_predict', '-Wl,-rpath,' + str(lib.parent)],
        capture_output=True, text=True, timeout=300)
    if cc.returncode != 0:
        fail('phase 38: rec_train.cpp failed to compile:\n%s%s'
             % (cc.stdout, cc.stderr))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    return Background([exe, prefix + '.rec', str(REC_TRAIN_EDGE),
                       str(REC_TRAIN_CLASSES)], 900, env=env, cwd=str(out))


def c_train_gate(run):
    """Phase 38's checks on a run's numbers: what failed, empty when it
    passed."""
    bad = []
    prog = run['program']
    if prog['rc'] != 0 or 'C TRAIN OK' not in prog['out']:
        bad.append('the C program exited %s: %s' % (prog['rc'],
                                                    prog['err']))
    for key in ('first', 'second'):
        if run['inprocess'][key]['rc'] != 0:
            bad.append('the in-process run exited %s'
                       % run['inprocess'][key]['rc'])
    want = run['want_launches'] * run['steps']
    for key in ('first', 'second'):
        n = run['inprocess'][key]['launches']
        if n != want:
            bad.append('the in-process %s run launched the kernel %d times '
                       'in %d steps, expected %d' % (key, n, run['steps'],
                                                     want))
    if not bad and run['replay']['launches'] != want:
        bad.append('the replay launched the kernel %d times in %d steps, '
                   'expected %d' % (run['replay']['launches'], run['steps'],
                                    want))
    if not bad:
        cmp_ = run['compare']
        losses = cmp_['losses']
        if not all(math.isfinite(v) for v in losses):
            bad.append('a loss is not finite: %s' % losses)
        if not cmp_['labels_equal']:
            bad.append('the C program\'s batches carry other labels than '
                       'the in-process run\'s')
        kernel = run['nondeterministic_kernel']
        if cmp_['deterministic']:
            for what, against in (('program', 'the in-process run'),
                                  ('replay', 'the C program')):
                c = cmp_[what]
                if not (c['data_equal'] and c['outputs_equal'] and
                        c['weights_equal']):
                    bad.append('the %s\'s batches / outputs / weights differ '
                               'from %s (%s, %s, %s): max |diff| %g / %g, '
                               'weights %.3g apart in relative norm'
                               % (what, against, c['data_equal'],
                                  c['outputs_equal'], c['weights_equal'],
                                  c['outputs_max_diff'],
                                  c['weights_max_diff'], c['weights_rel']))
        elif kernel is None:
            bad.append('the two in-process runs differ (outputs %g apart) '
                       'and no nondeterministic kernel is named'
                       % cmp_['rerun_outputs_max_diff'])
        else:
            for what, against in (('program', 'in process'),
                                  ('replay', 'in the program')):
                c = cmp_[what]
                for i, (a, b) in enumerate(zip(c['losses'], c['against'])):
                    if not abs(a - b) <= RESNET_LOSS_ATOL:
                        bad.append('the %s\'s step %d loss %.5f against '
                                   '%.5f %s (%s is nondeterministic)'
                                   % (what, i, a, b, against, kernel))
                if not c['weights_rel'] <= MODULE_STATE_REL:
                    bad.append('the %s\'s weights %.3g apart from those %s '
                               'in relative norm (bound %g; %s is '
                               'nondeterministic)'
                               % (what, c['weights_rel'], against,
                                  MODULE_STATE_REL, kernel))
    rec_ = run.get('rec_train')
    if rec_ is not None and (rec_['rc'] != 0 or
                             'final train-accuracy' not in rec_['out']):
        bad.append('rec_train.cpp on the CPU exited %s: %s'
                   % (rec_['rc'], rec_['err']))
    return bad


def c_train_start(mx, root, prefix, lib, source='native', dev_type=2,
                  steps=C_TRAIN_STEPS, batch=C_TRAIN_BATCH, image_shape=None,
                  net=None, skip=None, classes=RESNET['num_classes']):
    """Phase 38's inputs and program, built, and the program started in
    a process of its own, its batches from `source` ('native', or a
    context for the port's pipeline): the state c_train_run finishes
    from."""
    image_shape = image_shape or tuple(
        int(v) for v in RESNET['image_shape'].split(','))
    out = fresh_dir(root, 38)
    symbol = c_train_inputs(mx, out, image_shape, batch, net)
    exe, so = c_train_build(lib, out)
    run_dir = out / 'program'
    run_dir.mkdir()
    started = dict(out=out, so=so, symbol=symbol, dev_type=dev_type,
                   steps=steps, batch=batch, image_shape=image_shape,
                   prefix=prefix, source=source, classes=classes)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    started['job'] = Background(
        [str(exe)] + c_train_argv(started, run_dir, skip), 900, env=env,
        cwd=str(out))
    return started


def c_train_run(torch, mx, cuda_conv, started, counter=None,
                rec_train=None):
    """Phase 38: the C program of C_TRAIN_PROGRAM (started by
    c_train_start) binds the bf16 ResNet-50 from its symbol JSON on the
    card (dev_type 2) at batch 64, loads its seeded parameters, and takes
    C_TRAIN_STEPS SGD steps (momentum 0.9) fed by
    ImageRecordIter(use_native=1) through MXTNDArrayCopyFromNDArray;
    here the same program's function runs twice in this process (the conv
    launches counted), and c_train_replay makes the first run's steps
    again past the C API. The program's batches, outputs and weights are
    held against the first run's, and the replay's outputs and weights
    against the program's: bit for bit, or, where
    C_TRAIN_NONDETERMINISTIC names a kernel, within phase 36's bounds.
    `rec_train` is the Background of cpp-package's rec_train.cpp on the
    CPU, or None. Returns the run's numbers, for c_train_gate."""
    counter = counter or (lambda: cuda_conv.CONV_BN_STATS_LAUNCHES)
    out, steps, batch = started['out'], started['steps'], started['batch']
    classes, symbol = started['classes'], started['symbol']
    inproc = {}
    for key in ('first', 'second'):
        run_dir = out / key
        run_dir.mkdir()
        argv = c_train_argv(started, run_dir)
        before = counter()
        t0 = time.perf_counter()
        rc = c_train_inprocess(started['so'], argv)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        inproc[key] = dict(rc=rc, launches=counter() - before,
                           s=time.perf_counter() - t0)
    proc, prog_s = started['job'].wait()
    program = dict(rc=proc.returncode, s=prog_s,
                   out=proc.stdout.strip()[-300:],
                   err=proc.stderr.strip()[-2000:])
    rec_run = None
    if rec_train is not None:
        p, s = rec_train.wait()
        rec_run = dict(rc=p.returncode, s=s, out=p.stdout.strip()[-300:],
                       err=p.stderr.strip()[-1500:])
    # the program binds every argument with grad_req 'write': the data
    # has a gradient, so the stem's pair stays on the route (no split)
    run = dict(steps=steps, batch=batch, dev_type=started['dev_type'],
               source=started['source'], want_launches=graph_pairs(symbol),
               nondeterministic_kernel=C_TRAIN_NONDETERMINISTIC,
               program=program, inprocess=inproc, rec_train=rec_run)
    if program['rc'] == 0 and all(v['rc'] == 0 for v in inproc.values()):
        a, b, c = (c_train_read(out / key, steps, batch, classes)
                   for key in ('first', 'second', 'program'))
        t0 = time.perf_counter()
        replay = c_train_replay(mx, started, a, counter)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        run['replay'] = dict(launches=replay['launches'],
                             s=time.perf_counter() - t0)
        replay.update(labels=c['labels'], data=c['data'])

        def against(x, y):
            """x's numbers held against y's."""
            return dict(
                data_equal=bool(np.array_equal(x['data'], y['data'])),
                outputs_equal=bool(np.array_equal(x['outputs'],
                                                  y['outputs'])),
                weights_equal=bool(np.array_equal(x['weights'],
                                                  y['weights'])),
                outputs_max_diff=float(np.abs(x['outputs'] -
                                              y['outputs']).max()),
                weights_max_diff=float(np.abs(x['weights'] -
                                              y['weights']).max()),
                weights_rel=c_train_weights_rel(
                    symbol, batch, started['image_shape'], x['weights'],
                    y['weights']),
                losses=c_train_losses(x['outputs'], x['labels']),
                against=c_train_losses(y['outputs'], y['labels']))
        run['compare'] = dict(
            deterministic=bool(all(np.array_equal(a[k], b[k]) for k in a)),
            labels_equal=bool(np.array_equal(c['labels'], a['labels'])),
            program=against(c, a), replay=against(replay, c),
            rerun_outputs_max_diff=float(np.abs(b['outputs'] -
                                                a['outputs']).max()),
            weights=int(a['weights'].size),
            losses=c_train_losses(a['outputs'], a['labels']))
    return run


def c_train_phase(torch, mx, cuda_conv, started, rec_train=None):
    """Phase 38 (c_train_run), gated by c_train_gate."""
    run = c_train_run(torch, mx, cuda_conv, started, rec_train=rec_train)
    out, steps, batch = started['out'], run['steps'], run['batch']
    prog_s, inproc, rec_run = (run['program']['s'], run['inprocess'],
                               run['rec_train'])
    print('c_train ' + json.dumps(run))
    bad = c_train_gate(run)
    if bad:
        fail('phase 38: ' + '; '.join(bad))
    cmp_ = run['compare']
    print('c_train: the C program (%.1f s, its own process, batches from '
          '%s) %s the same calls in this process over %d steps at batch %d '
          '(%d weights), and the replay through Executor.forward_backward '
          'and a Python SGD updater (%.1f s) %s the program; losses %s; '
          '%d conv launches a step here; rec_train.cpp on the CPU %s'
          % (prog_s, run['source'],
             'bit-equal to' if cmp_['deterministic'] else 'within phase '
             '36\'s bounds of', steps, batch, cmp_['weights'],
             run['replay']['s'], 'bit-equal to' if cmp_['deterministic']
             else 'within phase 36\'s bounds of',
             ['%.4f' % v for v in cmp_['program']['losses']],
             inproc['first']['launches'] // steps,
             rec_run['out'].splitlines()[-1] if rec_run else 'not run'))
    shutil.rmtree(out, ignore_errors=True)
    return run


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument('--forward-case', choices=sorted(FWD_CASES),
                        help='build, then run only this case of phase 2')
    parser.add_argument('--backward-case', choices=sorted(BWD_CASES),
                        help='build, then run only this case of phase 4')
    parser.add_argument('--conv-case', choices=sorted(CONV_CASES),
                        nargs='+',
                        help='build, then run only these cases of phase 6')
    parser.add_argument('--phases', type=lambda v: {int(p) for p in
                                                    v.split(',')},
                        default=ALL_PHASES,
                        help='build, then run only these phases (a comma '
                             'list of 2-38); the kernels line needs all')
    parser.add_argument('--dist-worker', choices=('ps', 'coord', 'dp',
                                                  'sparse', 'pipe', 'pipe4',
                                                  'hybrid'),
                        help=argparse.SUPPRESS)
    parser.add_argument('--dist-out', help=argparse.SUPPRESS)
    parser.add_argument('--dist-tag', help=argparse.SUPPRESS)
    parser.add_argument('--mutants', action='store_true',
                        help='check that phase 2\'s LM case fails each of '
                             'FWD_MUTANTS, phase 4\'s each of BWD_MUTANTS '
                             'and phase 6\'s main case each of '
                             'CONV_MUTANTS, broken copies of the kernels')
    args = parser.parse_args(argv)
    # a crash in native code prints every thread's Python stack to
    # stderr, in this process and in every process it starts
    faulthandler.enable(all_threads=True)
    os.environ.setdefault('PYTHONFAULTHANDLER', '1')
    import torch
    if args.dist_worker == 'dp':
        # one rank of phase 29, started by the port's launcher
        dp_worker(args.dist_out)
        return
    if args.dist_worker == 'sparse':
        # one rank of phase 31, started by the port's launcher
        mf_worker(args.dist_out)
        return
    if args.dist_worker == 'pipe':
        # one rank of phases 32 and 34, started by the port's launcher
        pipe_worker(args.dist_out)
        return
    if args.dist_worker == 'pipe4':
        # one rank of phase 33, started by the port's launcher
        pipe4_worker(args.dist_out)
        return
    if args.dist_worker == 'hybrid':
        # one rank of a worker of phase 35, started by the port's launcher
        hybrid_worker(args.dist_out)
        return
    if args.dist_worker:
        # one worker of phase 21 or 22, started by the port's launcher
        dist_worker(args.dist_worker, args.dist_out, args.dist_tag)
        return
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this script needs a '
             'CUDA device')
    root = Path(__file__).resolve().parent
    if not (root / 'mxnet_tpu_torch' / 'csrc').is_dir():
        fail('mxnet_tpu_torch/csrc not found beside %s: run it from a '
             'checkout of the repository' % Path(__file__).name)
    if args.mutants:
        mutant_check(root)
        return
    atexit.register(Background.stop_all)
    phases = args.phases
    if not phases <= ALL_PHASES:
        fail('--phases takes phases 2 to 38; got %s' % sorted(phases))
    sys.path.insert(0, str(root))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _build, cuda_conv, cuda_ops
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.parallel import mesh as pmesh
    from mxnet_tpu_torch.parallel import transformer as tfm
    from mxnet_tpu_torch.tools import bench_conv_bn

    # full float32 products in the plain versions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print('card: %s | torch %s, CUDA %s, %d device(s)' % (
        smi, torch.__version__, torch.version.cuda,
        torch.cuda.device_count()))

    # 1. build
    clock = PhaseClock()
    clock.start(1)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print('build: %.1f s' % build_s)
    # the native runtime (host C++) builds beside phases 2 on
    native_build = {}
    if phases & {37, 38}:
        native_thread = threading.Thread(target=host_builds,
                                         args=(native_build,), daemon=True)
        native_thread.start()
    build_log = _build.build_log().strip()
    print(build_log)
    sass_job = sass_start(_build.build())
    if args.forward_case or args.backward_case or args.conv_case:
        sass_check(sass_job, build_log)
        if args.forward_case:
            shape_q, tk, dtype_name, iters = FWD_CASES[args.forward_case]
            kernel_case(torch, cuda_ops, args.forward_case, shape_q, tk,
                        getattr(torch, dtype_name), True, iters)
        if args.backward_case:
            backward_phase(torch, cuda_ops, [args.backward_case])
        for name in args.conv_case or ():
            conv_case(torch, cuda_conv, name)
        return

    # 2. each kernel against its plain version, at the LM's shape first
    if 2 in phases:
        clock.start(2)
        cases = [kernel_case(torch, cuda_ops, name, shape_q, tk,
                             getattr(torch, dtype_name), True, iters=iters)
                 for name, (shape_q, tk, dtype_name, iters)
                 in FWD_CASES.items()]

    # 3. the LM forward, the port's serving path
    if phases & {3, 5, 26}:
        cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
    if phases & {3, 5}:
        t0 = time.perf_counter()
        params = tfm.params_from_jax(seeded_tree(cfg, SEED),
                                     dtype=torch.bfloat16, device='cuda')
        print('lm: parameters made in %.1f s' % (time.perf_counter() - t0))
    if phases & {3, 5, 26}:
        rng = np.random.default_rng(SEED + 1)
        requests = []
        for _ in range(REQUESTS):
            tok = rng.integers(0, cfg['vocab'], (BATCH, SEQ + 1))
            tok = torch.from_numpy(tok).cuda()
            requests.append((tok[:, :-1], tok[:, 1:]))
    if 3 in phases:
        clock.start(3)
        lm = lm_phase(torch, cuda_ops, tfm, cfg, params, requests)
        lm['wide_heads'] = lm_variant_check(
            torch, cuda_ops, tfm, requests[0], LM_WIDE_HEADS, torch.bfloat16,
            SEED + 7, 'wide heads')
        lm['float16'] = lm_variant_check(
            torch, cuda_ops, tfm, requests[0],
            dict(GPT2_MEDIUM, layers=F16_LAYERS), torch.float16, SEED + 8,
            'float16')
    clock.start(1)
    sass = sass_check(sass_job, build_log)
    clock.stop()

    # 4. the backward kernels against their plain versions
    if 4 in phases:
        clock.start(4)
        bwd_cases = backward_phase(torch, cuda_ops, BWD_CASES)

    # 5. the train step, the port's training path
    if 5 in phases:
        clock.start(5)
        train = train_phase(torch, cuda_ops, tfm, params, requests[0])
    if phases & {3, 5}:
        del params

    # 6. the conv + BN statistics kernel and its bench path
    if 6 in phases:
        clock.start(6)
        conv = conv_phase(torch, cuda_ops, cuda_conv, bench_conv_bn)

    # 8. mx.rtc: the RTC_CASES kernels and the imperative loop
    if 8 in phases:
        clock.start(8)
        rtc_run = rtc_phase(torch, mx)

    # 9. the bf16 ResNet-50 through Symbol and the executor
    if 9 in phases:
        clock.start(9)
        resnet = resnet_phase(torch, mx, cuda_conv)

    # 10. Module.fit trains the same network
    if 10 in phases:
        clock.start(10)
        module = module_phase(torch, mx, cuda_conv, root,
                              resnet if 9 in phases else None)

    # 11. the checkpoint served: Predictor and the InferenceEngine
    if 11 in phases:
        clock.start(11)
        serve = serve_phase(torch, mx, cuda_conv, cuda_ops, root)

    # 12. the Module remainder: BucketingModule, bulk_step, fit(bulk=),
    # the stem split and group2ctx
    if 12 in phases:
        clock.start(12)
        bucketing = bucketing_phase(torch, mx, cuda_conv,
                                    resnet if 9 in phases else None)

    # 13. Gluon trains ResNet-50 v1
    if 13 in phases:
        clock.start(13)
        gluon_run = gluon_phase(torch, mx, cuda_conv, cuda_ops, root)

    # 18. the train_imagenet input path: ImageRecordIter feeds Module.fit
    if 18 in phases:
        clock.start(18)
        record = record_phase(torch, mx, cuda_conv, root,
                              module if 10 in phases else None,
                              keep=(root / 'build' / 'native_rec'
                                    if phases & {37, 38} else None))

    # 19. VGG16-SSD300 through ImageDetIter and Module.fit
    if 19 in phases:
        clock.start(19)
        ssd_phase(torch, mx, cuda_conv, cuda_ops, root)

    # 20. the serving fleet: ModelRegistry, ContinuousEngine, HttpFront
    if 20 in phases:
        clock.start(20)
        fleet = fleet_phase(torch, mx, cuda_conv, cuda_ops, tfm, root)

    # the launches of phases 21, 22, 31 and 33 start together and share
    # the card: each phase then waits for its own
    started = {}
    if phases & {21, 22, 31, 32, 33, 34}:
        torch.cuda.empty_cache()
        for phase, start in ((21, ps_start), (22, coord_start),
                             (31, sparse_start), (33, pipe4_start)):
            if phase in phases:
                started[phase] = start(root)
        if 21 in started and 29 in phases:
            # phase 29's launch takes the memory phase 21's workers give
            # back, as soon as they have
            started[21][1].after(
                lambda: started.setdefault(29, dp_start(root)))
        if phases & {32, 34}:
            # phases 32 and 34's ranks take what phase 31's give back
            if 31 in started:
                started[31][1].after(
                    lambda: started.setdefault(32, pipe_start(root)))
            else:
                started[32] = pipe_start(root)

    # phases that gate no time run while those launches run (their host
    # times are taken beside the launches')

    # 7. the NDArray core, gpu(0) against cpu(0)
    if 7 in phases:
        clock.start(7)
        nd_phase(torch, mx)

    # 14. the PTB LSTM LM through mx.rnn and BucketingModule
    if 14 in phases:
        clock.start(14)
        ptb = ptb_phase(torch, mx, cuda_conv, cuda_ops, root)

    # 15. gluon.rnn: the medium word LM
    if 15 in phases:
        clock.start(15)
        gluon_lm = gluon_lm_phase(torch, mx, cuda_conv, cuda_ops)

    # 16. the model factories: Inception-v3 and ResNeXt-50 on the conv
    # kernel, the rest in float32
    if 16 in phases:
        clock.start(16)
        factories = factories_phase(torch, mx, cuda_conv)

    # 17. the last 50 op names, gpu(0) against cpu(0)
    if 17 in phases:
        clock.start(17)
        contrib_phase(torch, cuda_conv, cuda_ops)

    # 21. two workers and a parameter server train the ResNet-50
    if 21 in phases:
        clock.start(21)
        dist_ps = ps_phase(torch, mx, root, started.get(21))

    # 22. the coordinator's allreduce, an elastic restart, the ring and
    # the checkpoints served
    if 22 in phases:
        clock.start(22)
        dist_coord = coord_phase(torch, mx, root, started.get(22))

    # no launch runs beside phase 23's timed canary (phase 32's starts
    # when phase 31's ends, so it is there once 31's wait returns)
    for phase in (29, 31, 33, 32):
        if phase in started:
            clock.start(phase)
            started[phase][1].wait()
            clock.stop()

    # 23. the train -> serve loop: fit pushes its commits into a fleet of
    # two replica processes
    if 23 in phases:
        clock.start(23)
        loop = train_serve_phase(torch, mx, cuda_conv, root)

    # 24. the GPT-2-medium scorer behind the router
    if 24 in phases:
        clock.start(24)
        router = scorer_router_phase(torch, mx, cuda_conv, cuda_ops, tfm)

    # 35's launch starts once every other launch has ended (beside the
    # others and phases 14-17 its four ranks ran the card out of memory)
    # and runs beside phase 25, which gates no time
    if 35 in phases:
        torch.cuda.empty_cache()
        started[35] = hybrid_start(root)

    # 25. the deployment artifact and the C predict API
    if 25 in phases:
        clock.start(25)
        artifact_phase(torch, mx, cuda_conv, cuda_ops, root)

    # 35. hybrid workers: 2 workers x 2 ranks, each worker's ranks a data
    # mesh, the workers synced through a parameter server; the reductions
    # over the batch on a worker's mesh
    if 35 in phases:
        clock.start(35)
        hybrid = hybrid_phase(torch, mx, root, smi, started.get(35))

    # 26. the LM step through the mesh path, world 1 over NCCL
    if 26 in phases:
        clock.start(26)
        mesh_run = mesh_step_phase(torch, cuda_ops, tfm, pmesh, profiler,
                                   root, requests[0],
                                   train if 5 in phases else None)

    # 27. four ranks share the card: dp x sp x tp = 1 x 2 x 2 over gloo,
    # the ring's hops on the flash kernels
    if 27 in phases:
        clock.start(27)
        ring_run = ring_phase(torch, pmesh, root, smi)

    # 38's C program starts in a process of its own, and rec_train.cpp
    # on the CPU in another, and both run beside phases 28-37
    if phases & {37, 38}:
        clock.start(37)
        native_thread.join()
        if isinstance(native_build['native'], Exception):
            fail('the native runtime failed to build: %s'
                 % native_build['native'])
        rec_prefix = native_rec(torch, mx, root, 18 in phases)
    if 38 in phases:
        clock.start(38)
        # without OpenCV (no native iterator) the program's batches come
        # from the port's nvJPEG pipeline on the card
        c_started = c_train_start(
            mx, root, rec_prefix, _build.c_predict_library(),
            source='gpu(0)' if isinstance(native_build['image'], Exception)
            else 'native')
        rec_train = rec_train_start(torch, mx, c_started['out'])

    # 28. Module(context=[gpu(0)]) as the one rank of a data mesh over
    # NCCL, ZeRO 0 then 1, fit(bulk=2) on the mesh's staging
    if phases & {28, 29}:
        clock.start(28)
        dp_mesh = dp_mesh_phase(torch, mx, cuda_conv, pmesh, profiler, root,
                                smi)

    # 29. two launcher workers share the card as a data mesh over gloo,
    # ZeRO 1, against phase 28's world-1 step
    if 29 in phases:
        clock.start(29)
        dp_ranks = dp_ranks_phase(torch, mx, root, smi, dp_mesh,
                                  started.get(29))

    # 30. gluon.fuse_step trains the bf16 resnet50_v1, its conv ->
    # BatchNorm pairs on the conv kernel
    if 30 in phases:
        clock.start(30)
        gluon_fused = gluon_fused_phase(torch, mx, cuda_conv, smi)

    # 31. sparse_grad tables at MovieLens-20M's counts: rows-only steps,
    # striped over two ranks, served from a hot-row cache
    if 31 in phases:
        clock.start(31)
        sparse_phase(torch, mx, root, smi, started=started.get(31))

    # 32. the GPT-2-medium LM in two pipeline stages, two ranks sharing the
    # card over gloo, on the flash kernels
    if phases & {32, 34}:
        clock.start(32)
        pipe_run = pipe_phase(torch, cuda_ops, tfm, root, smi,
                              started.get(32))

    # 33. fuse_step(pipeline=) and Module.fit(pipeline=) at dp x pipe = 2 x 2
    if 33 in phases:
        clock.start(33)
        pipe4_phase(torch, root, smi, started.get(33))

    # 34. gluon.nn.MoE at Switch-Base-8's widths, at world 1 and over phase
    # 32's two ranks
    if 34 in phases:
        clock.start(34)
        moe_phase(torch, mx, root, smi)
    elif 32 in phases:
        shutil.rmtree(root / 'build' / 'phase32', ignore_errors=True)

    # 36. a Custom numpy loss head trains the ResNet-50 through Module; a
    # NumpyOp step; check_consistency over cpu, gpu and bfloat16
    if 36 in phases:
        clock.start(36)
        custom = custom_phase(torch, mx, cuda_conv, smi)

    # 37. the native runtime: mx.engine, RecordIO's C reader and writer,
    # ImageRecordIter(use_native=True) feeding Module.fit
    if 37 in phases:
        clock.start(37)
        native = native_phase(torch, mx, cuda_conv, root, rec_prefix,
                              native_build)

    # 38. the C training API: the C program against the same calls made
    # in this process
    if 38 in phases:
        clock.start(38)
        c_train = c_train_phase(torch, mx, cuda_conv, c_started,
                                rec_train=rec_train)
    if phases & {37, 38}:
        shutil.rmtree(root / 'build' / 'native_rec', ignore_errors=True)

    clock.stop()
    print('phase seconds ' + json.dumps(dict(
        clock.seconds, total=round(time.perf_counter() - clock.t_start, 1))))
    if phases != ALL_PHASES:
        print('phases %s passed' % sorted(phases))
        return
    main_case = cases[0]
    kernels = [dict(
        name='flash_attention_fwd', route='cuda',
        source='mxnet_tpu_torch/csrc/flash_attention_sm90.cu',
        float32_source='mxnet_tpu_torch/csrc/flash_attention.cu',
        sass=sass['flash_fwd_sm90'],
        replaces='mxnet_tpu/pallas_ops.py:95',
        launches=lm['flash_launches'],
        launches_by_path=dict(lm_serve=lm['flash_launches'],
                              lm_train=train['launches'][0],
                              resnet_serve=serve['launches']['flash_fwd'],
                              gluon_train=gluon_run['kernel_launches'][
                                  'flash_fwd'],
                              lstm_ptb_train=ptb['kernel_launches'][
                                  'flash_fwd'],
                              gluon_lstm_train=gluon_lm['kernel_launches'][
                                  'flash_fwd'],
                              fleet_lm_serve=fleet['flash']['launches'],
                              fleet_router_scorer=router['path_launches'],
                              lm_train_mesh=mesh_run['launches'][0],
                              lm_train_ring=ring_run['launches'][0],
                              lm_train_pipe=pipe_run['launches'][0]),
        max_abs_err=main_case['max_abs_err'],
        share_differ=main_case['share_differ'],
        ms=main_case['ms'], tflops=main_case['tflops'],
        plain_ms=main_case['plain_ms'],
        bound_ms=main_case['bound_ms'], bound_by=main_case['bound_by'],
        library_ms=main_case['library_ms'],
        library_call='scaled_dot_product_attention forward (is_causal)',
        build_s=build_s, cases=cases)]
    for i, (name, key, grads, line) in enumerate((
            ('flash_attention_bwd_dkdv', 'dkdv', ('dk', 'dv'), 313),
            ('flash_attention_bwd_dq', 'dq', ('dq',), 362))):
        per_case = [dict(
            case=c['case'], dtype=c['dtype'],
            max_abs_err=max(c['errors'][g]['max_abs_err'] for g in grads),
            share_differ=max(c['errors'][g]['share_differ'] for g in grads),
            tol=c['tol'], same_bits_twice=c['same_bits_twice'],
            ms=c[key + '_ms'], plain_ms=c[key + '_plain_ms'],
            library_ms=c['sdpa_backward_ms'], **c['bounds'][key],
            **c['rates'][key])
            for c in bwd_cases]
        main_case = per_case[0]
        kernels.append(dict(
            name=name, route='cuda',
            source='mxnet_tpu_torch/csrc/flash_attention_bwd_sm90.cu',
            float32_source='mxnet_tpu_torch/csrc/flash_attention_bwd.cu',
            sass=sass[('flash_bwd_dkdv_sm90', 'flash_bwd_dq_sm90')[i]],
            tflops=main_case['tflops'], tflops_done=main_case['tflops_done'],
            replaces='mxnet_tpu/pallas_ops.py:%d' % line,
            launches=train['launches'][1 + i],
            launches_by_path=dict(
                lm_serve=lm['launches'][1 + i],
                lm_train=train['launches'][1 + i],
                resnet_serve=serve['launches'][('flash_bwd_dkdv',
                                                'flash_bwd_dq')[i]],
                gluon_train=gluon_run['kernel_launches'][
                    ('flash_bwd_dkdv', 'flash_bwd_dq')[i]],
                lstm_ptb_train=ptb['kernel_launches'][
                    ('flash_bwd_dkdv', 'flash_bwd_dq')[i]],
                gluon_lstm_train=gluon_lm['kernel_launches'][
                    ('flash_bwd_dkdv', 'flash_bwd_dq')[i]],
                lm_train_mesh=mesh_run['launches'][1 + i],
                lm_train_ring=ring_run['launches'][1 + i],
                lm_train_pipe=pipe_run['launches'][1 + i]),
            max_abs_err=main_case['max_abs_err'], ms=main_case['ms'],
            plain_ms=main_case['plain_ms'], bound_ms=main_case['bound_ms'],
            bound_by=main_case['bound_by'],
            library_ms=main_case['library_ms'],
            library_call='scaled_dot_product_attention backward (dq, dk '
                         'and dv together), device time by torch.profiler',
            whole_backward_bound_ms=bwd_cases[0]['bounds']['whole'][
                'bound_ms'],
            cases=per_case))
    kernels.append(conv_kernel_entry(conv, sass, resnet, module, serve,
                                     bucketing, gluon_run, ptb, gluon_lm,
                                     factories, record, dist_ps,
                                     dist_coord, loop, dp_mesh, dp_ranks,
                                     gluon_fused, hybrid, custom, native,
                                     c_train))
    kernels.append(rtc_kernel_entry(rtc_run, ptb, gluon_lm))
    for kern in kernels:
        if kern['launches'] == 0:
            fail('its path launched no %s kernel' % kern['name'])
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def lm_phase(torch, cuda_ops, tfm, cfg, params, requests):
    """Phase 3: the LM forward answers REQUESTS requests on the flash
    kernel, and one request is held against plain attention."""
    model = tfm.TransformerLM(cfg, params).eval()
    dense = tfm.TransformerLM(dict(cfg, use_flash=False), params).eval()
    print('lm: %d parameters (bf16)' % sum(
        p.numel() for p in model.parameters()))
    with torch.inference_mode():
        model(requests[0][0])          # warm-up, not counted
        torch.cuda.synchronize()
        reset_counts(cuda_ops)
        times, nlls, per_request = [], [], []
        for tokens, targets in requests:
            before = cuda_ops.FLASH_FWD_LAUNCHES
            t0 = time.perf_counter()
            logits = model(tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            per_request.append(cuda_ops.FLASH_FWD_LAUNCHES - before)
            if tuple(logits.shape) != (BATCH, SEQ, cfg['vocab']):
                fail('logits shape %s' % (tuple(logits.shape),))
            if not bool(torch.isfinite(logits).all()):
                fail('non-finite logits')
            nlls.append(float(tfm.nll(logits, targets)))
        launches = read_counts(cuda_ops)

        # one request on plain attention, same weights
        tokens, targets = requests[0]
        flash_logits = model(tokens).float()
        dense_logits = dense(tokens).float()
        logit_err = float((flash_logits - dense_logits).abs().max())
        nll_dense = float(tfm.nll(dense_logits, targets))
        del flash_logits, dense_logits, logits

        # where the time of one request goes, by kernel
        dev_ms, top, copies = profile_device(
            torch, lambda: model(tokens), 'lm profile, one request', 10)

    fwd_ms = sorted(times)[len(times) // 2] * 1e3
    lm = dict(config='gpt2-medium widths, %d layers, bf16' % cfg['layers'],
              batch=BATCH, seq=SEQ, requests=REQUESTS,
              forward_ms=[t * 1e3 for t in times], forward_ms_median=fwd_ms,
              tokens_per_s=BATCH * SEQ / (fwd_ms / 1e3), mean_nll=nlls,
              ln_vocab=math.log(cfg['vocab']), flash_launches=launches[0],
              launches=launches, launches_per_request=per_request,
              flash_vs_plain_max_abs_logit_err=logit_err,
              logit_atol=LM_LOGIT_ATOL, nll_flash=nlls[0],
              nll_plain=nll_dense, nll_atol=LM_NLL_ATOL,
              profiled_device_ms=dev_ms, device_busy_share=dev_ms / fwd_ms,
              profile_top=top, copies=copies)
    print('lm ' + json.dumps(lm))
    if per_request != [cfg['layers']] * REQUESTS:
        fail('flash launches per request %s, expected %d each'
             % (per_request, cfg['layers']))
    if launches[1:] != (0, 0):
        fail('the forward launched backward kernels: %s' % (launches,))
    if not all(abs(n - math.log(cfg['vocab'])) < 1.0 for n in nlls):
        fail('mean NLL %s far from ln(vocab) = %.3f'
             % (nlls, math.log(cfg['vocab'])))
    if logit_err > LM_LOGIT_ATOL or abs(nlls[0] - nll_dense) > LM_NLL_ATOL:
        fail('flash and plain attention disagree: logits %.4g (tol %g), '
             'nll %.5f vs %.5f (tol %g)' % (logit_err, LM_LOGIT_ATOL,
                                            nlls[0], nll_dense,
                                            LM_NLL_ATOL))
    return lm


if __name__ == '__main__':
    main()
